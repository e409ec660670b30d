"""The port's renders: reference goldens, the JAX render, and the CLI.

- The six texture-free deterministic goldens, at the bounds of
  tests/test_golden.py:22-33.
- The port and the JAX package render the same frame of the same scene
  (carried across with ``scene_from_numpy``): frac(|dLDR| > 1) < 1e-4.
  rock6k goes through the BVH walks end to end.
- The CLI writes a PNG whose IDAT decodes to the ``to_ldr`` frame bit for
  bit, and refuses ``--device cuda`` without a CUDA device.
"""

import dataclasses
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

import conftest
from test_torch_scene import rock6k_xml

torch.set_num_threads(1)


def _load(name):
    from raytracer795_tpu_torch.scene.loader import load_scene

    return load_scene(os.path.join(conftest.SCENES, name + ".xml"), "cpu")


@pytest.mark.parametrize("name,mean_tol,frac_tol", [
    ("simple", 0.01, 0.001),
    ("cornellbox", 0.01, 0.001),
    ("brdfs", 0.01, 0.001),
    ("lights", 0.01, 0.001),
    ("transforms", 0.2, 0.01),
    ("instances", 0.2, 0.01),
])
def test_deterministic_golden(name, mean_tol, frac_tol):
    from raytracer795_tpu_torch.render import render_camera

    img = conftest.ldr(render_camera(_load(name), 0))
    diff = np.abs(img - conftest.golden(name))
    assert diff.mean() < mean_tol, f"mean {diff.mean()}"
    assert (diff > 2).mean() < frac_tol, f"frac>2 {(diff > 2).mean()}"


@pytest.mark.parametrize("name,res", [("cornellbox", 112), ("rock6k", 64)])
def test_frame_matches_jax_render(name, res, tmp_path):
    from raytracer795_tpu import render as jax_render
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.scene import types as T
    from raytracer795_tpu_torch.scene.bridge import scene_from_numpy

    path = (rock6k_xml(tmp_path, res) if name == "rock6k"
            else os.path.join(conftest.SCENES, name + ".xml"))
    jl = jax_load(path)
    jl.cameras[0] = dataclasses.replace(jl.cameras[0], nx=res, ny=res)
    want = conftest.ldr(jax_render.render_camera(jl, 0, seed=0))

    port = T.LoadedScene(
        scene=scene_from_numpy(jax.tree_util.tree_map(np.asarray, jl.scene),
                               "cpu"),
        cameras=[T.Camera(**vars(jl.cameras[0]))], path=path)
    got = render.render_camera(port, 0, ldr=True).astype(np.float32)
    frac = (np.abs(got - want) > 1).mean()
    assert frac < 1e-4, f"{frac:.6f} of LDR values differ by more than 1"


def _png_pixels(data: bytes) -> np.ndarray:
    """Decode an 8-bit RGB, non-interlaced PNG whose rows use filter 0."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = ihdr
    assert (depth, ctype, interlace) == (8, 2, 0)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_cli_writes_png_of_ldr_frame(tmp_path):
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.utils.image_io import to_ldr

    render.main([os.path.join(conftest.SCENES, "simple.xml"),
                 "-o", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "simple.png", "rb") as f:
        pixels = _png_pixels(f.read())
    want = to_ldr(render.render_camera(_load("simple"), 0))
    np.testing.assert_array_equal(pixels, want)


def test_cli_refuses_cuda_without_a_device(monkeypatch, tmp_path):
    from raytracer795_tpu_torch import render

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render.main([os.path.join(conftest.SCENES, "simple.xml"),
                     "-o", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name,item", [
    ("cornellbox_pt", "item 13"),       # path tracer
    ("arealight", "items 10 and 12"),   # multi-sample camera, area light
    ("distributed", "items 10 and 12"),  # multi-sample camera, glossy
])
def test_unported_features_raise(name, item):
    from raytracer795_tpu_torch.render import render_camera

    with pytest.raises(NotImplementedError, match=item):
        render_camera(_load(name), 0)


@pytest.mark.parametrize("nx,n_rows", [(400, 400), (800, 320), (800, 160),
                                       (112, 112), (200, 37)])
def test_lane_order_and_primary_rays_match_jax(nx, n_rows):
    """Tile-swizzled lanes equal the JAX package's; primary rays agree."""
    import jax.numpy as jnp

    from raytracer795_tpu.models import camera as jax_camera

    from raytracer795_tpu_torch.models import camera

    jpx, jpy = jax_camera.band_pixels(nx, n_rows)
    px, py = camera.band_pixels(nx, n_rows, "cpu")
    np.testing.assert_array_equal(px.numpy(), jpx)
    np.testing.assert_array_equal(py.numpy(), jpy)
    flat = np.empty(nx * n_rows, np.int64)
    flat[camera.band_unswizzle_index(px, py, nx).numpy()] = np.arange(
        nx * n_rows)
    np.testing.assert_array_equal(
        flat, np.argsort(jax_camera.band_unswizzle_index(nx, n_rows)))

    cam = dataclasses.replace(_load("cornellbox").cameras[0], nx=nx, ny=400)
    jr = jax_camera.primary_rays_at(cam, jnp.asarray(jpx),
                                    7 + jnp.asarray(jpy))
    tr = camera.primary_rays_at(cam, px, 7 + py)
    for got, want in ((tr.o, jr.o), (tr.d, jr.d)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)


def test_two_camera_scene_matches_jax(tmp_path):
    """render_scene's camera loop: both packages write both images, and
    the port's match the JAX package's (frac(|dLDR| > 1) < 1e-4)."""
    from raytracer795_tpu import render as jax_render
    from raytracer795_tpu.scene.loader import load_scene as jax_load
    from raytracer795_tpu.utils.image_io import read_ppm

    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.scene.loader import load_scene

    src = open(os.path.join(conftest.SCENES, "simple.xml")).read()
    cam = src[src.index("        <Camera id=\"1\">"):
              src.index("    </Cameras>")]
    second = (cam.replace('id="1"', 'id="2"')
              .replace("<Position>0 1.2 4</Position>",
                       "<Position>2.5 1.5 3</Position>")
              .replace("<Gaze>0 -0.12 -1</Gaze>",
                       "<Gaze>-0.6 -0.2 -0.8</Gaze>"))
    src = src.replace("    </Cameras>", second + "    </Cameras>")
    src = src.replace("200 200", "48 40")
    src = src.replace("<ImageName>simple.png</ImageName>",
                      "<ImageName>a.ppm</ImageName>", 1)
    src = src.replace("<ImageName>simple.png</ImageName>",
                      "<ImageName>b.ppm</ImageName>", 1)
    xml = tmp_path / "two.xml"
    xml.write_text(src)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_paths = jax_render.render_scene(jax_load(str(xml)),
                                        str(tmp_path / "jax"))
    paths = render.render_scene(load_scene(str(xml), "cpu"),
                                str(tmp_path / "port"))
    assert [os.path.basename(p) for p in paths] == ["a.ppm", "b.ppm"]
    images = [read_ppm(p) for p in paths]
    assert not np.array_equal(images[0], images[1])
    for got, jp in zip(images, jax_paths):
        assert got.shape == (40, 48, 3)
        assert (np.abs(got - read_ppm(jp)) > 1).mean() < 1e-4

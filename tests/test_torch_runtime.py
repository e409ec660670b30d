"""The port's film checkpoints, tonemapping and EXR output.

- Kill and resume (tests/test_runtime.py:14-66): cornellbox at 16x16, 8 spp
  with ``MAX_LANES = 32`` is 16 one-row bands of 4 two-sample chunks each
  (a chunk splits a band's samples only when ``MAX_LANES < nx * spp``), so
  a kill after 3 saves lands inside band 0 and the resume restores its
  accumulator; at 1 spp, ``MAX_LANES = 64`` gives 4 bands and the kill
  comes after 2. The resumed film equals the uninterrupted one bit for bit.
  A checkpoint of another spp is ignored, a finished one renders nothing,
  and a checkpoint the JAX package's ``render_camera`` wrote (simple.xml,
  1 spp, 4 bands, killed after one save) resumes in the port.
- ``write_exr``'s bytes equal the JAX package's for "none" and "zip", the
  round trip holds at rtol 1e-3 (tests/test_units.py:75-100), and each
  package reads the other's files.
- ``reinhard_global`` equals the JAX package's bit for bit and keeps its
  properties (tests/test_runtime.py:69-86); ``render_scene`` writes a
  ``<Tonemap>`` camera's PNG as ``to_ldr(reinhard_global(film))`` and
  envlight's second camera as an EXR of its float film.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)

RES = 16
SEED = 3


def _load(name="cornellbox"):
    from raytracer795_tpu_torch.scene.loader import load_scene

    ld = load_scene(os.path.join(conftest.SCENES, name + ".xml"), "cpu")
    ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=RES, ny=RES)
    return ld


def _render(ld, path, spp, abort_after=None):
    from raytracer795_tpu_torch import render

    return render.render_camera(
        ld, 0, seed=SEED, spp=spp,
        checkpoint=render.FilmCheckpoint(str(path), every_s=0.0),
        _abort_after_saves=abort_after)


@pytest.mark.parametrize("spp,max_lanes,abort_after,bands", [
    (8, 32, 3, 16),      # per chunk: the kill lands inside band 0
    (1, 64, 2, 4),       # per band
])
def test_kill_resume_bit_equal(spp, max_lanes, abort_after, bands, tmp_path,
                               monkeypatch):
    from raytracer795_tpu_torch import render

    monkeypatch.setattr(render, "MAX_LANES", max_lanes)
    ld = _load()
    assert RES // render.band_rows(render.with_spp(ld.cameras[0], spp)) \
        == bands
    reference = render.render_camera(ld, 0, seed=SEED, spp=spp)
    path = tmp_path / "film.ckpt.npz"
    with pytest.raises(KeyboardInterrupt):
        _render(ld, path, spp, abort_after)
    assert path.exists()
    assert (tmp_path / "film.ckpt.npz.preview.png").exists()
    saved = np.load(path)
    if spp > 1:         # inside band 0: 3 of its 4 chunks done
        assert int(saved["row0"]) == 0
        assert saved["sample_count"][0].max() == 6
    else:
        assert int(saved["row0"]) == 2 * RES // bands
    resumed = _render(ld, path, spp)
    assert resumed.dtype == np.float32
    np.testing.assert_array_equal(resumed, reference)


def test_mismatched_checkpoint_ignored(tmp_path, monkeypatch):
    from raytracer795_tpu_torch import render

    monkeypatch.setattr(render, "MAX_LANES", 32)
    ld = _load()
    path = tmp_path / "film.ckpt.npz"
    with pytest.raises(KeyboardInterrupt):
        _render(ld, path, 8, abort_after=1)
    img4 = _render(ld, path, 4)
    np.testing.assert_array_equal(
        img4, render.render_camera(ld, 0, seed=SEED, spp=4))


def test_finished_checkpoint_renders_nothing(tmp_path, monkeypatch):
    """A checkpoint at row0 == ny returns its film and traces no band."""
    from raytracer795_tpu_torch import render

    ld = _load()
    path = tmp_path / "film.ckpt.npz"
    first = _render(ld, path, 2)
    assert int(np.load(path)["row0"]) == RES
    calls = []
    monkeypatch.setattr(render, "render_sample_range",
                        lambda *a, **k: calls.append(a))
    np.testing.assert_array_equal(_render(ld, path, 2), first)
    assert not calls


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX package's 1-spp banded render of simple.xml at 16x16 (4
    bands; the cheapest scene to compile), killed after its first save:
    the checkpoint's path."""
    from raytracer795_tpu import render as jax_render

    path = tmp_path_factory.mktemp("jax_ckpt") / "film.ckpt.npz"
    loaded = conftest.load("simple")
    loaded.cameras[0] = dataclasses.replace(loaded.cameras[0], nx=RES, ny=RES)
    old = jax_render.MAX_LANES
    jax_render.MAX_LANES = 64
    try:
        with pytest.raises(KeyboardInterrupt):
            jax_render.render_camera(
                loaded, 0, seed=SEED, spp=1,
                checkpoint=jax_render.FilmCheckpoint(str(path), every_s=0.0),
                _abort_after_saves=1)
    finally:
        jax_render.MAX_LANES = old
    return path


def test_jax_checkpoint_resumes_in_port(jax_checkpoint, tmp_path,
                                        monkeypatch):
    from raytracer795_tpu_torch import render

    monkeypatch.setattr(render, "MAX_LANES", 64)
    path = tmp_path / "film.ckpt.npz"
    shutil.copy(jax_checkpoint, path)
    saved = np.load(path)
    row0 = int(saved["row0"])
    assert row0 == 4
    ld = _load("simple")
    resumed = _render(ld, path, 1)
    np.testing.assert_array_equal(resumed[:row0], saved["film_sum"][:row0])
    own = render.render_camera(ld, 0, seed=SEED, spp=1)
    np.testing.assert_array_equal(resumed[row0:], own[row0:])


def _hdr(seed=0, shape=(37, 23, 3)):
    return np.random.default_rng(seed).lognormal(0.0, 2.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("compression", ["none", "zip"])
def test_write_exr_bytes_equal_jax(compression, tmp_path):
    from raytracer795_tpu.utils import exr as jax_exr

    from raytracer795_tpu_torch.utils import exr

    img = _hdr()
    img[0, 0] = 0.0
    jax_exr.write_exr(str(tmp_path / "jax.exr"), img, compression)
    exr.write_exr(str(tmp_path / "port.exr"), img, compression)
    assert (tmp_path / "port.exr").read_bytes() == \
        (tmp_path / "jax.exr").read_bytes()


@pytest.mark.parametrize("compression", ["none", "zip"])
def test_exr_round_trip(compression, tmp_path):
    from raytracer795_tpu_torch.utils import exr

    img = (np.random.default_rng(3).random((37, 23, 3)) * 50).astype(
        np.float32)
    path = str(tmp_path / "t.exr")
    exr.write_exr(path, img, compression)
    assert np.allclose(exr.read_exr(path), img.astype(np.float16), rtol=1e-3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exr_read_by_the_other_package(writer, tmp_path):
    from raytracer795_tpu.utils import exr as jax_exr

    from raytracer795_tpu_torch.utils import exr

    write, read = ((jax_exr.write_exr, exr.read_exr) if writer == "jax"
                   else (exr.write_exr, jax_exr.read_exr))
    img = _hdr(1, (20, 9, 3))
    for compression in ("none", "zip"):
        path = str(tmp_path / f"{compression}.exr")
        write(path, img, compression)
        np.testing.assert_array_equal(
            read(path), img.astype(np.float16).astype(np.float32))


def _ramp():
    ramp = np.linspace(0.01, 100.0, 64, dtype=np.float32)
    return np.repeat(ramp, 3).reshape(1, 64, 3)


@pytest.mark.parametrize("name,kw", [
    ("lognormal", {}), ("ramp", {}), ("lognormal", {"burn_percent": 0.0}),
    ("lognormal", {"key": 0.5, "saturation": 0.7, "gamma": 1.8}),
])
def test_reinhard_equals_jax(name, kw):
    from raytracer795_tpu.utils.tonemap import reinhard_global as jax_tmo

    from raytracer795_tpu_torch.utils.tonemap import reinhard_global

    img = _hdr(0, (32, 32, 3)) if name == "lognormal" else _ramp()
    got, want = reinhard_global(img, **kw), jax_tmo(img, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_reinhard_properties():
    from raytracer795_tpu_torch.utils.tonemap import reinhard_global

    hdr = np.random.default_rng(0).lognormal(2.0, 2.0, (32, 32, 3)).astype(
        np.float32)
    out = reinhard_global(hdr)
    assert out.shape == hdr.shape
    assert out.min() >= 0.0 and out.max() <= 255.0
    assert out.max() > 250.0                    # burnout reaches white
    assert (np.diff(reinhard_global(_ramp())[0, :, 0]) >= -1e-4).all()
    hdr[0, 0] = 0.0
    assert (reinhard_global(hdr)[0, 0] == 0).all()     # black stays black
    assert (reinhard_global(np.zeros((4, 4, 3), np.float32)) == 0).all()


def _envlight_variant(tmp_path, tonemap):
    shutil.copy(os.path.join(conftest.SCENES, "sky.exr"), tmp_path / "sky.exr")
    src = open(os.path.join(conftest.SCENES, "envlight.xml")).read()
    if tonemap:
        src = src.replace(
            "</ImageName>",
            "</ImageName><Tonemap><TMO>Photographic</TMO>"
            "<TMOOptions>0.18 1</TMOOptions><Saturation>1.0</Saturation>"
            "<Gamma>2.2</Gamma></Tonemap>", 1)
    path = tmp_path / "envlight_variant.xml"
    path.write_text(src)
    return str(path)


def test_render_scene_tonemaps_png(tmp_path):
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.scene.loader import load_scene
    from raytracer795_tpu_torch.utils.image_io import read_png, to_ldr
    from raytracer795_tpu_torch.utils.tonemap import reinhard_global

    ld = load_scene(_envlight_variant(tmp_path, True), "cpu")
    assert ld.cameras[0].tonemap == (0.18, 1.0, 1.0, 2.2)
    ld.cameras = ld.cameras[:1]
    (path,) = render.render_scene(ld, str(tmp_path), spp=1)
    film = render.render_camera(ld, 0, spp=1)
    assert film.max() > 255.0                 # raw radiance blows past 255
    want = to_ldr(reinhard_global(film, 0.18, 1.0, 1.0, 2.2))
    got = read_png(path)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert got.std() > 1.0


def test_cli_writes_envlight_png_and_exr(tmp_path):
    """``python -m raytracer795_tpu_torch.render envlight.xml`` writes both
    cameras; the EXR is the second camera's float film as half floats."""
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.scene.loader import load_scene
    from raytracer795_tpu_torch.utils.exr import read_exr

    xml = os.path.join(conftest.SCENES, "envlight.xml")
    render.main([xml, "-o", str(tmp_path), "--device", "cpu", "--spp", "1"])
    assert sorted(os.listdir(tmp_path)) == ["envlight.png",
                                            "envlight_hdr.exr"]
    film = render.render_camera(load_scene(xml, "cpu"), 1, spp=1)
    got = read_exr(str(tmp_path / "envlight_hdr.exr"))
    assert got.shape == film.shape == (96, 96, 3)
    np.testing.assert_array_equal(got.astype(np.float16),
                                  film.astype(np.float16))

"""Net-ray counting of the port's path tracer against the JAX package.

- cornellbox_pt at 16x16 and 2 spp with ``MAX_LANES`` 16 in both
  packages (16 one-row bands of two one-sample chunks, each keyed as the
  frame keys it): ``render.count_net_rays`` equals JAX's as an integer;
- the port ends its bounce loop once no lane is live, where the JAX package
  runs all ``max_depth`` bounces: on cornellbox_pt cut to its floor and
  its mesh light every lane dies before bounce 6, and the count is still
  JAX's;
- ``with_stats=True`` leaves the radiance bit for bit.
"""

import dataclasses
import os
import xml.etree.ElementTree as ET

import torch

import conftest

torch.set_num_threads(1)


def loaders(path, res):
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.scene.loader import load_scene

    jl, pl = jax_load(path), load_scene(path, "cpu")
    for ld in (jl, pl):
        ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=res, ny=res)
    return jl, pl


def floor_and_light_xml(tmp_path) -> str:
    """cornellbox_pt with only its floor and its mesh light: a floor
    bounce escapes or hits the black light, so lanes die within 3."""
    tree = ET.parse(os.path.join(conftest.SCENES, "cornellbox_pt.xml"))
    objects = tree.getroot().find("Objects")
    for obj in list(objects):
        if not (obj.tag == "LightMesh"
                or (obj.tag == "Mesh" and obj.get("id") == "1")):
            objects.remove(obj)
    path = os.path.join(str(tmp_path), "floor_pt.xml")
    tree.write(path)
    return path


def test_net_rays_equal_jax_in_bands_and_chunks(monkeypatch):
    from raytracer795_tpu import render as jax_render

    from raytracer795_tpu_torch import render

    monkeypatch.setattr(jax_render, "MAX_LANES", 16)
    monkeypatch.setattr(render, "MAX_LANES", 16)
    jl, pl = loaders(os.path.join(conftest.SCENES, "cornellbox_pt.xml"), 16)
    cam = render.with_spp(pl.cameras[0], 2)
    assert render.band_rows(cam) == 1
    assert render.MAX_LANES // cam.nx == 1       # one sample a chunk
    want = jax_render.count_net_rays(jl, 0, seed=1, spp=2)
    got = render.count_net_rays(pl, 0, seed=1, spp=2)
    assert isinstance(got, int) and got == int(want)
    assert 16 * 16 * 2 <= got <= render.gross_rays(pl.scene, cam)


def test_early_break_counts_what_jax_counts(tmp_path, monkeypatch):
    from raytracer795_tpu import render as jax_render

    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.models import path_tracer

    jl, pl = loaders(floor_and_light_xml(tmp_path), 16)
    assert pl.scene.max_depth == 6 and not pl.scene.pt_rr
    bounces = []
    bounce = path_tracer._bounce

    def counted(*args):
        bounces.append(args[-1])
        return bounce(*args)
    monkeypatch.setattr(path_tracer, "_bounce", counted)
    want = jax_render.count_net_rays(jl, 0, seed=2, spp=2)
    got = render.count_net_rays(pl, 0, seed=2, spp=2)
    assert got == int(want)
    assert 0 < max(bounces) < pl.scene.max_depth - 1, bounces


@torch.no_grad()
def test_stats_leave_the_radiance_alone():
    """cornellbox_pt's sample rays at 16x16 and 2 spp with and without
    stats: the same bits; the count is a 0-d int64 tensor."""
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.models import camera, path_tracer
    from raytracer795_tpu_torch.utils import rng
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    _, pl = loaders(os.path.join(conftest.SCENES, "cornellbox_pt.xml"), 16)
    cam = render.with_spp(pl.cameras[0], 2)
    key = rng.PRNGKey(5)
    rays = camera.sample_rays(cam, key, device="cpu")
    bg = Vec3.zeros((rays.time.shape[0],), "cpu")
    plain = path_tracer.render_rays(pl.scene, rays, bg, key)
    radiance, net = path_tracer.render_rays(pl.scene, rays, bg, key,
                                            with_stats=True)
    assert torch.equal(plain.view(torch.int32), radiance.view(torch.int32))
    assert net.dtype == torch.int64 and net.dim() == 0
    assert rays.time.shape[0] <= int(net)

"""Net-ray counting and the smaller names of the port against the JAX
package, Whitted scenes.

- ``render.count_net_rays`` equals the JAX package's as an integer on
  cornellbox (mirror, dielectric split and conductor: the deferred-ray
  stack is counted), envlight (the environment light counts as a shadow
  light) and ply_smooth through the BVH walk (``bvh_min_tris=1``), with
  ``MAX_LANES`` small in both packages so frames run in several bands,
  and in several sample chunks where they have samples;
- ``with_stats=True`` leaves the radiance bit for bit;
- ``log_render_stats(..., net_rays=)`` adds the JAX line's ``rays_net``
  and ``rays_net_per_s``;
- ``camera.primary_rays``, ``sample_rays`` and ``sample_rays_range``
  within 2 ulp of the JAX rays (``tests/test_torch_sampling.py``'s bound
  for rays), ``brdf.brdf_radiance`` at rtol 1e-6, atol 1e-6 (its bound
  for the rough-mirror jitter; powers differ by up to 3 ulp), and
  ``shard.pad_to_multiple`` equal.

The path tracer's counts are in ``tests/test_torch_stats_pt.py``.
"""

import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)

RAY_ULPS = 2


def ulps(a, b) -> np.ndarray:
    """|a - b| in float32 units in the last place (sign-aware)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def loaders(name, res, **kw):
    """(JAX LoadedScene, port LoadedScene) of a scene at res x res."""
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.scene.loader import load_scene

    path = os.path.join(conftest.SCENES, name + ".xml")
    jl, pl = jax_load(path, **kw), load_scene(path, "cpu", **kw)
    for ld in (jl, pl):
        ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=res, ny=res)
    return jl, pl


def small_lanes(monkeypatch, lanes):
    from raytracer795_tpu import render as jax_render

    from raytracer795_tpu_torch import render

    monkeypatch.setattr(jax_render, "MAX_LANES", lanes)
    monkeypatch.setattr(render, "MAX_LANES", lanes)


@pytest.mark.parametrize("name,res,lanes,kw", [
    ("cornellbox", 24, 192, {}),            # 3 bands of 8 rows
    ("envlight", 16, 128, {}),              # 16 spp: 16 bands of 2 chunks
    ("ply_smooth", 24, 192, {"bvh_min_tris": 1})])
def test_net_rays_equal_jax(name, res, lanes, kw, monkeypatch):
    from raytracer795_tpu import render as jax_render

    from raytracer795_tpu_torch import render

    small_lanes(monkeypatch, lanes)
    jl, pl = loaders(name, res, **kw)
    cam = pl.cameras[0]
    bands = -(-cam.ny // render.band_rows(cam))
    chunk = lanes // (cam.nx * render.band_rows(cam))
    assert bands > 1
    assert cam.num_samples <= 1 or chunk < cam.num_samples
    if kw:
        assert all(g.bvh is not None for g in pl.scene.groups if g.n_tris)
    want = jax_render.count_net_rays(jl, 0, seed=1)
    got = render.count_net_rays(pl, 0, seed=1)
    assert isinstance(got, int) and got == int(want)
    lanes_traced = cam.nx * cam.ny * max(1, cam.num_samples)
    assert lanes_traced <= got <= render.gross_rays(pl.scene, cam)


def test_stats_leave_the_radiance_alone():
    """cornellbox's lane machine with and without stats: the same bits,
    and the count is a 0-d int64 tensor on the rays' device."""
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.models import camera, whitted
    from raytracer795_tpu_torch.utils import rng

    _, pl = loaders("cornellbox", 24)
    cam = pl.cameras[0]
    px, py = camera.band_pixels(cam.nx, cam.ny, "cpu")
    rays = camera.primary_rays_at(cam, px, py)
    bg = render._background_radiance(pl.scene, cam, rays, px, py)
    plain = whitted.render_rays(pl.scene, rays, bg, rng.PRNGKey(0))
    radiance, net = whitted.render_rays(pl.scene, rays, bg, rng.PRNGKey(0),
                                        with_stats=True)
    assert torch.equal(plain.view(torch.int32), radiance.view(torch.int32))
    assert net.dtype == torch.int64 and net.dim() == 0 and int(net) > 0


def test_log_line_has_jax_net_keys():
    from raytracer795_tpu import render as jax_render

    from raytracer795_tpu_torch import render

    jl, pl = loaders("cornellbox", 24)
    want = jax_render.log_render_stats(jl.scene, jl.cameras[0], 0.25,
                                       stream=io.StringIO(), net_rays=1111)
    out = io.StringIO()
    got = render.log_render_stats(pl.scene, pl.cameras[0], 0.25, stream=out,
                                  net_rays=1111)
    for k in ("rays_net", "rays_net_per_s", "rays_per_s"):
        assert got[k] == want[k], k
    assert json.loads(out.getvalue()) == got
    assert "rays_net" not in render.log_render_stats(
        pl.scene, pl.cameras[0], 0.25, stream=io.StringIO())


def assert_rays_close(got, want):
    for g, w in ((got.o, want.o), (got.d, want.d),
                 ((got.time,), (want.time,))):
        for gc, wc in zip(g, w):
            assert gc.shape == tuple(wc.shape)
            u = ulps(gc.numpy(), np.asarray(wc))
            assert u.max() <= RAY_ULPS, f"{u.max()} ulp"


@pytest.mark.parametrize("row0,n_rows", [(0, None), (5, 3)])
def test_primary_rays_match_jax(row0, n_rows):
    from raytracer795_tpu.models import camera as jax_camera

    from raytracer795_tpu_torch.models import camera

    _, pl = loaders("cornellbox", 12)
    cam = pl.cameras[0]
    want = jax_camera.primary_rays(cam, row0, n_rows)
    got = camera.primary_rays(cam, row0, n_rows, device="cpu")
    assert got.time.shape[0] == cam.nx * (n_rows or cam.ny)
    assert_rays_close(got, want)


@pytest.mark.parametrize("name", ["motionblur", "distributed"])
def test_sample_rays_match_jax(name):
    """Whole frames and a band of a chunk, plain and depth-of-field."""
    from raytracer795_tpu.models import camera as jax_camera

    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.models import camera
    from raytracer795_tpu_torch.utils import rng

    _, pl = loaders(name, 10)
    cam = render.with_spp(pl.cameras[0], 4)
    assert cam.is_dof == (name == "distributed")
    key = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    tkey = rng.fold_in(rng.PRNGKey(3), 2)
    assert_rays_close(camera.sample_rays(cam, tkey, device="cpu"),
                      jax_camera.sample_rays(cam, key))
    assert_rays_close(
        camera.sample_rays_range(cam, tkey, 1, 3, 4, 5, device="cpu"),
        jax_camera.sample_rays_range(cam, key, 1, 3, 4, 5))


def test_brdf_radiance_matches_jax():
    """brdfs.xml's materials (the eight BRDFs) on seeded directions."""
    from raytracer795_tpu.models import brdf as jax_brdf
    from raytracer795_tpu.utils.vec3 import Vec3 as JVec3

    from raytracer795_tpu_torch.models import brdf
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    jl, pl = loaders("brdfs", 8)
    r = np.random.default_rng(4)
    n = 4000

    def unit(v):
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)
    normal = unit(r.normal(size=(n, 3)))
    wi = unit(r.normal(size=(n, 3)) + normal)      # mostly above
    wo = unit(r.normal(size=(n, 3)) + normal)
    rad = r.uniform(0, 4, (n, 3)).astype(np.float32)
    mat = r.integers(0, pl.scene.materials.diffuse.shape[0], n).astype(
        np.int32)

    def jv(a):
        return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))

    def tv(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      for k in range(3)))
    want = jax_brdf.brdf_radiance(jv(wi), jv(wo), jv(normal), jv(rad),
                                  jax.tree_util.tree_map(
                                      jnp.asarray, jl.scene.materials),
                                  jnp.asarray(mat))
    got = brdf.brdf_radiance(tv(wi), tv(wo), tv(normal), tv(rad),
                             pl.scene.materials, torch.from_numpy(mat))
    assert len(set(pl.scene.materials.brdf.tolist())) >= 8
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert (w > 0).mean() > 0.5
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,m", [(0, 4), (1, 4), (4, 4), (5, 4), (7, 1),
                                 (1000, 6)])
def test_pad_to_multiple_matches_jax(n, m):
    from raytracer795_tpu.parallel import shard as jax_shard

    from raytracer795_tpu_torch.parallel import shard

    assert shard.pad_to_multiple(n, m) == jax_shard.pad_to_multiple(n, m)

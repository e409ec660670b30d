"""Multi-sample rendering in the port against the JAX package.

- ``sample_rays_at``: jittered rays, depth of field and motion-blur time for
  a range of (base, count) sample chunks, within 2 ulp of the JAX rays;
- area lights and glossy mirrors on seeded shade points and rays;
- whole multi-sample frames per pixel (arealight, motionblur, distributed)
  and one frame cut into one-row bands of several sample chunks, which
  exercises the ``fold_in(done)`` and ``fold_in(row0)`` keys.

Both packages draw from the same seed; the port renders on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest

torch.set_num_threads(1)

# a frame matches when this share of its float values agree within
# rtol=1e-4, atol=1e-3, and its LDR values by a mean |d| under 0.05
FRAME_CLOSE = 0.99
LDR_MEAN_TOL = 0.05


def _loaders(name, res=None):
    """(JAX LoadedScene, port LoadedScene) of a scene, at res x res."""
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.scene.loader import load_scene

    path = os.path.join(conftest.SCENES, name + ".xml")
    jl, pl = jax_load(path), load_scene(path, "cpu")
    if res is not None:
        for ld in (jl, pl):
            ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=res,
                                                ny=res)
    return jl, pl


def ulps(a, b) -> np.ndarray:
    """|a - b| in float32 units in the last place (sign-aware)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("name,base,count", [
    ("motionblur", 0, 4), ("motionblur", 3, 5), ("distributed", 0, 4),
    ("distributed", 8, 3), ("arealight", 17, 1)])
def test_sample_rays_match_jax(name, base, count):
    """Plain (motion-blur time) and depth-of-field cameras, 2 ulp."""
    from raytracer795_tpu.models import camera as jax_camera

    from raytracer795_tpu_torch.models import camera
    from raytracer795_tpu_torch.render import with_spp
    from raytracer795_tpu_torch.utils import rng

    _, pl = _loaders(name)
    cam = with_spp(pl.cameras[0], 16)
    assert cam.is_dof == (name == "distributed")
    seeded = np.random.default_rng(base)
    px = seeded.integers(0, cam.nx, 300).astype(np.int32)
    py = seeded.integers(0, cam.ny, 300).astype(np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(2), base)
    want = jax_camera.sample_rays_at(cam, key, jnp.asarray(px),
                                     jnp.asarray(py), base, count)
    got = camera.sample_rays_at(cam, rng.fold_in(rng.PRNGKey(2), base),
                                torch.from_numpy(px), torch.from_numpy(py),
                                base, count)
    differing = 0
    for g, w in ((got.o, want.o), (got.d, want.d), ((got.time,),
                                                    (want.time,))):
        for gc, wc in zip(g, w):
            u = ulps(gc.numpy(), np.asarray(wc))
            assert u.max() <= 2, f"{u.max()} ulp"
            differing += int((u > 0).sum())
    # the lanes that differ at all are few (recorded, not a bound)
    print(f"{differing} of {7 * 300 * count} components differ")


def _shade_points(n, n_mats, seed):
    """Seeded shade points on and above the y = 0 plane, as numpy."""
    r = np.random.default_rng(seed)
    point = np.stack([r.uniform(-3, 3, n), r.uniform(-0.5, 0.5, n),
                      r.uniform(-6, 0, n)], 1).astype(np.float32)
    normal = r.normal(size=(n, 3))
    normal[:, 1] = np.abs(normal[:, 1]) + 0.3
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True))
    wo = r.normal(size=(n, 3))
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True))
    return dict(point=point, normal=normal.astype(np.float32),
                wo=wo.astype(np.float32),
                mat=r.integers(0, n_mats, n).astype(np.int32),
                valid=r.random(n) < 0.9)


def test_area_light_matches_jax():
    """direct_lighting with arealight.xml's area light, seeded shade
    points, same key: equal within rtol 1e-5, atol 1e-4."""
    from raytracer795_tpu.models import lights as jax_lights
    from raytracer795_tpu.utils.vec3 import Vec3 as JVec3

    from raytracer795_tpu_torch.models import lights
    from raytracer795_tpu_torch.scene import types as T
    from raytracer795_tpu_torch.utils import rng
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    jl, pl = _loaders("arealight")
    assert pl.scene.lights.area_pos.shape[0] == 1
    n = 2000
    sp = _shade_points(n, pl.scene.materials.diffuse.shape[0], 0)

    def jv(a):
        return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))

    def tv(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      for k in range(3)))
    zeros = np.zeros((n, 3), np.float32)
    want = jax_lights.direct_lighting(jl.scene, jax_lights.ShadePoint(
        point=jv(sp["point"]), normal=jv(sp["normal"]), wo=jv(sp["wo"]),
        mat=jnp.asarray(sp["mat"]),
        dm=jnp.full((n,), T.DECAL_NONE, jnp.int32), tex_color=jv(zeros),
        tex_norm=jnp.ones((n,)), time=jnp.zeros((n,)),
        valid=jnp.asarray(sp["valid"])), jax.random.PRNGKey(9))
    got = lights.direct_lighting(pl.scene, lights.ShadePoint(
        point=tv(sp["point"]), normal=tv(sp["normal"]), wo=tv(sp["wo"]),
        mat=torch.from_numpy(sp["mat"]),
        dm=torch.full((n,), T.DECAL_NONE, dtype=torch.int32),
        tex_color=tv(zeros), tex_norm=torch.ones((n,)),
        time=torch.zeros((n,)), valid=torch.from_numpy(sp["valid"])),
        rng.PRNGKey(9))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_glossy_perturb_and_rough_mirror_rays_match_jax():
    """The rough-mirror jitter on seeded inputs (rtol 1e-6, atol 1e-6),
    then distributed.xml's lane machine, whose floor is a rough mirror,
    on seeded rays with one key: 99% of values within rtol 1e-4, atol
    1e-3."""
    from raytracer795_tpu.models import camera as jax_camera
    from raytracer795_tpu.models import whitted as jax_whitted
    from raytracer795_tpu.utils.vec3 import Vec3 as JVec3

    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.ops.intersect import Rays
    from raytracer795_tpu_torch.utils import rng
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    r = np.random.default_rng(1)
    wr = r.normal(size=(3, 500)).astype(np.float32)
    wr /= np.linalg.norm(wr, axis=0)
    rough = r.uniform(0, 0.3, 500).astype(np.float32)
    is_rough = r.random(500) < 0.7
    chi = (r.random((2, 500)) - 0.5).astype(np.float32)
    want = jax_whitted._glossy_perturb(
        JVec3(*map(jnp.asarray, wr)), jnp.asarray(rough),
        jnp.asarray(is_rough), jnp.asarray(chi[0]), jnp.asarray(chi[1]))
    got = whitted._glossy_perturb(
        Vec3(*map(torch.from_numpy, wr)), torch.from_numpy(rough),
        torch.from_numpy(is_rough), torch.from_numpy(chi[0]),
        torch.from_numpy(chi[1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)

    jl, pl = _loaders("distributed")
    assert pl.scene.any_rough
    cam = pl.cameras[0]
    px = r.integers(0, cam.nx, 256).astype(np.int32)
    py = r.integers(cam.ny // 2, cam.ny, 256).astype(np.int32)   # floor
    jr = jax_camera.sample_rays_at(cam, jax.random.PRNGKey(4),
                                   jnp.asarray(px), jnp.asarray(py), 0, 2)
    n = jr.time.shape[0]
    bg = np.asarray(jl.scene.background)
    want = np.asarray(jax_whitted.render_rays(
        jl.scene, jr, JVec3(*(jnp.full((n,), c) for c in bg)),
        jax.random.PRNGKey(6), differentiable=False))
    tr = Rays(o=Vec3(*(torch.from_numpy(np.array(c)) for c in jr.o)),
              d=Vec3(*(torch.from_numpy(np.array(c)) for c in jr.d)),
              time=torch.from_numpy(np.array(jr.time)))
    got = whitted.render_rays(
        pl.scene, tr, Vec3(*(torch.full((n,), float(c)) for c in bg)),
        rng.PRNGKey(6)).numpy()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-3).mean()
    assert close >= FRAME_CLOSE, close


def _frames_agree(got, want):
    from raytracer795_tpu.utils.image_io import to_ldr

    close = np.isclose(got, want, rtol=1e-4, atol=1e-3).mean()
    assert close >= FRAME_CLOSE, f"{close:.5f} of values agree"
    d = np.abs(to_ldr(got).astype(np.float32)
               - to_ldr(np.asarray(want)).astype(np.float32))
    assert d.mean() < LDR_MEAN_TOL, f"LDR mean |d| {d.mean()}"


@pytest.mark.parametrize("name", ["arealight", "motionblur", "distributed"])
def test_multisample_frame_matches_jax(name):
    """32x32 at 4 spp, seed 0, one band of one chunk."""
    from raytracer795_tpu import render as jax_render

    from raytracer795_tpu_torch import render

    jl, pl = _loaders(name, 32)
    want = jax_render.render_camera(jl, 0, seed=0, spp=4)
    got = render.render_camera(pl, 0, seed=0, spp=4)
    _frames_agree(got, want)
    # LDR on the device is to_ldr of the float frame, bit for bit
    ldr = render.render_camera(pl, 0, seed=0, spp=4, ldr=True)
    from raytracer795_tpu_torch.utils.image_io import to_ldr
    np.testing.assert_array_equal(ldr, to_ldr(got))


def test_banded_multichunk_frame_matches_jax(monkeypatch):
    """MAX_LANES = 64 in both packages: 24x24 at 5 spp renders as 24
    one-row bands of chunks of 2, 2 and 1 samples, each keyed
    fold_in(fold_in(key, done), row0)."""
    from raytracer795_tpu import render as jax_render

    from raytracer795_tpu_torch import render

    monkeypatch.setattr(jax_render, "MAX_LANES", 64)
    monkeypatch.setattr(render, "MAX_LANES", 64)
    jl, pl = _loaders("arealight", 24)
    cam = render.with_spp(pl.cameras[0], 5)
    assert render.band_rows(cam) == 1
    want = jax_render.render_camera(jl, 0, seed=3, spp=5)
    got = render.render_camera(pl, 0, seed=3, spp=5)
    _frames_agree(got, want)
    # the chunked, banded frame is not the one-launch frame
    monkeypatch.setattr(render, "MAX_LANES", 1 << 18)
    assert not np.array_equal(got, render.render_camera(pl, 0, seed=3,
                                                        spp=5))

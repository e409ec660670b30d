"""Multi-pack groups and batched instances: the port against the JAX package.

A group of more than ``single_pack_max`` triangles is cut into Morton packs
with one BVH each; its traversal walks every pack. Held against the JAX
package on the same numpy inputs:

- the loaders give the same leaves, ``pack_bvhs`` and ``pack_share`` ids
  (the JAX loader's split set by ``RT795_SINGLE_PACK_MAX`` and
  ``pallas_bvh.PACK_TRIS``/``PACK_LEAF``, as tests/test_pallas.py:18-29
  sets them; the port's by loader arguments);
- the port's plain multi-pack walks give the JAX per-pack fallback's
  answers (ops/intersect.py:618-628, :756-760): masks, ids and any-hit
  answers equal, t within rtol = atol = 2e-5, as tests/test_torch_traverse.py
  holds the single-pack walks;
- tracing the groups of a cluster in one query gives each group what its
  own query gives, bit for bit (tests/test_pallas.py:305);
- a frame of the multi-packed rock6k matches the JAX render;
- scene/assets.py writes make_assets.py's bytes.

The multi-pack kernels themselves run only on a CUDA device: their test is
in tests/test_torch_traverse.py, under the ``cuda`` marker.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

import conftest
from test_torch_scene import assert_same, rock6k_xml

torch.set_num_threads(1)

EPS = 1e-3
# rock6k (6,242 triangles) in 4 packs of up to 2,048; 36-triangle leaves
# keep the JAX fallback's statically unrolled leaf loop small on the CPU
SPLIT = dict(single_pack_max=2000, pack_tris=2048, pack_leaf=36)
# the frame test's split: 2 packs of 16-triangle leaves, so that the JAX
# render's compile (one unrolled walk a pack and query) stays ~10 s here
FRAME_SPLIT = dict(single_pack_max=2000, pack_tris=4096, pack_leaf=16)


def _jax_split(monkeypatch, split):
    from raytracer795_tpu.ops import pallas_bvh

    monkeypatch.setenv("RT795_SINGLE_PACK_MAX", str(split["single_pack_max"]))
    monkeypatch.setattr(pallas_bvh, "PACK_TRIS", split["pack_tris"])
    monkeypatch.setattr(pallas_bvh, "PACK_LEAF", split["pack_leaf"])


def _bridged(jax_scene):
    from raytracer795_tpu_torch.scene.bridge import scene_from_numpy

    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, jax_scene),
                            "cpu")


def _path(name, tmp_path, res=64):
    if name == "rock6k":
        return rock6k_xml(tmp_path, res)
    return os.path.join(conftest.SCENES, name + ".xml")


@pytest.mark.parametrize("name,split", [
    ("rock6k", True), ("instances_rock", False), ("instances_rock", True)])
def test_loader_packs_match_jax_loader(name, split, monkeypatch, tmp_path):
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch.scene.loader import load_scene

    path = _path(name, tmp_path)
    if split:
        _jax_split(monkeypatch, SPLIT)
    port = load_scene(path, "cpu", **(SPLIT if split else {}))
    assert_same(port.scene, _bridged(jax_load(path).scene))
    packed = [g for g in port.scene.groups if g.pack_bvhs is not None]
    if split:
        assert packed and all(g.bvh is None and len(g.pack_bvhs) == 4
                              for g in packed)
    else:
        assert not packed
    if name == "instances_rock":
        shared = [g for g in port.scene.groups if g.pack_share == 0]
        assert len(shared) == 37
        assert all(g.bvh is shared[0].bvh and
                   g.pack_bvhs is shared[0].pack_bvhs for g in shared)


def _random_mesh_rays(t, n, seed):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(t * 3, 3)).astype(np.float32)
    tri_vidx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    rng = np.random.default_rng(seed + 10)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 16, 1] = 0.0
    o[n // 16: n // 8] = np.nan
    d[n // 8: 3 * n // 16] = 0.0
    cap = np.random.default_rng(seed + 20).uniform(0.1, 5.0, n).astype(
        np.float32)
    return verts, tri_vidx, o, d, cap


def _jax_pack_walks(o, d, verts, tv, cap, flat):
    """The JAX package's jnp walks of one pack (``flat``) over the group's
    whole triangle table: (key, t, idx, found)."""
    import jax.numpy as jnp

    from raytracer795_tpu.ops import intersect
    from raytracer795_tpu.utils.vec3 import Vec3

    class _Scene:
        vertices = verts
        int_eps = jnp.float32(EPS)

    class _Group:
        bvh = None
        n_tris = tv.shape[0]
        tri_vidx = tv

    rays = intersect.Rays(o=Vec3.from_array(o), d=Vec3.from_array(d),
                          time=jnp.zeros(o.shape[0]))
    key, t, idx = intersect._tri_bvh_candidates(_Scene, _Group, rays,
                                                flat=flat)
    found = intersect._tri_bvh_anyhit(_Scene, _Group, rays, cap, flat=flat)
    return key, t, idx, found


# one compile per pack shape, shared by the tests of this module
_jax_pack_walks_jit = jax.jit(_jax_pack_walks)


def _jax_per_pack(pack_bvhs, verts, tv, o, d, cap):
    """The JAX package's per-pack fallback over the same packs and rays
    (its ops/intersect.py:618-628 and :756-760)."""
    key = None
    found = np.zeros(o.shape[0], bool)
    for fb in pack_bvhs:
        k2, t2, i2, f2 = map(np.asarray, _jax_pack_walks_jit(
            o, d, verts, tv, cap, fb))
        if key is None:
            key, t, idx = k2, t2, i2
        else:
            upd = k2 < key
            t = np.where(upd, t2, t)
            idx = np.where(upd, i2, idx)
            key = np.minimum(key, k2)
        found |= f2
    return key, t, idx, found


@pytest.mark.parametrize("moved", [False, True])
def test_plain_multi_walks_match_jax_per_pack(moved, monkeypatch):
    """600 triangles in packs of 128 (tests/test_pallas.py:129-206); with
    ``moved``, every vertex moves after the build (:209): both walk the
    stale boxes and test the live triangles."""
    from raytracer795_tpu.ops import bvh as jax_bvh
    from raytracer795_tpu.ops import pallas_bvh

    from raytracer795_tpu_torch.ops import bvh, bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    monkeypatch.setattr(pallas_bvh, "PACK_LEAF", 36)
    verts, tri_vidx, o, d, cap = _random_mesh_rays(600, 1024, 2)
    _, jperm, jpacks = pallas_bvh.build_multipack(
        verts, tri_vidx, jax_bvh.build, pack_tris=128)
    perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=128,
                                      pack_leaf=36)
    np.testing.assert_array_equal(perm, jperm)
    assert len(packs) == len(jpacks) >= 4
    for f, jf in zip(packs, jpacks):
        assert f.max_leaf == jf.max_leaf
        for k in ("bmin", "bmax", "first", "count", "miss"):
            np.testing.assert_array_equal(getattr(f, k),
                                          np.asarray(getattr(jf, k)))
    tv = tri_vidx[perm]
    if moved:
        verts = verts + np.random.default_rng(3).normal(
            scale=0.05, size=verts.shape).astype(np.float32)

    def col(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      for k in range(3)))

    mt = bvh_traverse.build_multi_tables(
        to_device(packs, "cpu"), torch.from_numpy(verts),
        torch.from_numpy(tv))
    eps = torch.tensor(EPS, dtype=torch.float32)
    key, t, idx = (x.numpy() for x in bvh_traverse.tri_bvh_nearest_multi(
        mt, col(o), col(d), eps))
    found = bvh_traverse.tri_bvh_anyhit_multi(
        mt, col(o), col(d), torch.from_numpy(cap), eps).numpy()
    rk, rt, ridx, rfound = _jax_per_pack(jpacks, verts, tv, o, d, cap)
    hit = key < 1e38
    np.testing.assert_array_equal(hit, rk < 1e38)
    np.testing.assert_array_equal(key, rk)
    np.testing.assert_array_equal(idx[hit], ridx[hit])
    np.testing.assert_allclose(t[hit], rt[hit], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(found, rfound)
    assert hit.any() and found.any() and not found.all()


@pytest.mark.parametrize("split", [False, True])
def test_batched_instances_equal_per_group_queries(split, monkeypatch):
    """instances_rock's 37 groups share one BVH (or 4 packs with
    ``split``): one query over their concatenated local rays equals a
    query per group, bit for bit."""
    from raytracer795_tpu_torch.models import camera
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.scene.loader import load_scene

    ld = load_scene(os.path.join(conftest.SCENES, "instances_rock.xml"),
                    "cpu", **(SPLIT if split else {}))
    scene = ld.scene
    assert [len(g) for g in intersect._pack_clusters(scene).values()] == [37]
    cam = dataclasses.replace(ld.cameras[0], nx=32, ny=32)
    rays = camera.primary_rays_at(cam, *camera.band_pixels(32, 32, "cpu"))
    cap = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 20.0, 1024).astype(np.float32))
    batched = intersect.trace(scene, rays)
    b_found = intersect.trace_anyhit(scene, rays, cap)
    monkeypatch.setattr(intersect, "_pack_clusters", lambda s: {})
    per_group = intersect.trace(scene, rays)
    g_found = intersect.trace_anyhit(scene, rays, cap)
    assert batched.valid.any() and b_found.any() and not b_found.all()
    for a, b in zip(batched, per_group):
        assert torch.equal(a, b)
    assert torch.equal(b_found, g_found)


def test_multipack_frame_matches_jax_render(monkeypatch, tmp_path):
    """The multi-packed rock6k at 48x48 through both packages: the JAX
    per-pack fallback against the port's plain multi-pack walks, at the
    bound of tests/test_torch_render.py:52."""
    from raytracer795_tpu import render as jax_render
    from raytracer795_tpu.scene.loader import load_scene as jax_load

    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.scene import types as T

    res = 48
    path = rock6k_xml(tmp_path, res)
    _jax_split(monkeypatch, FRAME_SPLIT)
    jl = jax_load(path)
    assert jl.scene.groups[0].pack_bvhs is not None
    want = conftest.ldr(jax_render.render_camera(jl, 0, seed=0))
    port = T.LoadedScene(scene=_bridged(jl.scene),
                         cameras=[T.Camera(**vars(jl.cameras[0]))],
                         path=path)
    assert len(port.scene.groups[0].pack_bvhs) == 2
    got = render.render_camera(port, 0, ldr=True).astype(np.float32)
    frac = (np.abs(got - want) > 1).mean()
    assert frac < 1e-4, f"{frac:.6f} of LDR values differ by more than 1"


@pytest.mark.parametrize("nu,nv", [(80, 40), (1350, 668)])
def test_rock_generator_bytes_match_make_assets(nu, nv, tmp_path):
    from raytracer795_tpu_torch.scene import assets

    sys.path.insert(0, conftest.SCENES)
    try:
        import make_assets
    finally:
        sys.path.remove(conftest.SCENES)
    want = make_assets.make_rock_ply(str(tmp_path / "want.ply"), nu=nu,
                                     nv=nv)
    path = assets.ensure_rock(str(tmp_path / "got.ply"), nu, nv)
    assert want == (nu * nv, 2 * nu * (nv - 1))
    with open(path, "rb") as f, open(tmp_path / "want.ply", "rb") as g:
        assert f.read() == g.read()

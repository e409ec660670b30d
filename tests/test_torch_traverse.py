"""BVH traversal: the port's plain walks against the JAX package's oracles.

``intersect._tri_bvh_candidates`` / ``_tri_bvh_anyhit`` of the JAX package
are the oracles ``tests/test_pallas.py`` holds the Pallas kernels to; here
the port's plain walks (what its CUDA kernels are held to on the card) are
held to them, over the same FlatBVH and the same rays. Hit masks and prim
ids must be equal; t within rtol = atol = 2e-5 (the oracle's XLA fusion
reassociates a few ulp, as tests/test_pallas.py notes). The kernel itself
runs only on a CUDA device: its test carries the ``cuda`` marker, and as
this module imports jax only inside the oracle, it runs on a card without
jax: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_traverse.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EPS = 1e-3


def _random_mesh(t, seed):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(t * 3, 3)).astype(np.float32)
    tri_vidx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    return verts, tri_vidx


def _random_rays(n, seed):
    """Rays with d == 0 components, NaN origins and zero directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 16, 1] = 0.0
    o[n // 16: n // 8] = np.nan
    d[n // 8: 3 * n // 16] = 0.0
    return o, d


def _build(verts, tri_vidx, use_native=True):
    """Port BVH over the mesh: (FlatBVH numpy, leaf-ordered tri_vidx)."""
    from raytracer795_tpu_torch.ops import bvh

    flat, perm = bvh.build(*bvh.tri_bounds(verts, tri_vidx),
                           use_native=use_native)
    return flat, tri_vidx[perm]


def _port(flat, verts, tv, o, d, cap, device="cpu"):
    """The port's wrappers (plain walk on CPU, kernel on CUDA)."""
    from raytracer795_tpu_torch.ops import bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    def col(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      .to(device) for k in range(3)))

    tb = bvh_traverse.build_tables(
        to_device(flat, device), torch.from_numpy(verts).to(device),
        torch.from_numpy(tv).to(device))
    eps = torch.tensor(EPS, dtype=torch.float32, device=device)
    key, t, idx = bvh_traverse.tri_bvh_nearest(tb, col(o), col(d), eps)
    found = bvh_traverse.tri_bvh_anyhit(
        tb, col(o), col(d), torch.from_numpy(cap).to(device), eps)
    return tuple(x.cpu().numpy() for x in (key, t, idx, found))


def _oracle(flat, verts, tv, o, d, cap):
    """The JAX package's jnp walks over the same BVH and rays."""
    import jax
    import jax.numpy as jnp

    from raytracer795_tpu.ops import intersect
    from raytracer795_tpu.scene import types as JT
    from raytracer795_tpu.utils.vec3 import Vec3

    class _Scene:
        vertices = jnp.asarray(verts)
        int_eps = jnp.float32(EPS)

    class _Group:
        bvh = JT.FlatBVH(**{k: jnp.asarray(getattr(flat, k)) for k in
                            ("bmin", "bmax", "first", "count", "miss")},
                         max_leaf=flat.max_leaf)
        n_tris = tv.shape[0]
        tri_vidx = jnp.asarray(tv)

    rays = intersect.Rays(o=Vec3.from_array(jnp.asarray(o)),
                          d=Vec3.from_array(jnp.asarray(d)),
                          time=jnp.zeros(o.shape[0]))
    key, t, idx = jax.jit(
        lambda r: intersect._tri_bvh_candidates(_Scene, _Group, r))(rays)
    found = jax.jit(lambda r: intersect._tri_bvh_anyhit(
        _Scene, _Group, r, jnp.asarray(cap)))(rays)
    return tuple(np.asarray(x) for x in (key, t, idx, found))


def _assert_match(got, ref):
    """Masks and ids equal, t close; True when some ray hit and some ray
    was occluded."""
    key, t, idx, found = got
    rk, rt, ridx, rfound = ref
    hit, rhit = key < 1e38, rk < 1e38
    np.testing.assert_array_equal(hit, rhit)
    np.testing.assert_array_equal(idx[hit], ridx[hit])
    np.testing.assert_allclose(t[hit], rt[hit], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(found, rfound)
    return hit.any() and found.any()


@pytest.mark.parametrize("t,n,seed", [(333, 1500, 0), (2048, 4096, 1)])
def test_plain_walks_match_oracle_random_mesh(t, n, seed):
    verts, tri_vidx = _random_mesh(t, seed)
    flat, tv = _build(verts, tri_vidx)
    o, d = _random_rays(n, seed + 10)
    cap = np.random.default_rng(seed + 20).uniform(0.1, 5.0, n).astype(
        np.float32)
    assert _assert_match(_port(flat, verts, tv, o, d, cap),
                         _oracle(flat, verts, tv, o, d, cap))


def test_plain_walks_match_oracle_moved_vertices():
    """Vertices move after the build: both walk the stale boxes and test
    the LIVE triangles (tables rebuilt from the moved vertices)."""
    t, n, seed = 333, 1024, 5
    verts, tri_vidx = _random_mesh(t, seed)
    flat, tv = _build(verts, tri_vidx)
    rng = np.random.default_rng(seed + 1)
    verts2 = verts + rng.normal(scale=0.05, size=verts.shape).astype(
        np.float32)
    o, d = _random_rays(n, seed + 10)
    cap = np.full(n, 3.0, np.float32)
    got = _port(flat, verts2, tv, o, d, cap)
    assert _assert_match(got, _oracle(flat, verts2, tv, o, d, cap))
    # the move really changed the answer
    assert not np.array_equal(got[0], _port(flat, verts, tv, o, d, cap)[0])


def test_plain_walks_match_oracle_axis_aligned_vertex_origins():
    """Rays with a zero direction component whose origins sit EXACTLY on
    node-box bounds and vertex coordinates (the d == 0 NaN-entry corner)."""
    t, seed, n = 222, 7, 1280
    verts, tri_vidx = _random_mesh(t, seed)
    flat, tv = _build(verts, tri_vidx)
    rng = np.random.default_rng(seed + 1)
    bounds = np.concatenate([flat.bmin, flat.bmax, verts]).astype(np.float32)
    pick = rng.integers(0, bounds.shape[0], (n, 3))
    o = bounds[pick, rng.integers(0, 3, (n, 3))]
    d = np.zeros((n, 3), np.float32)
    main_ax = rng.integers(0, 3, n)
    zero_ax = rng.integers(0, 3, n)
    d[np.arange(n), main_ax] = rng.choice([-1.0, 1.0], n)
    diag = rng.random(n) < 0.33
    other = (main_ax + 1) % 3
    d[diag, other[diag]] = rng.choice([-1.0, 1.0], diag.sum())
    d[np.arange(n), zero_ax] = 0.0
    cap = np.full(n, 3.0, np.float32)
    _assert_match(_port(flat, verts, tv, o, d, cap),
                  _oracle(flat, verts, tv, o, d, cap))


def test_tables_decode_to_bvh_and_triangles():
    """The float4 tables read back as the FlatBVH and a, a-b, a-c, ng."""
    from raytracer795_tpu_torch.ops import bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device

    verts, tri_vidx = _random_mesh(777, 3)
    flat, tv = _build(verts, tri_vidx)
    tb = bvh_traverse.build_tables(to_device(flat, "cpu"),
                                   torch.from_numpy(verts),
                                   torch.from_numpy(tv))
    assert tb.nodes.shape == (flat.first.shape[0], 8)
    assert tb.tris.shape == (777, 16)
    dec = bvh_traverse.decode(tb)
    np.testing.assert_array_equal(np.stack(dec.bmin, -1), flat.bmin)
    np.testing.assert_array_equal(np.stack(dec.bmax, -1), flat.bmax)
    for name in ("first", "count", "miss"):
        np.testing.assert_array_equal(getattr(dec, name).numpy(),
                                      getattr(flat, name))
    a, b, c = verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]]
    e1, e2 = a - b, a - c
    for got, want in ((dec.a, a), (dec.e1, e1), (dec.e2, e2),
                      (dec.ng, np.cross(e1, e2))):
        np.testing.assert_array_equal(np.stack(got, -1), want)
    np.testing.assert_array_equal(tb.tris[:, 3::4].numpy(), 0.0)


def test_numpy_builder_gives_native_hits():
    """The numpy builder and the native builder give the same hits."""
    from raytracer795_tpu_torch import native

    assert native.load_bvh_builder() is not None, \
        "the native builder failed to compile"
    verts, tri_vidx = _random_mesh(900, 4)
    o, d = _random_rays(2048, 14)
    cap = np.full(2048, 4.0, np.float32)
    flat_n, tv_n = _build(verts, tri_vidx, use_native=True)
    flat_p, tv_p = _build(verts, tri_vidx, use_native=False)
    kn, tn, in_, fn = _port(flat_n, verts, tv_n, o, d, cap)
    kp, tp, ip, fp = _port(flat_p, verts, tv_p, o, d, cap)
    np.testing.assert_array_equal(kn < 1e38, kp < 1e38)
    hit = kn < 1e38
    np.testing.assert_array_equal(tv_n[in_[hit]], tv_p[ip[hit]])
    np.testing.assert_array_equal(tn[hit], tp[hit])
    np.testing.assert_array_equal(fn, fp)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n,seed", [(333, 1500, 0), (2048, 4096, 1)])
def test_kernels_match_plain_walks_on_card(t, n, seed):
    """The CUDA kernels against the plain walks, both on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    verts, tri_vidx = _random_mesh(t, seed)
    flat, tv = _build(verts, tri_vidx)
    o, d = _random_rays(n, seed + 10)
    cap = np.random.default_rng(seed + 20).uniform(0.1, 5.0, n).astype(
        np.float32)
    got = _port(flat, verts, tv, o, d, cap, device="cuda")
    ref = _port(flat, verts, tv, o, d, cap, device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)

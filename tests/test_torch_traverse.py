"""BVH traversal: the port's plain walks against the JAX package's oracles.

``intersect._tri_bvh_candidates`` / ``_tri_bvh_anyhit`` of the JAX package
are the oracles ``tests/test_pallas.py`` holds the Pallas kernels to; here
the port's plain walks (what its CUDA kernels are held to on the card) are
held to them, over the same FlatBVH and the same rays. Hit masks and prim
ids must be equal; t within rtol = atol = 2e-5 (the oracle's XLA fusion
reassociates a few ulp, as tests/test_pallas.py notes). The kernels
themselves run only on a CUDA device: their tests carry the ``cuda``
marker and hold the single-pack and multi-pack kernels against the plain
walks on the card. As this module imports jax only inside the oracle, they
run on a card without jax: ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_traverse.py``.
"""

import os

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


def _moved_vertices_case(t=333, n=1024, seed=5):
    """A tree built over a mesh whose vertices then move: (flat, built
    vertices, live vertices, tri_vidx, o, d, cap)."""
    verts, tri_vidx = _random_mesh(t, seed)
    flat, tv = _build(verts, tri_vidx)
    rng = np.random.default_rng(seed + 1)
    moved = verts + rng.normal(scale=0.05, size=verts.shape).astype(
        np.float32)
    o, d = _random_rays(n, seed + 10)
    return flat, verts, moved, tv, o, d, np.full(n, 3.0, np.float32)


def _axis_aligned_case(t=222, n=1280, seed=7):
    """Rays with a zero direction component whose origins sit EXACTLY on
    node-box bounds and vertex coordinates: (flat, vertices, tri_vidx, o,
    d, cap)."""
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
    return flat, verts, tv, o, d, np.full(n, 3.0, np.float32)


def test_plain_walks_match_oracle_moved_vertices():
    """Vertices move after the build: both walk the stale boxes and test
    the LIVE triangles (tables rebuilt from the moved vertices)."""
    flat, verts, verts2, tv, o, d, cap = _moved_vertices_case()
    got = _port(flat, verts2, tv, o, d, cap)
    assert _assert_match(got, _oracle(flat, verts2, tv, o, d, cap))
    # the move really changed the answer
    assert not np.array_equal(got[0], _port(flat, verts, tv, o, d, cap)[0])


def test_plain_walks_match_oracle_axis_aligned_vertex_origins():
    """Rays with a zero direction component whose origins sit EXACTLY on
    node-box bounds and vertex coordinates (the d == 0 NaN-entry corner)."""
    flat, verts, tv, o, d, cap = _axis_aligned_case()
    _assert_match(_port(flat, verts, tv, o, d, cap),
                  _oracle(flat, verts, tv, o, d, cap))


def test_tables_decode_to_bvh_and_triangles():
    """The tables read back as the FlatBVH and a, a-b, a-c, ng: a node is
    one 32-byte row (bmin, link, bmax, count) with link = first for a leaf
    and miss for an inner node; a triangle is 12 floats, a, e1, e2, ng."""
    from raytracer795_tpu_torch.ops import bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device

    verts, tri_vidx = _random_mesh(777, 3)
    flat, tv = _build(verts, tri_vidx)
    tb = bvh_traverse.build_tables(to_device(flat, "cpu"),
                                   torch.from_numpy(verts),
                                   torch.from_numpy(tv))
    assert tb.nodes.shape == (flat.first.shape[0], 8)
    assert tb.tris.shape == (777, 12)
    leaf = flat.count > 0
    np.testing.assert_array_equal(
        tb.nodes.view(torch.int32)[:, 3].numpy(),
        np.where(leaf, flat.first, flat.miss))
    np.testing.assert_array_equal(tb.nodes.view(torch.int32)[:, 7].numpy(),
                                  flat.count)
    dec = bvh_traverse.decode(tb)
    np.testing.assert_array_equal(np.stack(dec.bmin, -1), flat.bmin)
    np.testing.assert_array_equal(np.stack(dec.bmax, -1), flat.bmax)
    for name in ("first", "count", "miss"):
        np.testing.assert_array_equal(getattr(dec, name).numpy(),
                                      getattr(flat, name))
    a, b, c = verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]]
    e1, e2 = a - b, a - c
    ng = np.cross(e1, e2)
    for got, want in ((dec.a, a), (dec.e1, e1), (dec.e2, e2), (dec.ng, ng)):
        np.testing.assert_array_equal(np.stack(got, -1), want)
    np.testing.assert_array_equal(tb.tris.numpy(),
                                  np.concatenate([a, e1, e2, ng], axis=1))


def test_node_tables_made_once_per_build():
    """Node tables are made once per build (one BVH or a group's packs);
    the triangle rows follow the live vertices on every call."""
    from raytracer795_tpu_torch.ops import bvh, bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device

    verts, tri_vidx = _random_mesh(600, 5)
    moved = torch.from_numpy(verts + np.float32(0.25))
    flat, tv = _build(verts, tri_vidx)
    perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=128)
    for build, host_tree, tv_t in (
            (bvh_traverse.build_tables, flat, torch.from_numpy(tv)),
            (bvh_traverse.build_multi_tables, packs,
             torch.from_numpy(tri_vidx[perm]))):
        tree = to_device(host_tree, "cpu")
        tb = build(tree, torch.from_numpy(verts), tv_t)
        again = build(tree, moved, tv_t)
        assert again.nodes is tb.nodes
        np.testing.assert_array_equal(
            again.tris[:, :3].numpy(), moved[tv_t[:, 0].long()].numpy())
        # another build of the same tree gets tables of its own
        fresh = build(to_device(host_tree, "cpu"), moved, tv_t)
        assert fresh.nodes is not tb.nodes
        # compared as bits: a top node's count -1 reads as a NaN float
        assert fresh.nodes.view(torch.int32).equal(tb.nodes.view(torch.int32))


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


def _port_multi(packs, verts, tv, o, d, cap, device):
    """The port's multi-pack wrappers (plain per-pack walks on CPU, the
    kernels on CUDA): (key, t, idx, found)."""
    from raytracer795_tpu_torch.ops import bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    def col(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      .to(device) for k in range(3)))

    mt = bvh_traverse.build_multi_tables(
        to_device(packs, device), torch.from_numpy(verts).to(device),
        torch.from_numpy(tv).to(device))
    eps = torch.tensor(EPS, dtype=torch.float32, device=device)
    key, t, idx = bvh_traverse.tri_bvh_nearest_multi(mt, col(o), col(d), eps)
    found = bvh_traverse.tri_bvh_anyhit_multi(
        mt, col(o), col(d), torch.from_numpy(cap).to(device), eps)
    return tuple(x.cpu().numpy() for x in (key, t, idx, found))


def _multi_case(case):
    """(packs, vertices, group-ordered tri_vidx, o, d, cap) of a multi-pack
    case: random meshes cut into 5, 8 and 71 packs (the last over the
    64-pack cap the kernels once had) with the rays of ``_random_rays``,
    the knife-edge lanes of ``chip_smoke.knife_edge_rays`` over 5 packs
    and over 4 packs whose last root is a leaf, and the hand-built case
    of the top-node rule."""
    from raytracer795_tpu_torch.ops import bvh

    if case == "top rule":
        return _rule_case()
    t, n, seed, pack_tris = {"5 packs": (600, 4096, 2, 128),
                             "8 packs": (4096, 8192, 3, 512),
                             "71 packs": (9000, 2048, 4, 128),
                             "knife edges": (600, 4096, 5, 128),
                             "knife edges, leaf root": (1000, 4096, 6, 333)
                             }[case]
    verts, tri_vidx = _random_mesh(t, seed)
    perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=pack_tris)
    if case.startswith("knife"):
        o, d, cap = _chip_smoke().knife_edge_rays(packs, n, seed + 10)
    else:
        o, d = _random_rays(n, seed + 10)
        cap = np.random.default_rng(seed + 20).uniform(0.1, 5.0, n).astype(
            np.float32)
    return packs, verts, tri_vidx[perm], o, d, cap


def _chip_smoke():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rule_case():
    """chip_smoke.rule_inputs: two packs whose union box misses rays that
    pack 1's root hits through a NaN slab test."""
    return _chip_smoke().rule_inputs()


MULTI_CASES = ["5 packs", "8 packs", "71 packs", "knife edges",
               "knife edges, leaf root", "top rule"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MULTI_CASES)
def test_multi_kernels_match_plain_walks_on_card(case):
    """The multi-pack kernels against the plain per-pack walks: |t| keys,
    t, prim ids and any-hit answers equal bit for bit, and again on a
    second launch, over 71 packs too (the kernels once took 64 at most)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    packs, verts, tv, o, d, cap = _multi_case(case)
    got = _port_multi(packs, verts, tv, o, d, cap, "cuda")
    again = _port_multi(packs, verts, tv, o, d, cap, "cuda")
    ref = _port_multi(packs, verts, tv, o, d, cap, "cpu")
    for a, b, c in zip(got, again, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, b)
    assert (ref[0] < 1e38).any() and ref[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["moved_vertices", "axis_aligned"])
def test_kernels_match_plain_walks_on_card_edge_cases(case):
    """The single-pack kernels against the plain walks, both on the card,
    on the moved-vertex and the axis-aligned vertex-exact cases: every
    output equal bit for bit, and again on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    if case == "moved_vertices":
        flat, _, verts, tv, o, d, cap = _moved_vertices_case()
    else:
        flat, verts, tv, o, d, cap = _axis_aligned_case()
    got = _port(flat, verts, tv, o, d, cap, device="cuda")
    again = _port(flat, verts, tv, o, d, cap, device="cuda")
    ref = _port(flat, verts, tv, o, d, cap, device="cpu")
    for a, b, c in zip(got, again, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, b)


def _rock6k_bvh(tmp_path):
    """The FlatBVH the port's loader builds for rock6k (rock100k.xml with
    the 6,242-triangle rock6k.ply)."""
    from raytracer795_tpu_torch.scene.loader import load_scene

    scenes = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scenes")
    src = open(os.path.join(scenes, "rock100k.xml")).read()
    src = src.replace('plyFile="rock100k.ply"',
                      f'plyFile="{os.path.join(scenes, "rock6k.ply")}"')
    path = os.path.join(str(tmp_path), "rock6k.xml")
    with open(path, "w") as f:
        f.write(src)
    (group,) = load_scene(path, "cpu").scene.groups
    return group.bvh


@pytest.mark.parametrize("builder", ["numpy", "native", "rock6k", "packs"])
def test_leaf_skip_link_is_next_node(builder, tmp_path):
    """A leaf's miss is node + 1 in every FlatBVH the port builds (the numpy
    and native builders, the loader's rock6k tree, the Morton packs), so a
    node row carries one link; tables of a tree where it fails are
    refused."""
    from raytracer795_tpu_torch.ops import bvh, bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device

    verts, tri_vidx = _random_mesh(600, 9)
    if builder in ("numpy", "native"):
        trees = [_build(verts, tri_vidx, use_native=builder == "native")[0]]
    elif builder == "rock6k":
        trees = [_rock6k_bvh(tmp_path)]
    else:
        trees = list(bvh.build_multipack(verts, tri_vidx, pack_tris=128)[1])
        assert len(trees) == 5
    for tree in trees:
        count, miss = (np.asarray(tree.count), np.asarray(tree.miss))
        leaf = np.nonzero(count > 0)[0]
        assert leaf.shape[0] > 1
        np.testing.assert_array_equal(miss[leaf], leaf + 1)
    bad = to_device(trees[0], "cpu")
    bad.miss = bad.miss.clone()
    bad.miss[int(np.nonzero(np.asarray(trees[0].count) > 0)[0][0])] += 1
    with pytest.raises(ValueError, match="node \\+ 1"):
        bvh_traverse.build_tables(bad, torch.from_numpy(verts),
                                  torch.from_numpy(tri_vidx))


def _hand_built_tables():
    """A root over two leaves: A = [0,1]x[0,1]x[0,1] with triangles 0
    (z = 0.5) and 1 (z = 0.8), B = [1,2]x[0,1]x[0,1] with triangle 2
    (z = 0.5); and four rays heading down -z: into A, into B, past the
    root, and a NaN ray."""
    from raytracer795_tpu_torch.ops import bvh_traverse
    from raytracer795_tpu_torch.scene import types as T
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    flat = T.FlatBVH(
        bmin=np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0]], np.float32),
        bmax=np.array([[2, 1, 1], [1, 1, 1], [2, 1, 1]], np.float32),
        first=np.array([0, 0, 2], np.int32),
        count=np.array([0, 2, 1], np.int32),
        miss=np.array([3, 2, 3], np.int32), max_leaf=2)
    verts = np.array([[-1, -1, 0.5], [3, -1, 0.5], [-1, 3, 0.5],
                      [-1, -1, 0.8], [3, -1, 0.8], [-1, 3, 0.8],
                      [1, -1, 0.5], [3, -1, 0.5], [1, 3, 0.5]], np.float32)
    tb = bvh_traverse.build_tables(
        to_device(flat, "cpu"), torch.from_numpy(verts),
        torch.arange(9, dtype=torch.int32).reshape(3, 3))
    o = torch.tensor([[0.4, 0.4, 2], [1.5, 0.5, 2], [5, 5, 2],
                      [float("nan"), 0, 2]])
    d = torch.tensor([[0.01, 0.01, -1.0]]).expand(4, 3)

    def col(a):
        return Vec3(*(a[:, k].contiguous() for k in range(3)))
    return tb, col(o), col(d)


@pytest.mark.parametrize("caps,want", [
    # nearest: A tests both of its triangles and B is missed; B alone;
    # the root alone; nothing
    (None, ([3, 3, 1, 0], [1, 1, 0, 0], [2, 1, 0, 0])),
    # any-hit: triangle 0 occludes first and the ray leaves after A
    ((10.0, 10.0, 10.0, 10.0), ([2, 3, 1, 0], [1, 1, 0, 0], [1, 1, 0, 0])),
    # caps below both of A's hits, and below the root's entry (1.0)
    ((1.1, 0.5, 10.0, 10.0), ([3, 1, 1, 0], [1, 0, 0, 0], [2, 0, 0, 0]))])
def test_walk_work_on_a_hand_built_tree(caps, want):
    from raytracer795_tpu_torch.ops import bvh_traverse

    tb, o, d = _hand_built_tables()
    cap = None if caps is None else torch.tensor(caps)
    work = bvh_traverse.walk_work(tb, o, d, torch.tensor(EPS), cap)
    assert [w.tolist() for w in work] == [list(x) for x in want]


@pytest.mark.parametrize("anyhit", [False, True])
def test_walk_work_counts_the_plain_walks_steps(anyhit, monkeypatch):
    """On a random mesh, walk_work's node and leaf visits are the plain
    walk's own (counted inside ``intersect._Walk``), and so are its
    triangle tests, except that an any-hit leaf stops at its occluder."""
    from raytracer795_tpu_torch.ops import bvh_traverse, intersect
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    verts, tri_vidx = _random_mesh(600, 8)
    flat, tv = _build(verts, tri_vidx)
    n = 1024
    o, d = _random_rays(n, 18)
    cap = torch.from_numpy(np.random.default_rng(28).uniform(
        0.1, 5.0, n).astype(np.float32))
    tb = bvh_traverse.build_tables(to_device(flat, "cpu"),
                                   torch.from_numpy(verts),
                                   torch.from_numpy(tv))

    def col(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      for k in range(3)))
    o, d = col(o), col(d)
    eps = torch.tensor(EPS)
    steps = torch.zeros((3, n), dtype=torch.int64)
    visit, leaf_tests = intersect._Walk.visit, intersect._Walk.leaf_tests

    def counted_visit(self):
        steps[0, self.lane] += 1
        return visit(self)

    def counted_leaf_tests(self, li):
        steps[1, self.lane[li]] += 1
        steps[2, self.lane[li]] += self.tb.count[self.node[li]].long()
        return leaf_tests(self, li)
    monkeypatch.setattr(intersect._Walk, "visit", counted_visit)
    monkeypatch.setattr(intersect._Walk, "leaf_tests", counted_leaf_tests)
    dec = bvh_traverse.decode(tb)
    if anyhit:
        intersect._tri_bvh_anyhit(dec, o, d, cap, eps)
    else:
        intersect._tri_bvh_candidates(dec, o, d, eps)
    monkeypatch.undo()
    work = bvh_traverse.walk_work(tb, o, d, eps, cap if anyhit else None)
    assert torch.equal(work.nodes, steps[0])
    assert torch.equal(work.leaves, steps[1])
    assert int(work.nodes.sum()) > 10 * n and int(work.leaves.sum()) > n
    if anyhit:
        assert bool((work.tris <= steps[2]).all())
        assert bool((work.tris < steps[2]).any())
    else:
        assert torch.equal(work.tris, steps[2])


def test_walk_work_over_packs():
    """Over Morton packs, walk_work visits every pack's root for each live
    ray and, carrying the best |t| from pack to pack, does no more work
    than walking each pack on its own."""
    from raytracer795_tpu_torch.ops import bvh, bvh_traverse, intersect
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    verts, tri_vidx = _random_mesh(600, 2)
    perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=128)
    mt = bvh_traverse.build_multi_tables(
        to_device(packs, "cpu"), torch.from_numpy(verts),
        torch.from_numpy(tri_vidx[perm]))
    o, d = _random_rays(2048, 12)
    o, d = (Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                   for k in range(3))) for a in (o, d))
    eps = torch.tensor(EPS)
    work = bvh_traverse.walk_work(mt, o, d, eps)
    live = ~intersect._dead_lanes(o, d)
    assert bool((work.nodes[live] >= mt.n_packs).all())
    assert int(work.nodes[~live].max()) == 0
    apart = torch.zeros((3, 2048), dtype=torch.int64)
    for pk in packs:
        tb = bvh_traverse.build_tables(to_device(pk, "cpu"),
                                       torch.from_numpy(verts),
                                       torch.from_numpy(tri_vidx[perm]))
        apart += torch.stack(bvh_traverse.walk_work(tb, o, d, eps))
    assert bool((torch.stack(work) <= apart).all())
    assert int(work.tris.sum()) < int(apart[2].sum())


def test_native_builder_source_is_the_ports_own():
    """The native builder compiles the port's copy of the JAX package's
    source, which keeps that source's code below its header comment."""
    import raytracer795_tpu_torch
    from raytracer795_tpu_torch import native

    pkg = os.path.dirname(os.path.abspath(raytracer795_tpu_torch.__file__))
    src = os.path.realpath(native.BVH_BUILDER_SRC)
    assert src.startswith(pkg + os.sep) and os.path.isfile(src)
    jax_src = os.path.join(os.path.dirname(pkg), "raytracer795_tpu",
                           "native", "bvh_builder.cpp")

    def code(path):
        text = open(path).read()
        return text[text.index("#include"):]
    assert code(src) == code(jax_src)
    assert native.load_bvh_builder() is not None


def _steps_tool():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_traverse_steps",
        os.path.join(root, "tools", "torch_traverse_steps.py"))
    steps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(steps)
    return steps


def test_ctypes_signatures_match_the_c_entry_points():
    """Each C entry point takes the pointers ``C_ARGS`` declares around its
    two ints: ctypes passes an undeclared argument as a 32-bit int, which
    would cut a pointer. The same holds for the entry points that
    tools/torch_traverse_steps.py adds in its sorted-pack-list variant."""
    import re

    from raytracer795_tpu_torch.ops import bvh_traverse

    steps = _steps_tool()
    src = open(bvh_traverse.SOURCE).read()
    (listed_subs,) = [subs for name, subs, _ in steps.VARIANTS
                      if name == steps.LISTED]
    for text, args in ((src, bvh_traverse.C_ARGS),
                       (steps.variant_source(src, listed_subs),
                        steps.LISTED_ARGS)):
        for name, (n_in, n_out) in args.items():
            sig = re.search(r'extern "C" int rt795_bvh_%s\(([^)]*)\)' % name,
                            text).group(1)
            kinds = ["int" if re.fullmatch(r"\s*int \w+\s*", a) else "ptr"
                     for a in sig.split(",")]
            assert kinds == ["ptr"] * n_in + ["int"] * 2 + ["ptr"] * n_out, \
                name


def test_design_step_variants_apply_to_the_kernel_source():
    """tools/torch_traverse_steps.py times each step of the kernels' design
    through text substitutions of csrc/bvh_traverse.cu: every substitution
    must still find its text, and every variant must be a source of its
    own; the multi-pack variants named in the tool are there."""
    steps = _steps_tool()
    src = open(steps.bt.SOURCE).read()
    names = [name for name, _, _ in steps.VARIANTS]
    assert names[0] == "design" and len(set(names)) == len(names)
    assert {steps.CARRIED, steps.LISTED,
            "top culling off (every pack root tested)"} <= set(names)
    made = [steps.variant_source(src, subs) for _, subs, _ in steps.VARIANTS]
    assert made[0] == src and len(set(made)) == len(made)


def _multi_tables(packs, verts, tv, o, d, cap, eps=EPS):
    """CPU tables and tensors of a multi-pack case."""
    from raytracer795_tpu_torch.ops import bvh_traverse
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    def col(a):
        return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                      for k in range(3)))
    mt = bvh_traverse.build_multi_tables(
        to_device(packs, "cpu"), torch.from_numpy(verts), torch.from_numpy(tv))
    return mt, col(o), col(d), torch.from_numpy(cap), torch.tensor(eps)


@pytest.mark.parametrize("case", ["5 packs", "71 packs",
                                  "knife edges, leaf root", "one pack"])
def test_two_level_table_round_trip(case):
    """The two-level table reads back as each pack's FlatBVH exactly, its
    packs in order; every top node has the exact min/max of its packs'
    root boxes, count -1 and a skip link just past its packs; leaves keep
    skip links of node + 1 and global ``first``s that tile the triangle
    table in order."""
    from raytracer795_tpu_torch.ops import bvh, bvh_traverse

    if case == "one pack":
        verts, tri_vidx = _random_mesh(300, 8)
        perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=512)
        o, d = _random_rays(8, 8)
        tv, cap = tri_vidx[perm], np.ones(8, np.float32)
    else:
        packs, verts, tv, o, d, cap = _multi_case(case)
    mt = _multi_tables(packs, verts, tv, o, d, cap)[0]
    k = len(packs)
    assert mt.n_packs == k
    for flat, dec in zip(packs, bvh_traverse.decode_multi(mt)):
        leaf = flat.count > 0
        np.testing.assert_array_equal(np.stack(dec.bmin, -1), flat.bmin)
        np.testing.assert_array_equal(np.stack(dec.bmax, -1), flat.bmax)
        np.testing.assert_array_equal(dec.count.numpy(), flat.count)
        np.testing.assert_array_equal(dec.miss.numpy(), flat.miss)
        np.testing.assert_array_equal(dec.first.numpy()[leaf],
                                      flat.first[leaf])
    whole = bvh_traverse.decode(mt)
    count, miss = whole.count.numpy(), whole.miss.numpy()
    bmin, bmax = np.stack(whole.bmin, -1), np.stack(whole.bmax, -1)
    ranges = mt.offsets.numpy()
    assert (ranges[1:, 0] > ranges[:-1, 0]).all()
    in_pack = np.zeros(mt.n_nodes, bool)
    for lo, hi in ranges:
        in_pack[lo:hi] = True
    top = np.nonzero(~in_pack)[0]
    assert top.shape[0] == k - 1 and (count[top] == -1).all()
    for i in top:
        under = (ranges[:, 0] > i) & (ranges[:, 1] <= miss[i])
        assert under.sum() >= 2 and ranges[under][-1, 1] == miss[i]
        roots = ranges[under, 0]
        np.testing.assert_array_equal(bmin[i], bmin[roots].min(0))
        np.testing.assert_array_equal(bmax[i], bmax[roots].max(0))
    leaf = np.nonzero(count > 0)[0]
    np.testing.assert_array_equal(miss[leaf], leaf + 1)
    np.testing.assert_array_equal(
        mt.nodes.view(torch.int32)[leaf, 3].numpy(),
        np.cumsum(count[leaf]) - count[leaf])
    assert np.cumsum(count[leaf])[-1] == tv.shape[0]


def _plain_multi(mt, o, d, cap, eps):
    from raytracer795_tpu_torch.ops import bvh_traverse, intersect

    packs = bvh_traverse.decode_multi(mt)
    return (*intersect._tri_bvh_candidates_multi(packs, o, d, eps),
            intersect._tri_bvh_anyhit_multi(packs, o, d, cap, eps))


def _two_level(mt, o, d, cap, eps, top_rule=True):
    """The two-level walk's (key, t, idx, found); without ``top_rule``, the
    same table walked as a plain tree, whose top nodes cull every ray."""
    from raytracer795_tpu_torch.ops import bvh_traverse

    if top_rule:
        def walk(c):
            return bvh_traverse.walk_two_level(mt, o, d, eps, c)[0]
    else:
        def walk(c):
            return bvh_traverse._walk((bvh_traverse.decode(mt),), o, d, eps,
                                      c)[0]
    return (*walk(None), walk(cap))


@pytest.mark.parametrize("case", MULTI_CASES)
def test_two_level_walk_equals_plain_walk(case):
    """The multi-pack kernels' walk of the two-level table, on the host,
    gives the plain per-pack walks' |t| keys, t, prim ids and any-hit
    answers bit for bit: on random meshes in 5, 8 and 71 packs, on
    knife-edge lanes (NaN; +-0, denormal and infinite direction
    components; infinite origins; origins on pack-root planes; caps 0 and
    +inf) and on the hand-built case of the top-node rule."""
    mt, o, d, cap, eps = _multi_tables(*_multi_case(case))
    got = _two_level(mt, o, d, cap, eps)
    ref = _plain_multi(mt, o, d, cap, eps)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool((ref[0] < 1e38).any()) and bool(ref[3].any())


def test_top_node_rule_is_needed():
    """Without the rule (a top node culls every ray), the two-level walk
    loses the rule case's hits through a pack root's NaN slab test: the
    union box misses where the root counts as hit."""
    mt, o, d, cap, eps = _multi_tables(*_rule_case())
    ref = _plain_multi(mt, o, d, cap, eps)
    assert ref[0].tolist()[:2] == [1.5, 1.5] and ref[3].tolist() == [
        True, True, False]
    got = _two_level(mt, o, d, cap, eps)
    off = _two_level(mt, o, d, cap, eps, top_rule=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool((off[0][:2] > 1e38).all())
    assert not bool(off[3].any())


def _shared_edge_surface(g=40):
    """A height field of (g - 1)^2 quads, two triangles each, whose
    neighbours share edges."""
    xs, ys = np.meshgrid(np.linspace(-2, 2, g), np.linspace(-2, 2, g))
    zs = 0.3 * np.sin(3 * xs) * np.cos(2 * ys)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    i = (np.arange(g - 1)[:, None] * g + np.arange(g - 1)[None, :]).ravel()
    tri_vidx = np.concatenate([np.stack([i, i + 1, i + g], 1),
                               np.stack([i + 1, i + g + 1, i + g], 1)])
    return verts, tri_vidx.astype(np.int32)


def test_carried_best_is_not_exact_but_the_two_level_walk_is():
    """On a surface of shared edges cut into 48 packs, with a wide
    int_eps, a best |t| carried from pack to pack (what walk_work counts)
    prunes packs holding a nearer hit accepted outside its leaf box, so it
    changes some lanes; the kernels' walk, which prunes each pack with its
    own best, equals the plain per-pack walks on every lane."""
    from raytracer795_tpu_torch.ops import bvh, bvh_traverse

    verts, tri_vidx = _shared_edge_surface()
    perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=64)
    assert len(packs) == 48
    n = 4096
    rng = np.random.default_rng(1)
    o = np.concatenate([rng.uniform(-2, 2, (n, 2)), np.full((n, 1), 3.0)],
                       1).astype(np.float32)
    d = np.concatenate([rng.uniform(-2, 2, (n, 2)), np.full((n, 1), -0.3)],
                       1).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mt, o, d, cap, eps = _multi_tables(packs, verts, tri_vidx[perm], o, d,
                                       np.full(n, 9.0, np.float32), 3e-2)
    ref = _plain_multi(mt, o, d, cap, eps)
    for a, b in zip(_two_level(mt, o, d, cap, eps), ref):
        assert torch.equal(a, b)
    (key, t, idx), _ = bvh_traverse._walk(bvh_traverse.decode_multi(mt), o,
                                          d, eps, None)
    carried_differ = (key != ref[0]) | (t != ref[1]) | (idx != ref[2])
    assert 0 < int(carried_differ.sum()) < n // 100

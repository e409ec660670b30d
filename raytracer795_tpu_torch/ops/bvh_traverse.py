"""BVH traversal on the card: tables, kernel build, and the four wrappers.

Counterpart of ``raytracer795_tpu/ops/pallas_bvh.py``. The kernels are
hand-written CUDA C++ in ``csrc/bvh_traverse.cu`` (see the note there for
what they replace and what bounds them):

- ``tri_bvh_nearest`` replaces ``tri_bvh_nearest`` / ``_nearest_kernel``;
- ``tri_bvh_anyhit`` replaces ``tri_bvh_anyhit`` / ``_anyhit_kernel``;
- ``tri_bvh_nearest_multi`` replaces ``tri_bvh_nearest_multi`` /
  ``_nearest_multi_kernel`` (with its TLAS pass ``_block_pack_lists``);
- ``tri_bvh_anyhit_multi`` replaces ``tri_bvh_anyhit_multi`` /
  ``_anyhit_multi_kernel``.

Each wrapper takes the kernel path for CUDA tensors and the plain walk of
ops/intersect.py for CPU tensors, and for nothing else: a CUDA tensor
launches the kernel or raises. No kernel has a backward: as in the JAX
package, whose walk never reaches the AD tape, the queries run without
autograd and the tables hold no graph; gradients reach the geometry
through ``intersect.hit_details``. The plain walks read the same tables,
decoded (``decode``, ``decode_multi``), and are what the kernels are held
to. ``walk_work`` is the plain walk with counters: the work behind the
kernels' bounds. ``walk_two_level`` is the multi-pack kernels' own walk
of their two-level table, on the host.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false`` into
a shared library with a plain C interface under ``build/cuda/`` at the
repository root, keyed by a hash of the source and flags, at first use;
``ctypes`` loads it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from raytracer795_tpu_torch.ops import intersect
from raytracer795_tpu_torch.scene import types as T
from raytracer795_tpu_torch.utils import graphs
from raytracer795_tpu_torch.utils.vec3 import Vec3

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bvh_traverse.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# launches per kernel, counted where each wrapper launches its kernel, or,
# for a launch captured into a CUDA graph, where the graph replays it
# (``utils/graphs.count_launch``)
LAUNCHES = {"nearest": 0, "anyhit": 0, "nearest_multi": 0,
            "anyhit_multi": 0}
# pointer arguments of each C entry point before and after its two ints:
# rays (6), [t_cap], nodes, tris, int_eps; then node count, ray count; then
# the ray counter, outputs, stream
C_ARGS = {"nearest": (9, 5), "anyhit": (10, 3), "nearest_multi": (9, 5),
          "anyhit_multi": (10, 3)}

_log = logging.getLogger(__name__)
_LOCK = threading.Lock()
_LIB: dict = {}
# node tables of the builds in use (``_build_nodes``)
_NODES = WeakIdKeyDictionary()


@dataclasses.dataclass
class TraverseTables:
    """The kernels' tables for one group (see csrc/bvh_traverse.cu).

    ``nodes`` [M, 8] f32, one 32-byte row a node: bmin.xyz, link (int32
    bits), bmax.xyz, count (int32 bits); link is ``first`` for a leaf and
    ``miss`` for an inner node (a leaf's skip link is always node + 1).
    ``tris`` [T, 12] f32 in BVH order: a, e1 = a-b, e2 = a-c, ng = e1 x e2.
    """

    nodes: torch.Tensor
    tris: torch.Tensor
    max_leaf: int

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


class Decoded(NamedTuple):
    """The tables read back as a FlatBVH and triangle components."""

    bmin: Vec3
    bmax: Vec3
    first: torch.Tensor
    count: torch.Tensor
    miss: torch.Tensor
    a: Vec3
    e1: Vec3
    e2: Vec3
    ng: Vec3
    max_leaf: int
    n_nodes: int


def _links(bvh: T.FlatBVH) -> torch.Tensor:
    """Each node's link: ``first`` for a leaf, ``miss`` for an inner node.

    The builders emit whatever follows a leaf right after it, so a leaf's
    skip link is node + 1 and the walk needs no ``miss`` for it; a tree
    where that fails is refused.
    """
    leaf = bvh.count > 0
    after = torch.arange(1, bvh.count.shape[0] + 1, dtype=torch.int32,
                         device=bvh.count.device)
    if not bool(torch.all(~leaf | (bvh.miss == after))):
        raise ValueError("a leaf's skip link is not node + 1")
    return torch.where(leaf, bvh.first, bvh.miss)


def _node_rows(bmin, bmax, link, count) -> torch.Tensor:
    # assembled as int32 so the index fields keep their bits exactly
    return torch.cat([bmin.view(torch.int32), link[:, None],
                      bmax.view(torch.int32), count[:, None]],
                     dim=1).view(torch.float32)


def _tri_rows(vertices: torch.Tensor, tri_vidx: torch.Tensor) -> torch.Tensor:
    """The triangle rows of the live vertices, off the autograd tape: the
    walk never carries a gradient (``intersect.hit_details`` recomputes the
    winner's geometry on the tape), so the rows hold no graph even when
    ``vertices`` requires grad."""
    a, e1, e2, ng = intersect.tri_components(vertices.detach(), tri_vidx)
    return torch.stack([*a, *e1, *e2, *ng], dim=1)


def _build_nodes(key: torch.Tensor, make):
    """The node part of a build's tables, made once: node bounds are the
    build's and do not follow the vertices. Keyed weakly by a tensor of the
    build (instances of one mesh share it), so it goes with the scene."""
    got = _NODES.get(key)
    if got is None:
        got = _NODES[key] = make()
    return got


def build_tables(bvh: T.FlatBVH, vertices: torch.Tensor,
                 tri_vidx: torch.Tensor) -> TraverseTables:
    """Tables from a FlatBVH and the LIVE vertices (the counterpart of the
    JAX package's ``fresh_tri_rows``): a vertex update moves the geometry
    the kernels intersect, while node bounds stay those of the build."""
    nodes = _build_nodes(bvh.first, lambda: _node_rows(
        bvh.bmin, bvh.bmax, _links(bvh), bvh.count))
    return TraverseTables(nodes=nodes, tris=_tri_rows(vertices, tri_vidx),
                          max_leaf=bvh.max_leaf)


def _decode_nodes(nodes: torch.Tensor, base: int = 0):
    """bmin, bmax, first, count and miss of a node table whose links are
    ``base`` plus the table's own indices."""
    ni = nodes.view(torch.int32)
    link, count = ni[:, 3], ni[:, 7]
    leaf = count > 0
    after = torch.arange(1, nodes.shape[0] + 1, dtype=torch.int32,
                         device=nodes.device)
    return (Vec3(nodes[:, 0], nodes[:, 1], nodes[:, 2]),
            Vec3(nodes[:, 4], nodes[:, 5], nodes[:, 6]),
            torch.where(leaf, link, 0), count,
            torch.where(leaf, after, link - base))


def _decode_tris(tr: torch.Tensor):
    return tuple(Vec3(tr[:, k], tr[:, k + 1], tr[:, k + 2])
                 for k in (0, 3, 6, 9))


def _decoded(nodes, tris, max_leaf, base=0) -> Decoded:
    bmin, bmax, first, count, miss = _decode_nodes(nodes, base)
    a, e1, e2, ng = _decode_tris(tris)
    return Decoded(bmin=bmin, bmax=bmax, first=first, count=count,
                   miss=miss, a=a, e1=e1, e2=e2, ng=ng, max_leaf=max_leaf,
                   n_nodes=nodes.shape[0])


def decode(tb) -> Decoded:
    """The tables read back as one tree: a ``TraverseTables``' BVH, or a
    ``MultiTables``' whole two-level table (its top nodes have count -1)."""
    return _decoded(tb.nodes, tb.tris, tb.max_leaf)


@dataclasses.dataclass
class MultiTables:
    """The multi-pack kernels' tables for one group of K packs: one
    two-level skip-link table (see csrc/bvh_traverse.cu).

    ``nodes`` [M, 8] f32 in the layout of ``TraverseTables``. The top tree
    has the packs as leaves, in pack order, laid out depth first: an inner
    top node (count -1, link = miss) over packs [lo, hi) has the exact
    min/max of their root boxes and is followed by the top tree of
    [lo, mid) and then that of [mid, hi), mid = (lo + hi) // 2; the top
    tree of one pack is the pack's root with its nodes after it. Every link
    is global. ``offsets`` [K, 2] int32 on the host: pack p owns nodes
    [offsets[p, 0], offsets[p, 1]), its root first. ``tris`` [T, 12] f32:
    the group's one triangle table, in pack order.
    """

    nodes: torch.Tensor
    offsets: torch.Tensor
    tris: torch.Tensor
    max_leaf: int

    @property
    def n_packs(self) -> int:
        return self.offsets.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


def _two_level(pack_bvhs):
    """The two-level node table of a group's packs and each pack's node
    range (``MultiTables``). Refuses packs whose leaves do not follow one
    another in the triangle table (a leaf's ``first`` must be global) or
    whose leaves' skip links are not node + 1 (``_links``)."""
    roots_lo = torch.stack([f.bmin[0] for f in pack_bvhs])
    roots_hi = torch.stack([f.bmax[0] for f in pack_bvhs])
    parts, ranges = [], []

    def lay(lo, hi, at):
        """Lays out the top tree of packs [lo, hi) from node ``at``;
        returns the node after it."""
        if hi - lo == 1:
            f = pack_bvhs[lo]
            end = at + f.first.shape[0]
            parts.append((f.bmin, f.bmax, f.first, f.count, f.miss + at))
            ranges.append((at, end))
            return end
        top = len(parts)
        parts.append(None)
        mid = (lo + hi) // 2
        end = lay(mid, hi, lay(lo, mid, at + 1))
        ints = torch.tensor([[0, -1, end]], dtype=torch.int32,
                            device=roots_lo.device)
        parts[top] = (roots_lo[lo:hi].amin(0, keepdim=True),
                      roots_hi[lo:hi].amax(0, keepdim=True), *ints.T)
        return end

    lay(0, len(pack_bvhs), 0)
    flat = T.FlatBVH(*(torch.cat(field) for field in zip(*parts)),
                     max_leaf=max(f.max_leaf for f in pack_bvhs))
    leaf = flat.count > 0
    count = flat.count[leaf]
    if not bool(torch.all(flat.first[leaf] == count.cumsum(0) - count)):
        raise ValueError("the packs' leaves do not tile the triangle table "
                         "in order")
    return (_node_rows(flat.bmin, flat.bmax, _links(flat), flat.count),
            torch.tensor(ranges, dtype=torch.int32))


def build_multi_tables(pack_bvhs, vertices: torch.Tensor,
                       tri_vidx: torch.Tensor) -> MultiTables:
    """Tables from a group's pack FlatBVHs and the LIVE vertices, as
    ``build_tables`` makes them for one FlatBVH: the two-level node table
    once per group, the triangle rows on every call."""
    nodes, offsets = _build_nodes(pack_bvhs[0].first,
                                  lambda: _two_level(pack_bvhs))
    return MultiTables(
        nodes=nodes, offsets=offsets, tris=_tri_rows(vertices, tri_vidx),
        max_leaf=max(f.max_leaf for f in pack_bvhs))


def table_nbytes(group: T.TraceGroup) -> int:
    """Bytes of the tables ``build_tables`` or ``build_multi_tables``
    makes for a BVH group, without building them: a 32-byte row a node and
    a 48-byte row a triangle; a multi-pack group adds the K - 1 inner top
    nodes and its [K, 2] int32 offsets."""
    if group.bvh is not None:
        return 32 * int(group.bvh.first.shape[0]) + 48 * group.n_tris
    k = len(group.pack_bvhs)
    nodes = sum(int(f.first.shape[0]) for f in group.pack_bvhs) + k - 1
    return 32 * nodes + 8 * k + 48 * group.n_tris


def decode_multi(mt: MultiTables) -> Tuple[Decoded, ...]:
    """The tables read back as one ``Decoded`` per pack, with pack-local
    links, each over the group's whole triangle table (its ``first`` is
    global)."""
    return tuple(_decoded(mt.nodes[lo:hi], mt.tris, mt.max_leaf, base=lo)
                 for lo, hi in mt.offsets.tolist())


class Work(NamedTuple):
    """A walk's work per ray, [N] int64 each."""

    nodes: torch.Tensor     # node visits (slab tests)
    leaves: torch.Tensor    # leaves whose triangles were tested
    tris: torch.Tensor      # triangle tests


def _boxed(w: intersect._Walk) -> torch.Tensor:
    """Lanes whose o, d and 1/d are all finite: only these may be culled
    by a top node of a two-level table."""
    out = torch.ones_like(w.lane, dtype=torch.bool)
    for v in (w.o, w.d, w.inv_d):
        for c in v:
            out &= torch.isfinite(c)
    return out


def _counted_walk(dec: Decoded, o: Vec3, d: Vec3, int_eps, best, cap,
                  work: torch.Tensor, top=None):
    """One tree's plain walk with counters added into ``work`` [3, N]: the
    walk of ``intersect._tri_bvh_candidates`` when ``cap`` is None (``best``,
    each ray's |t| key, t and prim so far, [N] each, is updated in place),
    else that of ``intersect._tri_bvh_anyhit``, whose answers are returned.
    An any-hit leaf counts its triangles up to the first that occludes.

    ``top`` [M] bool marks the top nodes of a two-level table, walked as
    the multi-pack kernels walk it (csrc/bvh_traverse.cu): a lane that is
    not ``_boxed`` enters every top node, and the nearest walk prunes each
    pack with the pack's own best |t|, which starts again at 3e38 where the
    walk leaves a pack, while ``best`` takes a hit only below itself too.
    """
    nearest = cap is None
    found = None if nearest else torch.zeros_like(cap, dtype=torch.bool)
    w = intersect._Walk(dec, o, d, int_eps)
    if nearest:
        # key, t, idx; the prune limit; the end of the lane's pack (past
        # the tree where no limit restarts)
        state = [b[w.lane] for b in best]
        state += [state[0].clone(), torch.full_like(
            w.lane, 0 if top is not None else dec.n_nodes)]
    else:
        state = [cap[w.lane], torch.zeros_like(w.lane, dtype=torch.bool)]
    while w.lane.shape[0]:
        if nearest:
            lim, pend = state[3], state[4]
            left = w.node >= pend      # at a top node or a pack's root
            lim[left] = intersect._BIG
            root = left & (dec.count[w.node] >= 0)
            pend[root] = dec.miss[w.node[root]].long()
        else:
            lim = state[0]
        box_hit, entry, is_leaf = w.visit()
        box_hit = box_hit & ~(entry > lim)
        enter = box_hit if top is None else (
            box_hit | (top[w.node] & ~_boxed(w)))
        work[0, w.lane] += 1
        li = torch.nonzero(box_hit & is_leaf)[:, 0]
        if li.shape[0]:
            ok, tt, pi = w.leaf_tests(li)
            count = dec.count[w.node[li]].long()
            work[1, w.lane[li]] += 1
            if nearest:
                key, t, idx = state[:3]
                k = torch.where(ok, torch.abs(tt), intersect._BIG)
                ck, cj = torch.min(k, dim=1)
                lim[li] = torch.minimum(lim[li], ck)
                upd = ck < key[li]
                key[li] = torch.where(upd, ck, key[li])
                t[li] = torch.where(
                    upd, torch.gather(tt, 1, cj[:, None])[:, 0], t[li])
                idx[li] = torch.where(
                    upd, torch.gather(pi, 1, cj[:, None])[:, 0].to(
                        torch.int32), idx[li])
                work[2, w.lane[li]] += count
            else:
                got = state[1]
                occ = ok & (tt > 0) & (tt < lim[li][:, None])
                hit = occ.any(dim=1)
                upto = occ.to(torch.uint8).argmax(dim=1) + 1
                work[2, w.lane[li]] += torch.where(hit, upto, count)
                got[li] = hit
        w.advance(enter & ~is_leaf)
        done = w.node >= dec.n_nodes
        if not nearest:
            done = done | state[1]
        (lanes, *out), state = w.retire(done, *state)
        state = list(state)
        if nearest:
            for b, x in zip(best, out):
                b[lanes] = x
        else:
            found[lanes] = out[1]
    return found


def _walk(trees, o: Vec3, d: Vec3, int_eps, t_cap, top=None):
    """``trees`` walked one after another with counters, the best hit
    carried from tree to tree (nearest) or a ray leaving at its first
    occluder (any-hit): (answers, Work), the answers (|t| key, t, prim) or
    [N] bool."""
    n = o.x.shape[0]
    dev = o.x.device
    work = torch.zeros((3, n), dtype=torch.int64, device=dev)
    best = [torch.full((n,), intersect._BIG, device=dev),
            torch.zeros((n,), device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev)]
    live = torch.arange(n, device=dev)
    for dec in trees:
        if t_cap is None:
            _counted_walk(dec, o, d, int_eps, best, None, work, top)
            continue
        sub = torch.zeros((3, live.shape[0]), dtype=torch.int64, device=dev)
        found = _counted_walk(dec, intersect._gather3(o, live),
                              intersect._gather3(d, live), int_eps, None,
                              t_cap[live], sub, top)
        work[:, live] += sub
        live = live[~found]
    if t_cap is None:
        return tuple(best), Work(*work)
    found = torch.ones((n,), dtype=torch.bool, device=dev)
    found[live] = False
    return found, Work(*work)


def walk_work(tables, o: Vec3, d: Vec3, int_eps, t_cap=None) -> Work:
    """Node visits, leaf visits and triangle tests of each ray's walk: the
    plain nearest walk (``t_cap`` None) or any-hit walk, with counters.

    For ``MultiTables`` the packs are walked in pack order, each from its
    root, with the best |t| (nearest) carried from pack to pack and a ray
    leaving at its first occluder (any-hit). It counts the work behind a
    kernel's bound (chip_smoke.py); nothing on the render path calls it.
    """
    trees = (decode_multi(tables) if isinstance(tables, MultiTables)
             else (decode(tables),))
    return _walk(trees, o, d, int_eps, t_cap)[1]


def walk_two_level(mt: MultiTables, o: Vec3, d: Vec3, int_eps, t_cap=None):
    """The multi-pack kernels' walk on the host: the whole two-level table
    as one tree, in the kernels' node order, with counters. Returns
    (answers, Work) as ``_walk`` does; they must equal the plain per-pack
    walks' (``intersect._tri_bvh_candidates_multi``,
    ``_tri_bvh_anyhit_multi``)."""
    dec = decode(mt)
    return _walk((dec,), o, d, int_eps, t_cap, top=dec.count < 0)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build_kernels():
    """Compile (once per source hash) and load the kernel library.

    Returns ``(lib, seconds, compiler log)``; ``seconds`` is 0 and the log
    empty when the library was already loaded or built. Raises when the
    build fails: there is no fallback.
    """
    with _LOCK:
        if "lib" in _LIB:
            return _LIB["lib"], 0.0, ""
        t0 = time.perf_counter()
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"bvh_traverse-{digest}.so")
        log = ""
        if not os.path.exists(so):
            tmp = f"{so}.tmp{os.getpid()}"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
            os.replace(tmp, so)
            _log.info("built %s:\n%s", so, log)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, (n_in, n_out) in C_ARGS.items():
            fn = getattr(lib, f"rt795_bvh_{name}")
            fn.argtypes = [p] * n_in + [i, i] + [p] * n_out
            fn.restype = i
        _LIB["lib"] = lib
        return lib, time.perf_counter() - t0, log


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})")


def _kernel_args(tb, o: Vec3, d: Vec3, int_eps, extra=()):
    """Validated pointer arguments shared by the kernels: (rays, extra
    per-ray inputs, tables). ``tb`` is a ``TraverseTables`` or a
    ``MultiTables``; both give nodes, tris and the node count."""
    dev = o.x.device
    if dev.type != "cuda":
        raise ValueError(f"the traversal kernels run on CUDA, not {dev}")
    n = o.x.shape[0]
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o, *d)):
        _check(name, c, torch.float32, (n,), dev)
    for name, c in extra:
        _check(name, c, torch.float32, (n,), dev)
    _check("nodes", tb.nodes, torch.float32, (tb.n_nodes, 8), dev)
    _check("tris", tb.tris, torch.float32, (tb.tris.shape[0], 12), dev)
    _check("int_eps", int_eps, torch.float32, (), dev)
    return ([c.data_ptr() for c in (*o, *d)],
            [c.data_ptr() for _, c in extra],
            [c.data_ptr() for c in (tb.nodes, tb.tris, int_eps)])


def _launch(name: str, *args):
    """Launch kernel ``rt795_bvh_<name>`` on the current stream (or record
    it into the graph being captured there); count it."""
    lib, _, _ = build_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"rt795_bvh_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    graphs.count_launch(LAUNCHES, name)


def _ray_counter(device):
    """The persistent warps' ray counter (they take rays from it), zeroed."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def _nearest(name, tb, o: Vec3, d: Vec3, int_eps):
    rays, _, tables = _kernel_args(tb, o, d, int_eps)
    n = o.x.shape[0]
    key = torch.empty((n,), dtype=torch.float32, device=o.x.device)
    t = torch.empty_like(key)
    idx = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    if n:
        counter = _ray_counter(o.x.device)
        with torch.cuda.device(o.x.device):
            _launch(name, *rays, *tables, tb.n_nodes, n, counter.data_ptr(),
                    key.data_ptr(), t.data_ptr(), idx.data_ptr())
    return key, t, idx


def _anyhit(name, tb, o: Vec3, d: Vec3, t_cap, int_eps):
    rays, (cap,), tables = _kernel_args(tb, o, d, int_eps,
                                        extra=(("t_cap", t_cap),))
    n = o.x.shape[0]
    found = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    if n:
        counter = _ray_counter(o.x.device)
        with torch.cuda.device(o.x.device):
            _launch(name, *rays, cap, *tables, tb.n_nodes, n,
                    counter.data_ptr(), found.data_ptr())
    return found


def tri_bvh_nearest(tb: TraverseTables, o: Vec3, d: Vec3, int_eps):
    """Nearest-hit query: (|t| key, t, prim index in BVH order), [N] each.

    Key 3e38 (t 0, index 0) on a miss. CPU tensors take the plain walk.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_candidates(decode(tb), o, d, int_eps)
    return _nearest("nearest", tb, o, d, int_eps)


def tri_bvh_anyhit(tb: TraverseTables, o: Vec3, d: Vec3,
                   t_cap: torch.Tensor, int_eps) -> torch.Tensor:
    """Occlusion query: any triangle with t in (0, t_cap)? [N] bool.

    CPU tensors take the plain walk.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_anyhit(decode(tb), o, d, t_cap, int_eps)
    return _anyhit("anyhit", tb, o, d, t_cap, int_eps)


def tri_bvh_nearest_multi(mt: MultiTables, o: Vec3, d: Vec3, int_eps):
    """Nearest hit over all packs: (|t| key, t, prim index in the group's
    order), [N] each; key 3e38 on a miss.

    CPU tensors take the plain per-pack walk; the kernel gives its outputs
    bit for bit, the lower pack's prim at an exact |t| tie between packs
    included.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_candidates_multi(decode_multi(mt), o, d,
                                                   int_eps)
    return _nearest("nearest_multi", mt, o, d, int_eps)


def tri_bvh_anyhit_multi(mt: MultiTables, o: Vec3, d: Vec3,
                         t_cap: torch.Tensor, int_eps) -> torch.Tensor:
    """Occlusion query over all packs: [N] bool. CPU tensors take the
    plain per-pack walk."""
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_anyhit_multi(decode_multi(mt), o, d, t_cap,
                                               int_eps)
    return _anyhit("anyhit_multi", mt, o, d, t_cap, int_eps)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

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
launches the kernel or raises. The plain walks read the same tables,
decoded (``decode``, ``decode_multi``), and are what the kernels are held
to. ``walk_work`` is the plain walk with counters: the work behind the
kernels' bounds.

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
from raytracer795_tpu_torch.utils.vec3 import Vec3

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bvh_traverse.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# launches per kernel, counted where each wrapper launches its kernel
LAUNCHES = {"nearest": 0, "anyhit": 0, "nearest_multi": 0,
            "anyhit_multi": 0}
# packs a multi-pack kernel takes: its per-ray pack list is this long
# (csrc/bvh_traverse.cu kMaxPacks); rock1800k has 28
MAX_PACKS = 64
# pointer arguments of each C entry point before and after its two ints:
# rays (6), [t_cap], nodes, [offsets], tris, int_eps; then node or pack
# count, ray count; then [ray counter], outputs, stream
C_ARGS = {"nearest": (9, 5), "anyhit": (10, 3), "nearest_multi": (10, 4),
          "anyhit_multi": (11, 2)}

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
    a, e1, e2, ng = intersect.tri_components(vertices, tri_vidx)
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


def _decode_nodes(nodes: torch.Tensor):
    """bmin, bmax, first, count and the tree-local miss of a node table."""
    ni = nodes.view(torch.int32)
    link, count = ni[:, 3], ni[:, 7]
    leaf = count > 0
    after = torch.arange(1, nodes.shape[0] + 1, dtype=torch.int32,
                         device=nodes.device)
    return (Vec3(nodes[:, 0], nodes[:, 1], nodes[:, 2]),
            Vec3(nodes[:, 4], nodes[:, 5], nodes[:, 6]),
            torch.where(leaf, link, 0), count, torch.where(leaf, after, link))


def _decode_tris(tr: torch.Tensor):
    return tuple(Vec3(tr[:, k], tr[:, k + 1], tr[:, k + 2])
                 for k in (0, 3, 6, 9))


def decode(tb: TraverseTables) -> Decoded:
    bmin, bmax, first, count, miss = _decode_nodes(tb.nodes)
    a, e1, e2, ng = _decode_tris(tb.tris)
    return Decoded(bmin=bmin, bmax=bmax, first=first, count=count,
                   miss=miss, a=a, e1=e1, e2=e2, ng=ng,
                   max_leaf=tb.max_leaf, n_nodes=tb.n_nodes)


@dataclasses.dataclass
class MultiTables:
    """The multi-pack kernels' tables for one group of K packs.

    ``nodes`` [M, 8] f32: every pack's nodes in the layout of
    ``TraverseTables``, pack after pack; inner links stay pack-local and
    leaf ``first``s are global. ``offsets`` [K + 1] int32: pack p owns
    nodes [offsets[p], offsets[p + 1]); its root is node offsets[p].
    ``tris`` [T, 12] f32: the group's one triangle table, in pack order.
    """

    nodes: torch.Tensor
    offsets: torch.Tensor
    tris: torch.Tensor
    max_leaf: int

    @property
    def n_packs(self) -> int:
        return self.offsets.shape[0] - 1


def build_multi_tables(pack_bvhs, vertices: torch.Tensor,
                       tri_vidx: torch.Tensor) -> MultiTables:
    """Tables from a group's pack FlatBVHs and the LIVE vertices, as
    ``build_tables`` makes them for one FlatBVH: the packs' nodes and
    offsets once per group, the triangle rows on every call."""
    def make():
        def cat(field):
            return torch.cat([getattr(f, field) for f in pack_bvhs])

        sizes = [0] + [f.first.shape[0] for f in pack_bvhs]
        offsets = torch.tensor(sizes, dtype=torch.int32).cumsum(
            0, dtype=torch.int32)
        links = torch.cat([_links(f) for f in pack_bvhs])
        return (_node_rows(cat("bmin"), cat("bmax"), links, cat("count")),
                offsets.to(pack_bvhs[0].first.device))

    nodes, offsets = _build_nodes(pack_bvhs[0].first, make)
    return MultiTables(
        nodes=nodes, offsets=offsets, tris=_tri_rows(vertices, tri_vidx),
        max_leaf=max(f.max_leaf for f in pack_bvhs))


def decode_multi(mt: MultiTables) -> Tuple[Decoded, ...]:
    """The tables read back as one ``Decoded`` per pack, each over the
    group's whole triangle table (its ``first`` is global)."""
    a, e1, e2, ng = _decode_tris(mt.tris)
    bounds = mt.offsets.tolist()
    packs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        bmin, bmax, first, count, miss = _decode_nodes(mt.nodes[lo:hi])
        packs.append(Decoded(
            bmin=bmin, bmax=bmax, first=first, count=count, miss=miss,
            a=a, e1=e1, e2=e2, ng=ng, max_leaf=mt.max_leaf,
            n_nodes=hi - lo))
    return tuple(packs)


class Work(NamedTuple):
    """A walk's work per ray, [N] int64 each."""

    nodes: torch.Tensor     # node visits (slab tests)
    leaves: torch.Tensor    # leaves whose triangles were tested
    tris: torch.Tensor      # triangle tests


def _counted_walk(dec: Decoded, o: Vec3, d: Vec3, int_eps, limit, cap,
                  work: torch.Tensor):
    """One tree's plain walk with counters added into ``work`` [3, N]: the
    walk of ``intersect._tri_bvh_candidates`` when ``cap`` is None (``limit``
    [N], each ray's best |t| so far, is updated), else that of
    ``intersect._tri_bvh_anyhit``, whose answers are returned. An any-hit
    leaf counts its triangles up to the first that occludes."""
    found = None if cap is None else torch.zeros_like(cap, dtype=torch.bool)
    w = intersect._Walk(dec, o, d, int_eps)
    lim = (limit if cap is None else cap)[w.lane]
    while w.lane.shape[0]:
        box_hit, entry, is_leaf = w.visit()
        box_hit = box_hit & ~(entry > lim)
        work[0, w.lane] += 1
        li = torch.nonzero(box_hit & is_leaf)[:, 0]
        got = torch.zeros_like(box_hit)
        if li.shape[0]:
            ok, tt, _ = w.leaf_tests(li)
            count = dec.count[w.node[li]].long()
            work[1, w.lane[li]] += 1
            if cap is None:
                k = torch.where(ok, torch.abs(tt), intersect._BIG)
                lim[li] = torch.minimum(lim[li], k.min(dim=1).values)
                work[2, w.lane[li]] += count
            else:
                occ = ok & (tt > 0) & (tt < lim[li][:, None])
                hit = occ.any(dim=1)
                upto = occ.to(torch.uint8).argmax(dim=1) + 1
                work[2, w.lane[li]] += torch.where(hit, upto, count)
                got[li] = hit
        w.advance(box_hit & ~is_leaf)
        done = got | (w.node >= dec.n_nodes)
        (lanes, lim_d, got_d), (lim, _) = w.retire(done, lim, got)
        if cap is None:
            limit[lanes] = lim_d
        else:
            found[lanes] = got_d
    return found


def walk_work(tables, o: Vec3, d: Vec3, int_eps, t_cap=None) -> Work:
    """Node visits, leaf visits and triangle tests of each ray's walk: the
    plain nearest walk (``t_cap`` None) or any-hit walk, with counters.

    For ``MultiTables`` the packs are walked in pack order, each from its
    root, with the best |t| (nearest) carried from pack to pack and a ray
    leaving at its first occluder (any-hit). It counts the work behind a
    kernel's bound (chip_smoke.py); nothing on the render path calls it.
    """
    n = o.x.shape[0]
    dev = o.x.device
    work = torch.zeros((3, n), dtype=torch.int64, device=dev)
    best = torch.full((n,), intersect._BIG, device=dev)
    trees = (decode_multi(tables) if isinstance(tables, MultiTables)
             else (decode(tables),))
    live = torch.arange(n, device=dev)
    for dec in trees:
        if t_cap is None:
            _counted_walk(dec, o, d, int_eps, best, None, work)
            continue
        sub = torch.zeros((3, live.shape[0]), dtype=torch.int64, device=dev)
        found = _counted_walk(dec, intersect._gather3(o, live),
                              intersect._gather3(d, live), int_eps, None,
                              t_cap[live], sub)
        work[:, live] += sub
        live = live[~found]
    return Work(*work)


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
    ``MultiTables``; the latter adds its pack offsets after ``nodes``."""
    dev = o.x.device
    if dev.type != "cuda":
        raise ValueError(f"the traversal kernels run on CUDA, not {dev}")
    n = o.x.shape[0]
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o, *d)):
        _check(name, c, torch.float32, (n,), dev)
    for name, c in extra:
        _check(name, c, torch.float32, (n,), dev)
    m = tb.nodes.shape[0]
    _check("nodes", tb.nodes, torch.float32, (m, 8), dev)
    tables = [tb.nodes]
    if isinstance(tb, MultiTables):
        if not 1 <= tb.n_packs <= MAX_PACKS:
            raise ValueError(f"the multi-pack kernels take 1 to {MAX_PACKS} "
                             f"packs, got {tb.n_packs}")
        _check("offsets", tb.offsets, torch.int32, (tb.n_packs + 1,), dev)
        tables.append(tb.offsets)
    _check("tris", tb.tris, torch.float32, (tb.tris.shape[0], 12), dev)
    _check("int_eps", int_eps, torch.float32, (), dev)
    tables += [tb.tris, int_eps]
    return ([c.data_ptr() for c in (*o, *d)],
            [c.data_ptr() for _, c in extra],
            [c.data_ptr() for c in tables])


def _launch(name: str, *args):
    """Launch kernel ``rt795_bvh_<name>`` on the current stream; count it."""
    lib, _, _ = build_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"rt795_bvh_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _scratch(name, device):
    """The single-pack kernels' ray counter (their persistent warps take
    rays from it), zeroed; the multi-pack kernels take none."""
    if name.endswith("_multi"):
        return []
    return [torch.zeros((1,), dtype=torch.int32, device=device)]


def _nearest(name, tb, o: Vec3, d: Vec3, int_eps, size: int):
    rays, _, tables = _kernel_args(tb, o, d, int_eps)
    n = o.x.shape[0]
    key = torch.empty((n,), dtype=torch.float32, device=o.x.device)
    t = torch.empty_like(key)
    idx = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    if n:
        scratch = _scratch(name, o.x.device)
        with torch.cuda.device(o.x.device):
            _launch(name, *rays, *tables, size, n,
                    *(c.data_ptr() for c in scratch), key.data_ptr(),
                    t.data_ptr(), idx.data_ptr())
    return key, t, idx


def _anyhit(name, tb, o: Vec3, d: Vec3, t_cap, int_eps, size: int):
    rays, (cap,), tables = _kernel_args(tb, o, d, int_eps,
                                        extra=(("t_cap", t_cap),))
    n = o.x.shape[0]
    found = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    if n:
        scratch = _scratch(name, o.x.device)
        with torch.cuda.device(o.x.device):
            _launch(name, *rays, cap, *tables, size, n,
                    *(c.data_ptr() for c in scratch), found.data_ptr())
    return found


def tri_bvh_nearest(tb: TraverseTables, o: Vec3, d: Vec3, int_eps):
    """Nearest-hit query: (|t| key, t, prim index in BVH order), [N] each.

    Key 3e38 (t 0, index 0) on a miss. CPU tensors take the plain walk.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_candidates(decode(tb), o, d, int_eps)
    return _nearest("nearest", tb, o, d, int_eps, tb.n_nodes)


def tri_bvh_anyhit(tb: TraverseTables, o: Vec3, d: Vec3,
                   t_cap: torch.Tensor, int_eps) -> torch.Tensor:
    """Occlusion query: any triangle with t in (0, t_cap)? [N] bool.

    CPU tensors take the plain walk.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_anyhit(decode(tb), o, d, t_cap, int_eps)
    return _anyhit("anyhit", tb, o, d, t_cap, int_eps, tb.n_nodes)


def tri_bvh_nearest_multi(mt: MultiTables, o: Vec3, d: Vec3, int_eps):
    """Nearest hit over all packs: (|t| key, t, prim index in the group's
    order), [N] each; key 3e38 on a miss.

    CPU tensors take the plain per-pack walk. Where two packs hold hits of
    exactly the same |t|, the plain walk keeps the lower pack and the
    kernel the pack it reached first; everything else is equal.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_candidates_multi(decode_multi(mt), o, d,
                                                   int_eps)
    return _nearest("nearest_multi", mt, o, d, int_eps, mt.n_packs)


def tri_bvh_anyhit_multi(mt: MultiTables, o: Vec3, d: Vec3,
                         t_cap: torch.Tensor, int_eps) -> torch.Tensor:
    """Occlusion query over all packs: [N] bool. CPU tensors take the
    plain per-pack walk."""
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_anyhit_multi(decode_multi(mt), o, d, t_cap,
                                               int_eps)
    return _anyhit("anyhit_multi", mt, o, d, t_cap, int_eps, mt.n_packs)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

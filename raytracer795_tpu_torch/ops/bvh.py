"""Flat BVH: host-side build (native C++ with a numpy fallback).

Counterpart of ``raytracer795_tpu/ops/bvh.py``, same layout and split rule:

    hit inner node i  -> visit i+1 (its left child, next in DFS order)
    miss node i       -> jump to miss[i] (= i + subtree_size)
    leaf node i       -> test prims [first, first+count), then jump miss[i]

Round-robin axis, median of centers, depth cap 30 (src/BVH.cpp:64-135),
leaves of up to ``LEAF_SIZE`` primitives. Primitives are permuted so every
leaf is a contiguous range; ``build`` returns the permutation. The native
builder and the numpy builder give the same hits; which one ran is logged.
"""

from __future__ import annotations

import ctypes
import logging
import sys
from typing import Tuple

import numpy as np

from raytracer795_tpu_torch import native
from raytracer795_tpu_torch.scene import types as T

LEAF_SIZE = 36
MAX_DEPTH = 30  # reference depth cap (src/BVH.cpp:42,55)

_log = logging.getLogger(__name__)


def _build_native(bmin, bmax, centers, leaf_size, max_depth):
    lib = native.load_bvh_builder()
    if lib is None:
        return None
    n = bmin.shape[0]
    fn = lib.rt795_build_bvh
    fn.restype = ctypes.c_int
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = [fp, fp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   fp, fp, ip, ip, ip, ip]
    cap = 2 * n
    node_bmin = np.empty((cap, 3), np.float32)
    node_bmax = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    miss = np.empty(cap, np.int32)
    perm = np.empty(n, np.int32)

    def p_f(a):
        return a.ctypes.data_as(fp)

    def p_i(a):
        return a.ctypes.data_as(ip)

    n_nodes = fn(p_f(bmin), p_f(bmax), p_f(centers), n, leaf_size,
                 max_depth, p_f(node_bmin), p_f(node_bmax),
                 p_i(first), p_i(count), p_i(miss), p_i(perm))
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return (node_bmin[s].copy(), node_bmax[s].copy(), first[s].copy(),
            count[s].copy(), miss[s].copy(), perm)


def _build_numpy(bmin, bmax, centers, leaf_size, max_depth):
    """The same algorithm in numpy, by explicit DFS recursion."""
    n = bmin.shape[0]
    perm = np.arange(n, dtype=np.int32)
    nb_min, nb_max, first, count, miss = [], [], [], [], []

    def emit(lo_i, hi_i, first_i, count_i):
        ids = perm[lo_i:hi_i]
        nb_min.append(bmin[ids].min(0))
        nb_max.append(bmax[ids].max(0))
        first.append(first_i)
        count.append(count_i)
        miss.append(-1)
        return len(first) - 1

    def build(lo, hi, depth, axis):
        c = hi - lo
        if c <= leaf_size:
            idx = emit(lo, hi, lo, c)
            miss[idx] = len(first)
            return
        if depth >= max_depth:
            for s in range(lo, hi, leaf_size):
                idx = emit(lo, hi, s, min(leaf_size, hi - s))
                miss[idx] = len(first)
            return
        idx = emit(lo, hi, 0, 0)
        mid = lo + c // 2
        seg = perm[lo:hi]
        order = np.argpartition(centers[seg, axis], mid - lo)
        perm[lo:hi] = seg[order]
        build(lo, mid, depth + 1, (axis + 1) % 3)
        build(mid, hi, depth + 1, (axis + 1) % 3)
        miss[idx] = len(first)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, max_depth * 8 + 64))
    try:
        build(0, n, 0, 0)
    finally:
        sys.setrecursionlimit(old)
    return (np.asarray(nb_min, np.float32), np.asarray(nb_max, np.float32),
            np.asarray(first, np.int32), np.asarray(count, np.int32),
            np.asarray(miss, np.int32), perm)


def build(prim_bmin: np.ndarray, prim_bmax: np.ndarray,
          leaf_size: int = LEAF_SIZE, max_depth: int = MAX_DEPTH,
          use_native: bool = True) -> Tuple[T.FlatBVH, np.ndarray]:
    """Build a flat BVH (numpy leaves) over per-primitive bboxes.

    Returns ``(FlatBVH, perm)``; the caller reorders its primitive SoA by
    ``perm`` so leaf (first, count) ranges address it directly.
    """
    prim_bmin = np.ascontiguousarray(prim_bmin, np.float32)
    prim_bmax = np.ascontiguousarray(prim_bmax, np.float32)
    centers = np.ascontiguousarray((prim_bmin + prim_bmax) * 0.5, np.float32)
    out = None
    if use_native:
        out = _build_native(prim_bmin, prim_bmax, centers, leaf_size,
                            max_depth)
    builder = "native"
    if out is None:
        builder = "numpy"
        out = _build_numpy(prim_bmin, prim_bmax, centers, leaf_size,
                           max_depth)
    nbmin, nbmax, first, count, miss, perm = out
    _log.info("flat BVH over %d primitives: %d nodes, %s builder",
              prim_bmin.shape[0], first.shape[0], builder)
    flat = T.FlatBVH(bmin=nbmin, bmax=nbmax, first=first, count=count,
                     miss=miss, max_leaf=int(leaf_size))
    return flat, perm


def tri_bounds(verts: np.ndarray, tri_vidx: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-triangle bboxes from a vertex pool + index array."""
    pts = verts[tri_vidx]          # [T, 3, 3]
    return pts.min(axis=1), pts.max(axis=1)

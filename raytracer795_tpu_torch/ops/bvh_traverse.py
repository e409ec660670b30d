"""BVH traversal on the card: tables, kernel build, and the two wrappers.

Counterpart of the single-pack half of ``raytracer795_tpu/ops/pallas_bvh.py``.
The kernels are hand-written CUDA C++ in ``csrc/bvh_traverse.cu`` (see the
note there for what they replace and what bounds them):

- ``tri_bvh_nearest`` replaces ``tri_bvh_nearest`` / ``_nearest_kernel``;
- ``tri_bvh_anyhit`` replaces ``tri_bvh_anyhit`` / ``_anyhit_kernel``.

Each wrapper takes the kernel path for CUDA tensors and the plain walk of
ops/intersect.py for CPU tensors, and for nothing else: a CUDA tensor
launches the kernel or raises. The plain walks read the same tables,
decoded (``decode``), and are what the kernels are held to.

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
from typing import NamedTuple

import torch

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
LAUNCHES = {"nearest": 0, "anyhit": 0}

_log = logging.getLogger(__name__)
_LOCK = threading.Lock()
_LIB: dict = {}


@dataclasses.dataclass
class TraverseTables:
    """The kernels' tables for one group (see csrc/bvh_traverse.cu).

    ``nodes`` [M, 8] f32: bmin.xyz, first (int32 bits), bmax.xyz, count
    (int32 bits). ``miss`` [M] int32. ``tris`` [T, 16] f32 in BVH order:
    a, e1 = a-b, e2 = a-c, ng = e1 x e2, each padded to a float4.
    """

    nodes: torch.Tensor
    miss: torch.Tensor
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


def build_tables(bvh: T.FlatBVH, vertices: torch.Tensor,
                 tri_vidx: torch.Tensor) -> TraverseTables:
    """Tables from a FlatBVH and the LIVE vertices (the counterpart of the
    JAX package's ``fresh_tri_rows``): a vertex update moves the geometry
    the kernels intersect, while node bounds stay those of the build."""
    a, e1, e2, ng = intersect.tri_components(vertices, tri_vidx)
    z = torch.zeros_like(a.x)
    tris = torch.stack([a.x, a.y, a.z, z, e1.x, e1.y, e1.z, z,
                        e2.x, e2.y, e2.z, z, ng.x, ng.y, ng.z, z], dim=1)
    # assembled as int32 so the index fields keep their bits exactly
    nodes = torch.cat([bvh.bmin.view(torch.int32), bvh.first[:, None],
                       bvh.bmax.view(torch.int32), bvh.count[:, None]],
                      dim=1).view(torch.float32)
    return TraverseTables(nodes=nodes, miss=bvh.miss.contiguous(),
                          tris=tris, max_leaf=bvh.max_leaf)


def decode(tb: TraverseTables) -> Decoded:
    nf, ni, tr = tb.nodes, tb.nodes.view(torch.int32), tb.tris
    return Decoded(
        bmin=Vec3(nf[:, 0], nf[:, 1], nf[:, 2]),
        bmax=Vec3(nf[:, 4], nf[:, 5], nf[:, 6]),
        first=ni[:, 3], count=ni[:, 7], miss=tb.miss,
        a=Vec3(tr[:, 0], tr[:, 1], tr[:, 2]),
        e1=Vec3(tr[:, 4], tr[:, 5], tr[:, 6]),
        e2=Vec3(tr[:, 8], tr[:, 9], tr[:, 10]),
        ng=Vec3(tr[:, 12], tr[:, 13], tr[:, 14]),
        max_leaf=tb.max_leaf, n_nodes=tb.n_nodes)


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
        lib.rt795_bvh_nearest.argtypes = [p] * 10 + [i, i] + [p] * 4
        lib.rt795_bvh_nearest.restype = i
        lib.rt795_bvh_anyhit.argtypes = [p] * 11 + [i, i] + [p] * 2
        lib.rt795_bvh_anyhit.restype = i
        _LIB["lib"] = lib
        return lib, time.perf_counter() - t0, log


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of shape {shape} on "
            f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device} "
            f"(contiguous={x.is_contiguous()})")


def _kernel_args(tb: TraverseTables, o: Vec3, d: Vec3, int_eps, extra=()):
    """Validated pointer arguments shared by both kernels."""
    dev = o.x.device
    if dev.type != "cuda":
        raise ValueError(f"the traversal kernels run on CUDA, not {dev}")
    n = o.x.shape[0]
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o, *d)):
        _check(name, c, torch.float32, (n,), dev)
    for name, c in extra:
        _check(name, c, torch.float32, (n,), dev)
    m = tb.n_nodes
    _check("nodes", tb.nodes, torch.float32, (m, 8), dev)
    _check("miss", tb.miss, torch.int32, (m,), dev)
    _check("tris", tb.tris, torch.float32, (tb.tris.shape[0], 16), dev)
    _check("int_eps", int_eps, torch.float32, (), dev)
    rays = [c.data_ptr() for c in (*o, *d)]
    return rays, [c.data_ptr() for _, c in extra], [
        tb.nodes.data_ptr(), tb.miss.data_ptr(), tb.tris.data_ptr(),
        int_eps.data_ptr()]


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def tri_bvh_nearest(tb: TraverseTables, o: Vec3, d: Vec3, int_eps):
    """Nearest-hit query: (|t| key, t, prim index in BVH order), [N] each.

    Key 3e38 (t 0, index 0) on a miss. CPU tensors take the plain walk.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_candidates(decode(tb), o, d, int_eps)
    rays, _, tables = _kernel_args(tb, o, d, int_eps)
    n = o.x.shape[0]
    key = torch.empty((n,), dtype=torch.float32, device=o.x.device)
    t = torch.empty_like(key)
    idx = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    if n == 0:
        return key, t, idx
    lib, _, _ = build_kernels()
    with torch.cuda.device(o.x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt795_bvh_nearest(*rays, *tables, tb.n_nodes, n,
                                    key.data_ptr(), t.data_ptr(),
                                    idx.data_ptr(), stream)
    _raise_on(err, "nearest")
    LAUNCHES["nearest"] += 1
    return key, t, idx


def tri_bvh_anyhit(tb: TraverseTables, o: Vec3, d: Vec3,
                   t_cap: torch.Tensor, int_eps) -> torch.Tensor:
    """Occlusion query: any triangle with t in (0, t_cap)? [N] bool.

    CPU tensors take the plain walk.
    """
    if o.x.device.type == "cpu":
        return intersect._tri_bvh_anyhit(decode(tb), o, d, t_cap, int_eps)
    rays, (cap,), tables = _kernel_args(tb, o, d, int_eps,
                                        extra=(("t_cap", t_cap),))
    n = o.x.shape[0]
    found = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    if n == 0:
        return found
    lib, _, _ = build_kernels()
    with torch.cuda.device(o.x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt795_bvh_anyhit(*rays, cap, *tables, tb.n_nodes, n,
                                   found.data_ptr(), stream)
    _raise_on(err, "anyhit")
    LAUNCHES["anyhit"] += 1
    return found


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0

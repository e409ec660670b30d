"""Chip smoke test: the PyTorch/CUDA port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failed check raises, so the script exits
non-zero and prints no result:

1. device: require CUDA; print the card's name and power limit.
2. build: compile csrc/bvh_traverse.cu with nvcc (sm_90a) into build/;
   ptxas's registers and spills are printed, and a spill fails.
3. kernel vs plain, on the card: random meshes with NaN, zero and d == 0
   rays, then rock100k's own primary wavefront (400x400, 160k rays) and its
   first shadow wavefront. Every single-pack kernel query runs twice; keys,
   t and prim ids on every lane and any-hit answers must equal the plain
   walk's bit for bit, and the repeat the first run. The same holds on the
   moved-vertex and axis-aligned vertex-exact cases of
   tests/test_torch_traverse.py at 131,072 rays, rock100k's mostly dead
   mirror-bounce wavefront, 0, 1, 31, 33 and 129 live shadow rays, and
   shadow caps of 0 and +inf.
4. main path: ``render_scene`` of tests/scenes/rock100k.xml on cuda, with
   the launch counters reset just before and read just after; the frame
   must match tests/goldens/rock100k.ppm at frac(|dLDR| > 1) < 1e-4. The
   six texture-free deterministic goldens (simple, cornellbox, brdfs,
   lights, transforms, instances) must meet their bounds.
5. times on this card: median of 5 rock100k frames after a warm-up at
   400x400 and 800x800 (1 spp), and kernel vs plain walk times for one
   primary, one shadow and the mirror-bounce wavefront at 400x400. Each kernel time (here and
   in phases 9 and 15) is printed beside its bound, the larger of the
   query's bytes over the memory rate and its operations (node visits
   and triangle tests counted by ``walk_work``) over the fp32 rate
   without FMA, and beside the kernel's time before (``BEFORE_MS``).
6. multi-pack kernels vs plain, on the card, each query twice: keys, t,
   prim ids and any-hit answers must equal the plain per-pack walks' bit
   for bit (``tie_lanes``, hit lanes whose ids differ, is printed and is
   0), and the repeat the first run. Cases: random meshes in 5 and 71
   packs (over the 64 the kernels once took), knife-edge lanes
   (``knife_edge_rays``: NaN, +-0, denormal and infinite direction
   components, infinite origins, origins on pack-root planes, caps 0 and
   +inf) over both and over rock1800k, the hand-built case of the
   top-node rule, rock1800k's primary and first shadow wavefronts
   (tests/scenes/rock1800k.ply is written by scene/assets.py when
   missing; 1,800,902 triangles in 28 packs), 0, 1, 31, 33 and 129 of its
   shadow rays and the whole shadow wavefront with caps 0 and +inf.
7. main path at dragon scale: ``render_scene`` of rock1800k; the counters
   must show multi-pack launches and no single-pack launch, and the frame
   must match tests/goldens/rock1800k.ppm at frac(|dLDR| > 1) < 1e-4.
8. instances: the single-pack kernels vs their plain walks at this path's
   shapes (instances_rock's primary and first shadow wavefronts, each
   carried into the 37 instances' local spaces and concatenated: 5.9M
   lanes over the 6,242-triangle tree), with the checks of phase 3; then
   ``render_scene`` of instances_rock (one launch a query for all 37
   instances) against its golden at mean < 0.2 and frac>2 < 0.01; the
   launch counts are printed.
9. times: rock1800k load and frame (median of 5 after a warm-up), the
   multi-pack kernels vs their plain versions on its two wavefronts (each
   beside its bound and the per-thread multi-pack kernels' time), one
   profiled rock1800k frame (kernels run, device ms, the traversal
   kernels' ms, and the triangle-row rebuild's: its calls in a frame
   times one call's CUDA-event ms), the single-pack kernels on
   instances_rock's two batched queries and over one BVH of rock1800k's
   triangles (a probe), instances_rock frames with batched against
   per-group launches, and one profiled instances_rock frame.
10. rng: ``utils/rng`` on the card gives the bits it gives on the CPU, and
   the literal ``jax.random`` values of tests/test_torch_rng.py.
11. multi-sample main path: ``render_scene`` of rock100k at 800x800 and
   4 spp (bench_mesh.py's configuration) with the launch counters reset
   just before and read just after; both single-pack kernels launched and
   no plain walk called; 8x8-pooled means within 3 of the 1-spp golden
   (the frame averaged 2x2 to its 400x400); frame median of 5 and one
   profiled frame (kernel launches, device time, the traversal kernels'
   device ms and share of it, the costliest kernels, RNG draws).
12. stochastic goldens: arealight, motionblur and distributed at their own
   resolution and spp, at tests/test_golden.py:45-50's bounds.
13. path tracer, Cornell: tests/scenes/cornellbox_pt.xml at 800x800, 4 spp,
   depth 6 with NEE and importance sampling (bench.py's configuration):
   frame median of 5, gross rays/s (bench.py:47-56), one profiled frame.
14. path tracer, analytic: the furnace closed form and the NEE floor-point
   integral of tests/test_path_tracer.py:43-80.
15. path tracer through the kernels: ``render_scene`` of
   tests/scenes/rock100k_pt.xml at 400x400 and 4 spp with the counters
   reset just before and read just after (both single-pack kernels
   launched, no plain walk); the kernels vs their plain walks on the
   first diffuse-bounce wavefront and the first NEE wavefront with its
   per-ray caps, with their times; its frame median of 5 and one profiled
   frame; and a 64x64,
   2-spp frame rendered twice, once through the kernels and once with the
   wrappers swapped for the plain walks: the LDR frames must be equal.
16. textures, the environment light and image backgrounds: whether PIL
   imports here is printed (the port reads PNG, JPEG and EXR itself); the
   textures, background and ply_smooth goldens at tests/test_golden.py's
   mean and frac>2 bounds and the envlight golden at its sky, pooled and
   mean bounds; ``render_scene`` of tests/scenes/rock100k_tex.xml (rock100k
   with Perlin color and bump on the rock, image color and bump on the
   floor, a JPEG background) at 400x400 with the counters reset just
   before and read just after (both single-pack kernels launched, no
   multi-pack launch, no plain walk) against the JAX package's frame
   tests/goldens/rock100k_tex_jax.ppm at frac(|dLDR| > 1) < 1e-4; its
   800x800 frame median of 5 beside rock100k's from phase 5; one profiled
   800x800 frame of each (kernels run, device ms, busy share, the
   traversal kernels' ms) and the texture stage's device ms and kernels
   (every ``apply_textures`` call of the frame, replayed under the
   profiler).
17. gradients: the differentiable rock100k frame (400x400, autograd on,
   iterations checkpointed) equals the forward frame bit for bit through
   the same kernels; one ``train_step_with_grads`` each of rock100k,
   rock100k_pt and rock1800k (phase 6's loaded scene) at 400x400 and 1 spp
   on every differentiable parameter, toward 0.9 x the scene's own frame:
   loss, max |g| of each family, every gradient finite, the families the
   scene drives nonzero, the traversal launches split at
   ``torch.autograd.grad`` into the forward and the backward pass (both
   > 0, no plain walk, rock1800k multi-pack only), its triangle rows free
   of a graph; the median forward frame and step (3 after a warm-up), a
   profiled step (kernels, host launches, device ms, the costliest
   kernels) and the step's ``max_memory_allocated``. Three rock100k steps
   with tests/test_parallel.py's rates and three vertex-only steps must
   descend; ply_smooth's vertex gradient (``bvh_min_tris=1``, 24x24,
   tests/test_tpu.py:75-128) through the kernels must equal the CPU port's
   through the plain walks at rtol 2e-3, atol 2e-3 max|g|, and two card
   runs must give the same bits. The gathers' backward (ops/gather.py)
   at the step's 160k lanes (2 rows of 3, and rock100k's 101,762 triangle
   records of 31 with long runs on row 0 and two floor rows) must equal
   the accumulating ``index_put_`` at rtol 1e-5 on gradients that sum
   exactly in any order, lie within rtol 1e-5 of a float64 sum, repeat
   bit for bit and keep a NaN lane in its own row; both times are
   printed, each step's ``indexing_backward*`` ms beside its step over
   forward, and, on the rock100k step's own lanes, each gather backward's
   error against a float64 sum beside ``index_put_``'s.
18. checkpoints, tonemap and EXR, scale-out: rock100k at 800x800 killed
   and resumed from its checkpoint at 4 and 1 spp (bit-equal to the whole
   film, fewer launches), a save's cost a band, the CLI with
   ``--checkpoint-dir`` on a tonemapped-PNG + EXR variant (exact bytes; the
   rerun launches nothing), rock100k and rock1800k rays split over the card
   listed once and twice (bit-equal), a two-shard train step, and
   ``torch.distributed.run`` of two ranks on the card (PNG bytes equal to
   the one-process CLI's).
19. the profiler, net rays and the bench entry points: ``profile_scene`` of
   rock100k at 512x512 (the JAX module's stages in its order, every time
   above 0; ``trace`` launches one nearest kernel and ``trace_anyhit`` one
   any-hit kernel, and no plain walk runs), and ``profiling.main`` with
   ``--trace-dir`` writing a trace that names ``nearest_kernel<false>``; a
   400x400 rock100k band with stats bit-equal to the band without; the
   net-ray counts of rock100k (400x400), rock1800k (400x400, multi-pack
   launches only) and cornellbox_pt (800x800, 4 spp), each twice and
   equal, between the lanes and the gross count; the 64x64, 2-spp
   cornellbox_pt count on the card within 0.1% of the CPU port's; then
   ``bench.main`` and ``bench_mesh.main`` (phase 4's rock100k and phase
   6's rock1800k passed in): four lines that parse, carry the card and
   have 0 < net rays/s <= gross rays/s. Its wall time is printed.
20. the benchmark's cells (BENCHMARK.json, ``benchmark/run.py``): each
   cell's ``run_cell`` once, at one warm-up and one timed frame or step
   (the cells' own counts are the benchmark's), on phase 4's
   rock100k and phase 6's rock1800k and on cornellbox_pt and rock100k_tex
   loaded anew: every metric the cell lists is printed and set (the
   reused scenes' ``load_s`` excepted), its correctness checks pass (each
   entry of its ``checks``: reference frames at the scene's and at the
   cell's own res and spp, or the train step's gradients and change
   against the JAX package's, and the step's loss, repeatability and lr-0
   update; no plain walk; the scene's traversal kernels and no other
   launched),
   ``bvh_kernel_ms`` > 0 where the cell lists it, and cornellbox_pt
   launches no traversal kernel. Its wall time is printed.
21. graphed frames (``utils/graphs.py``): cornellbox_pt, rock100k,
   rock100k_pt, rock1800k, rock100k_tex and instances_rock at 800x800 and
   their cells' spp (4, 4, 4, 1, 1, 1), each rendered through its
   captured graphs and op by op (``render_camera(..., _graphs=False)``):
   float and LDR frames bit for bit, equal traversal launches, no capture
   for seeds 2 and 3 after seed 1's frames; the captures, the median of 5
   frames each way, the profiler's kernels and the host's kernel and graph
   launch calls of one frame each way (the card's kernels alone for the
   op-by-op frames of ``CARD_ONLY_TRACE``), the peak allocation of the
   capturing frame (at most ``CAPTURE_PEAK_OVER_EAGER`` times the op-by-op
   frame's) and of a frame each way, and ``count_net_rays`` each way on
   ``GRAPH_NET_SCENES`` (equal); then cornellbox_pt killed after 5
   checkpoint saves and resumed through the graphs, bit for bit the
   op-by-op film; and rock100k's eager train step at ``GRAD_RES``, in
   alternating rounds on a scene without programs and on one whose graphed
   frame captured them: the median step a round and the peak allocation,
   the losses equal. Its wall time is printed.

Every ``render_camera`` frame on the card runs through captured graphs
(phase 21 holds them to op-by-op frames); a phase that spies on Python
calls during a frame (recorded queries, counted draws or row rebuilds,
the per-group instances dispatch, the plain-walk frame) renders that
frame op by op.

The ``kernels`` line's launch counts are summed over the main paths that
run each kernel (phases 4, 7, 8, 11, 15 and 16, phase 17's three train
steps, forward and backward, phase 18's resumed frames, CLI runs, sharded
frames and step, phase 19's profile, net counts and benches, phase 20's
timed frames and steps, and phase 21's graphed frames, each counted from
0); a graphed frame counts each launch its graphs replay. The
last three lines are the card, the kernels' JSON record and the result line;
the wall time is printed on an earlier line. It imports nothing of jax or
of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import re
import signal
import statistics
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "tests", "scenes")
GOLDENS = os.path.join(HERE, "tests", "goldens")
OUT = os.path.join(HERE, "build", "chip_smoke")
FRAME_RES = (400, 800)      # rock100k frame sizes timed in phase 5
FRAME_REPS = 5
# the texture-free deterministic goldens: (scene, mean tol, frac>2 tol) of
# tests/test_golden.py:22-33
GOLDEN_BOUNDS = (("simple", 0.01, 0.001), ("cornellbox", 0.01, 0.001),
                 ("brdfs", 0.01, 0.001), ("lights", 0.01, 0.001),
                 ("transforms", 0.2, 0.01), ("instances", 0.2, 0.01))
# jax.random under jax 0.9.0, as tests/test_torch_rng.py holds them against
# jax itself: PRNGKey(0), fold_in(PRNGKey(0), 3) and the uint32 views of
# uniform(fold_in(PRNGKey(0), 3), (2, 5))
RNG_KEY0 = (0, 0)
RNG_KEY0_FOLD3 = (2467461003, 3840466878)
RNG_UNIFORM_2x5_BITS = [[1049146072, 1060889640, 1064576818, 1045860880,
                         1007892352],
                        [1062247070, 1064149282, 1049439860, 1063452586,
                         1064178726]]
# (scene, mean tol, p99 tol) of tests/test_golden.py:45-50
STOCHASTIC_BOUNDS = (("arealight", 2.0, 12.0), ("motionblur", 2.0, 12.0),
                     ("distributed", 2.5, 14.0))
# (scene, mean tol, frac>2 tol) of tests/test_golden.py:30-32
TEXTURE_GOLDENS = (("textures", 0.05, 0.002), ("background", 0.05, 0.002),
                   ("ply_smooth", 0.2, 0.01))
MS_RES, MS_SPP = 800, 4     # bench_mesh.py's and bench.py's frames
PT_RES, PT_SPP = 400, 4     # rock100k_pt's main path
PLAIN_WALKS = ("_tri_bvh_candidates", "_tri_bvh_anyhit",
               "_tri_bvh_candidates_multi", "_tri_bvh_anyhit_multi")
REPLACES = {name: f"raytracer795_tpu/ops/pallas_bvh.py:{line}"
            for name, line in (("nearest", 335), ("anyhit", 404),
                               ("nearest_multi", 767),
                               ("anyhit_multi", 835))}
# each wrapper's kernel as a trace names it: the multi-pack kernels are the
# single-pack ones instantiated for a two-level table
KERNEL_SYMBOLS = {"nearest": "nearest_kernel<false>",
                  "anyhit": "anyhit_kernel<false>",
                  "nearest_multi": "nearest_kernel<true>",
                  "anyhit_multi": "anyhit_kernel<true>"}
# The card's peak rates (H100 SXM datasheet, 700 W):
# HBM bytes a second, and fp32 operations a second without FMA
# contraction. The kernels build with -fmad=false, so every add, multiply
# and compare is an instruction of its own: half the 67 TFLOP/s that
# counts an FMA as two.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_OPS_S = 33.5e12
# Operations a node visit and a triangle test need at least: the slab
# test (3 axes x (2 subtractions, 2 multiplications, a max, a min), the
# box and prune compares) and the triangle test up to t (a - o 3, e2 x d 9,
# det 5, 1/det 1, t 6, 2 compares); the exact early exit skips the rest
# for most triangles.
NODE_OPS = 20
TRI_OPS = 26
# Times of the one-thread-a-ray kernels that the persistent single-pack
# kernels replaced, and of the per-thread multi-pack kernels that the
# two-level walk replaced (PERF.md section 6, CUDA events, H100, 700 W), ms
BEFORE_MS = {("nearest", "rock100k primary"): 0.934,
             ("anyhit", "rock100k first shadow"): 1.254,
             ("nearest", "rock100k_pt first diffuse bounce"): 1.536,
             ("anyhit", "rock100k_pt first NEE"): 1.471,
             ("nearest_multi", "rock1800k primary"): 2.142,
             ("anyhit_multi", "rock1800k first shadow"): 5.961}
RAGGED_N = (0, 1, 31, 33, 129)
EDGE_RAYS = 131072          # rays of the moved-vertex and axis-aligned cases
GRAD_RES = 400              # the train steps' frames: one band, 1 spp
GRAD_REPS = 3               # timed forward frames and steps after a warm-up
# tests/test_parallel.py:112-113's per-parameter rates
TRAIN_LRS = {"diffuse": 1e-4, "specular": 1e-4, "ambient": 1e-4,
             "mirror": 1e-4, "point_intensity": 1e-1}
# the vertex-only steps' size: a first-order loss decrease of this share
# of the loss (tests/test_tpu.py:130-139's fixed 2e-4 is sized for 24x24)
VERTEX_STEP_DECREASE = 1e-3
# the host's kernel launch calls, as the profiler names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
# and its graph launch calls
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
# the JAX profiler's stages, in its order (raytracer795_tpu/profiling.py:
# 70-79), and its default wavefront size
PROFILE_STAGES = ("ray_gen", "trace", "trace_anyhit", "hit_details",
                  "apply_textures", "direct_lighting", "full_frame")
PROFILE_RES = 512
# phase 21's frames: each scene at 800x800 and its benchmark cell's spp
# (4 for rock100k_pt, 1 for instances_rock, which have no cell)
GRAPH_RES = 800
GRAPH_SCENES = (("cornellbox_pt", 4), ("rock100k", 4), ("rock100k_pt", 4),
                ("rock1800k", 1), ("rock100k_tex", 1), ("instances_rock", 1))
# the scenes whose op-by-op frame phase 21 traces on the card alone: a
# host trace of their 130k-170k eager launches takes about a minute
CARD_ONLY_TRACE = ("cornellbox_pt", "rock100k_pt")
# the scenes whose net rays phase 21 counts both ways
GRAPH_NET_SCENES = ("cornellbox_pt", "rock100k")
# a graphed frame's first (capturing) frame may hold its warm-up and its
# programs' pool beside the eager frame's peak; a pool per graph would
# hold one a trip (cornellbox_pt runs 6 bounces, rock100k 3 iterations)
CAPTURE_PEAK_OVER_EAGER = 4.0
# phase 21 (c): rounds of the eager train step beside a scene's programs,
# and the timed steps of each side a round (after one warm-up step)
STEP_ROUNDS = 4
STEP_REPS = 8


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name, **fields):
    """One phase line; ``t_s`` is the host seconds since the script began."""
    print(json.dumps({"phase": name, **fields,
                      "t_s": time.perf_counter() - T0}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def png_pixels(path: str) -> np.ndarray:
    """Pixels of an 8-bit RGB PNG as the port writes it (filter 0 rows)."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(bt, tb, o, d, cap, eps):
    """The single-pack kernels vs their plain walks on the card, each
    kernel query run twice: every output (|t| key, t and prim id on every
    lane, any-hit answer) must equal the plain walk's bit for bit, and the
    repeat the first run.

    Returns (max |dt|, any-hit mismatches, hits, occluded)."""
    from raytracer795_tpu_torch.ops import intersect

    dec = bt.decode(tb)
    runs = [(*bt.tri_bvh_nearest(tb, o, d, eps),
             bt.tri_bvh_anyhit(tb, o, d, cap, eps)) for _ in range(2)]
    pkey, pt, pidx = intersect._tri_bvh_candidates(dec, o, d, eps)
    pfound = intersect._tri_bvh_anyhit(dec, o, d, cap, eps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "a repeated kernel query gave other outputs")
    key, t, idx, found = runs[0]
    hit = key < 1e38
    check(torch.equal(hit, pkey < 1e38), "nearest hit masks differ")
    check(torch.equal(key, pkey), "nearest |t| keys differ")
    check(torch.equal(idx, pidx), "nearest prim ids differ")
    err = float((t - pt).abs().max()) if t.numel() else 0.0
    check(torch.equal(t, pt), f"nearest t differs by {err}")
    mismatches = int((found != pfound).sum())
    check(mismatches == 0, f"{mismatches} any-hit answers differ")
    return err, mismatches, int(hit.sum()), int(found.sum())


def col3(a, dev):
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                  for k in range(3)))


def random_inputs(t, n, seed):
    """A random mesh and rays with d == 0 components, NaN origins, zero
    directions, and per-lane caps (tests/test_pallas.py:32-52)."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(t * 3, 3)).astype(np.float32)
    tri_vidx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 16, 1] = 0.0
    o[n // 16: n // 8] = np.nan
    d[n // 8: 3 * n // 16] = 0.0
    cap = rng.uniform(0.1, 5.0, n).astype(np.float32)
    return verts, tri_vidx, o, d, cap


def knife_edge_rays(packs, n, seed):
    """Rays on the knife edges of a packed group's top tree: (o, d, cap)
    float32 numpy arrays. Every origin lies EXACTLY on a plane of some pack
    root's box (its bmin or bmax on one axis, inside the box on the
    others), and the lanes cycle through eight kinds: a +0, -0 or
    denormal (+-1e-40) direction component on that axis, an infinite
    direction component, an infinite origin component, a NaN, a zero
    direction, and a plain direction. Caps cycle through 0, +inf and a
    random one."""
    rng = np.random.default_rng(seed)
    def root(box):
        return np.asarray(box[0].cpu() if torch.is_tensor(box) else box[0])
    lo = np.stack([root(f.bmin) for f in packs])
    hi = np.stack([root(f.bmax) for f in packs])
    lane = np.arange(n)
    p = rng.integers(0, len(packs), n)
    ax = rng.integers(0, 3, n)
    o = rng.uniform(lo[p], hi[p]).astype(np.float32)
    o[lane, ax] = np.where(rng.random(n) < 0.5, hi[p, ax], lo[p, ax])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sign = rng.choice(np.float32([-1, 1]), n)
    kind = lane % 8
    k = kind == 0
    d[k, ax[k]] = np.where(sign[k] > 0, np.float32(0.0), np.float32(-0.0))
    k = kind == 1
    d[k, ax[k]] = sign[k] * np.float32(1e-40)
    k = kind == 2
    d[k, (ax[k] + 1) % 3] = sign[k] * np.float32(np.inf)
    k = kind == 3
    o[k, (ax[k] + 1) % 3] = sign[k] * np.float32(np.inf)
    k = (kind == 4) & (lane % 16 < 8)
    o[k, ax[k]] = np.nan
    k = (kind == 4) & (lane % 16 >= 8)
    d[k, ax[k]] = np.nan
    d[kind == 5] = 0.0
    k = kind == 6
    d[k, ax[k]] = 0.0
    d[k, (ax[k] + 1) % 3] = 0.0
    cap = rng.uniform(0.1, 5.0, n).astype(np.float32)
    cap[lane % 3 == 0] = 0.0
    cap[lane % 3 == 1] = np.inf
    return o, d, cap


def random_case(bt, t, n, seed, dev):
    from raytracer795_tpu_torch.ops import bvh
    from raytracer795_tpu_torch.scene.types import to_device

    verts, tri_vidx, o, d, cap = random_inputs(t, n, seed)
    flat, perm = bvh.build(*bvh.tri_bounds(verts, tri_vidx))
    tb = bt.build_tables(to_device(flat, dev),
                         torch.from_numpy(verts).to(dev),
                         torch.from_numpy(tri_vidx[perm]).to(dev))
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    return compare(bt, tb, col3(o, dev), col3(d, dev),
                   torch.from_numpy(cap).to(dev), eps)


def compare_multi(bt, mt, o, d, cap, eps):
    """The multi-pack kernels vs their plain per-pack walks on the card,
    each kernel query run twice: every output (|t| key, t and prim id on
    every lane, any-hit answer) must equal the plain walks' bit for bit,
    and the repeat the first run.

    Returns (max |dt|, any-hit mismatches, hits, occluded, tie lanes: hit
    lanes whose prim id differs, 0 when the ids are equal)."""
    from raytracer795_tpu_torch.ops import intersect

    packs = bt.decode_multi(mt)
    runs = [(*bt.tri_bvh_nearest_multi(mt, o, d, eps),
             bt.tri_bvh_anyhit_multi(mt, o, d, cap, eps)) for _ in range(2)]
    pkey, pt, pidx = intersect._tri_bvh_candidates_multi(packs, o, d, eps)
    pfound = intersect._tri_bvh_anyhit_multi(packs, o, d, cap, eps)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "a repeated multi-pack kernel query gave other outputs")
    key, t, idx, found = runs[0]
    hit = key < 1e38
    ties = int((hit & (idx != pidx)).sum())
    check(torch.equal(hit, pkey < 1e38), "multi nearest hit masks differ")
    check(torch.equal(key, pkey), "multi nearest |t| keys differ")
    check(torch.equal(idx, pidx),
          f"multi nearest prim ids differ on {ties} hit lanes")
    err = float((t - pt).abs().max()) if t.numel() else 0.0
    check(torch.equal(t, pt), f"multi nearest t differs by {err}")
    mismatches = int((found != pfound).sum())
    check(mismatches == 0, f"{mismatches} multi any-hit answers differ")
    return err, mismatches, int(hit.sum()), int(found.sum()), ties


def multi_case(bt, t, n, seed, pack_tris, dev, knife=False):
    """A random mesh cut into packs of ``pack_tris`` with the rays of
    ``random_inputs`` or, with ``knife``, ``knife_edge_rays``: (packs, the
    kernels' tables, o, d, cap, eps) on ``dev``."""
    from raytracer795_tpu_torch.ops import bvh
    from raytracer795_tpu_torch.scene.types import to_device

    verts, tri_vidx, o, d, cap = random_inputs(t, n, seed)
    perm, packs = bvh.build_multipack(verts, tri_vidx, pack_tris=pack_tris)
    if knife:
        o, d, cap = knife_edge_rays(packs, n, seed + 1)
    mt = bt.build_multi_tables(to_device(packs, dev),
                               torch.from_numpy(verts).to(dev),
                               torch.from_numpy(tri_vidx[perm]).to(dev))
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    return (packs, mt, col3(o, dev), col3(d, dev),
            torch.from_numpy(cap).to(dev), eps)


def rule_inputs():
    """The case of the top-node rule: two one-triangle packs, pack 0 at x
    in [3, 4] and pack 1 at x in [0, 1], in the plane z = 0.5, and three
    rays straight down: two from x = 1, pack 1's bmax.x, with dx = +0, and
    a control ray with dx = 1e-3. Pack 1's root slab test meets (1 - 1) *
    inf = NaN and counts as hit, and the two rays hit its triangle on its
    edge x = 1 at t = 1.5, while the union box [0, 4] misses them; the
    control ray misses both packs. (packs, vertices, tri_vidx, o, d, cap)
    as float32/int32 numpy arrays."""
    from raytracer795_tpu_torch.scene import types as T

    def leaf(lo, hi, first):
        return T.FlatBVH(bmin=np.array([lo], np.float32),
                         bmax=np.array([hi], np.float32),
                         first=np.array([first], np.int32),
                         count=np.array([1], np.int32),
                         miss=np.array([1], np.int32), max_leaf=1)
    packs = (leaf([3, 0, 0.5], [4, 1, 0.5], 0),
             leaf([0, 0, 0.5], [1, 1, 0.5], 1))
    verts = np.array([[3, 0, 0.5], [4, 0, 0.5], [4, 1, 0.5],
                      [0, 0, 0.5], [1, 0, 0.5], [1, 1, 0.5]], np.float32)
    tv = np.arange(6, dtype=np.int32).reshape(2, 3)
    o = np.array([[1, 0.2, 2], [1, 0.7, 2], [1, 0.2, 2]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1], [1e-3, 0, -1]], np.float32)
    return packs, verts, tv, o, d, np.full(3, np.inf, np.float32)


def rule_case(bt, dev):
    """``rule_inputs`` as the kernels' tables and tensors on ``dev``."""
    from raytracer795_tpu_torch.scene.types import to_device

    packs, verts, tv, o, d, cap = rule_inputs()
    mt = bt.build_multi_tables(to_device(packs, dev),
                               torch.from_numpy(verts).to(dev),
                               torch.from_numpy(tv).to(dev))
    return (mt, col3(o, dev), col3(d, dev), torch.from_numpy(cap).to(dev),
            torch.tensor(1e-3, dtype=torch.float32, device=dev))


def multi_phase(bt, assets, load_scene, dev):
    """Phase 6. Returns (rock1800k loaded, its tables, primary, shadow,
    caps, load seconds, max |dt|, any-hit mismatch flag)."""
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    errs, mism = [], []

    def run(case, mt, o, d, cap, eps):
        err, bad, hits, occ, ties = compare_multi(bt, mt, o, d, cap, eps)
        errs.append(err)
        mism.append(bad)
        phase("multi_kernel_vs_plain", case=case, packs=mt.n_packs,
              rays=o.x.shape[0], max_abs_t_err=err, anyhit_mismatches=bad,
              hits=hits, occluded=occ, tie_lanes=ties)
        return hits, occ

    for case, t, n, seed, pack_tris, knife in (
            ("random mesh 600 tris, 4096 rays", 600, 4096, 2, 128, False),
            ("random mesh 9000 tris in packs of 128, 4096 rays", 9000, 4096,
             3, 128, False),
            ("knife-edge lanes, random mesh 600 tris", 600, 8192, 4, 128,
             True),
            ("knife-edge lanes, random mesh 9000 tris", 9000, 8192, 5, 128,
             True)):
        packs, *args = multi_case(bt, t, n, seed, pack_tris, dev, knife)
        check(len(packs) > (64 if t == 9000 else 3), f"{len(packs)} packs")
        hits, occ = run(case, *args)
        check(hits > 0 and occ > 0, f"{case}: no hit")
    hits, occ = run("top-node rule, two hand-built packs", *rule_case(bt, dev))
    check(hits == 2 and occ == 2, "the rule case's two rays hit pack 1")

    nu, nv = assets.ROCK1800K_GRID
    assets.ensure_rock(os.path.join(SCENES, "rock1800k.ply"), nu, nv)
    t0 = time.perf_counter()
    big = load_scene(os.path.join(SCENES, "rock1800k.xml"), dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    (bgroup,) = big.scene.groups
    check(bgroup.bvh is None and bgroup.pack_bvhs is not None,
          "rock1800k is one multi-pack group")
    bprim, bshadow, bcap = rock_wavefronts(big)
    mt = bt.build_multi_tables(bgroup.pack_bvhs, big.scene.vertices,
                               bgroup.tri_vidx)
    beps = big.scene.int_eps
    phase("load", scene="rock1800k", seconds=load_s, tris=bgroup.n_tris,
          packs=mt.n_packs, nodes=mt.n_nodes)
    for case, rays, rcap in (
            ("rock1800k primary wavefront", bprim,
             torch.full_like(bprim.o.x, 3.0e38)),
            ("rock1800k first shadow wavefront", bshadow, bcap)):
        run(case, mt, rays.o, rays.d, rcap, beps)
    ko, kd, kc = knife_edge_rays(bgroup.pack_bvhs, 8192, 6)
    run("knife-edge lanes, rock1800k", mt, col3(ko, dev), col3(kd, dev),
        torch.from_numpy(kc).to(dev), beps)
    walking = torch.nonzero((bshadow.d.x != 0) | (bshadow.d.y != 0)
                            | (bshadow.d.z != 0))[:, 0]
    for n in RAGGED_N:
        lanes = walking[:n]
        caps = torch.where(torch.arange(n, device=dev) % 2 == 0, 0.0,
                           float("inf"))
        run(f"rock1800k first shadow wavefront, {n} live rays, caps 0 and "
            "+inf", mt, Vec3(*(c[lanes] for c in bshadow.o)),
            Vec3(*(c[lanes] for c in bshadow.d)), caps, beps)
    lanes = torch.arange(bcap.shape[0], device=dev)
    run("rock1800k first shadow wavefront, caps 0 and +inf", mt, bshadow.o,
        bshadow.d, torch.where(lanes % 2 == 0, 0.0, float("inf")), beps)
    return (big, mt, bprim, bshadow, bcap, load_s, max(errs),
            float(max(mism) > 0))


def kernel_bound(bt, tables, o, d, eps, cap=None):
    """The least time the card could take for one query, from this query's
    own work: its bytes (rays and caps in, answers out, the node and
    triangle tables read once) over the memory rate, and its operations
    (``walk_work``'s node visits and triangle tests) over the fp32 rate;
    the larger of the two, and the work behind it."""
    work = bt.walk_work(tables, o, d, eps, cap)
    n = o.x.shape[0]
    ops = NODE_OPS * int(work.nodes.sum()) + TRI_OPS * int(work.tris.sum())
    ray_bytes = n * (24 + 4 + 1) if cap is not None else n * (24 + 12)
    table_bytes = 4 * (tables.nodes.numel() + tables.tris.numel())
    nbytes = ray_bytes + table_bytes
    t_ops, t_bytes = ops / PEAK_FP32_OPS_S, nbytes / PEAK_BYTES_S
    live = max(int((work.nodes > 0).sum()), 1)
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes, "walking_rays": live,
            "node_visits_per_walk": int(work.nodes.sum()) / live,
            "leaf_visits_per_walk": int(work.leaves.sum()) / live,
            "tri_tests_per_walk": int(work.tris.sum()) / live}


def kernel_time(bt, name, wave, tables, o, d, eps, cap, plain_ms, card):
    """Times kernel ``name`` on one wavefront (mean of 20 launches) and
    prints it beside its bound and its time before; returns
    (ms, plain ms, bound record)."""
    fn = {"nearest": bt.tri_bvh_nearest,
          "nearest_multi": bt.tri_bvh_nearest_multi}.get(name)
    if fn is None:
        anyhit = {"anyhit": bt.tri_bvh_anyhit,
                  "anyhit_multi": bt.tri_bvh_anyhit_multi}[name]
        ms = cuda_ms(lambda: anyhit(tables, o, d, cap, eps), 20)
    else:
        ms = cuda_ms(lambda: fn(tables, o, d, eps), 20)
    bound = kernel_bound(bt, tables, o, d, eps, cap)
    phase("kernel_time", kernel=name, wavefront=wave, rays=o.x.shape[0],
          kernel_ms=ms, plain_ms=plain_ms, **bound,
          bound_share=bound["bound_ms"] / ms,
          before_ms=BEFORE_MS.get((name, wave)), card=card)
    return ms, plain_ms, bound


def moved_vertices_case(bt, dev, t=4096, n=EDGE_RAYS, seed=5):
    """tests/test_torch_traverse.py's moved-vertex case at ``n`` rays: a
    tree built over a random mesh whose vertices then move, with the rays
    of ``random_inputs``: (tables, o, d, cap, eps)."""
    from raytracer795_tpu_torch.ops import bvh
    from raytracer795_tpu_torch.scene.types import to_device

    verts, tri_vidx, o, d, cap = random_inputs(t, n, seed)
    flat, perm = bvh.build(*bvh.tri_bounds(verts, tri_vidx))
    moved = verts + np.random.default_rng(seed + 1).normal(
        scale=0.05, size=verts.shape).astype(np.float32)
    tb = bt.build_tables(to_device(flat, dev), torch.from_numpy(moved).to(dev),
                         torch.from_numpy(tri_vidx[perm]).to(dev))
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    return (tb, col3(o, dev), col3(d, dev), torch.from_numpy(cap).to(dev),
            eps)


def axis_aligned_case(bt, dev, t=2048, n=EDGE_RAYS, seed=7):
    """tests/test_torch_traverse.py's axis-aligned case at ``n`` rays:
    directions with a zero component, origins EXACTLY on node-box bounds
    and vertex coordinates: (tables, o, d, cap, eps)."""
    from raytracer795_tpu_torch.ops import bvh
    from raytracer795_tpu_torch.scene.types import to_device

    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(t * 3, 3)).astype(np.float32)
    tri_vidx = np.arange(t * 3, dtype=np.int32).reshape(t, 3)
    flat, perm = bvh.build(*bvh.tri_bounds(verts, tri_vidx))
    bounds = np.concatenate([flat.bmin, flat.bmax, verts]).astype(np.float32)
    o = bounds[rng.integers(0, bounds.shape[0], (n, 3)),
               rng.integers(0, 3, (n, 3))]
    d = np.zeros((n, 3), np.float32)
    main_ax, zero_ax = rng.integers(0, 3, n), rng.integers(0, 3, n)
    d[np.arange(n), main_ax] = rng.choice([-1.0, 1.0], n)
    diag = rng.random(n) < 0.33
    other = (main_ax + 1) % 3
    d[diag, other[diag]] = rng.choice([-1.0, 1.0], diag.sum())
    d[np.arange(n), zero_ax] = 0.0
    tb = bt.build_tables(to_device(flat, dev), torch.from_numpy(verts).to(dev),
                         torch.from_numpy(tri_vidx[perm]).to(dev))
    eps = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    return (tb, col3(o, dev), col3(d, dev),
            torch.full((n,), 3.0, dtype=torch.float32, device=dev), eps)


def record_queries(render, bt, loaded, spp=None):
    """Render ``loaded`` once op by op, recording every single-pack
    traversal query in order: [(kind, args)], kind "nearest" with (tb, o,
    d, eps) or "anyhit" with (tb, o, d, cap, eps)."""
    nearest, anyhit = bt.tri_bvh_nearest, bt.tri_bvh_anyhit
    calls = []

    def rec_nearest(tb, o, d, eps):
        calls.append(("nearest", (tb, o, d, eps)))
        return nearest(tb, o, d, eps)

    def rec_anyhit(tb, o, d, cap, eps):
        calls.append(("anyhit", (tb, o, d, cap, eps)))
        return anyhit(tb, o, d, cap, eps)
    bt.tri_bvh_nearest, bt.tri_bvh_anyhit = rec_nearest, rec_anyhit
    try:    # op by op: a replayed graph calls no Python
        render.render_camera(loaded, 0, spp=spp, ldr=True, _graphs=False)
    finally:
        bt.tri_bvh_nearest, bt.tri_bvh_anyhit = nearest, anyhit
    return calls


def edge_phase(bt, render, loaded, tb, shadow, cap, eps, dev):
    """Phase 3, second part: the single-pack kernels vs their plain walks,
    bit for bit and twice each, on the moved-vertex and axis-aligned cases
    at 131,072 rays, rock100k's mirror-bounce wavefront (mostly dead
    lanes), ragged ray counts and caps of 0 and +inf. Returns the max |dt|,
    any-hit mismatches and the mirror-bounce query's (tables, o, d, eps)."""
    from raytracer795_tpu_torch.utils.vec3 import Vec3

    errs, mism = [], []

    def run(case, tables, o, d, c, e):
        err, bad, hits, occ = compare(bt, tables, o, d, c, e)
        errs.append(err)
        mism.append(bad)
        phase("kernel_vs_plain", case=case, rays=o.x.shape[0],
              live=live_lanes(d) if o.x.shape[0] else 0, max_abs_t_err=err,
              anyhit_mismatches=bad, hits=hits, occluded=occ)

    run("random mesh 4096 tris, vertices moved after the build",
        *moved_vertices_case(bt, dev))
    run("random mesh 2048 tris, axis-aligned rays from vertex-exact "
        "origins", *axis_aligned_case(bt, dev))
    nearest = [a for kind, a in record_queries(render, bt, loaded)
               if kind == "nearest"]
    check(len(nearest) >= 2, "rock100k made a mirror-bounce query")
    btb, bo, bd, beps = nearest[1]
    check(live_lanes(bd) < bo.x.shape[0] // 2,
          "the mirror-bounce wavefront is mostly dead")
    run("rock100k mirror-bounce wavefront", btb, bo, bd,
        torch.full_like(bo.x, float("inf")), beps)
    walking = torch.nonzero((shadow.d.x != 0) | (shadow.d.y != 0)
                            | (shadow.d.z != 0))[:, 0]
    for n in RAGGED_N:
        lanes = walking[:n]

        def head(v):
            return Vec3(*(c[lanes] for c in v))
        run(f"rock100k first shadow wavefront, {n} live rays", tb,
            head(shadow.o), head(shadow.d), cap[lanes], eps)
    lanes = torch.arange(cap.shape[0], device=dev)
    run("rock100k first shadow wavefront, caps 0 and +inf", tb, shadow.o,
        shadow.d, torch.where(lanes % 2 == 0, 0.0, float("inf")), eps)
    return max(errs), max(mism), (btb, bo, bd, beps)


def rock_wavefronts(loaded):
    """A scene's primary wavefront and its first shadow wavefront (light
    0) in world space, as the main path builds them: (primary, shadow,
    shadow caps). For a scene of one untransformed group they are also the
    group's local rays."""
    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.models import camera, lights
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.ops.texture import apply_textures
    from raytracer795_tpu_torch.utils.vec3 import Vec3, vnorm

    scene, cam = loaded.scene, loaded.cameras[0]
    dev = scene.device
    check(render.band_rows(cam) == cam.ny, "400x400 is one band")
    px, py = camera.band_pixels(cam.nx, cam.ny, dev)
    rays = camera.primary_rays_at(cam, px, py)
    with torch.no_grad():
        hit = intersect.trace(scene, rays)
        det = intersect.hit_details(scene, rays, hit,
                                    intersect.compute_vertex_normals(scene))
        tex = apply_textures(scene, det)
        sp = lights.ShadePoint(
            point=det.point, normal=tex.normal, wo=-rays.d, mat=det.mat,
            dm=tex.dm, tex_color=tex.tex_color, tex_norm=tex.tex_normalizer,
            time=rays.time, valid=hit.valid)
        pos = scene.lights.point_pos[0]
        topoint = Vec3(pos[0] - sp.point.x, pos[1] - sp.point.y,
                       pos[2] - sp.point.z)
        d_light = vnorm(topoint)
        shadow, cap = lights.shadow_rays(scene, sp, topoint * (1.0 / d_light),
                                         d_light)
    return rays, shadow, cap


@contextlib.contextmanager
def counting(module, names):
    """Count calls of ``module``'s functions ``names`` while inside."""
    calls = dict.fromkeys(names, 0)
    saved = {name: getattr(module, name) for name in names}

    def counted(name):
        def call(*args):
            calls[name] += 1
            return saved[name](*args)
        return call
    for name in names:
        setattr(module, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def profile_launches(fn):
    """(kernels run, device kernel ms, device ms by kernel name) of
    ``fn()`` under torch.profiler, tracing the card only (a CPU trace of
    every eager op costs the host more than the frame itself)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    by_name = {e.key: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) / 1e3
               for e in kernels}
    return sum(e.count for e in kernels), sum(by_name.values()), by_name


def bvh_kernel_ms(by_name):
    """Device ms of each traversal kernel in a trace, by its name there."""
    out = {}
    for name, symbol in KERNEL_SYMBOLS.items():
        pat = re.compile(r"(?<![A-Za-z_])%s" % re.escape(symbol))
        out[name] = sum(ms for key, ms in by_name.items() if pat.search(key))
    return out


def profile_frame(render, ld, median_s, draw_s):
    """One LDR frame (after a warm-up) traced on the card: kernels run and
    device kernel time, the device's busy share of the unprofiled median
    frame, and the RNG's draws (counted over a frame rendered op by op)
    with their estimated share of that frame (draws x the host seconds of
    one band-sized draw)."""
    from raytracer795_tpu_torch.utils import rng

    draws = [0]
    uniform = rng.uniform

    def counted(*args):
        draws[0] += 1
        return uniform(*args)
    rng.uniform = counted
    try:    # the draws of a frame op by op: a replay calls no Python
        render.render_camera(ld, 0, ldr=True, _graphs=False)
    finally:
        rng.uniform = uniform
    render.render_camera(ld, 0, ldr=True)
    kernels, kernel_ms, by_name = profile_launches(
        lambda: render.render_camera(ld, 0, ldr=True))
    bvh_ms = bvh_kernel_ms(by_name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"kernels_run": kernels, "kernel_ms": kernel_ms,
            "busy_share_of_median": kernel_ms / 1e3 / median_s,
            "bvh_kernel_ms": bvh_ms,
            "bvh_share_of_device": sum(bvh_ms.values())
            / max(kernel_ms, 1e-9),
            "top_kernels_ms": {k[:70]: ms for k, ms in top},
            "rng_draws": draws[0],
            "rng_share_of_median_est": draws[0] * draw_s / median_s}


def frame_times(render, ld, reps=FRAME_REPS, graphed=None):
    """Host seconds of ``reps`` LDR frames after one warm-up frame;
    ``graphed`` is ``render_camera``'s ``_graphs``."""
    render.render_camera(ld, 0, ldr=True, _graphs=graphed)
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render.render_camera(ld, 0, ldr=True, _graphs=graphed)
        secs.append(time.perf_counter() - t0)
    check(out.shape == (ld.cameras[0].ny, ld.cameras[0].nx, 3), "frame shape")
    return secs


def main_path(render, bt, loaded, name, spp=None):
    """``render_scene`` with every launch counter reset just before and
    read just after; returns (seconds, launches, LDR frame)."""
    os.makedirs(OUT, exist_ok=True)
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    (png,) = render.render_scene(loaded, OUT, spp=spp)
    seconds = time.perf_counter() - t0
    launches = dict(bt.LAUNCHES)
    img = png_pixels(png).astype(np.float32)
    check(img.shape == (loaded.cameras[0].ny, loaded.cameras[0].nx, 3),
          f"{name} frame shape {img.shape}")
    return seconds, launches, img


def rng_phase(dev):
    """Phase 10; returns the kernel launches of one draw."""
    from raytracer795_tpu_torch.utils import rng

    key = rng.PRNGKey(0)
    k3 = rng.fold_in(key, 3)
    check(key == RNG_KEY0 and k3 == RNG_KEY0_FOLD3,
          f"keys {key}, {k3} differ from jax.random's")
    bits = rng.uniform(k3, (2, 5), dev).cpu().numpy().view(np.uint32)
    check(np.array_equal(bits, RNG_UNIFORM_2x5_BITS),
          f"uniform (2, 5) on the card differs from jax.random's: {bits}")
    k = rng.fold_in(rng.fold_in(rng.PRNGKey(11), 5), 2)
    shapes = ((1,), (2, 3), (5, 7, 3), (3, 23, 1000), (6, 204800))
    for shape in shapes:
        check(torch.equal(rng.random_bits(k, shape, dev).cpu(),
                          rng.random_bits(k, shape, "cpu")),
              f"random bits of {shape} differ between the card and the CPU")
        check(torch.equal(rng.uniform(k, shape, dev).cpu().view(torch.int32),
                          rng.uniform(k, shape, "cpu").view(torch.int32)),
              f"uniform {shape} differs between the card and the CPU")
    per_draw, draw_ms, _ = profile_launches(
        lambda: rng.uniform(k, (6, 204800), dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        rng.uniform(k, (6, 204800), dev)
    torch.cuda.synchronize()
    draw_s = (time.perf_counter() - t0) / 20
    phase("rng", literals_equal=True, card_equals_cpu=True,
          shapes=[list(sh) for sh in shapes], kernels_per_draw=per_draw,
          draw_6x204800_device_ms=draw_ms, draw_6x204800_host_s=draw_s)
    return per_draw, draw_s


def multisample_phase(render, bt, intersect, load_scene, read_ppm, dev, card,
                      per_draw, draw_s):
    """Phase 11; returns the main path's launch counts."""
    ms = load_scene(os.path.join(SCENES, "rock100k.xml"), dev)
    ms.cameras[0] = render.with_spp(dataclasses.replace(
        ms.cameras[0], nx=MS_RES, ny=MS_RES), MS_SPP)
    with counting(intersect, PLAIN_WALKS) as plain:
        ms_s, launches, img = main_path(render, bt, ms, "rock100k", MS_SPP)
    check(launches["nearest"] > 0 and launches["anyhit"] > 0,
          f"rock100k at {MS_SPP} spp launched both kernels: {launches}")
    check(not any(plain.values()), f"plain walks were called: {plain}")
    gold = read_ppm(os.path.join(GOLDENS, "rock100k.ppm"))
    g, k = gold.shape[0], MS_RES // gold.shape[0]
    half = img.reshape(g, k, g, k, 3).mean(axis=(1, 3))   # to the golden's

    def pool(a):
        return a.reshape(g // 8, 8, g // 8, 8, 3).mean(axis=(1, 3))
    pooled = float(np.abs(pool(half) - pool(gold)).mean())
    check(pooled < 3.0, f"rock100k {MS_SPP} spp pooled mean |d| {pooled}")
    phase("main_path", scene="rock100k", res=MS_RES, spp=MS_SPP,
          seconds=ms_s, launches=launches, plain_walk_calls=plain,
          golden_pooled8_mean_abs=pooled)
    secs = frame_times(render, ms)
    med = statistics.median(secs)
    phase("frame_time", scene="rock100k", res=MS_RES, spp=MS_SPP,
          median_s=med, samples_s=secs,
          gross_rays=render.gross_rays(ms.scene, ms.cameras[0]), card=card)
    prof = profile_frame(render, ms, med, draw_s)
    phase("profile", scene="rock100k", res=MS_RES, spp=MS_SPP,
          rng_kernels=prof["rng_draws"] * per_draw, **prof, card=card)
    return launches


def stochastic_phase(render, load_scene, read_ppm, dev):
    """Phase 12."""
    for name, mean_tol, p99_tol in STOCHASTIC_BOUNDS:
        ld = load_scene(os.path.join(SCENES, name + ".xml"), dev)
        img = render.render_camera(ld, 0, ldr=True).astype(np.float32)
        diff = np.abs(img - read_ppm(os.path.join(GOLDENS, name + ".ppm")))
        mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
        check(mean < mean_tol and p99 < p99_tol,
              f"{name} golden: mean {mean}, p99 {p99}")
        cam = ld.cameras[0]
        phase("stochastic_golden", scene=name, res=[cam.nx, cam.ny],
              spp=cam.num_samples, mean_abs=mean, p99=p99)


def cornell_phase(render, load_scene, dev, card, per_draw, draw_s):
    """Phase 13."""
    pt = load_scene(os.path.join(SCENES, "cornellbox_pt.xml"), dev)
    pt.cameras[0] = render.with_spp(dataclasses.replace(
        pt.cameras[0], nx=MS_RES, ny=MS_RES), MS_SPP)
    rays = render.gross_rays(pt.scene, pt.cameras[0])
    check(rays == 30_720_000, f"Cornell gross rays {rays}")
    secs = frame_times(render, pt)
    med = statistics.median(secs)
    phase("frame_time", scene="cornellbox_pt", res=MS_RES, spp=MS_SPP,
          depth=pt.scene.max_depth, median_s=med, samples_s=secs,
          gross_rays=rays, gross_rays_per_s=rays / med, card=card)
    prof = profile_frame(render, pt, med, draw_s)
    phase("profile", scene="cornellbox_pt", res=MS_RES, spp=MS_SPP,
          rng_kernels=prof["rng_draws"] * per_draw, **prof, card=card)


def analytic_phase(render, load_scene, dev):
    """Phase 14: tests/test_path_tracer.py:43-80 on the card."""
    fl = load_scene(os.path.join(SCENES, "furnace.xml"), dev)
    img = render.render_camera(fl, 0, spp=256)
    block = img[12:20, 12:20].mean(axis=(0, 1))
    corner = img[1, 1]
    check(np.allclose(block, 1.0, rtol=0.04), f"furnace block {block}")
    check(np.allclose(corner, 2.0, rtol=0.02), f"furnace corner {corner}")

    src = open(os.path.join(SCENES, "cornellbox_pt.xml")).read()
    src = re.sub(r"<MaxRecursionDepth>\d+</MaxRecursionDepth>",
                 "<MaxRecursionDepth>1</MaxRecursionDepth>", src)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "cornellbox_pt_depth1.xml")
    with open(path, "w") as f:
        f.write(src)
    img = render.render_camera(load_scene(path, dev), 0, spp=128)
    seeded = np.random.default_rng(0)
    cam = np.array([0, 1, 3.8])
    v = 1 - (60.5 / 100) * 2
    d = np.array([0, v, -1.0])
    d /= np.linalg.norm(d)
    p = cam + ((0 - cam[1]) / d[1]) * d
    m = 200000
    lp = np.stack([seeded.uniform(-0.6, 0.6, m), np.full(m, 1.999),
                   seeded.uniform(-0.6, 0.2, m)], 1)
    to_l = lp - p
    d2 = (to_l ** 2).sum(1)
    wi = to_l / np.sqrt(d2)[:, None]
    geom = np.maximum(0, wi[:, 1]) * np.abs(wi[:, 1]) / d2
    expected = np.array([18, 17, 14.0]) * (0.7 / np.pi) * geom.mean() * 0.96
    got = img[60, 50]
    check(np.allclose(got, expected, rtol=0.15),
          f"NEE floor point {got} against {expected}")
    phase("path_tracer_analytic", furnace_block=block.tolist(),
          furnace_corner=corner.tolist(), nee_pixel=got.tolist(),
          nee_expected=expected.tolist())


def live_lanes(d) -> int:
    """Lanes with a nonzero direction (zero retires a lane)."""
    return int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())


def capture_pt_wavefronts(render, bt, loaded):
    """Render ``loaded`` once more, recording every traversal query, and
    return the first diffuse-bounce wavefront (the nearest query after a
    band's primary one) and the first NEE wavefront (the band's first
    any-hit query: object-light NEE comes before the point lights) of the
    bands where they have the most live lanes: (tb, o, d, eps) and
    (tb, o, d, cap, eps)."""
    calls = record_queries(render, bt, loaded, PT_SPP)
    bounces, nees = [], []
    for i, (kind, args) in enumerate(calls):
        o = args[1]
        primary = kind == "nearest" and all(
            bool((c == c[0]).all()) for c in o)     # every lane at the eye
        if not primary:
            continue
        after = calls[i + 1:]
        bounces += [a for k, a in after if k == "nearest"][:1]
        nees += [a for k, a in after if k == "anyhit"][:1]
    check(bounces and nees, "no bounce or NEE wavefront was recorded")
    return (max(bounces, key=lambda a: live_lanes(a[2])),
            max(nees, key=lambda a: live_lanes(a[2])))


def rock_pt_phase(render, bt, intersect, load_scene, dev, card, per_draw,
                  draw_s):
    """Phase 15; returns (launches, max |dt|, any-hit mismatches)."""
    xml = os.path.join(SCENES, "rock100k_pt.xml")
    rp = load_scene(xml, dev)
    (group,) = rp.scene.groups
    check(group.bvh is not None and group.n_spheres == 1
          and len(rp.scene.sphere_lights) == 1,
          "rock100k_pt is one BVH group with its sphere light")
    with counting(intersect, PLAIN_WALKS) as plain:
        pt_s, launches, img = main_path(render, bt, rp, "rock100k_pt",
                                        PT_SPP)
    check(launches["nearest"] > 0 and launches["anyhit"] > 0,
          f"rock100k_pt launched both kernels: {launches}")
    check(not any(plain.values()), f"plain walks were called: {plain}")
    check(img.shape == (PT_RES, PT_RES, 3) and 0 < img.mean() < 255,
          f"rock100k_pt frame mean {img.mean()}")
    phase("main_path", scene="rock100k_pt", res=PT_RES, spp=PT_SPP,
          seconds=pt_s, launches=launches, plain_walk_calls=plain,
          frame_mean=float(img.mean()))

    bounce, nee = capture_pt_wavefronts(render, bt, rp)
    errs, mism = [], []
    tb, o, d, eps = bounce
    live = live_lanes(d)
    err, bad, hits, occ = compare(bt, tb, o, d,
                                  torch.full_like(o.x, 3.0e38), eps)
    errs.append(err)
    mism.append(bad)
    phase("kernel_vs_plain", case="rock100k_pt first diffuse-bounce "
          "wavefront of its fullest band", rays=o.x.shape[0], live=live,
          max_abs_t_err=err, anyhit_mismatches=bad, hits=hits, occluded=occ)
    dec = bt.decode(tb)
    kernel_time(bt, "nearest", "rock100k_pt first diffuse bounce", tb, o, d,
                eps, None, cuda_ms(lambda: intersect._tri_bvh_candidates(
                    dec, o, d, eps), 1), card)
    tb, o, d, cap, eps = nee
    live = live_lanes(d)
    err, bad, hits, occ = compare(bt, tb, o, d, cap, eps)
    errs.append(err)
    mism.append(bad)
    phase("kernel_vs_plain", case="rock100k_pt first NEE wavefront of its "
          "fullest band, per-ray caps", rays=o.x.shape[0], live=live,
          max_abs_t_err=err, anyhit_mismatches=bad, hits=hits, occluded=occ)
    dec = bt.decode(tb)
    kernel_time(bt, "anyhit", "rock100k_pt first NEE", tb, o, d, eps, cap,
                cuda_ms(lambda: intersect._tri_bvh_anyhit(
                    dec, o, d, cap, eps), 1), card)

    rp.cameras[0] = render.with_spp(rp.cameras[0], PT_SPP)
    secs = frame_times(render, rp)
    med = statistics.median(secs)
    phase("frame_time", scene="rock100k_pt", res=PT_RES, spp=PT_SPP,
          median_s=med, samples_s=secs,
          gross_rays=render.gross_rays(rp.scene, rp.cameras[0]), card=card)
    prof = profile_frame(render, rp, med, draw_s)
    phase("profile", scene="rock100k_pt", res=PT_RES, spp=PT_SPP,
          rng_kernels=prof["rng_draws"] * per_draw, **prof, card=card)

    # kernel = plain: one small frame through each, same RNG
    nearest, anyhit = bt.tri_bvh_nearest, bt.tri_bvh_anyhit
    small = load_scene(xml, dev)
    small.cameras[0] = dataclasses.replace(small.cameras[0], nx=64, ny=64)
    through_kernels = render.render_camera(small, 0, spp=2, ldr=True)
    bt.tri_bvh_nearest = lambda tb, o, d, eps: intersect._tri_bvh_candidates(
        bt.decode(tb), o, d, eps)
    bt.tri_bvh_anyhit = lambda tb, o, d, cap, eps: intersect._tri_bvh_anyhit(
        bt.decode(tb), o, d, cap, eps)
    try:
        bt.reset_launch_counts()     # op by op: a plain walk syncs
        through_plain = render.render_camera(small, 0, spp=2, ldr=True,
                                             _graphs=False)
        plain_launches = dict(bt.LAUNCHES)
    finally:
        bt.tri_bvh_nearest, bt.tri_bvh_anyhit = nearest, anyhit
    check(not any(plain_launches.values()),
          f"the plain-walk frame launched kernels: {plain_launches}")
    differ = int((through_kernels != through_plain).sum())
    check(differ == 0, f"{differ} LDR values differ between the kernels' "
          "and the plain walks' rock100k_pt frames")
    phase("kernel_equals_plain_frame", scene="rock100k_pt", res=64, spp=2,
          ldr_values_differing=differ,
          frame_mean=float(through_kernels.mean()))
    return launches, max(errs), float(max(mism) > 0)


def texture_phase(render, bt, intersect, load_scene, read_ppm, dev, card,
                  rock_800_median_s):
    """Phase 16; returns the rock100k_tex main path's launch counts."""
    from raytracer795_tpu_torch.models import whitted

    phase("pil", pil_importable=importlib.util.find_spec("PIL") is not None)
    for name, mean_tol, frac_tol in TEXTURE_GOLDENS:
        ld = load_scene(os.path.join(SCENES, name + ".xml"), dev)
        img = render.render_camera(ld, 0, ldr=True).astype(np.float32)
        diff = np.abs(img - read_ppm(os.path.join(GOLDENS, name + ".ppm")))
        mean, frac2 = float(diff.mean()), float((diff > 2).mean())
        check(mean < mean_tol and frac2 < frac_tol,
              f"{name} golden: mean {mean}, frac>2 {frac2}")
        phase("golden", scene=name, mean_abs=mean, frac_gt2=frac2)
    ld = load_scene(os.path.join(SCENES, "envlight.xml"), dev)
    check(ld.scene.env_texture >= 0, "envlight has its environment light")
    img = render.render_camera(ld, 0, ldr=True).astype(np.float32)
    gold = read_ppm(os.path.join(GOLDENS, "envlight.ppm"))
    sky = float(np.abs(img[:40] - gold[:40]).mean())

    def pool(a):
        return a.reshape(20, 8, 20, 8, 3).mean(axis=(1, 3))
    pooled = float(np.abs(pool(img) - pool(gold)).mean())
    dmean = float(abs(img.mean() - gold.mean()))
    check(sky < 0.05 and pooled < 6.0 and dmean < 3.0,
          f"envlight golden: sky {sky}, pooled {pooled}, |dmean| {dmean}")
    phase("golden", scene="envlight", spp=ld.cameras[0].num_samples,
          sky_mean_abs=sky, pooled8_mean_abs=pooled, abs_dmean=dmean)

    xml = os.path.join(SCENES, "rock100k_tex.xml")
    rt = load_scene(xml, dev)
    (group,) = rt.scene.groups
    check(group.bvh is not None and group.n_tris < 120_000
          and rt.scene.n_textures == 5 and rt.scene.bg_texture == 4,
          "rock100k_tex is one single-pack BVH group with its 5 textures")
    with counting(intersect, PLAIN_WALKS) as plain:
        tex_s, launches, img = main_path(render, bt, rt, "rock100k_tex")
    check(launches["nearest"] > 0 and launches["anyhit"] > 0,
          f"rock100k_tex launched both single-pack kernels: {launches}")
    check(launches["nearest_multi"] == 0 and launches["anyhit_multi"] == 0,
          f"rock100k_tex launched no multi-pack kernel: {launches}")
    check(not any(plain.values()), f"plain walks were called: {plain}")
    gold = read_ppm(os.path.join(GOLDENS, "rock100k_tex_jax.ppm"))
    frac = float((np.abs(img - gold) > 1).mean())
    check(frac < 1e-4, f"rock100k_tex against the JAX frame: frac(|d|>1) "
          f"= {frac}")
    phase("main_path", scene="rock100k_tex", res=400, seconds=tex_s,
          launches=launches, plain_walk_calls=plain, jax_frame_frac_gt1=frac)

    rt.cameras[0] = dataclasses.replace(rt.cameras[0], nx=MS_RES, ny=MS_RES)
    secs = frame_times(render, rt)
    med = statistics.median(secs)
    phase("frame_time", scene="rock100k_tex", res=MS_RES, spp=1,
          median_s=med, samples_s=secs,
          rock100k_median_s=rock_800_median_s, card=card)
    rock = load_scene(os.path.join(SCENES, "rock100k.xml"), dev)
    rock.cameras[0] = dataclasses.replace(rock.cameras[0], nx=MS_RES,
                                          ny=MS_RES)
    plain_prof = profile_frame(render, rock, rock_800_median_s, 0.0)
    phase("profile", scene="rock100k", res=MS_RES, spp=1, **plain_prof,
          card=card)
    # the texture stage: every apply_textures call of one frame, recorded
    # and then replayed under the profiler
    calls = []
    apply = whitted.apply_textures

    def recorded(scene, det):
        calls.append((scene, det))
        return apply(scene, det)
    whitted.apply_textures = recorded
    try:    # op by op: a replay calls no Python
        render.render_camera(rt, 0, ldr=True, _graphs=False)
    finally:
        whitted.apply_textures = apply
    check(len(calls) >= 2, f"{len(calls)} texture calls recorded")
    tex_kernels, tex_ms, _ = profile_launches(
        lambda: [apply(scene, det) for scene, det in calls])
    prof = profile_frame(render, rt, med, 0.0)
    phase("profile", scene="rock100k_tex", res=MS_RES, spp=1, **prof,
          texture_calls=len(calls), texture_kernels=tex_kernels,
          texture_kernel_ms=tex_ms,
          texture_share_of_device=tex_ms / max(prof["kernel_ms"], 1e-9),
          kernels_over_rock100k=prof["kernels_run"]
          / max(plain_prof["kernels_run"], 1), card=card)
    return launches


def grad_inputs(render, loaded, res=None):
    """The render path's center-of-pixel rays of one res x res band
    (``GRAD_RES`` by default), their background and key 0: (rays,
    background, key)."""
    from raytracer795_tpu_torch.models import camera
    from raytracer795_tpu_torch.utils import rng

    res = res or GRAD_RES
    scene = loaded.scene
    cam = dataclasses.replace(loaded.cameras[0], nx=res, ny=res)
    check(render.band_rows(cam) == res, f"{res}x{res} is one band")
    px, py = camera.band_pixels(res, res, scene.device)
    rays = camera.primary_rays_at(cam, px, py)
    return (rays, render._background_radiance(scene, cam, rays, px, py),
            rng.PRNGKey(0))


def param_leaves(tree):
    """Every tensor of a parameter dict (a tensor or a tuple a name)."""
    return [x for v in tree.values()
            for x in (v if isinstance(v, tuple) else (v,))]


def leaf_scene(par, scene):
    """``scene`` with every differentiable parameter a fresh leaf that
    requires grad."""
    return par.scene_with_params(scene, {
        k: (tuple(x.detach().requires_grad_() for x in v)
            if isinstance(v, tuple) else v.detach().requires_grad_())
        for k, v in par.differentiable_params(scene).items()})


@contextlib.contextmanager
def launch_split(bt):
    """Kernel launches of the forward pass and of the backward pass of the
    one ``torch.autograd.grad`` call inside (a train step's): the counters
    are reset on entry and read where the backward pass starts and ends."""
    grad = torch.autograd.grad
    split = {}

    def timed_grad(*args, **kw):
        split["forward"] = dict(bt.LAUNCHES)
        out = grad(*args, **kw)
        split["backward"] = {k: n - split["forward"][k]
                             for k, n in bt.LAUNCHES.items()}
        return out
    bt.reset_launch_counts()
    torch.autograd.grad = timed_grad
    try:
        yield split
    finally:
        torch.autograd.grad = grad


def family_max(grads):
    """max |g| of each gradient family (0 for an empty one)."""
    return {k: max((float(g.abs().max()) for g in param_leaves({k: v})
                    if g.numel()), default=0.0) for k, v in grads.items()}


def all_finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in param_leaves(tree))


def train_cell(render, bt, intersect, par, loaded, name):
    """One ``train_step_with_grads`` of ``loaded`` at 400x400 on every
    differentiable parameter toward 0.9 x its own frame (key 0), the plain
    walks counted and the launches split at the backward pass; the Whitted
    trip count is measured once before. Returns (record, gradients, step,
    forward, loss_of)."""
    from raytracer795_tpu_torch.utils import rng

    scene = loaded.scene
    rays, bg, key = grad_inputs(render, loaded)
    integrate = render._integrator(scene)

    def forward(sc=scene):
        with torch.no_grad():
            return integrate(sc, rays, bg, rng.fold_in(key, 0))
    target = 0.9 * forward()
    iters = par.resolve_whitted_iters(scene, rays, bg, key)

    def step(sc=scene, lr=0.0):
        return par.train_step_with_grads(sc, rays, bg, target, key, lr=lr,
                                         whitted_iters=iters)

    def loss_of(sc):
        return float(torch.mean((forward(sc) - target) ** 2))
    with counting(intersect, PLAIN_WALKS) as plain, \
            launch_split(bt) as split:
        loss, grads, _ = step()
    check(not any(plain.values()), f"{name}: plain walks ran: {plain}")
    check(all_finite(grads), f"{name}: a gradient is not finite")
    check(np.isfinite(float(loss)) and float(loss) > 0, f"{name}: loss")
    rec = {"loss": float(loss), "whitted_iters": iters,
           "max_abs_grad": family_max(grads),
           "launches_forward": split["forward"],
           "launches_backward": split["backward"],
           "plain_walk_calls": plain}
    return rec, grads, step, forward, loss_of


def profile_step(fn):
    """Kernels ``fn()`` runs on the card and their device ms, with the
    host's kernel launch calls counted beside them (torch.profiler tracing
    the host and the card)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    by_name = {e.key: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)) / 1e3
               for e in kernels}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"kernels_run": sum(e.count for e in kernels),
            "host_launches": sum(e.count for e in events
                                 if e.key in HOST_LAUNCHES),
            "kernel_ms": sum(by_name.values()),
            "bvh_kernel_ms": bvh_kernel_ms(by_name),
            "indexing_backward_ms": sum(
                ms for k, ms in by_name.items()
                if "indexing_backward_kernel" in k),
            "top_kernels_ms": {k[:90]: ms for k, ms in top}}


def host_seconds(fn, reps=GRAD_REPS):
    """Host seconds of ``reps`` calls of ``fn`` after a warm-up, each
    ending in a synchronize."""
    fn()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def train_times(step, forward, card):
    """The median forward frame and train step (``GRAD_REPS`` after a
    warm-up), their ratio, one profiled step, and the step's peak
    memory."""
    fwd, stp = host_seconds(forward), host_seconds(step)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fmed, smed = statistics.median(fwd), statistics.median(stp)
    prof = profile_step(step)
    return {"forward_median_s": fmed, "forward_s": fwd,
            "step_median_s": smed, "step_s": stp,
            "step_over_forward": smed / fmed,
            "indexing_backward_ms": prof["indexing_backward_ms"],
            "memory_before_step_mb": base / 2**20,
            "max_memory_allocated_mb": peak / 2**20,
            "step_profile": prof, "card": card}


def descend(step, loss_of, scene, lr, name):
    """Three steps at rate ``lr`` from ``scene``: every gradient and
    parameter finite, and the loss after them below the loss before.
    Returns the losses, before and after each step."""
    from raytracer795_tpu_torch.parallel import shard as par

    losses, cur = [loss_of(scene)], scene
    for _ in range(3):
        _, grads, cur = step(cur, lr)
        check(all_finite(grads) and all_finite(par.differentiable_params(cur)),
              f"{name}: a gradient or parameter is not finite")
        losses.append(loss_of(cur))
    check(losses[-1] < losses[0], f"{name}: the loss did not descend: "
          f"{losses}")
    return losses


def card_vs_cpu(render, bt, intersect, load_scene, dev):
    """tests/test_tpu.py:75-128 on the card: ply_smooth loaded with
    ``bvh_min_tris=1`` at 24x24, the vertex gradient of mean((img -
    0.9 img0)^2) through the single-pack kernels (twice) and through the
    CPU port's plain walks."""
    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.parallel import shard as par

    runs = []
    for device in (dev, dev, torch.device("cpu")):
        ld = load_scene(os.path.join(SCENES, "ply_smooth.xml"), device,
                        bvh_min_tris=1)
        check(all(g.bvh is not None for g in ld.scene.groups if g.n_tris),
              "ply_smooth's meshes are BVH groups")
        rays, bg, key = grad_inputs(render, ld, 24)
        iters = whitted.forward_iteration_count(ld.scene, rays, bg, key) + 1
        with torch.no_grad():
            target = 0.9 * whitted.render_rays(ld.scene, rays, bg, key)
        bt.reset_launch_counts()
        with counting(intersect, PLAIN_WALKS) as plain:
            _, grads, _ = par.train_step_with_grads(
                ld.scene, rays, bg, target, key, lr=0.0,
                whitted_iters=iters)
        runs.append((grads["vertices"].cpu(), dict(bt.LAUNCHES), plain))
    (g1, launches, plain), (g2, _, _), (g_cpu, cpu_launches, _) = runs
    check(launches["nearest"] > 0 and launches["anyhit"] > 0
          and not any(plain.values()),
          f"the card's step ran the kernels: {launches}, plain {plain}")
    check(not any(cpu_launches.values()), "the CPU step launched nothing")
    scale = float(g_cpu.abs().max())
    check(scale > 0 and bool(torch.isfinite(g1).all()),
          "a finite, nonzero vertex gradient")
    err = float((g1 - g_cpu).abs().max())
    bad = int((~torch.isclose(g1, g_cpu, rtol=2e-3, atol=2e-3 * scale)).sum())
    check(bad == 0, f"{bad} card vertex gradients differ from the CPU's "
          f"(max |d| {err}, max |g| {scale})")
    check(bits_equal(g1, g2), "two card runs' vertex gradients differ by "
          f"{float((g1 - g2).abs().max())}")
    phase("grad_card_vs_cpu", scene="ply_smooth", res=24,
          vertices=int(g1.shape[0]), max_abs_grad=scale,
          max_abs_diff_card_cpu=err,
          max_abs_diff_card_card=float((g1 - g2).abs().max()),
          card_launches=launches, tolerance="rtol 2e-3, atol 2e-3 max|g|")


def gather_backward_phase(dev, card):
    """``ops/gather.py``'s backward on the card at the train step's lane
    count against the accumulating ``index_put_`` that ``table[idx]``'s
    backward is: 2 rows of 3 (a material table, the masked sum) with the
    lanes spread over both, and rock100k's 101,762 triangle records of 31
    (the chunked sums) with 60% of the lanes on row 0 (misses and dead
    lanes) and 25% on two rows (a floor's two triangles). Gradients that
    are multiples of 1/64 sum exactly in any order, so the two must agree
    (rtol 1e-5; printed: whether bit for bit); on uniform [0, 1) gradients
    the new sums must be within rtol 1e-5 of a float64 sum
    (``index_put_``'s serial sum's error printed beside), two backwards the
    same bits, and a NaN lane NaN in its own row only. Both times are CUDA
    events over 20 backwards."""
    from raytracer795_tpu_torch.ops.gather import gather_rows

    rng = np.random.default_rng(0)
    n = GRAD_RES * GRAD_RES
    for rows, cols in ((2, 3), (101762, 31)):
        idx_np = rng.integers(0, rows, n)
        if rows > 2:
            u = rng.random(n)
            idx_np[u < 0.6] = 0
            idx_np[(u >= 0.6) & (u < 0.85)] = rows // 2 + (u[(u >= 0.6) & (
                u < 0.85)] < 0.725)
        idx = torch.from_numpy(idx_np).to(dev)

        def card_f32(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)
        table = card_f32(rng.normal(size=(rows, cols)))
        exact = card_f32(rng.integers(-64, 65, (n, cols)) / 64.0)
        noisy = card_f32(rng.random((n, cols)))
        leaf = table.clone().requires_grad_()
        out = gather_rows(leaf, idx)
        check(type(out.grad_fn).__name__ == "_GatherRowsBackward"
              and torch.equal(out.detach(), table[idx]),
              "gather_rows under autograd: table[idx]'s values, own backward")

        def ours(g):
            return torch.autograd.grad(out, leaf, g, retain_graph=True)[0]

        def index_put(g):
            return torch.zeros_like(table).index_put_((idx,), g,
                                                      accumulate=True)
        a, b = ours(exact), index_put(exact)
        check(torch.allclose(a, b, rtol=1e-5, atol=0),
              f"{rows}x{cols}: new backward vs index_put_, max |d| "
              f"{float((a - b).abs().max())}")
        ref = torch.zeros(rows, cols, dtype=torch.float64,
                          device=dev).index_put_((idx,), noisy.double(),
                                                 accumulate=True)
        o1, o2 = ours(noisy), ours(noisy)
        named = ref != 0

        def rel(x):
            return float(((x.double() - ref).abs()[named]
                          / ref.abs()[named]).max())
        check(rel(o1) <= 1e-5, f"{rows}x{cols}: new backward vs float64, "
              f"{rel(o1)}")
        check(bits_equal(o1, o2), f"{rows}x{cols}: two backwards differ")
        g = exact.clone()
        g[17, 1] = float("nan")
        want_nan = torch.zeros(rows, cols, dtype=torch.bool, device=dev)
        want_nan[idx_np[17], 1] = True
        check(torch.equal(torch.isnan(ours(g)), want_nan)
              and torch.equal(torch.isnan(index_put(g)), want_nan),
              f"{rows}x{cols}: a NaN lane reaches its own row only")
        counts = np.bincount(idx_np)
        phase("gather_backward", rows=rows, cols=cols, lanes=n,
              longest_run=int(counts.max()),
              max_abs_diff_index_put=float((a - b).abs().max()),
              bit_equal_index_put=bits_equal(a, b),
              rel_err_f64=rel(o1), index_put_rel_err_f64=rel(index_put(noisy)),
              repeat_bit_equal=True, nan_own_row_only=True,
              ms=cuda_ms(lambda: ours(exact), 20),
              index_put_ms=cuda_ms(lambda: index_put(exact), 20),
              tolerance="rtol 1e-5", card=card)


def gather_backward_step(step, card):
    """Every gather backward of one ``step()``, on its own lanes and
    gradients: the largest error, relative to a float64 sum, of the new
    backward and of ``index_put_``'s serial float32 sum (over the entries
    a lane names, for the masked and the chunked sums apart). Printed
    only: where a row's lanes cancel, both errors grow."""
    from raytracer795_tpu_torch.ops import gather

    seen = []
    backward = gather._GatherRows.backward

    def spy(ctx, grad):
        (idx,) = ctx.saved_tensors
        seen.append((idx, grad, ctx.rows))
        return gather.row_sums(idx, grad, ctx.rows), None
    gather._GatherRows.backward = staticmethod(spy)
    try:
        step()
    finally:
        gather._GatherRows.backward = staticmethod(backward)
    errs = {}
    for idx, grad, rows in seen:
        kind = "masked" if rows <= gather.SMALL_ROWS else "chunked"
        zeros = grad.new_zeros((rows,) + grad.shape[1:])
        ref = zeros.double().index_put_((idx,), grad.double(),
                                        accumulate=True)
        new = gather.row_sums(idx, grad, rows)
        put = zeros.index_put_((idx,), grad, accumulate=True)
        named = ref != 0
        if not bool(named.any()):
            continue
        new_err, put_err = (float(((x.double() - ref).abs()[named]
                                   / ref.abs()[named]).max())
                            for x in (new, put))
        was = errs.get(kind, {"calls": 0, "new": 0.0, "index_put": 0.0})
        errs[kind] = {"calls": was["calls"] + 1,
                      "new": max(was["new"], new_err),
                      "index_put": max(was["index_put"], put_err)}
    phase("gather_backward_step", scene="rock100k", res=GRAD_RES,
          rel_err_f64=errs, card=card)


def gradient_phase(render, bt, intersect, load_scene, dev, card, rock, big):
    """Phase 17; returns the traversal launches of the three train steps
    (forward and backward passes summed)."""
    from raytracer795_tpu_torch.models import whitted
    from raytracer795_tpu_torch.parallel import shard as par

    # the differentiable frame equals the forward frame, bit for bit
    scene = rock.scene
    rays, bg, key = grad_inputs(render, rock)
    want = whitted.render_rays(scene, rays, bg, key)
    iters = whitted.forward_iteration_count(scene, rays, bg, key)
    bt.reset_launch_counts()
    got = whitted.render_rays(leaf_scene(par, scene), rays, bg, key,
                              differentiable=True, max_iters=iters + 2)
    torch.cuda.synchronize()
    fwd_launches = dict(bt.LAUNCHES)
    check(got.requires_grad, "the differentiable frame has a graph")
    differ = int((got.detach() != want).sum())
    check(differ == 0 and fwd_launches["nearest"] > 0,
          f"{differ} values of the differentiable rock100k frame differ")
    # the card's vertex normals (a sorted accumulating index_put) against
    # the CPU's (index_add, in triangle order): printed, not checked
    cpu_rock = load_scene(os.path.join(SCENES, "rock100k.xml"), "cpu")
    vn = intersect.compute_vertex_normals(scene).cpu()
    vn_cpu = intersect.compute_vertex_normals(cpu_rock.scene)
    phase("grad_forward", scene="rock100k", res=GRAD_RES, iterations=iters,
          values_differing=differ, launches=fwd_launches,
          vertex_normals_equal_cpu=bool(torch.equal(vn, vn_cpu)),
          vertex_normals_max_abs_diff_cpu=float((vn - vn_cpu).abs().max()))
    del got
    gather_backward_phase(dev, card)

    total = dict.fromkeys(bt.LAUNCHES, 0)

    def add(rec):
        for part in ("launches_forward", "launches_backward"):
            for k, n in rec[part].items():
                total[k] += n

    # rock100k: every parameter, then the lr dict and vertex-only descents
    rec, grads, step, forward, loss_of = train_cell(render, bt, intersect,
                                                    par, rock, "rock100k")
    for name in ("vertices", "diffuse", "point_intensity"):
        check(rec["max_abs_grad"][name] > 0, f"rock100k {name} gradient 0")
    for part in ("launches_forward", "launches_backward"):
        check(rec[part]["nearest"] > 0 and rec[part]["anyhit"] > 0,
              f"rock100k {part}: {rec[part]}")
    add(rec)
    phase("train_step", scene="rock100k", res=GRAD_RES, **rec,
          **train_times(step, forward, card))
    gather_backward_step(step, card)
    losses = descend(step, loss_of, scene, TRAIN_LRS, "rock100k lr dict")
    phase("train_descent", scene="rock100k", lr=TRAIN_LRS, losses=losses)
    gv = grads["vertices"]
    lr_v = VERTEX_STEP_DECREASE * rec["loss"] / float(torch.sum(gv * gv))
    losses = descend(step, loss_of, scene, {"vertices": lr_v},
                     "rock100k vertices")
    phase("train_descent", scene="rock100k", lr={"vertices": lr_v},
          losses=losses)

    card_vs_cpu(render, bt, intersect, load_scene, dev)

    # rock100k_pt: the path tracer's step
    pt = load_scene(os.path.join(SCENES, "rock100k_pt.xml"), dev)
    rec, grads, step, forward, _ = train_cell(render, bt, intersect, par, pt,
                                              "rock100k_pt")
    for name in ("diffuse", "sphere_light_radiance", "vertices"):
        check(rec["max_abs_grad"][name] > 0, f"rock100k_pt {name} gradient 0")
    for part in ("launches_forward", "launches_backward"):
        check(rec[part]["nearest"] > 0 and rec[part]["anyhit"] > 0,
              f"rock100k_pt {part}: {rec[part]}")
    add(rec)
    phase("train_step", scene="rock100k_pt", res=GRAD_RES, spp=1, **rec,
          **train_times(step, forward, card))
    del pt, grads, step, forward

    # rock1800k: the multi-pack kernels, phase 6's loaded scene
    (bgroup,) = big.scene.groups
    live = big.scene.vertices.detach().requires_grad_()
    rows = bt.build_multi_tables(bgroup.pack_bvhs, live, bgroup.tri_vidx).tris
    check(not rows.requires_grad and rows.grad_fn is None,
          "rock1800k's triangle rows hold no graph")
    rec, grads, step, forward, _ = train_cell(render, bt, intersect, par, big,
                                              "rock1800k")
    check(grads["vertices"].shape == big.scene.vertices.shape
          and rec["max_abs_grad"]["vertices"] > 0,
          "rock1800k's vertex gradient")
    for part in ("launches_forward", "launches_backward"):
        check(rec[part]["nearest_multi"] > 0 and rec[part]["anyhit_multi"] > 0
              and rec[part]["nearest"] == 0 and rec[part]["anyhit"] == 0,
              f"rock1800k {part}: {rec[part]}")
    add(rec)
    phase("train_step", scene="rock1800k", res=GRAD_RES, **rec,
          table_rows_require_grad=False,
          **train_times(step, forward, card))
    return total


def bits_equal(a, b) -> bool:
    """Whether two float32 arrays (host or card) hold the same bits."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(
            a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


def add_launches(total, bt):
    for k, n in bt.LAUNCHES.items():
        total[k] += n


def kill_and_resume(render, bt, ld, spp, abort_after, total):
    """Phase 18 (a): render ``ld`` whole, then with a checkpoint saved
    every band killed after ``abort_after`` saves, then resumed; the
    resumed float film must equal the whole one bit for bit, having
    launched fewer nearest kernels, and more than none."""
    cam = render.with_spp(ld.cameras[0], spp)
    bands = -(-cam.ny // render.band_rows(cam))
    bt.reset_launch_counts()
    whole = render.render_camera(ld, 0, spp=spp)
    whole_launches = dict(bt.LAUNCHES)
    path = os.path.join(OUT, "ckpt", f"rock100k_{spp}spp.ckpt.npz")
    if os.path.exists(path):
        os.remove(path)
    try:
        render.render_camera(ld, 0, spp=spp, checkpoint=render.FilmCheckpoint(
            path, every_s=0.0), _abort_after_saves=abort_after)
        check(False, "the render was not killed")
    except KeyboardInterrupt:
        pass
    check(os.path.exists(path) and os.path.exists(path + ".preview.png"),
          "the killed render left its checkpoint and preview")
    row0 = int(np.load(path)["row0"])
    bt.reset_launch_counts()
    resumed = render.render_camera(
        ld, 0, spp=spp, checkpoint=render.FilmCheckpoint(path, every_s=0.0))
    resumed_launches = dict(bt.LAUNCHES)
    add_launches(total, bt)
    check(bits_equal(resumed, whole),
          f"the resumed {spp}-spp film differs from the whole one")
    check(0 < resumed_launches["nearest"] < whole_launches["nearest"],
          f"resumed launches {resumed_launches} against {whole_launches}")
    phase("checkpoint_resume", scene="rock100k", res=cam.nx, spp=spp,
          bands=bands, killed_after_saves=abort_after, resumed_from_row=row0,
          launches_whole=whole_launches, launches_resumed=resumed_launches,
          resumed_equals_whole=True)
    return path, bands


def cli_variant_xml() -> str:
    """rock100k at 400x400 with two cameras under build/chip_smoke: camera
    1 with a <Tonemap> writing a PNG, camera 2 (moved) writing an EXR."""
    src = open(os.path.join(SCENES, "rock100k.xml")).read()
    cam = src[src.index('        <Camera id="1">'):src.index("    </Cameras>")]
    second = (cam.replace('id="1"', 'id="2"')
              .replace("<Position>0 1.0 3.2</Position>",
                       "<Position>1.6 1.2 2.8</Position>")
              .replace("<Gaze>0 -0.28 -1</Gaze>", "<Gaze>-0.5 -0.3 -0.8</Gaze>")
              .replace("rock100k.png", "rock100k_hdr.exr"))
    src = src.replace("    </Cameras>", second + "    </Cameras>")
    src = src.replace("<ImageName>rock100k.png</ImageName>",
                      "<ImageName>rock100k_tm.png</ImageName><Tonemap>"
                      "<TMOOptions>0.18 1</TMOOptions><Saturation>1.0"
                      "</Saturation><Gamma>2.2</Gamma></Tonemap>", 1)
    src = src.replace('plyFile="rock100k.ply"', 'plyFile="%s"' % os.path.join(
        SCENES, "rock100k.ply"))
    path = os.path.join(OUT, "rock100k_cli.xml")
    with open(path, "w") as f:
        f.write(src)
    return path


def cli_phase(render, bt, load_scene, dev, total):
    """Phase 18 (b): ``render.main`` with ``--checkpoint-dir`` on the
    two-camera rock100k variant; the tonemapped PNG and the EXR must be the
    bytes of ``render_camera``'s float films written by the port's own
    writers, and the same command again launches nothing and writes the
    same bytes."""
    from raytracer795_tpu_torch.utils import exr, image_io
    from raytracer795_tpu_torch.utils.tonemap import reinhard_global

    xml = cli_variant_xml()
    out = os.path.join(OUT, "cli")
    ckpt = os.path.join(OUT, "cli_ckpt")
    for d in (out, ckpt):
        if os.path.isdir(d):
            for name in os.listdir(d):
                os.remove(os.path.join(d, name))
    argv = [xml, "-o", out, "--device", "cuda", "--checkpoint-dir", ckpt]
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    render.main(argv)
    first_s = time.perf_counter() - t0
    launches = dict(bt.LAUNCHES)
    add_launches(total, bt)
    check(launches["nearest"] > 0 and launches["anyhit"] > 0,
          f"the CLI launched both single-pack kernels: {launches}")
    ld = load_scene(xml, dev)
    check(ld.cameras[0].tonemap == (0.18, 1.0, 1.0, 2.2), "the Tonemap")
    png, hdr = (os.path.join(out, n) for n in ("rock100k_tm.png",
                                               "rock100k_hdr.exr"))
    film = render.render_camera(ld, 0)
    want_png = image_io.png_bytes(image_io.to_ldr(
        reinhard_global(film, 0.18, 1.0, 1.0, 2.2)))
    with open(png, "rb") as f:
        png_bytes = f.read()
    check(png_bytes == want_png, "the tonemapped PNG's bytes")
    ref = os.path.join(OUT, "rock100k_hdr_ref.exr")
    exr.write_exr(ref, render.render_camera(ld, 1))
    with open(hdr, "rb") as f, open(ref, "rb") as g:
        hdr_bytes = f.read()
        check(hdr_bytes == g.read(), "the EXR's bytes")
    check(np.array_equal(exr.read_exr(hdr).astype(np.float16),
                         render.render_camera(ld, 1).astype(np.float16)),
          "the EXR read back")
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    render.main(argv)
    again_s = time.perf_counter() - t0
    again = dict(bt.LAUNCHES)
    check(not any(again.values()), f"the rerun launched {again}")
    with open(png, "rb") as f, open(hdr, "rb") as g:
        check(f.read() == png_bytes and g.read() == hdr_bytes,
              "the rerun wrote other bytes")
    phase("cli_checkpoint_tonemap_exr", scene="rock100k two cameras",
          res=400, launches=launches, rerun_launches=again,
          png_equal=True, exr_equal=True, seconds=first_s,
          rerun_seconds=again_s)


def sharded_phase(render, bt, par, dev, card, rock, big, total):
    """Phase 18 (c): ``render_rays_sharded`` of rock100k's and rock1800k's
    400x400 primary rays over ``make_ray_mesh()`` and over the card listed
    twice must equal the unsharded frame bit for bit; rock100k's
    ``train_step_with_grads`` with the card listed twice must match it
    listed once at rtol 2e-3, atol 2e-3 max|g|."""
    from raytracer795_tpu_torch.models import whitted

    for name, ld, kinds in (("rock100k", rock, ("nearest", "anyhit")),
                            ("rock1800k", big,
                             ("nearest_multi", "anyhit_multi"))):
        rays, bg, key = grad_inputs(render, ld)
        want = whitted.render_rays(ld.scene, rays, bg, key)
        for mesh_name, mesh in (("make_ray_mesh()", par.make_ray_mesh()),
                                ("card twice", [dev, dev])):
            bt.reset_launch_counts()
            got = par.render_rays_sharded(ld.scene, rays, bg, key, mesh)
            torch.cuda.synchronize()
            launches = dict(bt.LAUNCHES)
            add_launches(total, bt)
            check(bits_equal(got, want),
                  f"{name} over {mesh_name} differs from the unsharded frame")
            check(all(launches[k] > 0 for k in kinds),
                  f"{name} over {mesh_name}: {launches}")
            phase("sharded_render", scene=name, res=GRAD_RES, mesh=mesh_name,
                  shards=len(mesh), equals_unsharded=True, launches=launches)

    scene = rock.scene
    rays, bg, key = grad_inputs(render, rock)
    with torch.no_grad():
        target = 0.9 * whitted.render_rays(scene, rays, bg, key)
    iters = par.resolve_whitted_iters(scene, rays, bg, key)

    def step(mesh):
        return par.train_step_with_grads(scene, rays, bg, target, key, lr=0.0,
                                         whitted_iters=iters, mesh=mesh)
    loss1, g1, _ = step([dev])
    bt.reset_launch_counts()
    loss2, g2, _ = step([dev, dev])
    add_launches(total, bt)
    launches = dict(bt.LAUNCHES)
    check(abs(float(loss2) - float(loss1)) <= 2e-3 * float(loss1),
          f"2-shard loss {float(loss2)} against {float(loss1)}")
    worst = {}
    for k in g1:
        for a, b in zip(param_leaves({k: g1[k]}), param_leaves({k: g2[k]})):
            if not a.numel():
                continue
            scale = float(a.abs().max())
            bad = int((~torch.isclose(b, a, rtol=2e-3,
                                      atol=2e-3 * scale)).sum())
            check(bad == 0 and bool(torch.isfinite(b).all()),
                  f"rock100k 2-shard {k} gradients: {bad} differ")
            worst[k] = max(worst.get(k, 0.0), float((a - b).abs().max()))
    one = host_seconds(lambda: step([dev]))
    two = host_seconds(lambda: step([dev, dev]))
    phase("sharded_train_step", scene="rock100k", res=GRAD_RES,
          loss_one=float(loss1), loss_two=float(loss2),
          max_abs_grad_diff=worst, launches_two=launches,
          tolerance="rtol 2e-3, atol 2e-3 max|g|",
          one_shard_median_s=statistics.median(one), one_shard_s=one,
          two_shard_median_s=statistics.median(two), two_shard_s=two,
          card=card)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def two_process_phase(card):
    """Phase 18 (d): ``torch.distributed.run`` of the distributed CLI with
    two processes on the one card (rock100k, 4 spp, 4 bands); rank 0's PNG
    must be the one-process CLI's bytes."""
    rock_xml = os.path.join(SCENES, "rock100k.xml")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", PYTHONPATH=HERE)
    runs = {}
    for name, cmd in (
            ("two_process", [sys.executable, "-m", "torch.distributed.run",
                             "--nnodes", "1", "--nproc_per_node", "2",
                             "--master_addr", "127.0.0.1", "--master_port",
                             str(free_port()), "-m",
                             "raytracer795_tpu_torch.parallel.distributed",
                             rock_xml, "--spp", "4", "-o",
                             os.path.join(OUT, "dist")]),
            ("one_process", [sys.executable, "-m",
                             "raytracer795_tpu_torch.render", rock_xml,
                             "--spp", "4", "-o", os.path.join(OUT, "one"),
                             "--device", "cuda"])):
        t0 = time.perf_counter()
        # a process group of its own, so that a timeout stops the ranks too
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        runs[name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"{name} exited {proc.returncode}:\n"
              f"{out[-2000:]}\n{err[-4000:]}")
    pngs = []
    for d in ("dist", "one"):
        with open(os.path.join(OUT, d, "rock100k.png"), "rb") as f:
            pngs.append(f.read())
    check(pngs[0] == pngs[1], "the two-process PNG differs from the "
          "one-process PNG")
    phase("two_process_render", scene="rock100k", res=400, spp=4,
          processes=2, png_equal=True, wall_s=runs["two_process"],
          one_process_wall_s=runs["one_process"], card=card)


def scaleout_phase(render, bt, load_scene, dev, card, rock, big):
    """Phase 18; returns its traversal launches."""
    from raytracer795_tpu_torch.parallel import shard as par

    total = dict.fromkeys(bt.LAUNCHES, 0)
    os.makedirs(os.path.join(OUT, "ckpt"), exist_ok=True)
    ld = load_scene(os.path.join(SCENES, "rock100k.xml"), dev)
    ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=MS_RES, ny=MS_RES)
    path, bands = kill_and_resume(render, bt, ld, MS_SPP, 5, total)
    kill_and_resume(render, bt, ld, 1, 1, total)

    def checkpointed():
        os.remove(path)
        render.render_camera(ld, 0, spp=MS_SPP, checkpoint=render.
                             FilmCheckpoint(path, every_s=0.0))
    saved = host_seconds(checkpointed)
    plain = host_seconds(lambda: render.render_camera(ld, 0, spp=MS_SPP))
    phase("checkpoint_time", scene="rock100k", res=MS_RES, spp=MS_SPP,
          bands=bands, saved_every_band_median_s=statistics.median(saved),
          saved_s=saved, plain_median_s=statistics.median(plain),
          plain_s=plain, save_ms_per_band=(statistics.median(saved)
                                           - statistics.median(plain))
          / bands * 1e3, card=card)
    cli_phase(render, bt, load_scene, dev, total)
    sharded_phase(render, bt, par, dev, card, rock, big, total)
    two_process_phase(card)
    return total


def profiler_phase(bt, intersect, loaded, total, card):
    """Phase 19 (a): ``profile_scene`` of rock100k at 512x512, its stages
    those of the JAX module and ``trace``/``trace_anyhit`` each launching
    its single-pack kernel and no plain walk; ``profiling.main`` with
    ``--trace-dir`` writes a trace that names the nearest kernel."""
    from raytracer795_tpu_torch import profiling

    bt.reset_launch_counts()
    with counting(intersect, PLAIN_WALKS) as plain:
        prof = profiling.profile_scene(loaded, res=PROFILE_RES, reps=5)
    add_launches(total, bt)
    launches = dict(bt.LAUNCHES)
    check([name for name, _, _ in prof] == list(PROFILE_STAGES),
          f"profile stages {[name for name, _, _ in prof]}")
    check(all(s > 0 for _, s, _ in prof), f"a stage took no time: {prof}")
    _, stages = profiling.stages(loaded, PROFILE_RES)
    by_stage = {}
    with counting(intersect, PLAIN_WALKS) as stage_plain:
        for name, fn in stages:
            bt.reset_launch_counts()
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            by_stage[name] = {k: n for k, n in bt.LAUNCHES.items() if n}
    check(not any(plain.values()) and not any(stage_plain.values()),
          f"plain walks ran in the profile: {plain}, {stage_plain}")
    check(by_stage["trace"] == {"nearest": 1}
          and by_stage["trace_anyhit"] == {"anyhit": 1},
          f"trace and trace_anyhit launches: {by_stage}")
    trace_dir = os.path.join(OUT, "profile_trace")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        profiling.main([os.path.join(SCENES, "rock100k.xml"), "--res",
                        str(PROFILE_RES), "--reps", "1", "--trace-dir",
                        trace_dir])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    check([ln["stage"] for ln in lines]
          == list(PROFILE_STAGES) + ["profiler_trace"],
          f"profiling.main printed {lines}")
    with open(lines[-1]["file"]) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    symbol = KERNEL_SYMBOLS["nearest"]
    check(any(symbol in name for name in names),
          f"the trace names no {symbol}")
    phase("profile_scene", scene="rock100k", res=PROFILE_RES, reps=5,
          stages={name: {"ms": s * 1e3, "lanes_per_s": lps}
                  for name, s, lps in prof},
          launches=launches, stage_launches=by_stage,
          main_ms={ln["stage"]: ln["ms"] for ln in lines[:-1]},
          trace_file=os.path.relpath(lines[-1]["file"], HERE),
          trace_events=len(names), card=card)


def net_phase(render, bt, load_scene, dev, rock, big, total, card):
    """Phase 19 (b): a rock100k band with stats equal to it without, bit
    for bit; net-ray counts of rock100k, rock1800k (multi-pack launches
    only) and cornellbox_pt, each twice, equal, and between the lanes and
    the gross count; the card's 64x64 cornellbox_pt count against the CPU
    port's."""
    from raytracer795_tpu_torch.bench import with_frame
    from raytracer795_tpu_torch.models import camera, whitted
    from raytracer795_tpu_torch.utils import rng

    cam = rock.cameras[0]
    px, py = camera.band_pixels(cam.nx, cam.ny, dev)
    rays = camera.primary_rays_at(cam, px, py)
    bg = render._background_radiance(rock.scene, cam, rays, px, py)
    plain = whitted.render_rays(rock.scene, rays, bg, rng.PRNGKey(0))
    counted, band_net = whitted.render_rays(rock.scene, rays, bg,
                                            rng.PRNGKey(0), with_stats=True)
    check(bits_equal(plain, counted),
          "the rock100k band with stats differs from the band without")
    phase("stats_band", scene="rock100k", res=cam.nx, lanes=px.shape[0],
          with_stats_equals_without=True, net_rays=int(band_net))

    pt = load_scene(os.path.join(SCENES, "cornellbox_pt.xml"), dev)
    for name, ld in (("rock100k", rock), ("rock1800k", big),
                     ("cornellbox_pt", with_frame(pt, MS_RES, MS_SPP))):
        c = ld.cameras[0]
        nets, secs = [], []
        for _ in range(2):
            bt.reset_launch_counts()
            t0 = time.perf_counter()
            nets.append(render.count_net_rays(ld, 0, seed=1))
            secs.append(time.perf_counter() - t0)
            add_launches(total, bt)
        launches = dict(bt.LAUNCHES)
        gross = render.gross_rays(ld.scene, c)
        lanes = c.nx * c.ny * max(1, c.num_samples)
        check(nets[0] == nets[1], f"{name}: two counts {nets}")
        check(lanes <= nets[0] <= gross,
              f"{name}: net {nets[0]} outside [{lanes}, {gross}]")
        if name == "rock1800k":
            check(launches["nearest_multi"] > 0
                  and launches["anyhit_multi"] > 0
                  and launches["nearest"] == 0 and launches["anyhit"] == 0,
                  f"rock1800k's count launched {launches}")
        phase("net_rays", scene=name, res=c.nx, spp=max(1, c.num_samples),
              net_rays=nets[0], gross_rays=gross, lanes=lanes,
              net_over_gross=nets[0] / gross, count_s=secs,
              launches=launches, card=card)

    small = {d: with_frame(load_scene(os.path.join(
        SCENES, "cornellbox_pt.xml"), d), 64, 2) for d in (dev, "cpu")}
    on_card, on_cpu = (render.count_net_rays(small[d], 0, seed=1)
                       for d in (dev, "cpu"))
    rel = abs(on_card - on_cpu) / on_cpu
    check(rel <= 1e-3, f"64x64 cornellbox_pt: card {on_card}, CPU {on_cpu}")
    phase("net_rays_card_vs_cpu", scene="cornellbox_pt", res=64, spp=2,
          card_net=on_card, cpu_net=on_cpu, difference=on_card - on_cpu,
          relative=rel)


def bench_phase(bt, rock, big, total, card):
    """Phase 19 (c): ``bench.main`` and ``bench_mesh.main`` (rock100k and
    rock1800k passed in as loaded); every line parses, carries the card,
    and has 0 < net rays/s <= gross."""
    from raytracer795_tpu_torch import bench, bench_mesh

    out = io.StringIO()
    bt.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        bench.main()
        bench_mesh.main({"rock100k.xml": rock, "rock1800k.xml": big})
    add_launches(total, bt)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    check(len(lines) == 4, f"{len(lines)} bench lines")
    for rec in lines:
        check({"metric", "value", "unit", "net_rays_per_s", "card",
               "median_s", "best_s"} <= set(rec), f"bench keys {rec}")
        check(rec["card"] == card, f"bench card {rec['card']!r}")
        check(0 < rec["net_rays_per_s"] <= rec["value"],
              f"bench rays/s {rec}")
        phase("bench", **rec)
    check(all("frame_seconds" in rec for rec in lines[1:]),
          "bench_mesh's lines carry frame_seconds")
    phase("bench_launches", launches=dict(bt.LAUNCHES))


def stats_phase(render, bt, intersect, load_scene, dev, card, rock, big):
    """Phase 19; returns its traversal launches."""
    total = dict.fromkeys(bt.LAUNCHES, 0)
    profiler_phase(bt, intersect, rock, total, card)
    net_phase(render, bt, load_scene, dev, rock, big, total, card)
    bench_phase(bt, rock, big, total, card)
    return total


def benchmark_phase(dev, rock, big, big_load_s):
    """Phase 20; returns the traversal launches of the cells' timed frames
    and steps."""
    from benchmark import cells as bench_cells
    from benchmark import run as bench_run

    total = dict.fromkeys(REPLACES, 0)
    reused = {"rock100k": (rock, None), "rock1800k": (big, big_load_s)}
    for name, cell in bench_cells.cells().items():
        loaded, load_s = reused.get(cell.config, (None, None))
        rec = bench_run.run_cell(
            dataclasses.replace(cell, warmup=1, timed=1, window_s=0.0), 0,
            dev,
            loaded=loaded, load_s=load_s)
        failed = [k for k, c in rec["checks"].items() if not c["passed"]]
        check(not failed, f"{name}: checks failed: {failed}: "
              f"{ {k: rec['checks'][k] for k in failed} }")
        unset = [k for k, v in rec["metrics"].items()
                 if v is None and not (k == "load_s" and loaded is not None)]
        check(not unset, f"{name}: metrics not set: {unset}")
        check(rec["metrics"]["kernel_launches"] > 0,
              f"{name}: the trace holds no kernel")
        if "bvh_kernel_ms" in rec["metrics"]:
            check(rec["metrics"]["bvh_kernel_ms"] > 0,
                  f"{name}: no traversal kernel time in the trace")
        if cell.config == "cornellbox_pt":
            check(not any(rec["launches"].values()),
                  f"{name}: a traversal kernel launched: {rec['launches']}")
        phase("benchmark_cell", cell=name, metrics=rec["metrics"],
              units=rec["units"], samples_ms=rec["breakdown"]["samples_ms"],
              launches=rec["launches"], counts=rec["counts"],
              checks={k: c["passed"] for k, c in rec["checks"].items()},
              readings={k: c["readings"] for k, c in rec["checks"].items()
                        if "readings" in c},
              top_device_ops=rec["breakdown"]["top_device_ops"][:3],
              idle_gaps=rec["breakdown"]["idle_gaps"][:3], card=rec["card"])
        for k, n in rec["launches"].items():
            total[k] += n
    return total


def frame_trace(fn, host=True):
    """Kernels ``fn()`` runs on the card, their device ms, and the host's
    kernel and graph launch calls (torch.profiler on the host and the
    card; on the card alone without ``host``, the host's calls None)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host else [])) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    return {"kernels_run": sum(e.count for e in kernels),
            "kernel_ms": sum(getattr(e, "self_device_time_total", getattr(
                e, "self_cuda_time_total", 0)) for e in kernels) / 1e3,
            "host_kernel_launches": sum(e.count for e in events
                                        if e.key in HOST_LAUNCHES)
            if host else None,
            "host_graph_launches": sum(e.count for e in events
                                       if e.key in GRAPH_LAUNCHES)
            if host else None}


def frame_peak_mb(fn) -> float:
    """MB the card's allocations rose to above their level before
    ``fn()``."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def graphed_resume_phase(render, ld, spp, abort_after):
    """Phase 21 (b): ``ld`` killed after ``abort_after`` checkpoint saves
    and resumed, both through the graphs, against its frame rendered op by
    op: bit for bit."""
    whole = render.render_camera(ld, 0, spp=spp, _graphs=False)
    path = os.path.join(OUT, "ckpt", "graphed.ckpt.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    try:
        render.render_camera(ld, 0, spp=spp, checkpoint=render.FilmCheckpoint(
            path, every_s=0.0), _abort_after_saves=abort_after)
        check(False, "the graphed render was not killed")
    except KeyboardInterrupt:
        pass
    row0 = int(np.load(path)["row0"])
    resumed = render.render_camera(
        ld, 0, spp=spp, checkpoint=render.FilmCheckpoint(path, every_s=0.0))
    check(bits_equal(resumed, whole), "the graphed resumed film differs "
          "from the op-by-op one")
    return row0


def graphs_phase(render, bt, load_scene, dev, card, big):
    """Phase 21: every frame through its captured graphs (utils/graphs.py)
    against the same frame op by op, on the six scenes of
    ``GRAPH_SCENES`` at 800x800: float and LDR frames bit for bit, equal
    traversal launches, no capture for seeds 2 and 3 after seed 1's float
    and LDR frames; the medians of 5 frames each way, the profiler's
    kernels and the host's launch calls of one frame each way, the peak
    allocation of the capturing frame and of one frame each way, and
    ``count_net_rays`` each way. Then a graphed kill and resume of
    cornellbox_pt. Returns the graphed frames' traversal launches."""
    from raytracer795_tpu_torch.bench import with_frame
    from raytracer795_tpu_torch.utils import graphs

    total = dict.fromkeys(bt.LAUNCHES, 0)
    reuse = {"rock1800k": big}      # captured at 800x800 in phase 20
    for name, spp in GRAPH_SCENES:
        ld = with_frame(reuse.get(name) or load_scene(
            os.path.join(SCENES, name + ".xml"), dev), GRAPH_RES, spp)
        progs = graphs.programs(ld.scene)
        before = progs.captures()
        t0 = time.perf_counter()
        capture_mb = frame_peak_mb(
            lambda: render.render_camera(ld, 0, seed=1, ldr=True))
        first_s = time.perf_counter() - t0
        render.render_camera(ld, 0, seed=1)     # the float film's tails
        captures = progs.captures() - before
        floats, ldrs, launches, peak = {}, {}, {}, {}
        for graphed in (True, False):
            bt.reset_launch_counts()
            peak[graphed] = frame_peak_mb(lambda: floats.__setitem__(
                graphed, render.render_camera(ld, 0, seed=2,
                                              _graphs=graphed)))
            launches[graphed] = dict(bt.LAUNCHES)
            if graphed:
                add_launches(total, bt)
            ldrs[graphed] = render.render_camera(ld, 0, seed=2, ldr=True,
                                                 _graphs=graphed)
        check(bits_equal(floats[True], floats[False]),
              f"{name}: the graphed float frame differs from op by op")
        check(np.array_equal(ldrs[True], ldrs[False]),
              f"{name}: the graphed LDR frame differs from op by op")
        check(launches[True] == launches[False],
              f"{name}: launches graphed {launches[True]}, op by op "
              f"{launches[False]}")
        render.render_camera(ld, 0, seed=3)
        render.render_camera(ld, 0, seed=3, ldr=True)
        again = progs.captures() - before - captures
        check(again == 0, f"{name}: seeds 2 and 3 captured {again} graphs "
              "that seed 1 did not")
        secs = {g: frame_times(render, ld, graphed=g) for g in (True, False)}
        med = {g: statistics.median(v) for g, v in secs.items()}
        check(capture_mb <= CAPTURE_PEAK_OVER_EAGER * peak[False] + 64,
              f"{name}: the capturing frame peaked at {capture_mb} MB, the "
              f"op-by-op frame at {peak[False]} MB")
        traced = {g: frame_trace(lambda: render.render_camera(
            ld, 0, seed=2, ldr=True, _graphs=g),
            host=g or name not in CARD_ONLY_TRACE) for g in (True, False)}
        nets = {g: render.count_net_rays(ld, 0, seed=4, _graphs=g)
                for g in (True, False)} if name in GRAPH_NET_SCENES else {}
        check(len(set(nets.values())) <= 1, f"{name}: net rays {nets}")
        side = {True: "graphed", False: "op_by_op"}
        phase("graphs", scene=name, res=GRAPH_RES, spp=spp,
              captures=captures, captures_second_seed=again,
              first_frame_s=first_s, float_bits_equal=True, ldr_equal=True,
              launches=launches[True],
              median_s={side[g]: med[g] for g in med},
              samples_s={side[g]: secs[g] for g in secs},
              speedup=med[False] / med[True],
              trace={side[g]: traced[g] for g in traced},
              peak_mem_mb={side[g]: peak[g] for g in peak},
              capture_peak_mem_mb=capture_mb,
              reserved_mb=torch.cuda.memory_reserved() / 1e6,
              net_rays=nets.get(True), card=card)
        if name == "cornellbox_pt":
            cam = ld.cameras[0]
            row0 = graphed_resume_phase(render, ld, spp, 5)
            phase("graphs_checkpoint_resume", scene=name, res=cam.nx,
                  spp=spp, killed_after_saves=5, resumed_from_row=row0,
                  resumed_equals_op_by_op=True)
    return total


def step_beside_programs(render, bt, intersect, rock, card):
    """Phase 21 (c): rock100k's eager train step (``train_cell``'s, lr 0)
    in ``STEP_ROUNDS`` rounds of one process, the sides' order alternating,
    each side on a new ``Scene`` object of the same tensors: one without
    programs, and one whose graphed GRAD_RES frame captured them first (as
    the benchmark's train cell renders its target frame). A side's medians
    of ``STEP_REPS`` steps a round and its peak allocations above the
    level before its scene was made; the two sides' losses must be
    equal."""
    from raytracer795_tpu_torch.bench import with_frame
    from raytracer795_tpu_torch.parallel import shard as par

    _, _, step, _, _ = train_cell(render, bt, intersect, par, rock,
                                  "rock100k")
    side = {False: "no_programs", True: "with_programs"}
    rec = {v: {"median_ms": [], "peak_mb": []} for v in side.values()}
    losses = set()
    for r in range(STEP_ROUNDS):
        for programs in ((False, True) if r % 2 == 0 else (True, False)):
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            sc = dataclasses.replace(rock.scene)
            if programs:
                render.render_camera(with_frame(dataclasses.replace(
                    rock, scene=sc), GRAD_RES, 1), 0, seed=1)
            torch.cuda.reset_peak_memory_stats()
            losses_of = []
            secs = host_seconds(lambda: losses_of.append(step(sc)[0]),
                                STEP_REPS)
            peak = torch.cuda.max_memory_allocated() - before
            losses.update(float(x) for x in losses_of)
            rec[side[programs]]["median_ms"].append(
                statistics.median(secs) * 1e3)
            rec[side[programs]]["peak_mb"].append(peak / 1e6)
            del sc
    check(len(losses) == 1, f"the step's losses differ: {losses}")
    phase("train_step_beside_programs", scene="rock100k", res=GRAD_RES,
          rounds=STEP_ROUNDS, steps=STEP_REPS, **rec, loss=losses.pop(),
          card=card)


def main() -> int:
    wall0 = time.perf_counter()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda", 0)
    phase("device", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    from raytracer795_tpu_torch import render
    from raytracer795_tpu_torch.ops import bvh
    from raytracer795_tpu_torch.ops import bvh_traverse as bt
    from raytracer795_tpu_torch.ops import intersect
    from raytracer795_tpu_torch.scene import assets
    from raytracer795_tpu_torch.scene.loader import load_scene
    from raytracer795_tpu_torch.scene.types import to_device
    from raytracer795_tpu_torch.utils.image_io import read_ppm

    # ---- 2. build ----
    _, build_s, log = bt.build_kernels()
    regs = [ln.strip() for ln in log.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill", log)]
    phase("build", seconds=build_s, ptxas=regs)
    check(not any(spills), f"ptxas reports register spills: {regs}")

    # ---- 3. kernel vs plain on the card ----
    errs, mism = [], []
    for t, n, seed in ((333, 1500, 0), (2048, 4096, 1)):
        err, bad, hits, occ = random_case(bt, t, n, seed, dev)
        errs.append(err)
        mism.append(bad)
        phase("kernel_vs_plain", case=f"random mesh {t} tris, {n} rays",
              max_abs_t_err=err, anyhit_mismatches=bad, hits=hits,
              occluded=occ)
    rock_xml = os.path.join(SCENES, "rock100k.xml")
    loaded = load_scene(rock_xml, dev)
    (group,) = loaded.scene.groups
    check(group.bvh is not None, "rock100k is one BVH group")
    prim, shadow, cap = rock_wavefronts(loaded)
    tb = bt.build_tables(group.bvh, loaded.scene.vertices, group.tri_vidx)
    eps = loaded.scene.int_eps
    # nearest on the primary wavefront, any-hit on the shadow wavefront
    for case, rays, rcap in (
            ("rock100k primary wavefront", prim,
             torch.full_like(prim.o.x, 3.0e38)),
            ("rock100k first shadow wavefront", shadow, cap)):
        err, bad, hits, occ = compare(bt, tb, rays.o, rays.d, rcap, eps)
        errs.append(err)
        mism.append(bad)
        phase("kernel_vs_plain", case=case, rays=rays.o.x.shape[0],
              max_abs_t_err=err, anyhit_mismatches=bad, hits=hits,
              occluded=occ)
    err, bad, mirror = edge_phase(bt, render, loaded, tb, shadow, cap, eps,
                                  dev)
    errs.append(err)
    mism.append(bad)

    # ---- 4. main path ----
    main_s, launches, img = main_path(render, bt, loaded, "rock100k")
    check(launches["nearest"] > 0 and launches["anyhit"] > 0,
          f"the main path launched every kernel: {launches}")
    gold = read_ppm(os.path.join(GOLDENS, "rock100k.ppm"))
    frac = float((np.abs(img - gold) > 1).mean())
    check(frac < 1e-4, f"rock100k golden: frac(|d|>1) = {frac}")
    phase("main_path", scene="rock100k", seconds=main_s, launches=launches,
          golden_frac_gt1=frac)

    for name, mean_tol, frac_tol in GOLDEN_BOUNDS:
        ld = load_scene(os.path.join(SCENES, name + ".xml"), dev)
        img = render.render_camera(ld, 0, ldr=True).astype(np.float32)
        diff = np.abs(img - read_ppm(os.path.join(GOLDENS, name + ".ppm")))
        mean, frac2 = float(diff.mean()), float((diff > 2).mean())
        check(mean < mean_tol and frac2 < frac_tol,
              f"{name} golden: mean {mean}, frac>2 {frac2}")
        phase("golden", scene=name, mean_abs=mean, frac_gt2=frac2)

    # ---- 5. times on this card ----
    rock_median_s = {}
    for res in FRAME_RES:
        ld = load_scene(rock_xml, dev)
        ld.cameras[0] = dataclasses.replace(ld.cameras[0], nx=res, ny=res)
        secs = frame_times(render, ld)
        rock_median_s[res] = statistics.median(secs)
        phase("frame_time", scene="rock100k", res=res, spp=1,
              median_s=rock_median_s[res], samples_s=secs, card=card)

    dec = bt.decode(tb)
    timing = {
        "nearest": kernel_time(
            bt, "nearest", "rock100k primary", tb, prim.o, prim.d, eps, None,
            cuda_ms(lambda: intersect._tri_bvh_candidates(
                dec, prim.o, prim.d, eps), 1), card),
        "anyhit": kernel_time(
            bt, "anyhit", "rock100k first shadow", tb, shadow.o, shadow.d,
            eps, cap, cuda_ms(lambda: intersect._tri_bvh_anyhit(
                dec, shadow.o, shadow.d, cap, eps), 1), card),
    }
    mtb, mo, md, meps = mirror
    mdec = bt.decode(mtb)
    kernel_time(bt, "nearest", "rock100k mirror bounce", mtb, mo, md, meps,
                None, cuda_ms(lambda: intersect._tri_bvh_candidates(
                    mdec, mo, md, meps), 1), card)
    # any-hit answers are booleans, so their |kernel - plain| is 0 or 1
    err_by = {"nearest": max(errs), "anyhit": float(max(mism) > 0)}

    # ---- 6. multi-pack kernels vs plain on the card ----
    big, mt, bprim, bshadow, bcap, load_s, err, bad = multi_phase(
        bt, assets, load_scene, dev)
    (bgroup,) = big.scene.groups
    beps = big.scene.int_eps
    err_by["nearest_multi"] = err
    err_by["anyhit_multi"] = bad

    # ---- 7. main path at dragon scale ----
    big_s, big_launches, img = main_path(render, bt, big, "rock1800k")
    check(big_launches["nearest_multi"] > 0
          and big_launches["anyhit_multi"] > 0,
          f"rock1800k launched both multi-pack kernels: {big_launches}")
    check(big_launches["nearest"] == 0 and big_launches["anyhit"] == 0,
          f"rock1800k launched no single-pack kernel: {big_launches}")
    gold = read_ppm(os.path.join(GOLDENS, "rock1800k.ppm"))
    frac = float((np.abs(img - gold) > 1).mean())
    check(frac < 1e-4, f"rock1800k golden: frac(|d|>1) = {frac}")
    phase("main_path", scene="rock1800k", seconds=big_s,
          launches=big_launches, golden_frac_gt1=frac)
    for k in ("nearest_multi", "anyhit_multi"):
        launches[k] = big_launches[k]

    # ---- 8. instances, batched ----
    inst = load_scene(os.path.join(SCENES, "instances_rock.xml"), dev)
    clusters = intersect._pack_clusters(inst.scene)
    check([len(g) for g in clusters.values()] == [37],
          f"one cluster of 37 groups: {clusters}")
    # the single-pack kernels vs plain on the query the batched dispatch
    # makes (intersect._batched_nearest / _batched_anyhit)
    (gis,) = clusters.values()
    base = inst.scene.groups[gis[0]]
    itb = bt.build_tables(base.bvh, inst.scene.vertices, base.tri_vidx)
    iprim, ishadow, icap = rock_wavefronts(inst)
    for case, rays, rcap in (
            ("instances_rock primary wavefront", iprim,
             torch.full_like(iprim.o.x, 3.0e38)),
            ("instances_rock first shadow wavefront", ishadow, icap)):
        o, d = intersect._concat_local_rays(inst.scene, gis, rays)
        err, bad, hits, occ = compare(bt, itb, o, d, rcap.repeat(len(gis)),
                                      inst.scene.int_eps)
        err_by["nearest"] = max(err_by["nearest"], err)
        err_by["anyhit"] = max(err_by["anyhit"], float(bad > 0))
        phase("kernel_vs_plain", case=case, groups=len(gis),
              rays=o.x.shape[0], max_abs_t_err=err, anyhit_mismatches=bad,
              hits=hits, occluded=occ)
    inst_s, inst_launches, img = main_path(render, bt, inst,
                                           "instances_rock")
    diff = np.abs(img - read_ppm(os.path.join(GOLDENS,
                                              "instances_rock.ppm")))
    mean, frac2 = float(diff.mean()), float((diff > 2).mean())
    check(mean < 0.2 and frac2 < 0.01,
          f"instances_rock golden: mean {mean}, frac>2 {frac2}")
    check(0 < inst_launches["nearest"] < 37
          and 0 < inst_launches["anyhit"] < 37,
          f"one single-pack launch per query, not per group: "
          f"{inst_launches}")
    phase("main_path", scene="instances_rock", seconds=inst_s,
          launches=inst_launches, golden_mean_abs=mean, golden_frac_gt2=frac2)

    # ---- 9. times at dragon scale and for instances ----
    secs = frame_times(render, big)
    phase("frame_time", scene="rock1800k", res=400, spp=1,
          median_s=statistics.median(secs), samples_s=secs,
          load_s=load_s, card=card)
    packs = bt.decode_multi(mt)
    timing["nearest_multi"] = kernel_time(
        bt, "nearest_multi", "rock1800k primary", mt, bprim.o, bprim.d, beps,
        None, cuda_ms(lambda: intersect._tri_bvh_candidates_multi(
            packs, bprim.o, bprim.d, beps), 1), card)
    timing["anyhit_multi"] = kernel_time(
        bt, "anyhit_multi", "rock1800k first shadow", mt, bshadow.o,
        bshadow.d, beps, bcap, cuda_ms(
            lambda: intersect._tri_bvh_anyhit_multi(
                packs, bshadow.o, bshadow.d, bcap, beps), 1), card)
    # the single-pack kernels on instances_rock's batched query
    for name, wave, rays, rcap in (
            ("nearest", "instances_rock primary, 37 instances", iprim,
             None),
            ("anyhit", "instances_rock first shadow, 37 instances",
             ishadow, icap.repeat(len(gis)))):
        o, d = intersect._concat_local_rays(inst.scene, gis, rays)
        kernel_time(bt, name, wave, itb, o, d, inst.scene.int_eps, rcap,
                    None, card)

    # one profiled rock1800k frame; the triangle-row rebuild of every
    # query (build_multi_tables) timed alone and counted over the frame
    with counting(bt, ("_tri_rows",)) as rebuilds:
        render.render_camera(big, 0, ldr=True, _graphs=False)
    rebuild_ms = cuda_ms(lambda: bt._tri_rows(big.scene.vertices,
                                              bgroup.tri_vidx), 5)
    phase("profile", scene="rock1800k", res=400, spp=1,
          **profile_frame(render, big, statistics.median(secs), 0.0),
          tri_row_rebuilds=rebuilds["_tri_rows"],
          tri_row_rebuild_ms_each=rebuild_ms,
          tri_row_rebuild_ms=rebuilds["_tri_rows"] * rebuild_ms, card=card)

    # probe: the single-pack kernels over ONE BVH of the same triangles
    verts_np = big.scene.vertices.cpu().numpy()
    tv_np = bgroup.tri_vidx.cpu().numpy()
    t0 = time.perf_counter()
    flat, perm = bvh.build(*bvh.tri_bounds(verts_np, tv_np))
    one_build_s = time.perf_counter() - t0
    tb1 = bt.build_tables(to_device(flat, dev), big.scene.vertices,
                          bgroup.tri_vidx[torch.from_numpy(perm).to(dev)])
    k1, _, _ = bt.tri_bvh_nearest(tb1, bprim.o, bprim.d, beps)
    km, _, _ = bt.tri_bvh_nearest_multi(mt, bprim.o, bprim.d, beps)
    f1 = bt.tri_bvh_anyhit(tb1, bshadow.o, bshadow.d, bcap, beps)
    fm = bt.tri_bvh_anyhit_multi(mt, bshadow.o, bshadow.d, bcap, beps)
    phase("one_tree_probe", scene="rock1800k", build_s=one_build_s,
          nodes=tb1.n_nodes, keys_equal=bool(torch.equal(k1, km)),
          anyhit_equal=bool(torch.equal(f1, fm)),
          nearest_ms=cuda_ms(lambda: bt.tri_bvh_nearest(
              tb1, bprim.o, bprim.d, beps), 20),
          anyhit_ms=cuda_ms(lambda: bt.tri_bvh_anyhit(
              tb1, bshadow.o, bshadow.d, bcap, beps), 20),
          card=card)

    # instances_rock frames: batched (the main path) against per-group
    # launches, the latter by leaving the dispatch no clusters; op by op
    # both (the scene's captured programs hold the batched dispatch)
    batched = frame_times(render, inst)
    batched_eager = frame_times(render, inst, graphed=False)
    clusters_fn = intersect._pack_clusters
    intersect._pack_clusters = lambda scene: {}
    try:
        bt.reset_launch_counts()
        render.render_camera(inst, 0, ldr=True, _graphs=False)
        per_group_launches = dict(bt.LAUNCHES)
        per_group = frame_times(render, inst, graphed=False)
    finally:
        intersect._pack_clusters = clusters_fn
    phase("instances_time", scene="instances_rock", res=400,
          batched_median_s=statistics.median(batched), batched_s=batched,
          batched_op_by_op_median_s=statistics.median(batched_eager),
          batched_launches=inst_launches,
          per_group_median_s=statistics.median(per_group),
          per_group_s=per_group, per_group_launches=per_group_launches,
          card=card)
    phase("profile", scene="instances_rock", res=400, spp=1,
          **profile_frame(render, inst, statistics.median(batched), 0.0),
          card=card)

    # ---- 10-15. the RNG, multi-sample frames and the path tracer ----
    per_draw, draw_s = rng_phase(dev)
    ms_launches = multisample_phase(render, bt, intersect, load_scene,
                                    read_ppm, dev, card, per_draw, draw_s)
    stochastic_phase(render, load_scene, read_ppm, dev)
    cornell_phase(render, load_scene, dev, card, per_draw, draw_s)
    analytic_phase(render, load_scene, dev)
    pt_launches, pt_err, pt_bad = rock_pt_phase(
        render, bt, intersect, load_scene, dev, card, per_draw, draw_s)
    # ---- 16. textures, the environment light, image backgrounds ----
    tex_launches = texture_phase(render, bt, intersect, load_scene, read_ppm,
                                 dev, card, rock_median_s[MS_RES])
    # ---- 17. gradients and the train step ----
    grad_launches = gradient_phase(render, bt, intersect, load_scene, dev,
                                   card, loaded, big)
    # ---- 18. checkpoints, tonemap and EXR, and scale-out ----
    t0 = time.perf_counter()
    scale_launches = scaleout_phase(render, bt, load_scene, dev, card,
                                    loaded, big)
    phase("phase18_wall", seconds=time.perf_counter() - t0)
    # ---- 19. the profiler, net rays and the bench entry points ----
    t0 = time.perf_counter()
    stats_launches = stats_phase(render, bt, intersect, load_scene, dev,
                                 card, loaded, big)
    phase("phase19_wall", seconds=time.perf_counter() - t0,
          launches=stats_launches)
    # ---- 20. the benchmark's cells ----
    t0 = time.perf_counter()
    bench_launches = benchmark_phase(dev, loaded, big, load_s)
    phase("phase20_wall", seconds=time.perf_counter() - t0,
          launches=bench_launches)
    # ---- 21. graphed frames against op-by-op ones ----
    t0 = time.perf_counter()
    graph_launches = graphs_phase(render, bt, load_scene, dev, card, big)
    step_beside_programs(render, bt, intersect, loaded, card)
    phase("phase21_wall", seconds=time.perf_counter() - t0,
          launches=graph_launches)
    for k in ("nearest", "anyhit"):
        launches[k] += (inst_launches[k] + ms_launches[k] + pt_launches[k]
                        + big_launches[k] + tex_launches[k])
    for k in REPLACES:
        launches[k] += (grad_launches[k] + scale_launches[k]
                        + stats_launches[k] + bench_launches[k]
                        + graph_launches[k])
    err_by["nearest"] = max(err_by["nearest"], pt_err)
    err_by["anyhit"] = max(err_by["anyhit"], pt_bad)

    kernels = [{
        "name": name, "route": "cuda",
        "source": "raytracer795_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": err_by[name], "ms": timing[name][0],
        "plain_ms": timing[name][1],
        "bound_ms": timing[name][2]["bound_ms"],
        "bound_by": timing[name][2]["bound_by"],
        "library_ms": None} for name in REPLACES]
    phase("wall", seconds=time.perf_counter() - wall0)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What each step of the BVH kernels' design is worth, on the card.

    python3 tools/torch_traverse_steps.py [--parent DIR]

Builds ``raytracer795_tpu_torch/csrc/bvh_traverse.cu`` as it stands and in
variants that each undo one step of its design or try another (exact text
substitutions of the source, built into ``build/cuda/steps/``), and, with
``--parent``, the kernels of another checkout of the port (``DIR``, for
example an earlier commit unpacked with ``git archive``) on the table
layout that checkout's wrapper made: for the multi-pack kernels, the packs'
nodes one after another with pack-local links and a [K + 1] offset array,
and no ray counter. Every version runs on the wavefronts ``chip_smoke.py``
times: rock100k's primary, first shadow and mirror-bounce wavefronts
(400x400), rock100k_pt's first diffuse-bounce and NEE wavefronts (400x400,
4 spp), instances_rock's two batched 37-instance queries, and rock1800k's
primary and first shadow wavefronts (28 packs), the variants of the
multi-pack walk on the last two only. Each version's outputs must equal
the design's bit for bit, except those of the versions in ``INEXACT``,
whose differing lanes are counted.

Times are CUDA events, the mean of 10 launches, taken in 3 rounds that
visit the versions in turn (reversed every other round); the median round
is printed. One JSON line a (wavefront, version), then the card's name and
power limit. Each build's line gives its spills and its count of SASS
instructions, in all and for each traversal kernel. Needs one CUDA card
and nvcc, as chip_smoke.py does.
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from raytracer795_tpu_torch import render  # noqa: E402
from raytracer795_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from raytracer795_tpu_torch.ops import intersect  # noqa: E402
from raytracer795_tpu_torch.scene import assets  # noqa: E402
from raytracer795_tpu_torch.scene.loader import load_scene  # noqa: E402

OUT = os.path.join(REPO, "build", "cuda", "steps")
ROUNDS, REPS = 3, 10

# The early exit that the design dropped: t first, beta and gamma only
# where the hit can count (nearest: t >= -eps and |t| < best; any-hit:
# 0 < t < cap). The shared subexpressions of tri_t and tri_test are one.
_TRI_T = """__device__ __forceinline__ float tri_t(const Ray& r,
                                        const Tri& tr) {
  const float aox = tr.p.x - r.ox;
  const float aoy = tr.p.y - r.oy;
  const float aoz = tr.p.z - r.oz;
  const float cx = tr.q.w * r.dz - tr.r.x * r.dy;
  const float cy = tr.r.x * r.dx - tr.q.z * r.dz;
  const float cz = tr.q.z * r.dy - tr.q.w * r.dx;
  const float det = tr.p.w * cx + tr.q.x * cy + tr.q.y * cz;
  return (tr.r.y * aox + tr.r.z * aoy + tr.r.w * aoz) * (1.0f / det);
}

"""
_LEAF_DOC = "// The triangles [first, first + count) of a leaf, in order,"
# The step loop of the design: one node loaded a step, once it is known.
_NEXT_LEAF = """  while (node < n_nodes) {
    const Node n = load_node(nodes, node);
    if (kPacks && node >= pack_end) {
      limit = kBig;
      const int c = node_count(n);
      if (c >= 0) pack_end = c > 0 ? node + 1 : node_link(n);
    }
    float entry;
    const bool hit = slab(r, n.lo, n.hi, &entry) && !(entry > limit);
    const int count = node_count(n);
    const int link = node_link(n);
    const bool enter = hit || (kTop && count < 0 && !r.boxed);
    node = (enter || count > 0) ? node + 1 : link;
    if (hit && count > 0) {
      *first = link;
      return count;
    }
  }
  return 0;
}"""
# The successor prefetch that the design dropped: both nodes that may come
# next (node + 1, and an inner node's miss link) loaded before the slab
# test of the current one.
_NEXT_LEAF_PREFETCH = """  if (node >= n_nodes) return 0;
  const int last = n_nodes - 1;
  Node n = load_node(nodes, node);
  for (;;) {
    const int count = node_count(n);
    const int link = node_link(n);
    if (kPacks && node >= pack_end) {
      limit = kBig;
      if (count >= 0) pack_end = count > 0 ? node + 1 : link;
    }
    const Node after = load_node(nodes, min(node + 1, last));
    const Node skip = load_node(nodes, count > 0 ? min(node + 1, last)
                                                 : min(link, last));
    float entry;
    const bool hit = slab(r, n.lo, n.hi, &entry) && !(entry > limit);
    const bool ahead = hit || (kTop && count < 0 && !r.boxed) || count > 0;
    node = ahead ? node + 1 : link;
    if (hit && count > 0) {
      *first = link;
      return count;
    }
    if (node >= n_nodes) return 0;
    n = ahead ? after : skip;
  }
}"""

# Speculative any-hit traversal (Aila and Laine, 2009), which the any-hit
# kernel's freedom of order allows: a lane that has found a leaf goes on
# walking while other lanes of its warp still look for one, and stops at
# a second leaf (walked again in the next round).
_NEXT_LEAF_SPEC = """template <bool kTop>
__device__ __forceinline__ int next_leaf_spec(
    const Ray& r, const float4* __restrict__ nodes, int n_nodes,
    float& limit, int& node, int& pack_end, int* first) {
  int count = 0;
  while (node < n_nodes) {
    const Node n = load_node(nodes, node);
    float entry;
    const bool hit = slab(r, n.lo, n.hi, &entry) && !(entry > limit);
    const int c = node_count(n);
    const int link = node_link(n);
    if (hit && c > 0) {
      if (count > 0) break;
      *first = link;
      count = c;
    }
    node = (hit || (kTop && c < 0 && !r.boxed) || c > 0) ? node + 1 : link;
    if (__all_sync(__activemask(), count > 0)) break;
  }
  return count;
}

"""
_TAKE_DOC = "// The warp's idle lanes (`idle`, a ballot)"

# The per-thread multi-pack kernels' per-ray pack list, under the
# persistent while-while loop, with no top tree: at fetch a lane
# slab-tests the K pack roots, keeps those it hits (any-hit: whose entry
# is not above the cap) sorted by root entry,
# and walks them in that order, its node cursor moving from the end of one
# listed pack to the root of the next; the best |t| is carried from pack to
# pack. Its entry points take each pack's node range [K, 2].
_LISTED = """namespace {

constexpr int kMaxListed = 64;
int g_listed_resident[2][kMaxDevices];

// The packs whose root box the ray hits (and whose root entry is not
// above cap), nearest root entry first: (key bits << 32 | pack), key =
// entry for a finite entry > 0, 0 for a finite entry <= 0, kBig otherwise.
__device__ __forceinline__ int listed_packs(const Ray& r,
                                            const float4* __restrict__ nodes,
                                            const int* __restrict__ ranges,
                                            int n_packs, float cap,
                                            unsigned long long* order) {
  int n = 0;
  for (int p = 0; p < n_packs; ++p) {
    const Node root = load_node(nodes, ranges[2 * p]);
    float entry;
    if (!slab(r, root.lo, root.hi, &entry) || entry > cap) continue;
    const float key =
        fabsf(entry) < CUDART_INF_F ? (entry > 0.0f ? entry : 0.0f) : kBig;
    const unsigned long long e =
        (static_cast<unsigned long long>(__float_as_uint(key)) << 32) |
        static_cast<unsigned int>(p);
    int j = n++;
    while (j > 0 && order[j - 1] > e) {
      order[j] = order[j - 1];
      --j;
    }
    order[j] = e;
  }
  return n;
}

// next_leaf over the listed packs: the lane walks nodes [node, end) of
// listed pack j and goes on to the root of pack j + 1 at its end; 0 once
// the list is done (j == n_listed).
__device__ __forceinline__ int next_listed_leaf(
    const Ray& r, const float4* __restrict__ nodes,
    const int* __restrict__ ranges, const unsigned long long* order,
    int n_listed, float limit, int& j, int& node, int& end, int* first) {
  for (;;) {
    while (node < end) {
      const Node n = load_node(nodes, node);
      float entry;
      const bool hit = slab(r, n.lo, n.hi, &entry) && !(entry > limit);
      const int count = node_count(n);
      const int link = node_link(n);
      node = (hit || count > 0) ? node + 1 : link;
      if (hit && count > 0) {
        *first = link;
        return count;
      }
    }
    if (++j >= n_listed) return 0;
    const int p = static_cast<int>(order[j] & 0xffffffffu);
    node = ranges[2 * p];
    end = ranges[2 * p + 1];
  }
}

template <bool kAnyhit>
__global__ void __launch_bounds__(kThreads) listed_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_cap, const float4* __restrict__ nodes,
    const int* __restrict__ ranges, const float4* __restrict__ tris,
    const float* __restrict__ eps_ptr, int n_packs, int n_rays,
    int* __restrict__ next_ray, float* __restrict__ key_out,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    unsigned char* __restrict__ found_out) {
  const float eps = *eps_ptr;
  Ray r{};
  unsigned long long order[kMaxListed];
  int n_listed = 0, j = 0, node = 0, end = 0;
  int ray = -1;
  float cap = 0.0f, best_key = kBig, best_t = 0.0f;
  int best_idx = 0;
  bool more = true;
  for (;;) {
    const unsigned idle = __ballot_sync(kFullWarp, ray < 0);
    if (more && __popc(idle) >= kRefillIdle) {
      const int base = take_rays(next_ray, idle);
      more = base + __popc(idle) < n_rays;
      const int i = base + lane_rank(idle);
      if (ray < 0 && i < n_rays) {
        r = load_ray(ox, oy, oz, dx, dy, dz, i);
        if (dead_ray(r)) {
          if (kAnyhit) {
            found_out[i] = 0;
          } else {
            key_out[i] = kBig;
            t_out[i] = 0.0f;
            idx_out[i] = 0;
          }
        } else {
          ray = i;
          cap = kAnyhit ? t_cap[i] : CUDART_INF_F;
          n_listed = listed_packs(r, nodes, ranges, n_packs, cap, order);
          j = -1;
          node = end = 0;
          best_key = kBig;
          best_t = 0.0f;
          best_idx = 0;
        }
      }
    }
    if (__ballot_sync(kFullWarp, ray >= 0) == 0) {
      if (!more) return;
      continue;
    }
    int first = 0;
    const int count =
        ray >= 0 ? next_listed_leaf(r, nodes, ranges, order, n_listed,
                                    kAnyhit ? cap : best_key, j, node, end,
                                    &first)
                 : 0;
    __syncwarp();
    if (kAnyhit) {
      if (count > 0 && anyhit_leaf(r, tris, eps, cap, first, count)) {
        found_out[ray] = 1;
        ray = -1;
      } else if (ray >= 0 && j >= n_listed) {
        found_out[ray] = 0;
        ray = -1;
      }
    } else {
      if (count > 0) {
        nearest_leaf<false>(r, tris, eps, first, count, best_key, best_key,
                            best_t, best_idx);
      }
      if (ray >= 0 && j >= n_listed) {
        key_out[ray] = best_key;
        t_out[ray] = best_t;
        idx_out[ray] = best_idx;
        ray = -1;
      }
    }
  }
}

template <bool kAnyhit>
int launch_listed(const float* ox, const float* oy, const float* oz,
                  const float* dx, const float* dy, const float* dz,
                  const float* t_cap, const void* nodes, const int* ranges,
                  const void* tris, const float* int_eps, int n_packs,
                  int n_rays, int* next_ray, float* key, float* t, int* idx,
                  unsigned char* found, void* stream) {
  if (n_packs < 1 || n_packs > kMaxListed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rays <= 0) return 0;
  const int blocks = persistent_blocks(listed_kernel<kAnyhit>,
                                       g_listed_resident[kAnyhit], n_rays);
  listed_kernel<kAnyhit>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          ox, oy, oz, dx, dy, dz, t_cap, static_cast<const float4*>(nodes),
          ranges, static_cast<const float4*>(tris), int_eps, n_packs, n_rays,
          next_ray, key, t, idx, found);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt795_bvh_nearest_listed(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const void* nodes, const int* ranges,
    const void* tris, const float* int_eps, int n_packs, int n_rays,
    int* next_ray, float* key, float* t, int* idx, void* stream) {
  return launch_listed<false>(ox, oy, oz, dx, dy, dz, nullptr, nodes, ranges,
                              tris, int_eps, n_packs, n_rays, next_ray, key,
                              t, idx, nullptr, stream);
}

extern "C" int rt795_bvh_anyhit_listed(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t_cap, const void* nodes,
    const int* ranges, const void* tris, const float* int_eps, int n_packs,
    int n_rays, int* next_ray, unsigned char* found, void* stream) {
  return launch_listed<true>(ox, oy, oz, dx, dy, dz, t_cap, nodes, ranges,
                             tris, int_eps, n_packs, n_rays, next_ray,
                             nullptr, nullptr, nullptr, found, stream);
}

"""
_ENTRY_DOC = "// C entry points for ctypes."
CARRIED = "best carried from pack to pack, top culling by it"
LISTED = "sorted pack list, no top tree (root-entry order)"
# versions whose multi-pack outputs may differ from the design's (their
# differing lanes are counted): a best carried across packs, as the
# per-thread multi-pack kernels carried it, prunes packs that may hold a nearer hit accepted
# within int_eps outside its leaf box, and breaks |t| ties between packs
# by the order it reaches them
INEXACT = {CARRIED, LISTED, "parent"}

# Each variant undoes one step of the design, or tries another: (name,
# [(text of the source, replacement)], multi-pack only?). Variants of the
# single-pack steps change the multi-pack kernels too, which share the
# walk.
VARIANTS = (
    ("design", [], False),
    # (e) lane refill: a warp takes new rays once all 32 lanes are idle,
    # or 16, or as soon as one is (the design: 8)
    ("refill at 32 idle lanes", [("kRefillIdle = 8;", "kRefillIdle = 32;")],
     False),
    ("refill at 16 idle lanes", [("kRefillIdle = 8;", "kRefillIdle = 16;")],
     False),
    ("refill at 1 idle lane", [("kRefillIdle = 8;", "kRefillIdle = 1;")],
     False),
    # (e) persistence: one 128-thread block per 128 rays, not the card's
    # resident blocks (warps still take their rays from the counter)
    ("grid of one thread a ray",
     [("return needed < resident ? needed : resident;", "return needed;")],
     False),
    # (d) while-while: a lane takes one node a step and tests a leaf as
    # soon as it reaches it
    ("one node a step (no while-while)",
     [("  while (node < n_nodes) {\n    const Node n = load_node(nodes, "
       "node);",
       "  if (node < n_nodes) {\n    const Node n = load_node(nodes, "
       "node);")], False),
    # the successor prefetch, dropped
    ("successor prefetch", [(_NEXT_LEAF, _NEXT_LEAF_PREFETCH)], False),
    # (c) the next triangle's row loaded before the current one is tested
    ("no row prefetch",
     [("  Tri cur = load_tri(tris, first);\n  for (int k = first; k <= last;"
       " ++k) {\n    const Tri nxt = load_tri(tris, min(k + 1, last));",
       "  Tri cur;\n  for (int k = first; k <= last; ++k) {\n"
       "    cur = load_tri(tris, k);\n    const Tri nxt = cur;")], False),
    # (c) the early exit, dropped
    ("early exit before beta and gamma",
     [(_LEAF_DOC, _TRI_T + _LEAF_DOC),
      ("    const bool ok = tri_test(r, cur, eps, &t);  // sets t before it "
       "is read\n    if (ok & (fabsf(t) < limit)) {",
       "    t = tri_t(r, cur);\n"
       "    if (t >= -eps && fabsf(t) < limit && "
       "tri_test(r, cur, eps, &t)) {"),
      ("    const bool ok = tri_test(r, cur, eps, &t);\n"
       "    if (ok & (t > 0.0f) & (t < cap)) {",
       "    t = tri_t(r, cur);\n"
       "    if (t > 0.0f && t < cap && t >= -eps && "
       "tri_test(r, cur, eps, &t)) {")], False),
    # (d) any-hit only: walking past a pending leaf, dropped
    ("any-hit walks past a pending leaf",
     [(_TAKE_DOC, _NEXT_LEAF_SPEC + _TAKE_DOC),
      ("next_leaf<kTop, false>(", "next_leaf_spec<kTop>(")], False),
    # the slab test's NaN-propagating max and min as one instruction each
    ("max.NaN / min.NaN",
     [("  return (a > b || is_nan(a)) ? a : b;",
       "  float m;\n  asm(\"max.NaN.f32 %0, %1, %2;\" : \"=f\"(m) : \"f\"(a),"
       " \"f\"(b));\n  return m;"),
      ("  return (a < b || is_nan(a)) ? a : b;",
       "  float m;\n  asm(\"min.NaN.f32 %0, %1, %2;\" : \"=f\"(m) : \"f\"(a),"
       " \"f\"(b));\n  return m;")], False),
    # the correctly rounded reciprocal as the intrinsic
    ("__frcp_rn(det)", [("const float inv_det = 1.0f / det;",
                         "const float inv_det = __frcp_rn(det);")], False),
    # fewer registers for more resident warps: 10 blocks an SM (51
    # registers a thread)
    ("launch bounds of 10 blocks an SM",
     [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 10)")],
     False),
    # multi-pack: the top tree culls nothing, every pack root is tested
    ("top culling off (every pack root tested)",
     [("const bool enter = hit || (kTop && count < 0 && !r.boxed);",
       "const bool enter = hit || (kTop && count < 0);")], True),
    # multi-pack: the nearest walk prunes with the group's best |t|,
    # carried from pack to pack, top nodes included
    (CARRIED, [("    float& lim = kTop ? limit : best_key;",
                "    float& lim = best_key;"),
               ("next_leaf<kTop, kTop>(", "next_leaf<kTop, false>("),
               ("nearest_leaf<kTop>(", "nearest_leaf<false>(")], True),
    (LISTED, [(_ENTRY_DOC, _LISTED + _ENTRY_DOC)], True),
)
# the parent's C entry points (those of the per-thread multi-pack
# kernels): pointers before and after the two ints; its multi-pack
# kernels take pack offsets and no ray counter
PARENT_ARGS = {"nearest": (9, 5), "anyhit": (10, 3), "nearest_multi": (10, 4),
               "anyhit_multi": (11, 2)}
LISTED_ARGS = {**bt.C_ARGS, "nearest_listed": (10, 5),
               "anyhit_listed": (11, 3)}


def variant_source(text, subs):
    for old, new in subs:
        # the substitutions are made in both single-pack leaf loops
        count = text.count(old)
        if count == 0:
            raise SystemExit(f"variant text not found in the source: {old!r}")
        text = text.replace(old, new)
    return text


def sass_instructions(so):
    """Instructions in a library's SASS (``cuobjdump -sass``): (all, {kernel:
    count}) for the traversal kernels. Two builds of a kernel with equal
    counts are very likely the same code."""
    tool = os.path.join(os.path.dirname(bt._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    total, per, fn = 0, {}, None
    for ln in out.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            fn = head.group(1)
        elif re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln):
            total += 1
            per[fn] = per.get(fn, 0) + 1
    return total, {f: c for f, c in per.items() if f and "_kernel" in f}


def build_all(parent_dir):
    """Writes and compiles every version at once (one nvcc each); returns
    {name: (ctypes library, multi-pack only?)}."""
    os.makedirs(OUT, exist_ok=True)
    src = open(bt.SOURCE).read()
    jobs = []
    for i, (name, subs, multi_only) in enumerate(VARIANTS):
        path = os.path.join(OUT, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, subs))
        jobs.append((name, path, LISTED_ARGS if name == LISTED else bt.C_ARGS,
                     multi_only))
    if parent_dir:
        path = os.path.join(parent_dir, "raytracer795_tpu_torch", "csrc",
                            "bvh_traverse.cu")
        jobs.append(("parent", path, PARENT_ARGS, False))
    procs = []
    for name, path, args, multi_only in jobs:
        so = os.path.join(OUT, f"{len(procs)}.so")
        cmd = [bt._nvcc(), *bt.NVCC_FLAGS, "-o", so, path]
        procs.append((name, so, args, multi_only, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, args, multi_only, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        total, per = sass_instructions(so)
        print(json.dumps({"built": name, "spills": spills,
                          "sass_instructions": total,
                          "sass_by_kernel": per}), flush=True)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        for kname, (n_in, n_out) in args.items():
            fn = getattr(lib, f"rt795_bvh_{kname}")
            fn.argtypes = [p] * n_in + [i, i] + [p] * n_out
            fn.restype = i
        libs[name] = (lib, multi_only)
    return libs


def parent_tables(mt):
    """The per-thread multi-pack kernels' layout of a multi table: every pack's nodes one after
    another, links pack-local, and the [K + 1] offsets of the packs."""
    rows, sizes = [], [0]
    for dec in bt.decode_multi(mt):
        link = torch.where(dec.count > 0, dec.first, dec.miss)
        rows.append(bt._node_rows(torch.stack(list(dec.bmin), 1),
                                  torch.stack(list(dec.bmax), 1), link,
                                  dec.count))
        sizes.append(dec.n_nodes)
    offsets = torch.tensor(sizes, dtype=torch.int32).cumsum(
        0, dtype=torch.int32)
    return (torch.cat(rows).contiguous(),
            offsets.to(mt.nodes.device).contiguous())


def launcher(lib, version, kind, tables, o, d, eps, cap):
    """A function that launches ``kind`` once in ``version``, and its
    output tensors."""
    n = o.x.shape[0]
    dev = o.x.device
    multi = isinstance(tables, bt.MultiTables)
    rays = [c.data_ptr() for c in (*o, *d)]
    if kind == "nearest":
        outs = (torch.empty(n, device=dev), torch.empty(n, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))
    else:
        outs = (torch.empty(n, dtype=torch.bool, device=dev),)
    extra = [] if cap is None else [cap.data_ptr()]
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    keep = []
    name = kind + ("_multi" if multi else "")
    size, scratch = tables.n_nodes, [counter.data_ptr()]
    tbl = [tables.nodes.data_ptr(), tables.tris.data_ptr(), eps.data_ptr()]
    if multi and version == "parent":
        keep = list(parent_tables(tables))
        tbl[:1] = [x.data_ptr() for x in keep]
        size, scratch = tables.n_packs, []
    elif multi and version == LISTED:
        keep = [tables.offsets.to(dev).contiguous()]
        tbl[1:1] = [keep[0].data_ptr()]
        name, size = kind + "_listed", tables.n_packs
    fn = getattr(lib, f"rt795_bvh_{name}")

    def launch():
        counter.zero_()
        err = fn(*rays, *extra, *tbl, size, n, *scratch,
                 *(x.data_ptr() for x in outs),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launch.keep = keep
    return launch, outs


def report(wave, kernel, names, runs, rays, live, multi=True):
    """Checks each version's outputs against the design's (bit for bit,
    except ``INEXACT`` ones on multi-pack queries) and prints its median
    time on one wavefront (``runs``: {version: (launch, [outputs of each
    query])})."""
    for n in names:
        runs[n][0]()
    torch.cuda.synchronize()
    ref = runs["design"][1]
    differ = {n: differing_lanes(runs[n][1], ref) for n in names}
    for n in names:
        if differ[n] and not (multi and n in INEXACT):
            raise SystemExit(f"{n} differs from the design on {wave}")
    times = {n: [] for n in names}
    for r in range(ROUNDS):
        for n in names if r % 2 == 0 else names[::-1]:
            times[n].append(cs.cuda_ms(runs[n][0], REPS))
    for n in names:
        print(json.dumps({
            "wavefront": wave, "kernel": kernel, "version": n, "rays": rays,
            "live": live, "lanes_differing_from_design": differ[n],
            "ms": statistics.median(times[n]), "rounds_ms": times[n]}),
            flush=True)


def differing_lanes(outs, ref):
    """Lanes where any output differs from the design's, summed over the
    queries (``outs``, ``ref``: one tuple of output tensors a query)."""
    total = 0
    for got, want in zip(outs, ref):
        bad = torch.zeros_like(want[0], dtype=torch.bool)
        for a, b in zip(got, want):
            bad |= a != b
        total += int(bad.sum())
    return total


def wavefronts(dev):
    """[(wavefront, kind, tables, o, d, eps, cap)] as chip_smoke.py times
    them."""
    waves = []
    rock = load_scene(os.path.join(cs.SCENES, "rock100k.xml"), dev)
    (group,) = rock.scene.groups
    tb = bt.build_tables(group.bvh, rock.scene.vertices, group.tri_vidx)
    eps = rock.scene.int_eps
    prim, shadow, cap = cs.rock_wavefronts(rock)
    mirror = [a for k, a in cs.record_queries(render, bt, rock)
              if k == "nearest"][1]
    waves += [("rock100k primary", "nearest", tb, prim.o, prim.d, eps, None),
              ("rock100k first shadow", "anyhit", tb, shadow.o, shadow.d,
               eps, cap),
              ("rock100k mirror bounce", "nearest", *mirror, None)]
    rp = load_scene(os.path.join(cs.SCENES, "rock100k_pt.xml"), dev)
    bounce, nee = cs.capture_pt_wavefronts(render, bt, rp)
    waves += [("rock100k_pt first diffuse bounce", "nearest", *bounce, None),
              ("rock100k_pt first NEE", "anyhit", nee[0], nee[1], nee[2],
               nee[4], nee[3])]
    inst = load_scene(os.path.join(cs.SCENES, "instances_rock.xml"), dev)
    (gis,) = intersect._pack_clusters(inst.scene).values()
    base = inst.scene.groups[gis[0]]
    itb = bt.build_tables(base.bvh, inst.scene.vertices, base.tri_vidx)
    iprim, ishadow, icap = cs.rock_wavefronts(inst)
    for wave, kind, rays, rcap in (
            ("instances_rock primary, 37 instances", "nearest", iprim, None),
            ("instances_rock first shadow, 37 instances", "anyhit", ishadow,
             icap.repeat(len(gis)))):
        o, d = intersect._concat_local_rays(inst.scene, gis, rays)
        waves.append((wave, kind, itb, o, d, inst.scene.int_eps, rcap))
    nu, nv = assets.ROCK1800K_GRID
    assets.ensure_rock(os.path.join(cs.SCENES, "rock1800k.ply"), nu, nv)
    big = load_scene(os.path.join(cs.SCENES, "rock1800k.xml"), dev)
    (bgroup,) = big.scene.groups
    mt = bt.build_multi_tables(bgroup.pack_bvhs, big.scene.vertices,
                               bgroup.tri_vidx)
    bprim, bshadow, bcap = cs.rock_wavefronts(big)
    waves += [("rock1800k primary", "nearest", mt, bprim.o, bprim.d,
               big.scene.int_eps, None),
              ("rock1800k first shadow", "anyhit", mt, bshadow.o,
               bshadow.d, big.scene.int_eps, bcap)]
    return waves, frame_queries(big)


def frame_queries(loaded):
    """Every multi-pack query of one frame of ``loaded``, recorded in
    order: [(kind, tables, o, d, eps, cap)]."""
    calls = []
    nearest, anyhit = bt.tri_bvh_nearest_multi, bt.tri_bvh_anyhit_multi

    def rec_nearest(mt, o, d, eps):
        calls.append(("nearest", mt, o, d, eps, None))
        return nearest(mt, o, d, eps)

    def rec_anyhit(mt, o, d, cap, eps):
        calls.append(("anyhit", mt, o, d, eps, cap))
        return anyhit(mt, o, d, cap, eps)
    bt.tri_bvh_nearest_multi, bt.tri_bvh_anyhit_multi = rec_nearest, rec_anyhit
    try:
        render.render_camera(loaded, 0, ldr=True)
    finally:
        bt.tri_bvh_nearest_multi, bt.tri_bvh_anyhit_multi = nearest, anyhit
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of the port whose kernels "
                    "are timed beside these, on their own table layout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build_all(args.parent)
    waves, frame = wavefronts(dev)
    for wave, kind, tables, o, d, eps, cap in waves:
        multi = isinstance(tables, bt.MultiTables)
        names = [n for n, (_, multi_only) in libs.items()
                 if multi or not multi_only]
        runs = {}
        for n in names:
            launch, outs = launcher(libs[n][0], n, kind, tables, o, d, eps,
                                    cap)
            runs[n] = (launch, [outs])
        report(wave, kind + ("_multi" if multi else ""), names, runs,
               o.x.shape[0], cs.live_lanes(d), multi)
    # all of a rock1800k frame's multi-pack queries, launched in turn: the
    # traversal's device time in a frame
    runs = {}
    for n in libs:
        queries = [launcher(libs[n][0], n, kind, mt, o, d, eps, cap)
                   for kind, mt, o, d, eps, cap in frame]

        def launch_all(queries=queries):
            for launch, _ in queries:
                launch()
        runs[n] = (launch_all, [outs for _, outs in queries])
    report(f"rock1800k frame, its {len(frame)} queries",
           "+".join(k for k, *_ in frame), list(libs), runs,
           sum(q[2].x.shape[0] for q in frame),
           sum(cs.live_lanes(q[3]) for q in frame))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

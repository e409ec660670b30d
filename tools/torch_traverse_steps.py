"""What each step of the single-pack BVH kernels' design is worth, on the card.

    python3 tools/torch_traverse_steps.py [--parent DIR]

Builds ``raytracer795_tpu_torch/csrc/bvh_traverse.cu`` as it stands and in
variants that each undo one step of its design (exact text substitutions
of the source, built into ``build/cuda/steps/``), and, with ``--parent``,
the kernels of another checkout of the port (``DIR``, for example an
earlier commit unpacked with ``git archive``) on the table layout that
checkout's wrapper made: 16-float triangle rows and a separate ``miss``
array. Every version runs on the wavefronts ``chip_smoke.py`` times:
rock100k's primary, first shadow and mirror-bounce wavefronts (400x400),
rock100k_pt's first diffuse-bounce and NEE wavefronts (400x400, 4 spp),
instances_rock's two batched 37-instance queries, and, with ``--parent``,
rock1800k's primary and first shadow wavefronts for the multi-pack
kernels. Each version's outputs must equal the design's bit for bit.

Times are CUDA events, the mean of 10 launches, taken in 3 rounds that
visit the versions in turn (reversed every other round); the median round
is printed. One JSON line a (wavefront, version), then the card's name and
power limit. Each build's line gives its spills and its count of SASS
instructions. Needs one CUDA card and nvcc, as chip_smoke.py does.
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
    const Node after = load_node(nodes, min(node + 1, last));
    const Node skip = load_node(nodes, count > 0 ? min(node + 1, last)
                                                 : min(link, last));
    float entry;
    const bool hit = slab(r, n.lo, n.hi, &entry) && !(entry > limit);
    const bool ahead = hit || count > 0;
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
_NEXT_LEAF_SPEC = """__device__ __forceinline__ int next_leaf_spec(
    const Ray& r, const float4* __restrict__ nodes, int n_nodes,
    float limit, int& node, int* first) {
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
    node = (hit || c > 0) ? node + 1 : link;
    if (__all_sync(__activemask(), count > 0)) break;
  }
  return count;
}

"""
_TAKE_DOC = "// The warp's idle lanes (`idle`, a ballot)"

# Each variant undoes one step of the design, or redoes one that was
# dropped: (name, [(text of the source, replacement)]).
VARIANTS = (
    ("design", []),
    # (e) lane refill: a warp takes new rays once all 32 lanes are idle,
    # or 16, or as soon as one is (the design: 8)
    ("refill at 32 idle lanes", [("kRefillIdle = 8;", "kRefillIdle = 32;")]),
    ("refill at 16 idle lanes", [("kRefillIdle = 8;", "kRefillIdle = 16;")]),
    ("refill at 1 idle lane", [("kRefillIdle = 8;", "kRefillIdle = 1;")]),
    # (e) persistence: one 128-thread block per 128 rays, not the card's
    # resident blocks (warps still take their rays from the counter)
    ("grid of one thread a ray",
     [("return needed < resident ? needed : resident;", "return needed;")]),
    # (d) while-while: a lane takes one node a step and tests a leaf as
    # soon as it reaches it
    ("one node a step (no while-while)",
     [("  while (node < n_nodes) {\n    const Node n = load_node(nodes, "
       "node);",
       "  if (node < n_nodes) {\n    const Node n = load_node(nodes, "
       "node);")]),
    # the successor prefetch, dropped
    ("successor prefetch", [(_NEXT_LEAF, _NEXT_LEAF_PREFETCH)]),
    # (c) the next triangle's row loaded before the current one is tested
    ("no row prefetch",
     [("  Tri cur = load_tri(tris, first);\n  for (int k = first; k <= last;"
       " ++k) {\n    const Tri nxt = load_tri(tris, min(k + 1, last));",
       "  Tri cur;\n  for (int k = first; k <= last; ++k) {\n"
       "    cur = load_tri(tris, k);\n    const Tri nxt = cur;")]),
    # (c) the early exit, dropped
    ("early exit before beta and gamma",
     [(_LEAF_DOC, _TRI_T + _LEAF_DOC),
      ("    if (tri_test(r, cur, eps, &t) & (fabsf(t) < best_key)) {",
       "    t = tri_t(r, cur);\n"
       "    if (t >= -eps && fabsf(t) < best_key && "
       "tri_test(r, cur, eps, &t)) {"),
      ("    if (tri_test(r, cur, eps, &t) & (t > 0.0f) & (t < cap)) {",
       "    t = tri_t(r, cur);\n"
       "    if (t > 0.0f && t < cap && t >= -eps && "
       "tri_test(r, cur, eps, &t)) {")]),
    # (d) any-hit only: walking past a pending leaf, dropped
    ("any-hit walks past a pending leaf",
     [(_TAKE_DOC, _NEXT_LEAF_SPEC + _TAKE_DOC),
      ("ray >= 0 ? next_leaf(r, nodes, n_nodes, cap, node, &first) : 0;",
       "ray >= 0 ? next_leaf_spec(r, nodes, n_nodes, cap, node, &first)"
       " : 0;")]),
    # the slab test's NaN-propagating max and min as one instruction each
    ("max.NaN / min.NaN",
     [("  return (a > b || is_nan(a)) ? a : b;",
       "  float m;\n  asm(\"max.NaN.f32 %0, %1, %2;\" : \"=f\"(m) : \"f\"(a),"
       " \"f\"(b));\n  return m;"),
      ("  return (a < b || is_nan(a)) ? a : b;",
       "  float m;\n  asm(\"min.NaN.f32 %0, %1, %2;\" : \"=f\"(m) : \"f\"(a),"
       " \"f\"(b));\n  return m;")]),
    # the correctly rounded reciprocal as the intrinsic
    ("__frcp_rn(det)", [("const float inv_det = 1.0f / det;",
                         "const float inv_det = __frcp_rn(det);")]),
    # fewer registers for more resident warps: 10 blocks an SM (51
    # registers a thread)
    ("launch bounds of 10 blocks an SM",
     [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 10)")]),
)
# the parent's C entry points: pointers before and after the two ints
PARENT_ARGS = {"nearest": (10, 4), "anyhit": (11, 2), "nearest_multi": (11, 4),
               "anyhit_multi": (12, 2)}


def variant_source(text, subs):
    for old, new in subs:
        # the substitutions are made in both single-pack leaf loops
        count = text.count(old)
        if count == 0:
            raise SystemExit(f"variant text not found in the source: {old!r}")
        text = text.replace(old, new)
    return text


def sass_instructions(so):
    """Instructions in a library's SASS (``cuobjdump -sass``), all kernels
    together: two builds with equal counts are very likely the same code."""
    tool = os.path.join(os.path.dirname(bt._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    return sum(1 for ln in out.splitlines()
               if re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln))


def build_all(parent_dir):
    """Writes and compiles every version at once (one nvcc each); returns
    {name: (ctypes library, C argument counts, parent layout?)}."""
    os.makedirs(OUT, exist_ok=True)
    src = open(bt.SOURCE).read()
    jobs = []
    for i, (name, subs) in enumerate(VARIANTS):
        path = os.path.join(OUT, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, subs))
        jobs.append((name, path, bt.C_ARGS, False))
    if parent_dir:
        path = os.path.join(parent_dir, "raytracer795_tpu_torch", "csrc",
                            "bvh_traverse.cu")
        jobs.append(("parent", path, PARENT_ARGS, True))
    procs = []
    for name, path, args, old in jobs:
        so = os.path.join(OUT, f"{len(procs)}.so")
        cmd = [bt._nvcc(), *bt.NVCC_FLAGS, "-o", so, path]
        procs.append((name, so, args, old, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, args, old, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        print(json.dumps({"built": name, "spills": spills,
                          "sass_instructions": sass_instructions(so)}),
              flush=True)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        for kname, (n_in, n_out) in args.items():
            fn = getattr(lib, f"rt795_bvh_{kname}")
            fn.argtypes = [p] * n_in + [i, i] + [p] * n_out
            fn.restype = i
        libs[name] = (lib, old)
    return libs


def parent_tables(tables):
    """The parent's layout of the same tables: node rows (bmin, first,
    bmax, count), the miss array and 16-float triangle rows."""
    packs = (bt.decode_multi(tables) if isinstance(tables, bt.MultiTables)
             else (bt.decode(tables),))
    rows, miss = [], []
    for dec in packs:
        rows.append(torch.cat(
            [torch.stack(list(dec.bmin), 1).view(torch.int32),
             dec.first[:, None],
             torch.stack(list(dec.bmax), 1).view(torch.int32),
             dec.count[:, None]], 1).view(torch.float32))
        miss.append(dec.miss.to(torch.int32))
    dec = packs[0]
    z = torch.zeros_like(dec.a.x)
    tris = torch.stack([c for v in (dec.a, dec.e1, dec.e2, dec.ng)
                        for c in (*v, z)], 1)
    return (torch.cat(rows).contiguous(), torch.cat(miss).contiguous(),
            tris.contiguous())


def launcher(lib, old, kind, tables, o, d, eps, cap):
    """A function that launches ``kind`` once, and its output tensors."""
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
    if old:
        nodes, miss, tris = parent_tables(tables)
        keep = [nodes, miss, tris]
        tbl = [nodes.data_ptr(), miss.data_ptr()]
    else:
        keep = []
        tbl = [tables.nodes.data_ptr()]
        tris = tables.tris
    if multi:
        tbl.append(tables.offsets.data_ptr())
    tbl += [tris.data_ptr(), eps.data_ptr()]
    size = tables.n_packs if multi else tables.n_nodes
    name = kind + ("_multi" if multi else "")
    fn = getattr(lib, f"rt795_bvh_{name}")
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    scratch = [] if old or multi else [counter.data_ptr()]

    def launch():
        if scratch:
            counter.zero_()
        err = fn(*rays, *extra, *tbl, size, n, *scratch,
                 *(x.data_ptr() for x in outs),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launch.keep = keep
    return launch, outs


def wavefronts(dev, with_big):
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
    if with_big:
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
    return waves


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
    waves = wavefronts(dev, with_big=bool(args.parent))
    for wave, kind, tables, o, d, eps, cap in waves:
        multi = isinstance(tables, bt.MultiTables)
        # the variants leave the multi-pack kernels as they are
        names = [n for n in libs if not multi or n in ("design", "parent")]
        runs = {n: launcher(*libs[n], kind, tables, o, d, eps, cap)
                for n in names}
        for n in names:
            runs[n][0]()
        torch.cuda.synchronize()
        ref = runs[names[0]][1]
        for n in names:
            same = all(torch.equal(a, b) for a, b in zip(runs[n][1], ref))
            if not same:
                raise SystemExit(f"{n} differs from the design on {wave}")
        times = {n: [] for n in names}
        for r in range(ROUNDS):
            for n in names if r % 2 == 0 else names[::-1]:
                times[n].append(cs.cuda_ms(runs[n][0], REPS))
        live = cs.live_lanes(d)
        for n in names:
            print(json.dumps({
                "wavefront": wave, "kernel": kind + ("_multi" if multi
                                                     else ""),
                "version": n, "rays": o.x.shape[0], "live": live,
                "ms": statistics.median(times[n]), "rounds_ms": times[n]}),
                flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

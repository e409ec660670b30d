// BVH traversal kernels for Hopper (sm_90a): nearest hit and any hit, over
// one BVH and over a group cut into packs.
//
// What they replace. raytracer795_tpu/ops/pallas_bvh.py has four TPU
// kernels on the main render path:
//   - rt795_bvh_nearest replaces _nearest_kernel (pallas_bvh.py:335),
//     reached through _nearest_call / tri_bvh_nearest;
//   - rt795_bvh_anyhit replaces _anyhit_kernel (pallas_bvh.py:404),
//     reached through _anyhit_call / tri_bvh_anyhit;
//   - rt795_bvh_nearest_multi replaces _nearest_multi_kernel
//     (pallas_bvh.py:767) with its TLAS pass _block_pack_lists (:707),
//     reached through _nearest_multi_call / tri_bvh_nearest_multi;
//   - rt795_bvh_anyhit_multi replaces _anyhit_multi_kernel
//     (pallas_bvh.py:835), reached through _anyhit_multi_call /
//     tri_bvh_anyhit_multi.
// They compute what those kernels compute, which is exactly what the
// per-lane walks _tri_bvh_candidates and _tri_bvh_anyhit of
// raytracer795_tpu/ops/intersect.py compute, but not the way they do it.
// The TPU kernels walk a whole 64x128-ray block with one scalar node
// pointer and per-lane ancestor masks. Here one lane walks one ray down the
// stackless skip-link tree of ops/bvh.py:
//   hit inner node i -> i + 1;   missed inner node i -> miss[i];
//   leaf i (tested when hit) -> i + 1,
// as a leaf's skip link is always i + 1 (the builders emit what follows a
// leaf right after it; ops/bvh_traverse.py checks it when it builds the
// tables). So each lane is exact by construction: no packet consensus, no
// ancestor bitmask, no 9-triangles-a-row packing.
//
// What bounds the single-pack kernels on the card. A ray of rock100k's
// primary wavefront visits ~62 nodes and tests ~106 triangles: ~20
// operations a node and ~26 a triangle up to t, about 0.64 G operations a
// 160k-ray wavefront, or ~19 us at the card's fp32 rate without FMA
// contraction. The tables of a 100k-triangle mesh (~6.5 MB) stay in the
// 50 MB L2, so bytes bound nothing. What keeps a SIMT walk far from that
// bound is idle lanes and latency: lanes that wait while one lane of the
// warp tests a leaf (about 80% of the arithmetic is triangle tests), lanes
// whose rays finished early or were dead from the start (NaN or
// zero-direction lanes of retired paths), and the dependent load that
// starts each step.
//
// The design of rt795_bvh_nearest and rt795_bvh_anyhit. Each step was
// timed on the card against the design without it, in one run
// (tools/torch_traverse_steps.py, on an H100 80GB HBM3 at 700 W); PERF.md
// keeps the numbers. (a) and (b) change the wrapper's tables too, so they
// were timed only as part of the whole, against the kernels they replaced:
// 2.2-2.7x faster on rock100k's and rock100k_pt's wavefronts.
//   (a) Kept. One 32-byte sector per node: (bmin.xyz, link), (bmax.xyz,
//       count), with link = first for a leaf and miss for an inner node. A
//       node step reads one sector and nothing else.
//   (b) Kept. 48-byte triangle rows, three float4s: a, e1 = a - b,
//       e2 = a - c and ng = e1 x e2 packed as 12 floats, rebuilt from the
//       live vertices on every query (the counterpart of fresh_tri_rows).
//   (c) The next triangle's row is loaded before the current one is tested:
//       kept, worth 4-15% on every wavefront. The early exit (t first, beta
//       and gamma only where a hit can count) was dropped: once the warp
//       tests its leaves together, the branch costs about what the dozen
//       operations it skips save (nearest up to 6% slower on coherent
//       rays, any-hit within 2%), and one test function is simpler.
//   (d) Kept: the step that counts. A while-while loop (Aila and Laine,
//       2009): a lane advances through inner nodes until it reaches a leaf
//       that passes, and waits there; the warp tests its lanes' leaves
//       together. Without it the kernels are 1.9-2.9x slower. No lane tests a
//       leaf later than the per-lane oracle does, so each ray's node
//       sequence, and with it every prune, update and |t| tie, is the
//       oracle's. The any-hit kernel uses the same loop: walking on past a
//       pending leaf, which its freedom of order allows, measured 3-12%
//       slower.
//   (e) Kept. Persistent warps with dynamic fetch: the grid fills the card
//       once (SMs x resident blocks); each warp takes rays 32 at a time from
//       a global counter (scratch zeroed by the wrapper), writes dead rays
//       (NaN, zero direction) out at fetch so they never enter a walk, and
//       refills its idle lanes once kRefillIdle of them are idle. A ray's
//       outputs depend on its own walk only, never on which lane took it.
//       The persistent grid is worth up to 9% (instances_rock's 5.9M-lane
//       queries); the refill threshold, from 1 to 32 idle lanes, moves no
//       wavefront by more than 5% either way, about the spread between
//       runs.
//   (f) Not tried: the node table in shared memory. The one small tree on
//       the main path (instances_rock's 511 nodes, 16 KB) serves 5.9M lanes
//       that make 1.5 node visits each, so that query is bound by its ray
//       bytes, and rock100k's 262 KB do not fit.
// Also measured and dropped: loading both nodes that may come next before
// the current node's test ends (5-21% slower), and __launch_bounds__ for
// 10 blocks an SM (spills, 4-32% slower). PTX max.NaN/min.NaN in place of
// max_nan/min_nan gained 0-5%, inside the run-to-run noise, and stays out.
// The kernels use 56-62 registers and spill nothing (nvcc -Xptxas -v).
//
// Tables (built by ops/bvh_traverse.py from the FlatBVHs and the live
// vertices):
//   nodes [2M] float4: (bmin.xyz, link as int bits), (bmax.xyz, count as
//         int bits); count == 0 marks an inner node, count == -1 an inner
//         node of a multi table's top tree. Links and leaf `first`s are
//         global.
//   tris  [3T] float4 in BVH (leaf-contiguous) order: (a.xyz, e1.x),
//         (e1.yz, e2.xy), (e2.z, ng.xyz).
//
// Arithmetic follows the JAX package operation by operation: correctly
// rounded division (build without --use_fast_math), no FMA contraction
// (build with -fmad=false), and NaN-propagating max/min in the slab test
// (fmaxf/fminf drop NaN; jnp.maximum does not). A ray with a zero
// direction component thus rejects boxes through inf/NaN as the reference
// does. No kernel adds the behind-the-origin box culls of the TPU
// kernels: a walk here visits exactly the nodes of the per-lane oracle.
//
// The multi-pack kernels (rt795_bvh_nearest_multi, rt795_bvh_anyhit_multi)
// are the same two kernels instantiated with kTop: they walk one two-level
// skip-link table (ops/bvh_traverse.py build_multi_tables). Its top tree
// has the K packs as leaves in pack order, each inner top node halving its
// range of packs, with a box that is the exact min/max of its packs' root
// boxes and count -1; each top leaf is its pack's root, followed by the
// pack's nodes, all links global. On the TPU the pack axis is a sequential
// grid dimension fed by a TLAS pass (_block_pack_lists) that gives each ray
// block a sorted pack list; here the top tree replaces both, and the walk,
// lanes and prefetch are the single-pack kernels'. Packs are reached in
// index order, and the nearest kernel prunes each pack with that pack's own
// best |t| (kPacks), restarting at each pack root, while the group's best
// takes a hit only where it is below that best too. So each pack's node
// sequence is exactly its per-pack walk's and the group's answer is the
// strict-less merge of theirs in pack order, the lower pack's prim at an
// exact |t| tie included. (A best carried from pack to pack would prune
// more, but not exactly: a hit accepted within int_eps of a triangle's
// edge can lie outside its leaf box, before the box's entry, so a pack
// pruned at an entry above the carried best may hold a nearer hit. On a
// height field of shared edges in 48 packs that changes 3 of 4,096 lanes
// at int_eps 3e-2, tests/test_torch_traverse.py.) Any-hit answers are an OR, so order and
// prune do not matter there. One rule keeps the top tree exact: a top node
// may cull only a ray whose o, d and 1/d are all finite (Ray::boxed). For
// such a ray the slab test's subtractions, multiplications and max/min are
// monotone and NaN-free, so a union box's entry is at most, and its exit
// at least, those of every pack root below it: a top node that misses, or
// is pruned (entry > kBig, the limit a pack root meets; entry > cap for
// any-hit), implies that every root below it would be. A zero or denormal
// component of d (1/d infinite) or an infinite o or d can put NaN into a
// root's slab test, which then counts as hit while the wider union box
// misses; such a ray passes every top node and meets each pack root's own
// test. There is no cap on K.
// A 1.8M-triangle group's triangle table is ~86 MB, over the L2, so leaf
// loads also reach HBM; coherent warps share them.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kBig = 3.0e38f;
// a persistent warp takes new rays for its idle lanes once at least this
// many of its 32 lanes are idle
constexpr int kRefillIdle = 8;
// devices whose resident block counts are remembered
constexpr int kMaxDevices = 64;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  // o, d and 1/d all finite: a top node of a multi table may cull the ray
  bool boxed;
};

// one node: lo = (bmin.xyz, link bits), hi = (bmax.xyz, count bits)
struct Node {
  float4 lo, hi;
};

// one triangle row: p = (a.xyz, e1.x), q = (e1.yz, e2.xy), r = (e2.z, ng.xyz)
struct Tri {
  float4 p, q, r;
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) < CUDART_INF_F;  // false for NaN
}

// jnp.maximum / jnp.minimum: NaN if either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || is_nan(a)) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || is_nan(a)) ? a : b;
}

__device__ __forceinline__ bool dead_ray(const Ray& r) {
  return is_nan(r.ox) || is_nan(r.oy) || is_nan(r.oz) || is_nan(r.dx) ||
         is_nan(r.dy) || is_nan(r.dz) ||
         (r.dx == 0.0f && r.dy == 0.0f && r.dz == 0.0f);
}

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  Ray r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.dx = dx[i];
  r.dy = dy[i];
  r.dz = dz[i];
  r.ix = 1.0f / r.dx;  // +/-inf where d == +/-0
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  r.boxed = is_finite(r.ox) && is_finite(r.oy) && is_finite(r.oz) &&
            is_finite(r.dx) && is_finite(r.dy) && is_finite(r.dz) &&
            is_finite(r.ix) && is_finite(r.iy) && is_finite(r.iz);
  return r;
}

__device__ __forceinline__ Node load_node(const float4* __restrict__ nodes,
                                          int i) {
  return Node{__ldg(nodes + 2 * i), __ldg(nodes + 2 * i + 1)};
}

__device__ __forceinline__ int node_link(const Node& n) {
  return __float_as_int(n.lo.w);
}

__device__ __forceinline__ int node_count(const Node& n) {
  return __float_as_int(n.hi.w);
}

__device__ __forceinline__ Tri load_tri(const float4* __restrict__ tris,
                                        int k) {
  const float4* row = tris + 3 * k;
  return Tri{__ldg(row), __ldg(row + 1), __ldg(row + 2)};
}

// One axis of _slab_test (intersect.py:371-387): d == 0 takes the
// negative branch.
__device__ __forceinline__ void slab_axis(float o, float d, float inv,
                                          float lo, float hi, float& entry,
                                          float& exit) {
  const bool pos = d > 0.0f;
  const float t_lo = (lo - o) * inv;
  const float t_hi = (hi - o) * inv;
  entry = max_nan(entry, pos ? t_lo : t_hi);
  exit = min_nan(exit, pos ? t_hi : t_lo);
}

// Box hit iff !(exit < entry); the entry distance goes to *entry_out.
__device__ __forceinline__ bool slab(const Ray& r, float4 lo, float4 hi,
                                     float* entry_out) {
  float entry = -CUDART_INF_F;
  float exit = CUDART_INF_F;
  slab_axis(r.ox, r.dx, r.ix, lo.x, hi.x, entry, exit);
  slab_axis(r.oy, r.dy, r.iy, lo.y, hi.y, entry, exit);
  slab_axis(r.oz, r.dz, r.iz, lo.z, hi.z, entry, exit);
  *entry_out = entry;
  return !(exit < entry);
}

// The Cramer test of _tri_test (intersect.py:204-221) in its operation
// order: whether the hit is accepted, and its t in *t_out. Every triangle
// computes beta and gamma: skipping them where no update can follow makes
// the warp branch, which measured slower (tools/torch_traverse_steps.py).
__device__ __forceinline__ bool tri_test(const Ray& r, const Tri& tr,
                                         float eps, float* t_out) {
  const float aox = tr.p.x - r.ox;
  const float aoy = tr.p.y - r.oy;
  const float aoz = tr.p.z - r.oz;
  // e2 x d
  const float cx = tr.q.w * r.dz - tr.r.x * r.dy;
  const float cy = tr.r.x * r.dx - tr.q.z * r.dz;
  const float cz = tr.q.z * r.dy - tr.q.w * r.dx;
  const float det = tr.p.w * cx + tr.q.x * cy + tr.q.y * cz;
  const float inv_det = 1.0f / det;
  const float beta = (aox * cx + aoy * cy + aoz * cz) * inv_det;
  // e1 x d
  const float gx = tr.q.x * r.dz - tr.q.y * r.dy;
  const float gy = tr.q.y * r.dx - tr.p.w * r.dz;
  const float gz = tr.p.w * r.dy - tr.q.x * r.dx;
  const float gamma = -(aox * gx + aoy * gy + aoz * gz) * inv_det;
  const float t = (tr.r.y * aox + tr.r.z * aoy + tr.r.w * aoz) * inv_det;
  *t_out = t;
  return (t >= -eps) & (beta >= -eps) & (gamma >= -eps) &
         (beta + gamma <= 1.0f);
}

// The triangles [first, first + count) of a leaf, in order, with the
// strict-less |t| update of _tri_bvh_candidates. The next row is loaded
// before the current one is tested. `limit` is the walk's best |t|, which
// prunes; with kPacks it is the pack's own, and the group's best (key, t,
// idx) takes a hit only where it is below that best too: the strict-less
// merge of the per-pack results, made hit by hit.
template <bool kPacks>
__device__ __forceinline__ void nearest_leaf(
    const Ray& r, const float4* __restrict__ tris, float eps, int first,
    int count, float& limit, float& best_key, float& best_t, int& best_idx) {
  const int last = first + count - 1;
  Tri cur = load_tri(tris, first);
  for (int k = first; k <= last; ++k) {
    const Tri nxt = load_tri(tris, min(k + 1, last));
    float t;
    const bool ok = tri_test(r, cur, eps, &t);  // sets t before it is read
    if (ok & (fabsf(t) < limit)) {
      limit = fabsf(t);
      if (!kPacks || fabsf(t) < best_key) {
        best_key = fabsf(t);
        best_t = t;
        best_idx = k;
      }
    }
    cur = nxt;
  }
}

// Any triangle of a leaf with an accepted hit at 0 < t < cap.
__device__ __forceinline__ bool anyhit_leaf(const Ray& r,
                                            const float4* __restrict__ tris,
                                            float eps, float cap, int first,
                                            int count) {
  const int last = first + count - 1;
  Tri cur = load_tri(tris, first);
  for (int k = first; k <= last; ++k) {
    const Tri nxt = load_tri(tris, min(k + 1, last));
    float t;
    const bool ok = tri_test(r, cur, eps, &t);
    if (ok & (t > 0.0f) & (t < cap)) {
      return true;
    }
    cur = nxt;
  }
  return false;
}

// Advances a lane from `node` through inner nodes to its next leaf that
// passes (box hit, entry not above `limit`), or to the end of the tree.
// Returns the leaf's triangle count (0 at the end) and its first triangle
// in *first; `node` ends just past the leaf. On a multi table (kTop) a top
// node (count < 0) passes a ray that is not `boxed` whatever its slab test
// says. With kPacks, `limit` is the current pack's best |t|: where the
// walk leaves the pack (node >= pack_end: a top node or the next pack's
// root) it starts again at kBig, and a pack root sets pack_end to its skip
// link, the end of its pack. (Loading both nodes that may come next before
// the slab test ends measured slower: the loads it adds cost more than the
// latency it hides, tools/torch_traverse_steps.py.)
template <bool kTop, bool kPacks>
__device__ __forceinline__ int next_leaf(const Ray& r,
                                         const float4* __restrict__ nodes,
                                         int n_nodes, float& limit, int& node,
                                         int& pack_end, int* first) {
  while (node < n_nodes) {
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
}

// The warp's idle lanes (`idle`, a ballot) take the next __popc(idle) rays
// of the counter, in lane order. Called by all 32 lanes; each gets the
// first ray taken.
__device__ __forceinline__ int take_rays(int* __restrict__ next_ray,
                                         unsigned idle) {
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(next_ray, __popc(idle));
  return __shfl_sync(kFullWarp, base, 0);
}

// This lane's rank among the lanes of `mask` below it.
__device__ __forceinline__ int lane_rank(unsigned mask) {
  return __popc(mask & ((1u << (threadIdx.x & 31)) - 1u));
}

// kTop: the multi-pack kernel, over a two-level table.
template <bool kTop>
__global__ void __launch_bounds__(kThreads)
    nearest_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float4* __restrict__ nodes,
                   const float4* __restrict__ tris,
                   const float* __restrict__ eps_ptr, int n_nodes,
                   int n_rays, int* __restrict__ next_ray,
                   float* __restrict__ key_out, float* __restrict__ t_out,
                   int* __restrict__ idx_out) {
  const float eps = *eps_ptr;
  Ray r{};
  int ray = -1;  // the ray this lane walks; -1 while the lane is idle
  int node = 0;
  int pack_end = 0;   // kTop: the end of the pack being walked
  float limit = kBig;  // kTop: that pack's best |t|; else best_key is used
  float best_key = kBig;
  float best_t = 0.0f;
  int best_idx = 0;
  bool more = true;  // warp-uniform: the counter may hold rays still
  for (;;) {
    const unsigned idle = __ballot_sync(kFullWarp, ray < 0);
    if (more && __popc(idle) >= kRefillIdle) {
      const int base = take_rays(next_ray, idle);
      more = base + __popc(idle) < n_rays;
      const int i = base + lane_rank(idle);
      if (ray < 0 && i < n_rays) {
        r = load_ray(ox, oy, oz, dx, dy, dz, i);
        if (dead_ray(r)) {
          key_out[i] = kBig;
          t_out[i] = 0.0f;
          idx_out[i] = 0;
        } else {
          ray = i;
          node = 0;
          pack_end = 0;
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
    float& lim = kTop ? limit : best_key;
    const int count = ray >= 0 ? next_leaf<kTop, kTop>(r, nodes, n_nodes, lim,
                                                       node, pack_end, &first)
                               : 0;
    __syncwarp();
    if (count > 0) {
      nearest_leaf<kTop>(r, tris, eps, first, count, lim, best_key, best_t,
                         best_idx);
    }
    if (ray >= 0 && node >= n_nodes) {
      key_out[ray] = best_key;
      t_out[ray] = best_t;
      idx_out[ray] = best_idx;
      ray = -1;
    }
  }
}

template <bool kTop>
__global__ void __launch_bounds__(kThreads)
    anyhit_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cap,
                  const float4* __restrict__ nodes,
                  const float4* __restrict__ tris,
                  const float* __restrict__ eps_ptr, int n_nodes, int n_rays,
                  int* __restrict__ next_ray,
                  unsigned char* __restrict__ found_out) {
  const float eps = *eps_ptr;
  Ray r{};
  int ray = -1;  // the ray this lane walks; -1 while the lane is idle
  int node = 0;
  float cap = 0.0f;
  bool more = true;  // warp-uniform: the counter may hold rays still
  for (;;) {
    const unsigned idle = __ballot_sync(kFullWarp, ray < 0);
    if (more && __popc(idle) >= kRefillIdle) {
      const int base = take_rays(next_ray, idle);
      more = base + __popc(idle) < n_rays;
      const int i = base + lane_rank(idle);
      if (ray < 0 && i < n_rays) {
        r = load_ray(ox, oy, oz, dx, dy, dz, i);
        if (dead_ray(r)) {
          found_out[i] = 0;
        } else {
          ray = i;
          node = 0;
          cap = t_cap[i];
        }
      }
    }
    if (__ballot_sync(kFullWarp, ray >= 0) == 0) {
      if (!more) return;
      continue;
    }
    int first = 0;
    int pack_end = 0;  // unused: any-hit prunes with the ray's cap alone
    const int count = ray >= 0 ? next_leaf<kTop, false>(r, nodes, n_nodes,
                                                        cap, node, pack_end,
                                                        &first)
                               : 0;
    __syncwarp();
    if (count > 0 && anyhit_leaf(r, tris, eps, cap, first, count)) {
      found_out[ray] = 1;
      ray = -1;
    } else if (ray >= 0 && node >= n_nodes) {
      found_out[ray] = 0;
      ray = -1;
    }
  }
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// resident blocks of each kernel (nearest, anyhit, nearest_multi,
// anyhit_multi) on each device, once known
int g_resident[4][kMaxDevices];

// Blocks of a persistent launch: the blocks the current device holds at
// once (SMs x resident blocks of `kernel`, remembered per device in
// `cache`), and no more than the rays need.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int* cache, int n_rays) {
  int dev = 0;
  cudaGetDevice(&dev);
  int resident = dev < kMaxDevices ? cache[dev] : 0;
  if (resident <= 0) {
    int sms = 0;
    int per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < kMaxDevices) cache[dev] = resident;
  }
  const int needed = blocks_for(n_rays);
  return needed < resident ? needed : resident;
}

template <bool kTop>
int launch_nearest(const float* ox, const float* oy, const float* oz,
                   const float* dx, const float* dy, const float* dz,
                   const void* nodes, const void* tris, const float* int_eps,
                   int n_nodes, int n_rays, int* next_ray, float* key,
                   float* t, int* idx, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = persistent_blocks(nearest_kernel<kTop>,
                                       g_resident[kTop ? 2 : 0], n_rays);
  nearest_kernel<kTop>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          ox, oy, oz, dx, dy, dz, static_cast<const float4*>(nodes),
          static_cast<const float4*>(tris), int_eps, n_nodes, n_rays,
          next_ray, key, t, idx);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTop>
int launch_anyhit(const float* ox, const float* oy, const float* oz,
                  const float* dx, const float* dy, const float* dz,
                  const float* t_cap, const void* nodes, const void* tris,
                  const float* int_eps, int n_nodes, int n_rays,
                  int* next_ray, unsigned char* found, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = persistent_blocks(anyhit_kernel<kTop>,
                                       g_resident[kTop ? 3 : 1], n_rays);
  anyhit_kernel<kTop>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          ox, oy, oz, dx, dy, dz, t_cap, static_cast<const float4*>(nodes),
          static_cast<const float4*>(tris), int_eps, n_nodes, n_rays,
          next_ray, found);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points for ctypes. Each launches on the given stream, does not
// synchronize, and returns cudaGetLastError() (0 when the launch was
// accepted). `n_nodes` counts the whole table (a multi table's top nodes
// and every pack's nodes); `next_ray` is one int the wrapper zeroes: the
// persistent warps' ray counter.
extern "C" int rt795_bvh_nearest(const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const void* nodes, const void* tris,
                                 const float* int_eps, int n_nodes,
                                 int n_rays, int* next_ray, float* key,
                                 float* t, int* idx, void* stream) {
  return launch_nearest<false>(ox, oy, oz, dx, dy, dz, nodes, tris, int_eps,
                               n_nodes, n_rays, next_ray, key, t, idx,
                               stream);
}

extern "C" int rt795_bvh_anyhit(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* t_cap, const void* nodes,
                                const void* tris, const float* int_eps,
                                int n_nodes, int n_rays, int* next_ray,
                                unsigned char* found, void* stream) {
  return launch_anyhit<false>(ox, oy, oz, dx, dy, dz, t_cap, nodes, tris,
                              int_eps, n_nodes, n_rays, next_ray, found,
                              stream);
}

extern "C" int rt795_bvh_nearest_multi(const float* ox, const float* oy,
                                       const float* oz, const float* dx,
                                       const float* dy, const float* dz,
                                       const void* nodes, const void* tris,
                                       const float* int_eps, int n_nodes,
                                       int n_rays, int* next_ray, float* key,
                                       float* t, int* idx, void* stream) {
  return launch_nearest<true>(ox, oy, oz, dx, dy, dz, nodes, tris, int_eps,
                              n_nodes, n_rays, next_ray, key, t, idx, stream);
}

extern "C" int rt795_bvh_anyhit_multi(const float* ox, const float* oy,
                                      const float* oz, const float* dx,
                                      const float* dy, const float* dz,
                                      const float* t_cap, const void* nodes,
                                      const void* tris, const float* int_eps,
                                      int n_nodes, int n_rays, int* next_ray,
                                      unsigned char* found, void* stream) {
  return launch_anyhit<true>(ox, oy, oz, dx, dy, dz, t_cap, nodes, tris,
                             int_eps, n_nodes, n_rays, next_ray, found,
                             stream);
}

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
// pointer and per-lane ancestor masks. Here one thread walks one ray down
// the stackless skip-link tree of ops/bvh.py:
//   hit inner node i -> i + 1;   miss, or leaf done -> miss[i];
// so each thread is exact per lane by construction: no packet consensus,
// no ancestor bitmask, no 9-triangles-a-row packing.
//
// What bounds them on the card. The walk does a few dozen flops per node
// and per triangle, and every step first waits for a dependent load: the
// next node's two float4s, then a leaf's triangles, with addresses that
// differ from thread to thread. The tables for a 100k-triangle mesh are a
// few MB and stay in the 50 MB L2, so the kernels are bound by the latency
// of those divergent L2 loads, not by arithmetic or HBM bandwidth. The
// tile-swizzled lane order of models/camera.py (64x64-pixel tiles) puts
// neighbouring pixels in one warp, so a warp's rays take nearly the same
// path and share most of their loads; shadow and bounce wavefronts keep
// that order. Making them faster (persistent threads, wider trees,
// treelets) is later work.
//
// Tables (built by ops/bvh_traverse.py from the FlatBVHs and the live
// vertices):
//   nodes [2M] float4: (bmin.xyz, first as int bits), (bmax.xyz, count as
//         int bits); count == 0 marks an inner node.
//   miss  [M]  int skip links; M means done (pack-local in multi tables).
//   tris  [4T] float4 in BVH (leaf-contiguous) order: a, e1 = a - b,
//         e2 = a - c, ng = e1 x e2 (w unused).
//   offsets [K + 1] int (multi tables only): pack p owns nodes
//         [offsets[p], offsets[p + 1]), its root first; leaf `first`
//         indices are global into the one tris table.
//
// Arithmetic follows the JAX package operation by operation: correctly
// rounded division (build without --use_fast_math), no FMA contraction
// (build with -fmad=false), and NaN-propagating max/min in the slab test
// (fmaxf/fminf drop NaN; jnp.maximum does not). A ray with a zero
// direction component thus rejects boxes through inf/NaN as the reference
// does. No kernel adds the behind-the-origin box culls of the TPU
// kernels: a walk here visits exactly the nodes of the per-lane oracle.
//
// The multi-pack kernels. On the TPU the pack axis is a sequential grid
// dimension and a separate TLAS pass gives each 16x128-ray block a culled
// pack list sorted front to back by root entry, so that the per-lane
// `entry > best` prune kills occluded packs at their root. Here one thread
// does all of it for its own ray: it slab-tests the K pack roots with the
// same math, keeps the packs whose root it hits in a list sorted by root
// entry (insertion sort of (entry bits, pack) pairs; NaN and infinite
// entries last, as the TLAS sanitizes them), and walks each listed pack's
// tree from its root, carrying one best (key, t, idx) from pack to pack.
// The order is a heuristic only: every listed pack is walked with the
// same prune as the per-pack oracle walk, so no mask, key or t depends on
// it; where two packs hold hits of exactly equal |t|, the pack reached
// first keeps its prim id (the per-pack oracle merge keeps the lower
// pack). The any-hit kernel drops packs whose root entry exceeds its cap
// and stops at its first hit. What bounds them: the K root tests read the
// same 2K float4s in every thread (broadcast loads, cached), and the list
// lives in local memory (kMaxPacks x 8 bytes a thread, L1-cached). A
// 1.8M-triangle group's triangle table is ~115 MB, over twice the L2, so
// leaf loads also reach HBM; coherent warps share them.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 3.0e38f;
// most packs a multi-pack kernel takes (ops/bvh_traverse.py MAX_PACKS)
constexpr int kMaxPacks = 64;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

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
  return r;
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

// Cramer test of _tri_test (intersect.py:204-221), same operation order.
__device__ __forceinline__ bool tri_test(const Ray& r,
                                         const float4* __restrict__ tri,
                                         float eps, float* t_out) {
  const float4 a = tri[0];
  const float4 e1 = tri[1];
  const float4 e2 = tri[2];
  const float4 ng = tri[3];
  const float aox = a.x - r.ox;
  const float aoy = a.y - r.oy;
  const float aoz = a.z - r.oz;
  // e2 x d
  const float cx = e2.y * r.dz - e2.z * r.dy;
  const float cy = e2.z * r.dx - e2.x * r.dz;
  const float cz = e2.x * r.dy - e2.y * r.dx;
  const float det = e1.x * cx + e1.y * cy + e1.z * cz;
  const float inv_det = 1.0f / det;
  const float beta = (aox * cx + aoy * cy + aoz * cz) * inv_det;
  // e1 x d
  const float gx = e1.y * r.dz - e1.z * r.dy;
  const float gy = e1.z * r.dx - e1.x * r.dz;
  const float gz = e1.x * r.dy - e1.y * r.dx;
  const float gamma = -(aox * gx + aoy * gy + aoz * gz) * inv_det;
  const float t = (ng.x * aox + ng.y * aoy + ng.z * aoz) * inv_det;
  *t_out = t;
  return t >= -eps && beta >= -eps && gamma >= -eps && beta + gamma <= 1.0f;
}

// _tri_bvh_candidates per thread over the tree of nodes [base, end): the
// nearest triangle by |t|, strict-less updates in leaf order, nodes pruned
// when their entry exceeds the best. miss links are relative to base.
__device__ __forceinline__ void nearest_walk(
    const Ray& r, const float4* __restrict__ nodes,
    const int* __restrict__ miss, const float4* __restrict__ tris, float eps,
    int base, int end, float& best_key, float& best_t, int& best_idx) {
  int node = base;
  while (node < end) {
    const float4 lo = nodes[2 * node];
    const float4 hi = nodes[2 * node + 1];
    float entry;
    const bool hit = slab(r, lo, hi, &entry) && !(entry > best_key);
    const int count = __float_as_int(hi.w);
    if (hit && count > 0) {
      const int first = __float_as_int(lo.w);
      for (int k = first; k < first + count; ++k) {
        float t;
        const bool ok = tri_test(r, tris + 4 * k, eps, &t);
        const float key = ok ? fabsf(t) : kBig;
        if (key < best_key) {
          best_key = key;
          best_t = t;
          best_idx = k;
        }
      }
    }
    node = (hit && count == 0) ? node + 1 : base + miss[node];
  }
}

// _tri_bvh_anyhit per thread over the tree of nodes [base, end): true at
// the first triangle with 0 < t < cap; nodes pruned when their entry
// exceeds the cap.
__device__ __forceinline__ bool anyhit_walk(
    const Ray& r, const float4* __restrict__ nodes,
    const int* __restrict__ miss, const float4* __restrict__ tris, float eps,
    float cap, int base, int end) {
  int node = base;
  while (node < end) {
    const float4 lo = nodes[2 * node];
    const float4 hi = nodes[2 * node + 1];
    float entry;
    const bool hit = slab(r, lo, hi, &entry) && !(entry > cap);
    const int count = __float_as_int(hi.w);
    if (hit && count > 0) {
      const int first = __float_as_int(lo.w);
      for (int k = first; k < first + count; ++k) {
        float t;
        if (tri_test(r, tris + 4 * k, eps, &t) && t > 0.0f && t < cap) {
          return true;
        }
      }
    }
    node = (hit && count == 0) ? node + 1 : base + miss[node];
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
    nearest_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float4* __restrict__ nodes,
                   const int* __restrict__ miss,
                   const float4* __restrict__ tris,
                   const float* __restrict__ eps_ptr, int n_nodes,
                   int n_rays, float* __restrict__ key_out,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float best_key = kBig;
  float best_t = 0.0f;
  int best_idx = 0;
  if (!dead_ray(r)) {
    nearest_walk(r, nodes, miss, tris, *eps_ptr, 0, n_nodes, best_key,
                 best_t, best_idx);
  }
  key_out[i] = best_key;
  t_out[i] = best_t;
  idx_out[i] = best_idx;
}

__global__ void __launch_bounds__(kThreads)
    anyhit_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ t_cap,
                  const float4* __restrict__ nodes,
                  const int* __restrict__ miss,
                  const float4* __restrict__ tris,
                  const float* __restrict__ eps_ptr, int n_nodes, int n_rays,
                  unsigned char* __restrict__ found_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const bool found =
      !dead_ray(r) &&
      anyhit_walk(r, nodes, miss, tris, *eps_ptr, t_cap[i], 0, n_nodes);
  found_out[i] = found ? 1 : 0;
}

// The packs whose root box the ray hits (and, for any-hit, whose root
// entry does not exceed cap), nearest root entry first: each entry of
// `order` is (key bits << 32 | pack) with key = entry for a finite entry
// > 0, 0 for a finite entry <= 0, kBig otherwise; ties go to the lower
// pack. Returns the list's length.
__device__ __forceinline__ int pack_order(const Ray& r,
                                          const float4* __restrict__ nodes,
                                          const int* __restrict__ offsets,
                                          int n_packs, float cap,
                                          unsigned long long* order) {
  int n = 0;
  for (int p = 0; p < n_packs; ++p) {
    const int root = offsets[p];
    float entry;
    if (!slab(r, nodes[2 * root], nodes[2 * root + 1], &entry) ||
        entry > cap) {
      continue;
    }
    // fabsf(NaN) < inf is false: NaN and +/-inf entries sort last
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

__device__ __forceinline__ int listed_pack(unsigned long long e) {
  return static_cast<int>(e & 0xffffffffu);
}

__global__ void __launch_bounds__(kThreads) nearest_multi_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float4* __restrict__ nodes, const int* __restrict__ miss,
    const int* __restrict__ offsets, const float4* __restrict__ tris,
    const float* __restrict__ eps_ptr, int n_packs, int n_rays,
    float* __restrict__ key_out, float* __restrict__ t_out,
    int* __restrict__ idx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float eps = *eps_ptr;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float best_key = kBig;
  float best_t = 0.0f;
  int best_idx = 0;
  if (!dead_ray(r)) {
    unsigned long long order[kMaxPacks];
    const int n = pack_order(r, nodes, offsets, n_packs, CUDART_INF_F, order);
    for (int j = 0; j < n; ++j) {
      const int p = listed_pack(order[j]);
      nearest_walk(r, nodes, miss, tris, eps, offsets[p], offsets[p + 1],
                   best_key, best_t, best_idx);
    }
  }
  key_out[i] = best_key;
  t_out[i] = best_t;
  idx_out[i] = best_idx;
}

__global__ void __launch_bounds__(kThreads) anyhit_multi_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_cap, const float4* __restrict__ nodes,
    const int* __restrict__ miss, const int* __restrict__ offsets,
    const float4* __restrict__ tris, const float* __restrict__ eps_ptr,
    int n_packs, int n_rays, unsigned char* __restrict__ found_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float eps = *eps_ptr;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const float cap = t_cap[i];
  bool found = false;
  if (!dead_ray(r)) {
    unsigned long long order[kMaxPacks];
    const int n = pack_order(r, nodes, offsets, n_packs, cap, order);
    for (int j = 0; j < n && !found; ++j) {
      const int p = listed_pack(order[j]);
      found = anyhit_walk(r, nodes, miss, tris, eps, cap, offsets[p],
                          offsets[p + 1]);
    }
  }
  found_out[i] = found ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// C entry points for ctypes. Each launches on the given stream, does not
// synchronize, and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int rt795_bvh_nearest(const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const void* nodes, const int* miss,
                                 const void* tris, const float* int_eps,
                                 int n_nodes, int n_rays, float* key,
                                 float* t, int* idx, void* stream) {
  nearest_kernel<<<blocks_for(n_rays), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, static_cast<const float4*>(nodes), miss,
      static_cast<const float4*>(tris), int_eps, n_nodes, n_rays, key, t,
      idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt795_bvh_anyhit(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const float* t_cap, const void* nodes,
                                const int* miss, const void* tris,
                                const float* int_eps, int n_nodes, int n_rays,
                                unsigned char* found, void* stream) {
  anyhit_kernel<<<blocks_for(n_rays), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, t_cap, static_cast<const float4*>(nodes), miss,
      static_cast<const float4*>(tris), int_eps, n_nodes, n_rays, found);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt795_bvh_nearest_multi(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const void* nodes, const int* miss,
    const int* offsets, const void* tris, const float* int_eps, int n_packs,
    int n_rays, float* key, float* t, int* idx, void* stream) {
  if (n_packs < 1 || n_packs > kMaxPacks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nearest_multi_kernel<<<blocks_for(n_rays), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, static_cast<const float4*>(nodes), miss,
      offsets, static_cast<const float4*>(tris), int_eps, n_packs, n_rays,
      key, t, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt795_bvh_anyhit_multi(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* t_cap, const void* nodes,
    const int* miss, const int* offsets, const void* tris,
    const float* int_eps, int n_packs, int n_rays, unsigned char* found,
    void* stream) {
  if (n_packs < 1 || n_packs > kMaxPacks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  anyhit_multi_kernel<<<blocks_for(n_rays), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, t_cap, static_cast<const float4*>(nodes), miss,
      offsets, static_cast<const float4*>(tris), int_eps, n_packs, n_rays,
      found);
  return static_cast<int>(cudaGetLastError());
}

// Flat-BVH builder of the PyTorch port: a copy of the JAX package's
// raytracer795_tpu/native/bvh_builder.cpp, kept here so that the port
// reads no file of that package. Its trees are leaf for leaf the JAX
// loader's (tests/test_torch_scene.py, tests/test_torch_multipack.py).
//
// The reference builds one pointer-tree BVH per object at render start
// (src/BVH.cpp:53-110): round-robin X/Y/Z axis, split at the median of the
// primitive centers (nth_element equivalent of FindMedian,
// src/BVH.cpp:117-135), depth cap 30. This builder keeps that split rule but
// emits a flat layout instead of a pointer tree: a single DFS-ordered
// node array with skip links, so the device traversal is a stackless
// while-loop (hit an inner node -> i+1; miss or finish a leaf -> miss[i]).
//
// Leaves hold at most `leaf_size` primitives; ranges that would exceed it
// (depth cap) are emitted as a chain of consecutive leaves sharing one bbox.
// `perm` maps the leaf-contiguous primitive order back to input order; the
// caller permutes its primitive SoA once so leaf slots are contiguous reads.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Builder {
  const float* bmin;     // [n, 3] per-primitive bbox min
  const float* bmax;     // [n, 3] per-primitive bbox max
  const float* center;   // [n, 3] per-primitive center
  int leaf_size;
  int max_depth;

  std::vector<int32_t> perm;      // current primitive order (mutated in place)
  // node SoA output
  std::vector<float> nbmin, nbmax;
  std::vector<int32_t> nfirst, ncount, nmiss;

  int emit_node(float lo[3], float hi[3], int first, int count) {
    int idx = static_cast<int>(nfirst.size());
    nbmin.insert(nbmin.end(), lo, lo + 3);
    nbmax.insert(nbmax.end(), hi, hi + 3);
    nfirst.push_back(first);
    ncount.push_back(count);
    nmiss.push_back(-1);  // patched after the subtree is emitted
    return idx;
  }

  void range_bbox(int lo_i, int hi_i, float lo[3], float hi[3]) const {
    lo[0] = lo[1] = lo[2] = 3.0e38f;
    hi[0] = hi[1] = hi[2] = -3.0e38f;
    for (int i = lo_i; i < hi_i; ++i) {
      const int p = perm[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], bmin[3 * p + a]);
        hi[a] = std::max(hi[a], bmax[3 * p + a]);
      }
    }
  }

  // Build primitives perm[lo..hi) at `depth` splitting on `axis`; appends the
  // subtree in DFS order and patches skip links (miss = index just past the
  // subtree, i.e. nodes.size() when the recursion returns).
  void build(int lo, int hi, int depth, int axis) {
    float blo[3], bhi[3];
    range_bbox(lo, hi, blo, bhi);
    const int count = hi - lo;
    if (count <= leaf_size) {
      int idx = emit_node(blo, bhi, lo, count);
      nmiss[idx] = static_cast<int>(nfirst.size());
      return;
    }
    if (depth >= max_depth) {
      // leaf chain: consecutive leaves of <= leaf_size prims, shared bbox
      for (int s = lo; s < hi; s += leaf_size) {
        int idx = emit_node(blo, bhi, s, std::min(leaf_size, hi - s));
        nmiss[idx] = static_cast<int>(nfirst.size());
      }
      return;
    }
    int idx = emit_node(blo, bhi, 0, 0);
    const int mid = lo + count / 2;  // median split (src/BVH.cpp:117-135)
    std::nth_element(
        perm.begin() + lo, perm.begin() + mid, perm.begin() + hi,
        [&](int32_t a, int32_t b) {
          return center[3 * a + axis] < center[3 * b + axis];
        });
    const int next_axis = (axis + 1) % 3;  // round-robin (src/BVH.cpp:76-90)
    build(lo, mid, depth + 1, next_axis);
    build(mid, hi, depth + 1, next_axis);
    nmiss[idx] = static_cast<int>(nfirst.size());
  }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2*n), or -1 on bad input. Output buffers must
// hold 2*n nodes (node_bmin/node_bmax: 6*n floats each; first/count/miss:
// 2*n int32) and perm n int32.
int rt795_build_bvh(const float* prim_bmin, const float* prim_bmax,
                    const float* centers, int n_prims, int leaf_size,
                    int max_depth, float* node_bmin, float* node_bmax,
                    int32_t* node_first, int32_t* node_count,
                    int32_t* node_miss, int32_t* perm_out) {
  if (n_prims <= 0 || leaf_size <= 0) return -1;
  Builder b;
  b.bmin = prim_bmin;
  b.bmax = prim_bmax;
  b.center = centers;
  b.leaf_size = leaf_size;
  b.max_depth = max_depth;
  b.perm.resize(n_prims);
  for (int i = 0; i < n_prims; ++i) b.perm[i] = i;
  size_t cap = 2 * static_cast<size_t>(n_prims);
  b.nbmin.reserve(3 * cap);
  b.nbmax.reserve(3 * cap);
  b.nfirst.reserve(cap);
  b.ncount.reserve(cap);
  b.nmiss.reserve(cap);

  b.build(0, n_prims, 0, 0);

  const int n_nodes = static_cast<int>(b.nfirst.size());
  if (static_cast<size_t>(n_nodes) > cap) return -1;  // cannot happen
  std::copy(b.nbmin.begin(), b.nbmin.end(), node_bmin);
  std::copy(b.nbmax.begin(), b.nbmax.end(), node_bmax);
  std::copy(b.nfirst.begin(), b.nfirst.end(), node_first);
  std::copy(b.ncount.begin(), b.ncount.end(), node_count);
  std::copy(b.nmiss.begin(), b.nmiss.end(), node_miss);
  std::copy(b.perm.begin(), b.perm.end(), perm_out);
  return n_nodes;
}
}

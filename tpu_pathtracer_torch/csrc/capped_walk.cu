// Range-capped nearest-hit BVH walk with Moller-Trumbore rows: the
// shadow-ray query, on the warp-cooperative walk of walk_common.cuh.
//
// Replaces the TPU kernel _traverse_kernel (tpu_pathtracer/ops/
// pallas_traverse.py, via intersect_bvh_pallas with resolve=False and
// prepass=0).  The TPU kernel stepped a ray tile through min(node pointer)
// one node at a time; here each lane steps its own ray over the same
// DFS-threaded layout (lay.nodes_packed: a node is two 16-byte loads) to the
// next leaf it enters, and the warp serves the leaves entered together, one
// leaf a step over all 32 lanes, or lane by lane where that takes fewer
// row-test slots.  best_t is seeded by
// the per-ray cap, so every subtree beyond the sampled light point is culled;
// there is no prepass.
//
// Contract: the nearest hit with strict < in visit order (leaf rows in DFS
// order, ascending within a leaf), seeded by the cap.  Writes 4 rows: t, u,
// v and the original triangle id (inactive lanes and lanes that latched
// nothing: cap, 0, 0, 0, written as literals: the zero sentinel row would
// give u = -0.0).  The walk latches (t, row) only; u, v and the original id
// are read from the winning row once the walk is over (mt_row again: the
// same operations on the same values as the test that won, so the same bits
// as the plain version's latch).  The wrapper turns t >= cap into a miss.
//
// What bounds it on an H100: shadow walks are short (the cap prunes them)
// and the leaf-8 tables of Water-plastic (2,417 nodes = 77 KB packed, 680 KB
// of rows) stay in L1/L2, so the walk is bound by the latency of its
// dependent node loads while a warp waits for its slowest lane, as the
// nearest-hit walks are (walk_common.cuh).  The measured share of its bound:
// PERF.md section 6 (row 2).
#include "walk_common.cuh"

namespace {

__global__ void __launch_bounds__(tpupt::kWalkMaxThreads, 1) capped_walk_kernel(
    tpupt::WalkArgs a, float* __restrict__ out) {
  const int warps = blockDim.x >> 5;
  const int tiles = (a.n + 31) >> 5;
  for (int tile = blockIdx.x * warps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * warps) {
    const int i = tile * 32 + (threadIdx.x & 31);
    tpupt::Ray r;
    const bool live = tpupt::load_ray(a, i, &r);
    float best_t = i < a.n ? a.t_max[i] : 0.0f;
    int best_row = a.num_tris;
    int useful = 0, slots = 0;
    tpupt::walk_nearest<true, false>(a, live, r, &best_t, &best_row, &useful, &slots);
    if (i < a.n) {
      float u = 0.0f, v = 0.0f, orig = 0.0f;
      if (best_row < a.num_tris) {
        const float* row = a.rows + 24 * best_row;
        float tt;
        tpupt::mt_row(row, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, a.t_min, &tt, &u, &v);
        orig = __ldg(row + 9);
      }
      out[i] = best_t;
      out[a.n + i] = u;
      out[2 * a.n + i] = v;
      out[3 * a.n + i] = orig;
    }
  }
}

}  // namespace

extern "C" int tpupt_capped_walk(
    const float* o, const float* d, const unsigned char* active,
    const float* cap, const float* packed, const float* tris, int num_nodes,
    int num_tris, float t_min, int n, float* out, void* stream) {
  if (n > 0) {
    const tpupt::WalkArgs a = {o, d, active, cap, reinterpret_cast<const float4*>(packed),
                               tris, nullptr, 0, 0.0f, 0.0f, 0.0f, num_nodes, num_tris,
                               t_min, n};
    capped_walk_kernel<<<tpupt::walk_blocks(n), tpupt::kWalkThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, out);
  }
  return static_cast<int>(cudaGetLastError());
}

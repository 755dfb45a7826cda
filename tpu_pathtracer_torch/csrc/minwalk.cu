// Nearest-hit BVH walk with Moller-Trumbore rows and the shading payload
// resolved in the kernel (traversal_kernel="minwalk"): the warp-cooperative
// walk of walk_common.cuh with the payload epilogue.
//
// Replaces the TPU kernel _traverse_kernel with resolve=True and a
// big-triangle prepass (tpu_pathtracer/ops/pallas_traverse.py, via
// intersect_bvh_pallas).  The TPU kernel stepped a ray tile through
// min(node pointer) one node at a time and then served the tile's unique hit
// triangles in a second min-loop ("phase 2"), because a TPU lane cannot
// gather.  Here each lane steps its own ray over the leaf-56 layout, the warp
// shares the leaf work on lay.tris's MT rows, and phase 2 is one read of the
// winning row.
//
// Contract: strict < in visit order -- the prepass rows (lay.prepass, col 21
// = the global row id) first, then leaf rows in DFS order -- seeded by
// t_max.  Writes the 12 rows of the TPU kernel's output: t, u, v, orig,
// material, light+1, position (3) and unit shading normal (3), the normal
// through rsqrt(max(|n|^2, 1e-20)).  Inactive lanes and misses resolve the
// all-zero sentinel row: (t_max, 0, ..., 0).
//
// The walk latches (t, row) only; u and v are recomputed from the winning
// row with mt_row once the walk is over: the same operations on the same
// values as the test that won (a prepass row is a copy of its leaf row), so
// the same bits as the plain version's latch.
//
// What bounds it on an H100, what the design does about it and the measured
// share of its bound: walk_common.cuh and PERF.md section 6 (row 3).
#include "walk_common.cuh"

namespace {

__global__ void __launch_bounds__(tpupt::kWalkMaxThreads, 1) minwalk_kernel(
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
      // phase 2: the winning row's u, v and payload
      const float* row = a.rows + 24 * best_row;
      float tt, u = 0.0f, v = 0.0f;
      if (best_row < a.num_tris) {
        tpupt::mt_row(row, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, a.t_min, &tt, &u, &v);
      }
      tpupt::write_payload(row, best_t, u, v, a.n, i, out);
    }
  }
}

}  // namespace

extern "C" int tpupt_minwalk(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* packed, const float* tris, const float* pre,
    int n_prepass, int num_nodes, int num_tris, float t_min, int n, float* out,
    void* stream) {
  if (n > 0) {
    const tpupt::WalkArgs a = {o, d, active, t_max,
                               reinterpret_cast<const float4*>(packed), tris, pre,
                               n_prepass, 0.0f, 0.0f, 0.0f, num_nodes, num_tris, t_min, n};
    minwalk_kernel<<<tpupt::walk_blocks(n), tpupt::kWalkThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, out);
  }
  return static_cast<int>(cudaGetLastError());
}

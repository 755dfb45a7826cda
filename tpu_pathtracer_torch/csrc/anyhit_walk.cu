// Any-hit occlusion BVH walk with Moller-Trumbore rows and early lane death:
// the shadow query of scenes with an environment light, on the
// warp-cooperative walk of walk_common.cuh (walk_anyhit).
//
// Replaces the TPU kernel _occlusion_anyhit_kernel (tpu_pathtracer/ops/
// pallas_traverse.py, via occlusion_clear_anyhit).  The TPU kernel stepped a
// ray tile through min(node pointer), and an occluded lane jumped its cursor
// to the sentinel so the tile stopped visiting subtrees only it demanded.
// Here each lane steps its own ray over the same DFS-threaded leaf-8 layout
// (lay.nodes_packed) to the next leaf it enters, the warp serves the leaves
// entered together, one leaf a step over all 32 lanes (or lane by lane where
// that takes fewer row-test slots), and an occluded lane leaves the walk at
// once.
//
// Per lane: clear = target >= 0 ? (target hit && !occluded) : !occluded,
// and 0 for inactive lanes.  The slab test bounds boxes by the fixed range
// cap (not a shrinking best_t).  A leaf row that passes the MT test (the op
// order of the reference's _mt_row):
//   * is an occluder when it is not the target and tt < cap - 4*eps;
//   * hits the target when it is the target and eps <= tt < cap; the walk
//     goes on, since a nearer occluder may come later in DFS order.
// Any occluder makes clear 0, so the order in which a leaf's rows are tested
// cannot change it: the warp's two flags (a vote each) give the per-thread
// walk's result on every lane.  Environment lanes carry target -1 (never an
// original triangle id) and a cap of 1e30, so any scene hit occludes them.
// The TPU packed the target into a float ray plane; here it is an int32
// array compared with the row's orig column converted to int.  eps and
// 4*eps arrive as float32, and cap - 4*eps is formed in float32, as the
// plain version does.
//
// What bounds it on an H100: as the capped walk (capped_walk.cu): the
// latency of the dependent node loads over tables that stay in L1/L2, while
// a warp waits for its slowest lane; occluded lanes leave early, which is
// the reason the kernel exists.  Writes one byte per lane.  The measured
// share of its bound: PERF.md section 6 (row 4).
#include "walk_common.cuh"

namespace {

__global__ void __launch_bounds__(tpupt::kWalkMaxThreads, 1) anyhit_walk_kernel(
    tpupt::WalkArgs a, const int* __restrict__ target, float eps, float four_eps,
    unsigned char* __restrict__ out) {
  const int warps = blockDim.x >> 5;
  const int tiles = (a.n + 31) >> 5;
  for (int tile = blockIdx.x * warps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * warps) {
    const int i = tile * 32 + (threadIdx.x & 31);
    tpupt::Ray r;
    const bool live = tpupt::load_ray(a, i, &r);
    const float cap = live ? a.t_max[i] : 0.0f;
    const int tgt = live ? target[i] : -1;
    const bool clear = tpupt::walk_anyhit(a, live, r, cap, tgt, eps, four_eps);
    if (i < a.n) out[i] = (live && clear) ? 1 : 0;
  }
}

}  // namespace

extern "C" int tpupt_anyhit_walk(
    const float* o, const float* d, const unsigned char* active,
    const float* cap, const int* target, const float* packed, const float* tris,
    int num_nodes, float t_min, float eps, float four_eps, int n, unsigned char* out,
    void* stream) {
  if (n > 0) {
    const tpupt::WalkArgs a = {o, d, active, cap, reinterpret_cast<const float4*>(packed),
                               tris, nullptr, 0, 0.0f, 0.0f, 0.0f, num_nodes, 0, t_min, n};
    anyhit_walk_kernel<<<tpupt::walk_blocks(n), tpupt::kWalkThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, target, eps, four_eps,
                                                              out);
  }
  return static_cast<int>(cudaGetLastError());
}

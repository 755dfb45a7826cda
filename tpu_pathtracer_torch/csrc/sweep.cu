// Dense sweep: every active ray against every Baldwin-Weber row, one thread
// per ray, no BVH navigation (traversal_kernel="sweep").
//
// Replaces the TPU kernel _sweep_kernel (tpu_pathtracer/ops/
// pallas_traverse.py, via intersect_bvh_sweep).  The TPU marched a ray tile
// over mtblock-row blocks of tris8bw; here each thread loops over the rows
// 0 .. num_tris-1 in ascending order with a strict < latch seeded by t_max,
// so the lowest row wins a tie.  The rows past num_tris (the sentinel and
// the pad rows) are all zero and can never hit, so the loop stops at
// num_tris and needs no padding.  Rows are evaluated at o - anchor, as in
// the window walk.  With kOrig the winner's original triangle id (BW col
// 13; -1 on a miss) is latched too, for the fused path+shadow walk.
// Inactive lanes write (t_max, num_tris[, -1]).
//
// What bounds it on an H100: exactly lanes x rows BW tests (~20 flops
// each).  Every lane of a warp reads the same row at the same time, so each
// 64-byte row is one broadcast load from L1/L2: the kernel is bound by
// float32 issue rate, not memory.  No divergence inside the loop except the
// latch.  It can only beat a walk when a warp's lanes would have visited
// nearly every leaf anyway.
#include "walk_common.cuh"

namespace {

template <bool kOrig>
__global__ void sweep_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ tris, float ax, float ay, float az, int num_tris,
    float t_min, int n, float* __restrict__ out_t, int* __restrict__ out_row,
    int* __restrict__ out_orig) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t = t_max[i];
  int best_row = num_tris;
  float best_orig = -1.0f;
  if (active[i]) {
    const float bx = o[i] - ax, by = o[n + i] - ay, bz = o[2 * n + i] - az;
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    float tt;
    for (int r = 0; r < num_tris; ++r) {
      const float* row = tris + 16 * r;
      if (tpupt::bw_row(row, bx, by, bz, dx, dy, dz, t_min, &tt) && tt < best_t) {
        best_t = tt;
        best_row = r;
        if (kOrig) best_orig = __ldg(row + 13);
      }
    }
  }
  out_t[i] = best_t;
  out_row[i] = best_row;
  if (kOrig) out_orig[i] = static_cast<int>(best_orig);
}

}  // namespace

extern "C" int tpupt_sweep(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* tris, float ax, float ay, float az,
    int num_tris, float t_min, int n, int with_orig, float* out_t, int* out_row,
    int* out_orig, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (with_orig) {
      sweep_kernel<true><<<blocks, threads, 0, s>>>(
          o, d, active, t_max, tris, ax, ay, az, num_tris, t_min, n, out_t,
          out_row, out_orig);
    } else {
      sweep_kernel<false><<<blocks, threads, 0, s>>>(
          o, d, active, t_max, tris, ax, ay, az, num_tris, t_min, n, out_t,
          out_row, out_orig);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Dense sweep: every active ray against every Baldwin-Weber or
// Moller-Trumbore row, one thread per ray, no BVH navigation
// (traversal_kernel="sweep").
//
// Replaces the TPU kernel _sweep_kernel (tpu_pathtracer/ops/
// pallas_traverse.py, via intersect_bvh_sweep).  The TPU marched a ray tile
// over mtblock-row blocks of tris8bw; here each thread loops over the rows
// 0 .. num_tris-1 in ascending order with a strict < latch seeded by t_max,
// so the lowest row wins a tie.  The rows past num_tris (the sentinel and
// the pad rows) are all zero and can never hit, so the loop stops at
// num_tris and needs no padding.  kMT (tritest="mt") reads tris8's 24-float
// MT rows at the world-space origin; BW rows are evaluated at o - anchor,
// as in the window walk.  With kOrig the winner's original triangle id (BW
// col 13, MT col 9; -1 on a miss) is latched too, for the fused
// path+shadow walk.
// Inactive lanes write (t_max, num_tris[, -1]).
//
// What bounds it on an H100: exactly lanes x rows row tests (~20 flops a
// BW test, ~30 an MT test).  Every lane of a warp reads the same row at the
// same time, so each row is one broadcast load from L1/L2: the kernel is bound by
// float32 issue rate, not memory.  No divergence inside the loop except the
// latch.  It can only beat a walk when a warp's lanes would have visited
// nearly every leaf anyway.
#include "walk_common.cuh"

namespace {

template <bool kMT, bool kOrig>
__global__ void sweep_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ tris, float ax, float ay, float az, int num_tris,
    float t_min, int n, float* __restrict__ out_t, int* __restrict__ out_row,
    int* __restrict__ out_orig) {
  using R = tpupt::Rows<kMT>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t = t_max[i];
  int best_row = num_tris;
  float best_orig = -1.0f;
  if (active[i]) {
    // BW planes are anchored at the scene-AABB centre; MT rows are world-space
    const float bx = kMT ? o[i] : o[i] - ax;
    const float by = kMT ? o[n + i] : o[n + i] - ay;
    const float bz = kMT ? o[2 * n + i] : o[2 * n + i] - az;
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    float tt;
    for (int r = 0; r < num_tris; ++r) {
      const float* row = tris + R::kStride * r;
      if (tpupt::row_test<kMT>(row, bx, by, bz, dx, dy, dz, t_min, &tt) &&
          tt < best_t) {
        best_t = tt;
        best_row = r;
        if (kOrig) best_orig = __ldg(row + R::kOrig);
      }
    }
  }
  out_t[i] = best_t;
  out_row[i] = best_row;
  if (kOrig) out_orig[i] = static_cast<int>(best_orig);
}

template <bool kMT>
void launch(const float* o, const float* d, const unsigned char* active,
            const float* t_max, const float* tris, float ax, float ay, float az,
            int num_tris, float t_min, int n, int with_orig, float* out_t,
            int* out_row, int* out_orig, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (with_orig) {
    sweep_kernel<kMT, true><<<blocks, threads, 0, s>>>(
        o, d, active, t_max, tris, ax, ay, az, num_tris, t_min, n, out_t,
        out_row, out_orig);
  } else {
    sweep_kernel<kMT, false><<<blocks, threads, 0, s>>>(
        o, d, active, t_max, tris, ax, ay, az, num_tris, t_min, n, out_t,
        out_row, out_orig);
  }
}

}  // namespace

extern "C" int tpupt_sweep(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* tris, float ax, float ay, float az,
    int num_tris, float t_min, int n, int mt, int with_orig, float* out_t,
    int* out_row, int* out_orig, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mt) {
      launch<true>(o, d, active, t_max, tris, ax, ay, az, num_tris, t_min, n,
                   with_orig, out_t, out_row, out_orig, s);
    } else {
      launch<false>(o, d, active, t_max, tris, ax, ay, az, num_tris, t_min, n,
                    with_orig, out_t, out_row, out_orig, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

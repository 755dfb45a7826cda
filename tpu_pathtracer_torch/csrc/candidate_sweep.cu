// Candidate-sweep kernels: classify rays by the number of leaf AABBs their
// primed segment crosses, and test the single candidate leaf of the rays
// that have at most one.  One thread per ray, no BVH navigation.
//
// Replaces the TPU kernels _count_kernel (via sweep_count) and _mt1_kernel
// (via intersect_sweep1) of scripts/experimental_pallas_sweep.py.  The TPU
// tested a ray tile against 16-row windows of leaf boxes and then served the
// tile's distinct candidate leaves in a min-loop of masked 16-row
// Moller-Trumbore blocks, because a TPU lane cannot gather.  Here each
// thread loops over the leaf boxes itself and reads its own leaf's rows.
//
// Shared contract of both kernels:
//   * the prime: the first n_prepass rows of lay.prepass (Moller-Trumbore
//     rows, col 21 = the global row id, col 9 = the original triangle id)
//     in row order with a strict < latch seeded by t_max (the first of
//     equal-t rows wins, as the TPU's argmin latch);
//   * the sweep: rows 0 .. num_leaves-1 of lay.leafbox through the walk's
//     slab test (entered before best_t, left after t_min), in row order.
//     The pad rows past num_leaves are far point-boxes that no ray enters,
//     so the loop stops at num_leaves.
// tpupt_sweep_count writes the number of boxes hit and the lowest hit row
// (num_leaves when none; inactive lanes 0 and num_leaves).  tpupt_sweep1
// then tests rows first_tri .. first_tri + tri_count - 1 (lay.leafmeta) of
// lay.tris8 for the lowest hit leaf, strict < in row order, and writes
// t, u, v, the tris8 row and the original id of the winner; a lane that hit
// nothing keeps (t_max, 0, 0, num_tris, 0).  The TPU kernel masked whole
// aligned blocks by col 21 == the leaf's node id; the masked rows
// contribute nothing, so the leaf's row range is the same function.
//
// What bounds them on an H100: lanes x num_leaves box tests (25 float32
// operations each), every thread of a warp reading the same 32-byte box row
// at the same time (one broadcast load from L1/L2): float32 instruction rate, not
// memory.  The targeted leaf's rows are a per-thread gather, at most
// max_leaf rows a lane.  Plain __ldg loads, no shared memory.
#include "walk_common.cuh"

namespace {

struct Best {
  float t, u, v;
  int row;
  float orig;
};

// The big-triangle prepass: strict < in row order.
__device__ __forceinline__ void prime(const float* __restrict__ pre, int n_prepass,
                                      float ox, float oy, float oz, float dx,
                                      float dy, float dz, float t_min, Best* b) {
  float tt, u, v;
  for (int k = 0; k < n_prepass; ++k) {
    const float* row = pre + 24 * k;
    if (tpupt::mt_row(row, ox, oy, oz, dx, dy, dz, t_min, &tt, &u, &v) &&
        tt < b->t) {
      b->t = tt;
      b->u = u;
      b->v = v;
      b->row = static_cast<int>(__ldg(row + 21));
      b->orig = __ldg(row + 9);
    }
  }
}

__global__ void sweep_count_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ lbox,
    const float* __restrict__ pre, int n_prepass, int num_leaves, float t_min,
    int n, int* __restrict__ out_count, int* __restrict__ out_first) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int count = 0;
  int first = num_leaves;
  if (active[i]) {
    const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    Best b = {__int_as_float(0x7f800000), 0.0f, 0.0f, 0, 0.0f};  // t_max = inf
    prime(pre, n_prepass, ox, oy, oz, dx, dy, dz, t_min, &b);
    for (int j = 0; j < num_leaves; ++j) {
      if (tpupt::slab_hit(lbox + 8 * j, ox, oy, oz, ix, iy, iz, t_min, b.t)) {
        ++count;
        if (first == num_leaves) first = j;
      }
    }
  }
  out_count[i] = count;
  out_first[i] = first;
}

__global__ void sweep1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ lbox, const int* __restrict__ lmeta,
    const float* __restrict__ tris, const float* __restrict__ pre,
    int n_prepass, int num_leaves, int num_tris, float t_min, int n,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ out_row,
    int* __restrict__ out_orig) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Best b = {t_max[i], 0.0f, 0.0f, num_tris, 0.0f};
  if (active[i]) {
    const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    prime(pre, n_prepass, ox, oy, oz, dx, dy, dz, t_min, &b);
    // the lowest candidate leaf: the count kernel's arithmetic, so the two
    // classify a lane alike
    int first = num_leaves;
    for (int j = 0; j < num_leaves; ++j) {
      if (tpupt::slab_hit(lbox + 8 * j, ox, oy, oz, ix, iy, iz, t_min, b.t)) {
        first = j;
        break;
      }
    }
    if (first < num_leaves) {
      const int4 m = __ldg(reinterpret_cast<const int4*>(lmeta) + first);
      float tt, u, v;
      for (int r = m.x; r < m.x + m.y; ++r) {
        const float* row = tris + 24 * r;
        if (tpupt::mt_row(row, ox, oy, oz, dx, dy, dz, t_min, &tt, &u, &v) &&
            tt < b.t) {
          b.t = tt;
          b.u = u;
          b.v = v;
          b.row = r;
          b.orig = __ldg(row + 9);
        }
      }
    }
  }
  out_t[i] = b.t;
  out_u[i] = b.u;
  out_v[i] = b.v;
  out_row[i] = b.row;
  out_orig[i] = static_cast<int>(b.orig);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int tpupt_sweep_count(
    const float* o, const float* d, const unsigned char* active,
    const float* lbox, const float* pre, int n_prepass, int num_leaves,
    float t_min, int n, int* out_count, int* out_first, void* stream) {
  if (n > 0) {
    sweep_count_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        o, d, active, lbox, pre, n_prepass, num_leaves, t_min, n, out_count,
        out_first);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_sweep1(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* lbox, const int* lmeta, const float* tris,
    const float* pre, int n_prepass, int num_leaves, int num_tris, float t_min,
    int n, float* out_t, float* out_u, float* out_v, int* out_row,
    int* out_orig, void* stream) {
  if (n > 0) {
    sweep1_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        o, d, active, t_max, lbox, lmeta, tris, pre, n_prepass, num_leaves,
        num_tris, t_min, n, out_t, out_u, out_v, out_row, out_orig);
  }
  return static_cast<int>(cudaGetLastError());
}

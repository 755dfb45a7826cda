// The yardsticks of the dense marches: the first port's row-test probe
// (tpupt_rowtest_probe_v1), candidate count (tpupt_sweep_count_v1) and
// targeted one-leaf MT (tpupt_sweep1_v1), one lane a thread, each row read
// with __ldg by every lane, as they stood before the redesign on
// dense_march.cuh.  They compute what tpupt_rowtest_probe, tpupt_sweep_count
// and tpupt_sweep1 compute, bit for bit, and are on no tool's path:
// chip_smoke.py times them against the redesigned kernels in turns (phases
// 14 and 17) and the card tests hold them equal.  See probes.cu and
// candidate_sweep.cu for the contract and the variants.
#include "walk_common.cuh"

namespace {

enum Variant { kFullBW = 0, kNoDiv = 1, kNoUV = 2, kNoPick = 3, kRowsLatch = 4, kMT = 5 };

// One row of the (T, 16) table against a ray -> accepted, *t_out.
template <int V>
__device__ __forceinline__ bool probe_row(const float* __restrict__ row,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float* t_out) {
  if constexpr (V == kMT) {
    float u, v;
    return tpupt::mt_row(row, ox, oy, oz, dx, dy, dz, 0.0f, t_out, &u, &v);
  } else {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row));
    const float den = a.x * dx + a.y * dy + a.z * dz;
    const float num = a.x * ox + a.y * oy + a.z * oz + a.w;
    const float inv = V == kNoDiv ? den : (den != 0.0f ? 1.0f / den : 0.0f);
    const float tt = -num * inv;
    *t_out = tt;
    if constexpr (V == kNoUV) {
      return (den != 0.0f) && (tt > 0.0f);
    } else {
      const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
      const float4 c = __ldg(reinterpret_cast<const float4*>(row) + 2);
      const float px = ox + tt * dx;
      const float py = oy + tt * dy;
      const float pz = oz + tt * dz;
      const float u = b.x * px + b.y * py + b.z * pz + b.w;
      const float v = c.x * px + c.y * py + c.z * pz + c.w;
      return (den != 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
             (tt > 0.0f);
    }
  }
}

template <int V>
__global__ void rowtest_probe_v1_kernel(const float* __restrict__ rays,
                                        const float* __restrict__ tris,
                                        int nblocks, int mtblock, int n,
                                        float* __restrict__ out_t,
                                        int* __restrict__ out_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  const float inf = __int_as_float(0x7f800000);
  float best_t = inf;
  int best_i = -1;
  float tt;
  for (int blk = 0; blk < nblocks; ++blk) {
    const int r0 = blk * mtblock;
    const float* rows = tris + 16 * r0;
    if constexpr (V == kRowsLatch) {
      for (int j = 0; j < mtblock; ++j) {
        if (probe_row<V>(rows + 16 * j, ox, oy, oz, dx, dy, dz, &tt) &&
            tt < best_t) {
          best_t = tt;
          best_i = r0 + j;
        }
      }
    } else {
      float tmin = inf;
      int pmin = 0;
      for (int j = 0; j < mtblock; ++j) {
        if (probe_row<V>(rows + 16 * j, ox, oy, oz, dx, dy, dz, &tt) &&
            tt < best_t && tt < tmin) {
          tmin = tt;
          pmin = j;
        }
      }
      if (tmin < best_t) {
        best_t = tmin;
        if constexpr (V != kNoPick) best_i = r0 + pmin;
      }
    }
  }
  out_t[i] = best_t;
  out_i[i] = best_i;
}

template <int V>
void launch_probe(const float* rays, const float* tris, int nblocks,
                  int mtblock, int threads, int n, float* out_t, int* out_i,
                  cudaStream_t s) {
  rowtest_probe_v1_kernel<V><<<(n + threads - 1) / threads, threads, 0, s>>>(
      rays, tris, nblocks, mtblock, n, out_t, out_i);
}

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

__global__ void sweep_count_v1_kernel(
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

// The targeted one-leaf MT, one thread a lane of the whole wavefront: the
// prime, the boxes in row order up to the first hit (slab_hit: eight
// dependent __ldg scalars a box), then the leaf's rows alone.
__global__ void sweep1_v1_kernel(
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

extern "C" int tpupt_rowtest_probe_v1(const float* rays, const float* tris,
                                      int variant, int nblocks, int mtblock,
                                      int threads, int n, float* out_t, int* out_i,
                                      void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (variant) {
      case kFullBW: launch_probe<kFullBW>(rays, tris, nblocks, mtblock, threads, n, out_t, out_i, s); break;
      case kNoDiv: launch_probe<kNoDiv>(rays, tris, nblocks, mtblock, threads, n, out_t, out_i, s); break;
      case kNoUV: launch_probe<kNoUV>(rays, tris, nblocks, mtblock, threads, n, out_t, out_i, s); break;
      case kNoPick: launch_probe<kNoPick>(rays, tris, nblocks, mtblock, threads, n, out_t, out_i, s); break;
      case kRowsLatch: launch_probe<kRowsLatch>(rays, tris, nblocks, mtblock, threads, n, out_t, out_i, s); break;
      case kMT: launch_probe<kMT>(rays, tris, nblocks, mtblock, threads, n, out_t, out_i, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_sweep_count_v1(
    const float* o, const float* d, const unsigned char* active,
    const float* lbox, const float* pre, int n_prepass, int num_leaves,
    float t_min, int n, int* out_count, int* out_first, void* stream) {
  if (n > 0) {
    sweep_count_v1_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        o, d, active, lbox, pre, n_prepass, num_leaves, t_min, n, out_count,
        out_first);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_sweep1_v1(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* lbox, const int* lmeta, const float* tris,
    const float* pre, int n_prepass, int num_leaves, int num_tris, float t_min,
    int n, float* out_t, float* out_u, float* out_v, int* out_row,
    int* out_orig, void* stream) {
  if (n > 0) {
    sweep1_v1_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        o, d, active, t_max, lbox, lmeta, tris, pre, n_prepass, num_leaves,
        num_tris, t_min, n, out_t, out_u, out_v, out_row, out_orig);
  }
  return static_cast<int>(cudaGetLastError());
}

// The two measuring kernels of the kernel-research tools: a no-op that
// prices a launch, and a dense march that prices one leaf-row test.
//
// tpupt_noop replaces the TPU kernel noop_kernel (scripts/perf_launch.py,
// via run_noop): out row 0 = rays row 0, rows 1-7 = 0, over (8, N) planes.
// One thread block covers `tile` lanes (the grid is ceil(N / tile) blocks,
// as the TPU grid is N / tile programs) and masks the ragged last tile.  It
// takes up to four table pointers that it never dereferences: on the TPU
// every table argument was copied into on-chip memory per launch, which is
// what the tool priced; here a table is a pointer in the argument block.
// Bound: 4 bytes read and 32 written per lane over the memory rate.
//
// tpupt_rowtest_probe replaces the TPU kernel _kernel
// (scripts/perf_ophit_probe.py, via run_variant): every lane marches all
// nblocks * mtblock rows of a (T, 16) float32 table, the same work for
// every variant, so the difference between two variants is the cost of the
// operations one of them drops:
//   full-bw     the Baldwin-Weber row test, block latch (the anchor)
//   nodiv       the reciprocal replaced by a multiply (wrong results)
//   nouv        the u/v planes and their accepts dropped (t plane only)
//   nopick      block latch keeps the minimum, drops the row id
//   rows-latch  the full test with a row-by-row strict < latch
//   mt          the Moller-Trumbore row test on cols 0-8, block latch
// The block latch is the per-thread form of the TPU's argmin latch: within
// each mtblock rows the accepted t below the best at the block's start fold
// into a block minimum (the lowest row of equal t), and the block then
// updates the best once.  All accept t > 0.  best_t starts at inf and
// best_i at -1.  Every variant, the wrong ones included, is a function of
// its inputs and is held against its plain version
// (scripts/perf_ophit_probe.py:rowtest_probe_plain).
// One thread per lane, `tile` threads a block.  Every thread of a warp
// reads the same row at the same time, so a row is one broadcast load
// through L1/L2 (__ldg, no shared-memory staging); the 455 KB table stays
// cache-resident.  Bound: lanes x rows x the variant's operations over the
// float32 rate.
#include "walk_common.cuh"

namespace {

struct Tables {
  const void* p[4];
};

__global__ void noop_kernel(const float* __restrict__ rays, Tables tables,
                            int tile, int n, float* __restrict__ out) {
  (void)tables;
  const int base = blockIdx.x * tile;
  const int end = min(base + tile, n);
  for (int i = base + threadIdx.x; i < end; i += blockDim.x) {
    out[i] = rays[i];
#pragma unroll
    for (int k = 1; k < 8; ++k) out[k * n + i] = 0.0f;
  }
}

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
__global__ void rowtest_probe_kernel(const float* __restrict__ rays,
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
  rowtest_probe_kernel<V><<<(n + threads - 1) / threads, threads, 0, s>>>(
      rays, tris, nblocks, mtblock, n, out_t, out_i);
}

}  // namespace

extern "C" int tpupt_noop(const float* rays, const void* t0, const void* t1,
                          const void* t2, const void* t3, int tile, int n,
                          float* out, void* stream) {
  if (n > 0) {
    const Tables tables = {{t0, t1, t2, t3}};
    noop_kernel<<<(n + tile - 1) / tile, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(rays, tables, tile, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_rowtest_probe(const float* rays, const float* tris,
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

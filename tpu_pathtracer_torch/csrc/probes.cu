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
// The march is dense_march.cuh's: `tile` lanes a block, kProbeK lanes a
// thread, the table's cols 0-11 staged in shared memory a tile of rows at a
// time (the 455 KB table of the tool does not fit one block's shared memory).
// mtblock = 16 (the tool's default) has an unrolled instance; any other
// mtblock takes the generic one, which counts rows to the block's end.
// Bound: lanes x rows x the variant's operations over the float32 rate.
#include "dense_march.cuh"
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

constexpr int kProbeCols = 3;  // float4 of a staged row: cols 0-11
// Lanes a thread (scripts/perf_ophit_probe.py:K_LANES).  K = 2 ran faster than
// K = 4 on every variant at full width, K = 4's instances taking 72-110
// registers against 40-63 (PERF.md section 6, the dense marches).
constexpr int kProbeK = 2;
// Rows a step of the unrolled instance: the whole 16-row block (the fastest
// of 2, 4, 8 and 16 rows a step on the tool's march).
constexpr int kRowUnroll = 16;

// One row (cols 0-11 as a, b, c) against a ray -> accepted, *t_out; the
// arithmetic of rowtest_probe_plain, the reciprocal through
// tpupt::recip_or_zero<kFast> (*slow: redo this test with kFast false).
template <int V, bool kFast>
__device__ __forceinline__ bool probe_test(const float4& a, const float4& b,
                                           const float4& c, float ox, float oy,
                                           float oz, float dx, float dy, float dz,
                                           float* t_out, bool* slow) {
  if constexpr (V == kMT) {
    float u, v;
    return tpupt::mt_test<kFast>(a, b, c.x, ox, oy, oz, dx, dy, dz, 0.0f, t_out, &u, &v,
                                 slow);
  } else {
    const float den = a.x * dx + a.y * dy + a.z * dz;
    const float num = a.x * ox + a.y * oy + a.z * oz + a.w;
    *slow = false;
    const float inv = V == kNoDiv ? den : tpupt::recip_or_zero<kFast>(den, slow);
    const float tt = -num * inv;
    *t_out = tt;
    if constexpr (V == kNoUV) {
      return (den != 0.0f) && (tt > 0.0f);
    } else {
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

// The kProbeK lanes of one thread: rays in, latches out.  tmin is the block
// minimum and starts each block at best_t, so a row's one compare against it
// is the block latch's two (tt < best_t and tt < the block's minimum).
struct ProbeLanes {
  float ox[kProbeK], oy[kProbeK], oz[kProbeK], dx[kProbeK], dy[kProbeK], dz[kProbeK];
  float best_t[kProbeK], tmin[kProbeK];
  int best_i[kProbeK], pmin[kProbeK];
};

// One lane's latch step on a tested row: the row latch of rows-latch, else
// the block latch's (pick = the id the block minimum keeps: the row's offset
// in its block, or its global id).
template <int V>
__device__ __forceinline__ void probe_latch(bool upd_ok, float tt, int r, int pick, int k,
                                            ProbeLanes& L) {
  if constexpr (V == kRowsLatch) {
    const bool upd = upd_ok && tt < L.best_t[k];
    L.best_t[k] = upd ? tt : L.best_t[k];
    L.best_i[k] = upd ? r : L.best_i[k];
  } else {
    const bool upd = upd_ok && tt < L.tmin[k];
    L.tmin[k] = upd ? tt : L.tmin[k];
    L.pmin[k] = upd ? pick : L.pmin[k];
  }
}

// Row `rs` (staged), global row id `r`, against every lane of the thread.
// The tests and latches run branch-free; a lane whose reciprocal left the
// fast path latches nothing there and is tested again exactly, one branch a
// row for all the thread's lanes (never taken on the tool's normal draws).
template <int V>
__device__ __forceinline__ void probe_step(const float4* rs, int r, int pick,
                                           ProbeLanes& L) {
  const float4 a = rs[0], b = rs[1], c = rs[2];
  bool slow[kProbeK];
  bool any_slow = false;
#pragma unroll
  for (int k = 0; k < kProbeK; ++k) {
    float tt;
    const bool ok = probe_test<V, true>(a, b, c, L.ox[k], L.oy[k], L.oz[k], L.dx[k],
                                        L.dy[k], L.dz[k], &tt, &slow[k]);
    probe_latch<V>(ok && !slow[k], tt, r, pick, k, L);
    any_slow = any_slow || slow[k];
  }
  if (any_slow) {
#pragma unroll
    for (int k = 0; k < kProbeK; ++k) {
      if (slow[k]) {
        float tt;
        bool unused;
        const bool ok = probe_test<V, false>(a, b, c, L.ox[k], L.oy[k], L.oz[k], L.dx[k],
                                             L.dy[k], L.dz[k], &tt, &unused);
        probe_latch<V>(ok, tt, r, pick, k, L);
      }
    }
  }
}

// The end of a block of mtblock rows: its minimum updates the best once.
template <int V>
__device__ __forceinline__ void probe_fold(int id0, ProbeLanes& L) {
#pragma unroll
  for (int k = 0; k < kProbeK; ++k) {
    if (L.tmin[k] < L.best_t[k]) {
      L.best_t[k] = L.tmin[k];
      if constexpr (V != kNoPick) L.best_i[k] = id0 + L.pmin[k];
    }
    L.tmin[k] = L.best_t[k];
  }
}

// MTB: mtblock as a compile-time constant (the rows of a tile are whole
// blocks), or 0 for the generic instance.
template <int V, int MTB>
__global__ void __launch_bounds__(tpupt::kMarchMaxThreads, 1) rowtest_probe_kernel(
    const float* __restrict__ rays, const float4* __restrict__ tris, int nrows,
    int mtblock, int tile_rows, int tile, int passes, int n, float* __restrict__ out_t,
    int* __restrict__ out_i) {
  extern __shared__ float4 staged[];  // one or two buffers of tile_rows rows
  const float inf = __int_as_float(0x7f800000);
  const int ntiles = (nrows + tile_rows - 1) / tile_rows;
  const int buf_stride = tile_rows * kProbeCols;
  for (int pass = 0; pass < passes; ++pass) {
    if (ntiles > 0) {
      tpupt::stage_rows<kProbeCols>(staged, tris, 0, min(tile_rows, nrows), 4);
    }
    tpupt::cp_async_commit();
    ProbeLanes L;
    int lane[kProbeK];
#pragma unroll
    for (int k = 0; k < kProbeK; ++k) {
      lane[k] = tpupt::march_lane(pass, k, kProbeK, tile, n);
      const int i = max(lane[k], 0);
      const bool live = lane[k] >= 0;  // a masked slot marches zeros: den = 0 accepts nothing
      L.ox[k] = live ? rays[i] : 0.0f;
      L.oy[k] = live ? rays[n + i] : 0.0f;
      L.oz[k] = live ? rays[2 * n + i] : 0.0f;
      L.dx[k] = live ? rays[3 * n + i] : 0.0f;
      L.dy[k] = live ? rays[4 * n + i] : 0.0f;
      L.dz[k] = live ? rays[5 * n + i] : 0.0f;
      L.best_t[k] = inf;
      L.best_i[k] = -1;
      L.tmin[k] = inf;
      L.pmin[k] = 0;
    }
    int in_block = 0;  // generic instance: rows of the current block seen so far
    for (int tl = 0; tl < ntiles; ++tl) {
      const int r0 = tl * tile_rows;
      if (tl + 1 < ntiles) {
        tpupt::stage_rows<kProbeCols>(staged + ((tl + 1) & 1) * buf_stride, tris,
                                      r0 + tile_rows, min(tile_rows, nrows - r0 - tile_rows),
                                      4);
        tpupt::cp_async_commit();
        tpupt::cp_async_wait<1>();
      } else {
        tpupt::cp_async_wait<0>();
      }
      __syncthreads();
      const float4* rs = staged + (tl & 1) * buf_stride;
      const int nr = min(tile_rows, nrows - r0);
      if constexpr (MTB > 0) {
        for (int b0 = 0; b0 < nr; b0 += MTB) {
#pragma unroll 1
          for (int j0 = 0; j0 < MTB; j0 += kRowUnroll) {
#pragma unroll
            for (int u = 0; u < kRowUnroll; ++u) {
              const int j = j0 + u;
              probe_step<V>(rs + (b0 + j) * kProbeCols, r0 + b0 + j, j, L);
            }
          }
          if constexpr (V != kRowsLatch) probe_fold<V>(r0 + b0, L);
        }
      } else {
        for (int j = 0; j < nr; ++j) {
          probe_step<V>(rs + j * kProbeCols, r0 + j, r0 + j, L);
          if constexpr (V != kRowsLatch) {
            if (++in_block == mtblock) {
              probe_fold<V>(0, L);
              in_block = 0;
            }
          }
        }
      }
      __syncthreads();  // the buffer is refilled two tiles on
    }
#pragma unroll
    for (int k = 0; k < kProbeK; ++k) {
      if (lane[k] >= 0) {
        out_t[lane[k]] = L.best_t[k];
        out_i[lane[k]] = L.best_i[k];
      }
    }
  }
}

template <int V, int MTB>
int launch_probe(const float* rays, const float* tris, int nrows, int mtblock,
                 int tile_rows, int tile, int blocks, int threads, int passes,
                 int smem, int n, float* out_t, int* out_i, cudaStream_t s) {
  auto kernel = rowtest_probe_kernel<V, MTB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, s>>>(rays, reinterpret_cast<const float4*>(tris),
                                       nrows, mtblock, tile_rows, tile, passes, n,
                                       out_t, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_probe_v(const float* rays, const float* tris, int nrows, int mtblock,
                   int tile_rows, int tile, int blocks, int threads, int passes,
                   int smem, int n, float* out_t, int* out_i, cudaStream_t s) {
  // the unrolled instance needs tiles of whole 16-row blocks
  if (mtblock == 16 && tile_rows % 16 == 0) {
    return launch_probe<V, 16>(rays, tris, nrows, mtblock, tile_rows, tile, blocks,
                               threads, passes, smem, n, out_t, out_i, s);
  }
  return launch_probe<V, 0>(rays, tris, nrows, mtblock, tile_rows, tile, blocks, threads,
                            passes, smem, n, out_t, out_i, s);
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

// tile, blocks, threads, passes, tile_rows and smem: the launch shape of
// scripts/dense_march.py:march_shape at kProbeK lanes a thread.
extern "C" int tpupt_rowtest_probe(const float* rays, const float* tris, int variant,
                                   int nblocks, int mtblock, int tile, int blocks,
                                   int threads, int passes, int tile_rows, int smem,
                                   int n, float* out_t, int* out_i, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nrows = nblocks * mtblock;
#define TPUPT_PROBE(V)                                                              \
  launch_probe_v<V>(rays, tris, nrows, mtblock, tile_rows, tile, blocks, threads, \
                    passes, smem, n, out_t, out_i, s)
  switch (variant) {
    case kFullBW: return TPUPT_PROBE(kFullBW);
    case kNoDiv: return TPUPT_PROBE(kNoDiv);
    case kNoUV: return TPUPT_PROBE(kNoUV);
    case kNoPick: return TPUPT_PROBE(kNoPick);
    case kRowsLatch: return TPUPT_PROBE(kRowsLatch);
    case kMT: return TPUPT_PROBE(kMT);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TPUPT_PROBE
}

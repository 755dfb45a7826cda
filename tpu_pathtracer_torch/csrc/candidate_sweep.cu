// Candidate-sweep kernels: classify rays by the number of leaf AABBs their
// primed segment crosses, and test the single candidate leaf of the rays
// that have at most one.  No BVH navigation.
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
// What bounds the count on an H100: live lanes x num_leaves box tests (25
// float32 operations each, and the count's add), plus the prime's 52 a
// prepass row: the float32 instruction rate, not memory.  It runs on the
// dense march of dense_march.cuh: the prepass block (at most a few KB) is
// staged in shared memory once a block, the leaf boxes a tile at a time (one
// tile up to 48 KB: Water-plastic's 184 leaf-56 and 1,209 leaf-8 boxes; a
// GRID 256 terrain's leaf-8 table takes many), each box read as two 16-byte
// broadcast loads and tested against kCountK lanes a thread; the count and the
// first leaf are selects, not branches.  The box arithmetic is
// tpupt::slab_test's, as sweep1's (which reaches it through slab_hit), so
// the two classify every lane alike.  The first port's count, one lane a
// thread reading each box with __ldg, is march_v1.cu's yardstick.
// sweep1 is one thread per ray: the targeted leaf's rows are a per-thread
// gather, at most max_leaf rows a lane, with plain __ldg loads.
#include "dense_march.cuh"
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

// Lanes a thread of the count (scripts/experimental_sweep.py:K_LANES): K = 4
// ran 3-4% faster than K = 2 on the whole bounce-1 wavefronts, in turns
// (PERF.md section 6, the dense marches).
constexpr int kCountK = 4;

// The kCountK lanes of one thread of the count.
struct CountLanes {
  float ox[kCountK], oy[kCountK], oz[kCountK], dx[kCountK], dy[kCountK], dz[kCountK];
  float ix[kCountK], iy[kCountK], iz[kCountK], best_t[kCountK];
  int count[kCountK], first[kCountK];
};

// The count on the march of dense_march.cuh: the block stages the prepass
// block (cols 0-11 of its n_prepass rows) once a pass and the leaf boxes
// `tile_rows` at a time; a thread primes and sweeps kCountK lanes.  A lane
// that is not active (or a masked slot) sweeps with best_t = -inf, which no
// box passes; a thread with no live lane skips the tests but not the barriers.
__global__ void __launch_bounds__(tpupt::kMarchMaxThreads, 1) sweep_count_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float4* __restrict__ lbox,
    const float4* __restrict__ pre, int n_prepass, int num_leaves, int tile_rows,
    float t_min, int tile, int passes, int n, int* __restrict__ out_count,
    int* __restrict__ out_first) {
  extern __shared__ float4 staged[];
  float4* pre_s = staged;                     // n_prepass rows of 3 float4
  float4* box_s = staged + 3 * n_prepass;     // one or two buffers of tile_rows boxes
  const int ntiles = (num_leaves + tile_rows - 1) / tile_rows;
  const int buf_stride = 2 * tile_rows;
  const float inf = __int_as_float(0x7f800000);
  for (int pass = 0; pass < passes; ++pass) {
    // the boxes go last tile first and descending in a tile: best_t is fixed
    // after the prime, so the order changes no hit, and the lowest hit leaf is
    // then the last one seen (a select, where ascending takes a min too)
    const int last = (ntiles - 1) * tile_rows;
    tpupt::stage_rows<3>(pre_s, pre, 0, n_prepass, 6);
    if (ntiles > 0) tpupt::stage_rows<2>(box_s, lbox, last, num_leaves - last, 2);
    tpupt::cp_async_commit();
    CountLanes L;
    int lane[kCountK];
    bool live[kCountK];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kCountK; ++k) {
      lane[k] = tpupt::march_lane(pass, k, kCountK, tile, n);
      const int i = max(lane[k], 0);
      live[k] = lane[k] >= 0 && active[i];
      any = any || live[k];
      L.ox[k] = live[k] ? o[i] : 0.0f;
      L.oy[k] = live[k] ? o[n + i] : 0.0f;
      L.oz[k] = live[k] ? o[2 * n + i] : 0.0f;
      L.dx[k] = live[k] ? d[i] : 0.0f;
      L.dy[k] = live[k] ? d[n + i] : 0.0f;
      L.dz[k] = live[k] ? d[2 * n + i] : 0.0f;
      L.ix[k] = tpupt::safe_inv(L.dx[k]);
      L.iy[k] = tpupt::safe_inv(L.dy[k]);
      L.iz[k] = tpupt::safe_inv(L.dz[k]);
      L.best_t[k] = inf;  // t_max = inf
      L.count[k] = 0;
      L.first[k] = num_leaves;
    }
    for (int step = 0; step < max(ntiles, 1); ++step) {
      const int r0 = last - step * tile_rows;  // this step's tile: its first box
      if (step + 1 < ntiles) {
        tpupt::stage_rows<2>(box_s + ((step + 1) & 1) * buf_stride, lbox, r0 - tile_rows,
                             tile_rows, 2);
        tpupt::cp_async_commit();
        tpupt::cp_async_wait<1>();
      } else {
        tpupt::cp_async_wait<0>();
      }
      __syncthreads();
      if (any) {
        if (step == 0) {
          // the prime: strict < in row order (prime() above, on staged rows),
          // straight code over the rows; a lane whose reciprocal left the fast
          // path on any row latched nothing on that row, and primes again,
          // exactly, from t_max (never on the bundled scenes' prepass rows)
          bool lane_slow[kCountK];
#pragma unroll
          for (int k = 0; k < kCountK; ++k) lane_slow[k] = false;
#pragma unroll 1
          for (int q = 0; q < n_prepass; ++q) {
            const float4 a = pre_s[3 * q], b = pre_s[3 * q + 1];
            const float e2z = pre_s[3 * q + 2].x;
#pragma unroll
            for (int k = 0; k < kCountK; ++k) {
              float tt, u, v;
              bool slow;
              const bool ok = tpupt::mt_test<true>(a, b, e2z, L.ox[k], L.oy[k], L.oz[k],
                                                   L.dx[k], L.dy[k], L.dz[k], t_min, &tt,
                                                   &u, &v, &slow);
              L.best_t[k] = ok && !slow && tt < L.best_t[k] ? tt : L.best_t[k];
              lane_slow[k] = lane_slow[k] || slow;
            }
          }
#pragma unroll
          for (int k = 0; k < kCountK; ++k) {
            if (lane_slow[k]) {
              L.best_t[k] = inf;
              for (int q = 0; q < n_prepass; ++q) {
                float tt, u, v;
                bool unused;
                if (tpupt::mt_test<false>(pre_s[3 * q], pre_s[3 * q + 1], pre_s[3 * q + 2].x,
                                          L.ox[k], L.oy[k], L.oz[k], L.dx[k], L.dy[k],
                                          L.dz[k], t_min, &tt, &u, &v, &unused) &&
                    tt < L.best_t[k]) {
                  L.best_t[k] = tt;
                }
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kCountK; ++k) L.best_t[k] = live[k] ? L.best_t[k] : -inf;
        }
        const float4* bs = box_s + (step & 1) * buf_stride;
        const int nr = ntiles > 0 ? min(tile_rows, num_leaves - r0) : 0;
#pragma unroll 8
        for (int jj = nr - 1; jj >= 0; --jj) {
          const float4 p = bs[2 * jj], q = bs[2 * jj + 1];  // bmin.xyz bmax.x | bmax.yz pad2
          const int j = r0 + jj;
#pragma unroll
          for (int k = 0; k < kCountK; ++k) {
            const bool hit = tpupt::slab_test(p.x, p.y, p.z, p.w, q.x, q.y, L.ox[k], L.oy[k],
                                              L.oz[k], L.ix[k], L.iy[k], L.iz[k], t_min,
                                              L.best_t[k]);
            L.count[k] += hit ? 1 : 0;
            L.first[k] = hit ? j : L.first[k];
          }
        }
      }
      __syncthreads();  // the buffer is refilled two tiles on
    }
#pragma unroll
    for (int k = 0; k < kCountK; ++k) {
      if (lane[k] >= 0) {
        out_count[lane[k]] = L.count[k];
        out_first[lane[k]] = L.first[k];
      }
    }
  }
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

// tile, blocks, threads, passes, tile_rows and smem: the launch shape of
// scripts/dense_march.py:march_shape at kCountK lanes a thread.
extern "C" int tpupt_sweep_count(
    const float* o, const float* d, const unsigned char* active,
    const float* lbox, const float* pre, int n_prepass, int num_leaves,
    float t_min, int tile, int blocks, int threads, int passes, int tile_rows,
    int smem, int n, int* out_count, int* out_first, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sweep_count_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, active, reinterpret_cast<const float4*>(lbox),
      reinterpret_cast<const float4*>(pre), n_prepass, num_leaves, tile_rows, t_min,
      tile, passes, n, out_count, out_first);
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

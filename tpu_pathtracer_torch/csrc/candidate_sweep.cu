// Candidate-sweep kernels: classify rays by the number of leaf AABBs their
// primed segment crosses, and test the single candidate leaf of the rays
// that have at most one.  No BVH navigation.
//
// Replaces the TPU kernels _count_kernel (via sweep_count) and _mt1_kernel
// (via intersect_sweep1) of scripts/experimental_pallas_sweep.py.  The TPU
// tested a ray tile against 16-row windows of leaf boxes and then served the
// tile's distinct candidate leaves in a min-loop of masked 16-row
// Moller-Trumbore blocks, because a TPU lane cannot gather.
//
// Shared contract of both kernels:
//   * the prime: the first n_prepass rows of lay.prepass (Moller-Trumbore
//     rows, col 21 = the global row id, col 9 = the original triangle id)
//     in row order with a strict < latch seeded by t_max (the first of
//     equal-t rows wins, as the TPU's argmin latch);
//   * the sweep: rows 0 .. num_leaves-1 of lay.leafbox through the walk's
//     slab test (entered before best_t, left after t_min).  The pad rows
//     past num_leaves are far point-boxes that no ray enters, so the sweep
//     stops at num_leaves.
// tpupt_sweep_count writes the number of boxes hit and the lowest hit row
// (num_leaves when none; inactive lanes 0 and num_leaves).  tpupt_sweep1
// then tests rows first_tri .. first_tri + tri_count - 1 (lay.leafmeta) of
// lay.tris8 for the lowest hit leaf, strict < in row order, and writes
// t, u, v, the tris8 row and the original id of the winner; a lane that hit
// nothing keeps (t_max, 0, 0, num_tris, 0).  The TPU kernel masked whole
// aligned blocks by col 21 == the leaf's node id; the masked rows
// contribute nothing, so the leaf's row range is the same function.
//
// What bounds both on an H100: live lanes x leaf boxes box tests (25
// float32 operations each, and a select or two), plus the prime's 52 a
// prepass row: the float32 instruction rate, not memory.  Both run the one
// prime-and-sweep of this file (march_pass) on the dense march of
// dense_march.cuh, so the two classify every lane alike by construction: the
// prepass block (at most a few KB) is staged in shared memory once a block,
// the leaf boxes a tile at a time (one tile up to 48 KB: Water-plastic's 184
// leaf-56 and 1,209 leaf-8 boxes; a GRID 256 terrain's leaf-8 table takes
// many), each box read as two 16-byte broadcast loads and tested against K
// lanes a thread; the prime takes its reciprocal through
// walk_common.cuh:rcp_fast, and a lane whose reciprocal left the fast path
// primes again exactly.  The count needs every box: it sweeps them last
// first, so that the lowest hit is a select.
//
// sweep1 (the first port's ran one thread per lane of the whole wavefront
// with a break at the first hit) adds three things:
//   * a list: only the lanes with at most one candidate are active (19% of
//     Water-plastic's bounce-1 wavefront at leaf 56, 35% at leaf 8), and they
//     cluster, so blocks that compact their own tile get very uneven work.
//     Two launches list the active lanes in ascending order (a ballot a lane
//     slot, a prefix of popcounts in a tile, a prefix of the tiles' counts:
//     deterministic, no host sync) and write the fresh record of every
//     inactive lane; the march then takes full passes of the list from a
//     counter, on as many blocks as the card keeps resident, each warp on its
//     own when the boxes are one tile;
//   * the sweep to the first hit: chunks of 8 boxes ascending, each chunk
//     descending (a select), a lane's sweep bound at -inf after its first
//     hit, and the warp leaves the sweep once every lane of it has one;
//   * the leaf on the warp: each lane's lowest candidate leaf is served as
//     the walks serve theirs (walk_common.cuh: warp_leaf, the 32-lane
//     cooperative service, or lane_leaf, the per-lane loop, by the walks'
//     slot-count rule coop_pays), with IEEE 1 / x, u and v.
// Tried in exploratory calls and dropped, each slower in turns (PERF.md
// section 6): one launch whose blocks compact their own tile, a dense
// descending sweep for sweep1, K = 4, marches of 64-384 threads a block.
#include "dense_march.cuh"
#include "walk_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Lanes a thread of the count (scripts/experimental_sweep.py:K_LANES): K = 4
// ran 3-4% faster than K = 2 on the whole bounce-1 wavefronts, in turns
// (PERF.md section 6, the dense marches).
constexpr int kCountK = 4;

// List entries a thread of sweep1 (scripts/experimental_sweep.py:SWEEP1_K).
constexpr int kSweep1K = 2;

// The K lanes of one thread of a candidate sweep.  kLatch (sweep1): the
// prime also latches u, v and the winning prepass row q (-1: none); the
// count keeps a count instead.
template <int K, bool kLatch>
struct SweepLanes {
  float ox[K], oy[K], oz[K], dx[K], dy[K], dz[K];
  float ix[K], iy[K], iz[K], best_t[K];
  int first[K];
  int count[kLatch ? 1 : K];
  float u[kLatch ? K : 1], v[kLatch ? K : 1];
  int q[kLatch ? K : 1];
};

// Lane lane[k] (or a zero ray where not live[k]) into slot k, seeded by
// t_max (sweep1) or +inf (the count).
template <int K, bool kLatch>
__device__ __forceinline__ void load_lanes(SweepLanes<K, kLatch>& L, const int (&lane)[K],
                                           const bool (&live)[K], const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           const float* __restrict__ t_max, int n,
                                           int num_leaves) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = max(lane[k], 0);
    L.ox[k] = live[k] ? o[i] : 0.0f;
    L.oy[k] = live[k] ? o[n + i] : 0.0f;
    L.oz[k] = live[k] ? o[2 * n + i] : 0.0f;
    L.dx[k] = live[k] ? d[i] : 0.0f;
    L.dy[k] = live[k] ? d[n + i] : 0.0f;
    L.dz[k] = live[k] ? d[2 * n + i] : 0.0f;
    L.ix[k] = tpupt::safe_inv(L.dx[k]);
    L.iy[k] = tpupt::safe_inv(L.dy[k]);
    L.iz[k] = tpupt::safe_inv(L.dz[k]);
    L.first[k] = num_leaves;
    if constexpr (kLatch) {
      L.best_t[k] = live[k] ? t_max[i] : 0.0f;
      L.u[k] = 0.0f;
      L.v[k] = 0.0f;
      L.q[k] = -1;
    } else {
      L.best_t[k] = __int_as_float(0x7f800000);  // t_max = inf
      L.count[k] = 0;
    }
  }
}

// The prime: strict < in row order over the staged prepass rows, straight
// code over the rows; a lane whose reciprocal left the fast path on any row
// latched nothing on that row, and primes again, exactly, from its seed
// (never on the bundled scenes' prepass rows).  A slot that is not live
// then gets best_t = -inf, which no box passes.
template <int K, bool kLatch>
__device__ __forceinline__ void prime_lanes(SweepLanes<K, kLatch>& L, const bool (&live)[K],
                                            const int (&lane)[K], const float4* pre_s,
                                            int n_prepass, float t_min,
                                            const float* __restrict__ t_max) {
  bool lane_slow[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lane_slow[k] = false;
#pragma unroll 1
  for (int q = 0; q < n_prepass; ++q) {
    const float4 a = pre_s[3 * q], b = pre_s[3 * q + 1];
    const float e2z = pre_s[3 * q + 2].x;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float tt, u, v;
      bool slow;
      const bool ok = tpupt::mt_test<true>(a, b, e2z, L.ox[k], L.oy[k], L.oz[k], L.dx[k],
                                           L.dy[k], L.dz[k], t_min, &tt, &u, &v, &slow);
      const bool take = ok && !slow && tt < L.best_t[k];
      L.best_t[k] = take ? tt : L.best_t[k];
      if constexpr (kLatch) {
        L.u[k] = take ? u : L.u[k];
        L.v[k] = take ? v : L.v[k];
        L.q[k] = take ? q : L.q[k];
      }
      lane_slow[k] = lane_slow[k] || slow;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane_slow[k]) {
      if constexpr (kLatch) {
        L.best_t[k] = live[k] ? t_max[lane[k]] : 0.0f;
        L.u[k] = 0.0f;
        L.v[k] = 0.0f;
        L.q[k] = -1;
      } else {
        L.best_t[k] = __int_as_float(0x7f800000);
      }
      for (int q = 0; q < n_prepass; ++q) {
        float tt, u, v;
        bool unused;
        if (tpupt::mt_test<false>(pre_s[3 * q], pre_s[3 * q + 1], pre_s[3 * q + 2].x,
                                  L.ox[k], L.oy[k], L.oz[k], L.dx[k], L.dy[k], L.dz[k],
                                  t_min, &tt, &u, &v, &unused) &&
            tt < L.best_t[k]) {
          L.best_t[k] = tt;
          if constexpr (kLatch) {
            L.u[k] = u;
            L.v[k] = v;
            L.q[k] = q;
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    L.best_t[k] = live[k] ? L.best_t[k] : -__int_as_float(0x7f800000);
  }
}

// Copy the prepass block (cols 0-11 of its n_prepass rows) and, when the
// boxes are one tile, every box into shared memory, and commit the group:
// once a block, before its passes.  With one tile the caller waits for it
// and syncs the block once; the passes then hold no barrier.
__device__ __forceinline__ bool stage_tables(float4* pre_s, float4* box_s,
                                             const float4* __restrict__ pre,
                                             const float4* __restrict__ lbox, int n_prepass,
                                             int num_leaves, int tile_rows) {
  tpupt::stage_rows<3>(pre_s, pre, 0, n_prepass, 6);
  const bool one = num_leaves <= tile_rows;
  if (one) tpupt::stage_rows<2>(box_s, lbox, 0, num_leaves, 2);
  tpupt::cp_async_commit();
  return one;
}

// The count's sweep of one staged tile (rows r0 .. r0 + nr - 1): every box,
// descending, so that the lowest hit is the last one seen (a select).
template <int K>
__device__ __forceinline__ void sweep_all(SweepLanes<K, false>& L, const float4* bs, int r0,
                                          int nr, float t_min) {
#pragma unroll 8
  for (int jj = nr - 1; jj >= 0; --jj) {
    const float4 p = bs[2 * jj], q = bs[2 * jj + 1];  // bmin.xyz bmax.x | bmax.yz pad2
    const int j = r0 + jj;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool hit = tpupt::slab_test(p.x, p.y, p.z, p.w, q.x, q.y, L.ox[k], L.oy[k],
                                        L.oz[k], L.ix[k], L.iy[k], L.iz[k], t_min,
                                        L.best_t[k]);
      L.count[k] += hit ? 1 : 0;
      L.first[k] = hit ? j : L.first[k];
    }
  }
}

// One box against a sweep1 lane's sweep bound: `first` takes j on a hit.
template <int K>
__device__ __forceinline__ void box_to_first(SweepLanes<K, true>& L, const float (&sb)[K],
                                             const float4& p, const float4& q, int j,
                                             float t_min) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool hit = tpupt::slab_test(p.x, p.y, p.z, p.w, q.x, q.y, L.ox[k], L.oy[k], L.oz[k],
                                      L.ix[k], L.iy[k], L.iz[k], t_min, sb[k]);
    L.first[k] = hit ? j : L.first[k];
  }
}

// sweep1's sweep of one staged tile: chunks of 8 boxes ascending, each
// chunk descending (the lowest hit in it is the last one seen, a select);
// after a chunk with a hit the lane's sweep bound drops to -inf, so `first`
// keeps its lowest hit, and the warp stops once every lane of it has one (a
// vote a chunk: every lane of the warp calls this together).  A slot that
// is not live sweeps from -inf.
template <int K>
__device__ __forceinline__ void sweep_to_first(SweepLanes<K, true>& L, const float4* bs,
                                               int r0, int nr, int num_leaves, float t_min) {
  const float ninf = -__int_as_float(0x7f800000);
  float sb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sb[k] = L.first[k] == num_leaves ? L.best_t[k] : ninf;
  for (int j0 = 0; j0 < nr; j0 += 8) {
    bool done = true;
#pragma unroll
    for (int k = 0; k < K; ++k) done = done && sb[k] == ninf;
    if (__all_sync(kFull, done)) break;
    if (j0 + 8 <= nr) {
#pragma unroll
      for (int jj = 7; jj >= 0; --jj) {
        box_to_first(L, sb, bs[2 * (j0 + jj)], bs[2 * (j0 + jj) + 1], r0 + j0 + jj, t_min);
      }
    } else {
      for (int jj = nr - 1 - j0; jj >= 0; --jj) {
        box_to_first(L, sb, bs[2 * (j0 + jj)], bs[2 * (j0 + jj) + 1], r0 + j0 + jj, t_min);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) sb[k] = L.first[k] == num_leaves ? sb[k] : ninf;
  }
}

// One pass of the march: the prime and the box sweep of this thread's K
// lanes; the count sweeps its tiles last first, sweep1 first first.  With
// one tile (`one`) the caller has staged it and synced; with more, this
// stages them itself, double-buffered, with a barrier a tile (every thread of
// the block calls it then).  A thread with no live lane (`any` false) skips
// the tests; sweep1 passes its warp's `any`, as its sweep votes.
template <int K, bool kLatch>
__device__ __forceinline__ void march_pass(SweepLanes<K, kLatch>& L, const bool (&live)[K],
                                           const int (&lane)[K], bool any, bool one,
                                           const float4* pre_s, float4* box_s,
                                           const float4* __restrict__ lbox, int n_prepass,
                                           int num_leaves, int tile_rows, float t_min,
                                           const float* __restrict__ t_max) {
  const int ntiles = (num_leaves + tile_rows - 1) / tile_rows;
  const int buf_stride = 2 * tile_rows;
  // the step's tile: ascending for sweep1, descending for the count
  auto tile_of = [&](int step) { return kLatch ? step : ntiles - 1 - step; };
  if (!one) {
    const int r0 = tile_of(0) * tile_rows;
    tpupt::stage_rows<2>(box_s, lbox, r0, min(tile_rows, num_leaves - r0), 2);
    tpupt::cp_async_commit();
  }
  for (int step = 0; step < max(ntiles, 1); ++step) {
    const int r0 = max(tile_of(step), 0) * tile_rows;  // this step's tile: its first box
    if (!one) {
      if (step + 1 < ntiles) {
        const int r1 = tile_of(step + 1) * tile_rows;
        tpupt::stage_rows<2>(box_s + ((step + 1) & 1) * buf_stride, lbox, r1,
                             min(tile_rows, num_leaves - r1), 2);
        tpupt::cp_async_commit();
        tpupt::cp_async_wait<1>();
      } else {
        tpupt::cp_async_wait<0>();
      }
      __syncthreads();
    }
    if (any) {
      if (step == 0) prime_lanes(L, live, lane, pre_s, n_prepass, t_min, t_max);
      const float4* bs = box_s + (step & 1) * buf_stride;
      const int nr = ntiles > 0 ? min(tile_rows, num_leaves - r0) : 0;
      if constexpr (kLatch) {
        sweep_to_first(L, bs, r0, nr, num_leaves, t_min);
      } else {
        sweep_all(L, bs, r0, nr, t_min);
      }
    }
    if (!one) __syncthreads();  // the buffer is refilled two tiles on
  }
}

// The count: the block stages its tables once and covers `tile` lanes in
// `passes` passes, kCountK lanes a thread (dense_march.cuh's lane mapping).
// A lane that is not active (or a masked slot) sweeps with best_t = -inf.
__global__ void __launch_bounds__(tpupt::kMarchMaxThreads, 1) sweep_count_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float4* __restrict__ lbox,
    const float4* __restrict__ pre, int n_prepass, int num_leaves, int tile_rows,
    float t_min, int tile, int passes, int n, int* __restrict__ out_count,
    int* __restrict__ out_first) {
  extern __shared__ float4 staged[];
  float4* pre_s = staged;                  // n_prepass rows of 3 float4
  float4* box_s = staged + 3 * n_prepass;  // one or two buffers of tile_rows boxes
  const bool one = stage_tables(pre_s, box_s, pre, lbox, n_prepass, num_leaves, tile_rows);
  if (one) {
    tpupt::cp_async_wait<0>();
    __syncthreads();
  }
  for (int pass = 0; pass < passes; ++pass) {
    int lane[kCountK];
    bool live[kCountK];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kCountK; ++k) {
      lane[k] = tpupt::march_lane(pass, k, kCountK, tile, n);
      live[k] = lane[k] >= 0 && active[max(lane[k], 0)];
      any = any || live[k];
    }
    SweepLanes<kCountK, false> L;
    load_lanes(L, lane, live, o, d, nullptr, n, num_leaves);
    march_pass(L, live, lane, any, one, pre_s, box_s, lbox, n_prepass, num_leaves,
               tile_rows, t_min, nullptr);
#pragma unroll
    for (int k = 0; k < kCountK; ++k) {
      if (lane[k] >= 0) {
        out_count[lane[k]] = L.count[k];
        out_first[lane[k]] = L.first[k];
      }
    }
  }
}

// sweep1's outputs.
struct Sweep1Out {
  float* t;
  float* u;
  float* v;
  int* row;
  int* orig;
};

// sweep1's list: tiles of kListTile lanes, a block of kListThreads threads a
// tile, kCompactLanes neighbouring lanes a thread (their loads independent)
// (scripts/dense_march.py:LIST_TILE).
constexpr int kListThreads = 256;
constexpr int kCompactLanes = 4;
constexpr int kListTile = kListThreads * kCompactLanes;

// The block's sum of x, on every thread (one use a kernel).
__device__ __forceinline__ int block_sum(int x, int* red) {
  x = __reduce_add_sync(kFull, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// First launch of sweep1: each tile's count of active lanes, and the fresh
// record (t_max, 0, 0, num_tris, 0) of every inactive lane.  Thread t takes
// lanes t, t + kListThreads, ... of the tile, so that each store of a warp
// writes 32 neighbouring lanes (lanes 4 t .. 4 t + 3, the list's order,
// would write a quarter of each sector a store).
__global__ void __launch_bounds__(kListThreads) sweep1_tally_kernel(
    const unsigned char* __restrict__ active, const float* __restrict__ t_max, int n,
    int num_tris, int* __restrict__ counts, Sweep1Out out) {
  __shared__ int red[kListThreads / 32];
  const int first = static_cast<int>(blockIdx.x) * kListTile + static_cast<int>(threadIdx.x);
  int cnt = 0;
#pragma unroll
  for (int b = 0; b < kCompactLanes; ++b) {
    const int i = first + b * kListThreads;
    if (i < n) {
      if (active[i]) {
        ++cnt;
      } else {
        out.t[i] = t_max[i];
        out.u[i] = 0.0f;
        out.v[i] = 0.0f;
        out.row[i] = num_tris;
        out.orig[i] = 0;
      }
    }
  }
  cnt = block_sum(cnt, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
}

// Second launch: each tile's active lanes into the list, in ascending order
// after the earlier tiles' (a prefix of their counts), a warp's after the
// lower warps' and a thread's after the lower threads' (a ballot a lane
// slot, then popcounts); the last tile writes the list's length to meta[0]
// and zeroes the march's pass counter, meta[1].
__global__ void __launch_bounds__(kListThreads) sweep1_list_kernel(
    const unsigned char* __restrict__ active, int n, const int* __restrict__ counts,
    int* __restrict__ list, int* __restrict__ meta) {
  __shared__ int red[kListThreads / 32];
  __shared__ int warp_n[kListThreads / 32];
  int before = 0;
  for (int x = threadIdx.x; x < static_cast<int>(blockIdx.x); x += blockDim.x) {
    before += counts[x];
  }
  const int offset = block_sum(before, red);
  const int w = static_cast<int>(threadIdx.x) >> 5;
  const int wl = static_cast<int>(threadIdx.x) & 31;
  const unsigned below = (1u << wl) - 1u;
  const int first = static_cast<int>(blockIdx.x) * kListTile +
                    static_cast<int>(threadIdx.x) * kCompactLanes;
  bool act[kCompactLanes];
  int pos = 0, in_warp = 0;
#pragma unroll
  for (int b = 0; b < kCompactLanes; ++b) {
    act[b] = first + b < n && active[first + b];
    const unsigned bal = __ballot_sync(kFull, act[b]);
    pos += __popc(bal & below);  // slot b of the lower threads
    in_warp += __popc(bal);
  }
  if (wl == 0) warp_n[w] = in_warp;
  __syncthreads();
  int in_tile = 0;
  for (int x = 0; x < static_cast<int>(blockDim.x >> 5); ++x) {
    pos += x < w ? warp_n[x] : 0;
    in_tile += warp_n[x];
  }
  pos += offset;
#pragma unroll
  for (int b = 0; b < kCompactLanes; ++b) {
    if (act[b]) list[pos++] = first + b;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    meta[0] = offset + in_tile;
    meta[1] = 0;
  }
}

// Third launch, the march: resident blocks stage the tables once and take
// passes of the list from a counter, kSweep1K entries a thread: with one
// tile of boxes each warp takes its own 32 kSweep1K entries and never waits
// on the block; with more tiles the block takes blockDim.x kSweep1K entries
// and syncs a tile.  Entry p0 + t kSweep1K + k goes to slot k of thread t
// (a thread's entries are neighbours).  Every pass but the last is full;
// the warp then serves each slot's lowest candidate leaf.
__global__ void __launch_bounds__(tpupt::kMarchMaxThreads, 1) sweep1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const float4* __restrict__ lbox,
    const int4* __restrict__ lmeta, const float* __restrict__ tris,
    const float4* __restrict__ pre, int n_prepass, int num_leaves, int num_tris,
    int tile_rows, float t_min, int n, const int* __restrict__ list, int* meta,
    Sweep1Out out) {
  extern __shared__ float4 staged[];
  __shared__ int pass_s;
  float4* pre_s = staged;
  float4* box_s = staged + 3 * n_prepass;
  const bool one = stage_tables(pre_s, box_s, pre, lbox, n_prepass, num_leaves, tile_rows);
  if (one) {
    tpupt::cp_async_wait<0>();
    __syncthreads();
  }
  const int m = meta[0];
  const float* pre_rows = reinterpret_cast<const float*>(pre);
  const int wl = static_cast<int>(threadIdx.x) & 31;
  const int per = (one ? 32 : static_cast<int>(blockDim.x)) * kSweep1K;
  const int slot0 = (one ? wl : static_cast<int>(threadIdx.x)) * kSweep1K;
  for (;;) {
    int p;
    if (one) {
      p = __shfl_sync(kFull, wl == 0 ? atomicAdd(meta + 1, 1) : 0, 0);
    } else {
      if (threadIdx.x == 0) pass_s = atomicAdd(meta + 1, 1);
      __syncthreads();
      p = pass_s;
      __syncthreads();
    }
    const int p0 = p * per;
    if (p0 >= m) break;
    int lane[kSweep1K];
    bool live[kSweep1K];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kSweep1K; ++k) {
      const int idx = p0 + slot0 + k;
      live[k] = idx < m;
      lane[k] = live[k] ? list[idx] : -1;
      any = any || live[k];
    }
    SweepLanes<kSweep1K, true> L;
    load_lanes(L, lane, live, o, d, t_max, n, num_leaves);
    march_pass(L, live, lane, __any_sync(kFull, any), one, pre_s, box_s, lbox, n_prepass,
               num_leaves, tile_rows, t_min, t_max);
    // the lowest candidate leaf of each slot, served by the warp: the rows of
    // tris8 with IEEE 1 / x (mt_row), u and v latched with t
    int row[kSweep1K];
#pragma unroll
    for (int k = 0; k < kSweep1K; ++k) {
      row[k] = -1;
      int f = 0, c = 0;
      if (L.first[k] < num_leaves) {
        const int4 lm = __ldg(lmeta + L.first[k]);
        f = lm.x;
        c = lm.y;
      }
      unsigned pend = __ballot_sync(kFull, c > 0);
      if (pend == 0u) continue;
      const int maxc = __reduce_max_sync(kFull, c);
      if (tpupt::coop_pays(c, maxc)) {
        do {
          const int owner = __ffs(pend) - 1;
          pend &= pend - 1u;
          int wrow, wc;
          float wu, wv;
          const unsigned kmin = tpupt::warp_leaf<true, true>(
              tris, owner, L.ox[k], L.oy[k], L.oz[k], L.dx[k], L.dy[k], L.dz[k], f, c, t_min,
              &wrow, &wc, &wu, &wv);
          if (wl == owner) {
            const float tw = tpupt::key_t(kmin);
            if (tw < L.best_t[k]) {
              L.best_t[k] = tw;
              L.u[k] = wu;
              L.v[k] = wv;
              row[k] = wrow;
            }
          }
        } while (pend != 0u);
      } else {
        tpupt::lane_leaf<true, true>(tris, f, c, maxc, L.ox[k], L.oy[k], L.oz[k], L.dx[k],
                                     L.dy[k], L.dz[k], t_min, &L.best_t[k], &row[k], &L.u[k],
                                     &L.v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kSweep1K; ++k) {
      if (live[k]) {
        const int i = lane[k];
        int r = num_tris;
        float orig = 0.0f;
        if (row[k] >= 0) {  // a leaf row won
          r = row[k];
          orig = __ldg(tris + 24 * r + 9);
        } else if (L.q[k] >= 0) {  // a prepass row won
          r = static_cast<int>(__ldg(pre_rows + 24 * L.q[k] + 21));
          orig = __ldg(pre_rows + 24 * L.q[k] + 9);
        }
        out.t[i] = L.best_t[k];
        out.u[i] = L.u[k];
        out.v[i] = L.v[k];
        out.row[i] = r;
        out.orig[i] = static_cast<int>(orig);
      }
    }
  }
  tpupt::cp_async_wait<0>();  // a block that marched nothing leaves no copy in flight
}

// Raise a kernel's dynamic shared-memory limit where `smem` needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// tile, blocks, threads, passes, tile_rows and smem: the launch shape of
// scripts/dense_march.py:march_shape at kCountK lanes a thread.
extern "C" int tpupt_sweep_count(
    const float* o, const float* d, const unsigned char* active,
    const float* lbox, const float* pre, int n_prepass, int num_leaves,
    float t_min, int tile, int blocks, int threads, int passes, int tile_rows,
    int smem, int n, int* out_count, int* out_first, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = allow_smem(sweep_count_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sweep_count_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, active, reinterpret_cast<const float4*>(lbox),
      reinterpret_cast<const float4*>(pre), n_prepass, num_leaves, tile_rows, t_min,
      tile, passes, n, out_count, out_first);
  return static_cast<int>(cudaGetLastError());
}

// threads, tile_rows and smem: the march's launch shape from
// scripts/dense_march.py:compact_shape; scratch: ceil(n / kListTile) + 2 + n
// ints (the tiles' counts, the list's length and pass counter, the list).
// Three launches: the tally, the list, the march on as many blocks as the
// card keeps resident.
extern "C" int tpupt_sweep1(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* lbox, const int* lmeta, const float* tris,
    const float* pre, int n_prepass, int num_leaves, int num_tris, float t_min,
    int threads, int tile_rows, int smem, int n, int* scratch, float* out_t,
    float* out_u, float* out_v, int* out_row, int* out_orig, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kListTile - 1) / kListTile;
  int* counts = scratch;
  int* meta = scratch + tiles;
  int* list = meta + 2;
  const Sweep1Out out{out_t, out_u, out_v, out_row, out_orig};
  sweep1_tally_kernel<<<tiles, kListThreads, 0, s>>>(active, t_max, n, num_tris, counts, out);
  sweep1_list_kernel<<<tiles, kListThreads, 0, s>>>(active, n, counts, list, meta);
  cudaError_t e = allow_smem(sweep1_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep1_kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int needed = (n + threads * kSweep1K - 1) / (threads * kSweep1K);
  const int blocks = max(1, min(per_sm * sms, needed));
  sweep1_kernel<<<blocks, threads, smem, s>>>(
      o, d, t_max, reinterpret_cast<const float4*>(lbox),
      reinterpret_cast<const int4*>(lmeta), tris, reinterpret_cast<const float4*>(pre),
      n_prepass, num_leaves, num_tris, tile_rows, t_min, n, list, meta, out);
  return static_cast<int>(cudaGetLastError());
}

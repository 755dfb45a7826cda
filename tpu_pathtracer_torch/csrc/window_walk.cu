// Nearest-hit BVH walk over Baldwin-Weber or Moller-Trumbore leaf rows: the
// warp-cooperative walk of walk_common.cuh with the window walk's epilogues.
//
// Replaces the TPU kernel _window_kernel (tpu_pathtracer/ops/pallas_traverse.py,
// via intersect_bvh_window) in each of its forms: tritest="bw" or "mt", both
// latches, with_orig, with_counts and hbm=True.  The TPU walked a whole ray
// tile in lockstep over 8-node windows because it has no per-lane gather; a
// Hopper thread gathers, so each lane steps its own ray through the same
// DFS-threaded layout (enter a hit internal node at node + 1, otherwise
// follow its miss link) and the warp shares the leaf work.
//
// Contract (the outputs, not the TPU algorithm): the same nearest hit, with
// strict < in visit order -- the 32-row big-triangle prepass first, then
// leaf rows in DFS order, ascending within a leaf -- which picks the same
// winner as the reference's latch="rows" (a sequential strict-< latch) and
// latch="argmin" (_argmin_pick's lowest-row rule) alike.  best_t starts at
// t_max.  Inactive lanes write (t_max, num_tris).  Every form is bit-equal to
// its plain version in ops/hopper_traverse.py on the card.
//
// The forms:
//
// * kMT (tritest="mt"): leaf rows are tris8's 24-float Moller-Trumbore rows
//   [p0, e1, e2, orig, ...] in _mt_block's operation order, tested at the
//   world-space origin (the reference anchors only the BW planes); the
//   prepass reads lay.prepass, whose col 21 holds the global row.  A row is
//   96 bytes against BW's 64, and MT does a few more operations a row.
// * out_orig (with_orig=True, the fused path+shadow walk): also writes the
//   winner's original triangle id (BW col 13, MT col 9; -1 on a miss), read
//   from the winning row once the walk is over (a prepass row carries the
//   same id as the leaf row it copies), so the shadow lanes'
//   nearest-hit-is-the-target test needs no gather.
// * kCounts (with_counts=True, the walk-utilization telemetry): two int32
//   rows beside the hits.  useful = the leaf rows this lane tested (the sum
//   of count over the leaves whose box it entered; prepass rows excluded) --
//   hardware-independent.  spent = n_prepass + the leaf-row test slots this
//   lane's WARP issued: the TPU charged every lane of a ray tile for each row
//   the tile tested, and Hopper's lockstep unit is the 32-lane warp.  A slot
//   is one row test on every lane of the warp: a cooperative step serves one
//   leaf with 32 of its rows a slot, the per-lane loop serves every pending
//   lane's next row in one.  So per warp, with U the sum of useful over its
//   32 lanes, n_prepass + ceil(U / 32) <= spent <= n_prepass + U
//   (ops/hopper_traverse.py:warp_spent_bounds).
//
// * out_payload (tpupt_window_walk_resolve: the frame's nearest-hit queries on
//   both routes): an epilogue after the walk replaces the XLA-fused
//   resolve_window_payload (pallas_traverse.py:1043).  It reads the winner's
//   row of lay.tris (the 24-float MT rows, the zero sentinel row at num_tris:
//   a pointer of its own, since the BW form walks tris8bw), recomputes u/v
//   with mt_row, which is resolve_window_payload's Moller-Trumbore
//   arithmetic, and writes minwalk's 12 rows through write_payload: t (raw:
//   t_max where nothing nearer was hit), u, v, orig, material, light+1,
//   position, unit normal.  The TPU resolved outside the kernel because
//   carrying u/v through every latch costs it a third more vector ops a row
//   (pallas_traverse.py:620-628); here the epilogue runs once a lane.  It
//   stays bit-equal to ops/hopper_traverse.py:window_payload_rows where
//   each of these holds:
//     - 1 / det is IEEE division (mt_row's `1.0f / det` under nvcc's default
//       -prec-div=true), never the dense marches' rcp_fast;
//     - det != 0 ? 1 / det : 0, as torch.where(det != 0, 1 / det, 0);
//     - the t rule comes before the clamp: t = t_raw < t_max ? t_raw : inf,
//       hit_ok = isfinite(t), then u, v = hit_ok ? clamp(., 0, 1) : 0, the
//       clamp NaN-propagating as torch.clamp is (fminf(fmaxf(u, 0), 1) in
//       torch's argument order);
//     - rsqrtf(fmaxf(|n|^2, 1e-20f)) equals torch.rsqrt(torch.clamp(...))
//       on the card (minwalk holds it so);
//     - every sum keeps resolve_window_payload's operation order, and the
//       build's --fmad=false keeps each multiply and add apart.
//   Dead lanes walk a zero ray; their t stays t_max, so hit_ok is false and
//   u = v = 0 whatever the ray, as in the torch resolve.
// * kCapped (tpupt_window_walk_capped: the HBM route's t_max-capped shadow
//   queries): the same epilogue cut to write_hit's first four rows, the
//   capped walk's (4, n) layout: t (raw), u, v and the row's col 9, the
//   original triangle id (0 on a miss, from the sentinel row, as the torch
//   resolve's rows[:, 9]; not out_orig's -1).  Bit-equal to
//   ops/hopper_traverse.py:window_capped_rows under the rules above.  A
//   template instance of its own, so the other forms compile as before.
//
// The HBM route (hbm=True: the TPU streamed demanded row blocks from HBM
// through double-buffered VMEM) needs no variant here: every table already
// lives in device memory.  ops/hopper_traverse.py:window_walk_hbm launches
// this same kernel on that route's queries: nearest ones with the payload
// epilogue, t_max-capped ones with the capped epilogue.
//
// What bounds it on an H100, what the design does about it and the measured
// share of its bound: walk_common.cuh and PERF.md section 6 (rows 1, 5-8).
#include "walk_common.cuh"

namespace {

// Where a launch writes: (t, row) and the variants' extra rows, or with
// `payload` only the epilogue's 12 rows, or in the kCapped instances only
// the capped epilogue's 4 rows.  Null pointers are not written.
struct Outs {
  float* t;
  int* row;
  int* orig;
  int* spent;
  int* useful;
  const float* tris;  // lay.tris, read by the epilogues
  float* payload;     // (12, n)
  float* capped = nullptr;  // (4, n), kCapped
};

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

template <bool kMT, bool kCounts, bool kCapped>
__global__ void __launch_bounds__(tpupt::kWalkMaxThreads, 1) window_walk_kernel(
    tpupt::WalkArgs a, Outs out) {
  using R = tpupt::Rows<kMT>;
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
    tpupt::walk_nearest<kMT, kCounts>(a, live, r, &best_t, &best_row, &useful, &slots);
    if (i < a.n) {
      if (out.t != nullptr) {
        out.t[i] = best_t;
        out.row[i] = best_row;
      }
      if (out.orig != nullptr) {
        out.orig[i] = best_row < a.num_tris
            ? static_cast<int>(__ldg(a.rows + R::kStride * best_row + R::kOrig))
            : -1;
      }
      if (kCounts) {
        out.spent[i] = a.n_prepass + slots;
        out.useful[i] = useful;
      }
      if (kCapped || out.payload != nullptr) {
        // the epilogues: resolve_window_payload on the winner's MT row
        const float* row = out.tris + 24 * best_row;
        float tt, u, v;
        tpupt::mt_row(row, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, a.t_min, &tt, &u, &v);
        // isfinite(t_raw < t_max ? t_raw : inf); t_max read again rather than
        // held in a register through the walk
        const bool hit_ok = best_t < a.t_max[i] && isfinite(best_t);
        const float uc = hit_ok ? clamp01(u) : 0.0f;
        const float vc = hit_ok ? clamp01(v) : 0.0f;
        if constexpr (kCapped) {
          tpupt::write_hit(row, best_t, uc, vc, a.n, i, out.capped);
        } else {
          tpupt::write_payload(row, best_t, uc, vc, a.n, i, out.payload);
        }
      }
    }
  }
}

// One launch of the kMT form `mt` picks.
template <bool kCounts, bool kCapped = false>
int launch(const tpupt::WalkArgs& a, int mt, const Outs& out, void* stream) {
  if (a.n > 0) {
    auto kernel = mt ? window_walk_kernel<true, kCounts, kCapped>
                     : window_walk_kernel<false, kCounts, kCapped>;
    kernel<<<tpupt::walk_blocks(a.n), tpupt::kWalkThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(a, out);
  }
  return static_cast<int>(cudaGetLastError());
}

tpupt::WalkArgs walk_args(const float* o, const float* d, const unsigned char* active,
                          const float* t_max, const float* packed, const float* rows,
                          const float* pre, int n_prepass, float ax, float ay, float az,
                          int num_nodes, int num_tris, float t_min, int n) {
  return {o, d, active, t_max, reinterpret_cast<const float4*>(packed), rows, pre,
          n_prepass, ax, ay, az, num_nodes, num_tris, t_min, n};
}

}  // namespace

extern "C" int tpupt_window_walk(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* packed, const float* rows, const float* pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, int mt, float* out_t, int* out_row, void* stream) {
  return launch<false>(walk_args(o, d, active, t_max, packed, rows, pre, n_prepass, ax,
                                 ay, az, num_nodes, num_tris, t_min, n),
                       mt, {out_t, out_row, nullptr, nullptr, nullptr, nullptr, nullptr},
                       stream);
}

extern "C" int tpupt_window_walk_resolve(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* packed, const float* rows, const float* pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, int mt, const float* tris, float* out, void* stream) {
  return launch<false>(walk_args(o, d, active, t_max, packed, rows, pre, n_prepass, ax,
                                 ay, az, num_nodes, num_tris, t_min, n),
                       mt, {nullptr, nullptr, nullptr, nullptr, nullptr, tris, out},
                       stream);
}

// The capped epilogue (kCapped): the arguments of tpupt_window_walk_resolve,
// `out` of 4 rows.
extern "C" int tpupt_window_walk_capped(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* packed, const float* rows, const float* pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, int mt, const float* tris, float* out, void* stream) {
  return launch<false, true>(
      walk_args(o, d, active, t_max, packed, rows, pre, n_prepass, ax, ay, az, num_nodes,
                num_tris, t_min, n),
      mt, {nullptr, nullptr, nullptr, nullptr, nullptr, tris, nullptr, out}, stream);
}

extern "C" int tpupt_window_walk_orig(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* packed, const float* rows, const float* pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, int mt, float* out_t, int* out_row, int* out_orig,
    void* stream) {
  return launch<false>(walk_args(o, d, active, t_max, packed, rows, pre, n_prepass, ax,
                                 ay, az, num_nodes, num_tris, t_min, n),
                       mt, {out_t, out_row, out_orig, nullptr, nullptr, nullptr, nullptr},
                       stream);
}

extern "C" int tpupt_window_walk_counts(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* packed, const float* rows, const float* pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, int mt, float* out_t, int* out_row, int* out_spent,
    int* out_useful, void* stream) {
  return launch<true>(walk_args(o, d, active, t_max, packed, rows, pre, n_prepass, ax,
                                ay, az, num_nodes, num_tris, t_min, n),
                      mt, {out_t, out_row, nullptr, out_spent, out_useful, nullptr, nullptr},
                      stream);
}

// Nearest-hit BVH walk over Baldwin-Weber or Moller-Trumbore leaf rows, one
// thread per ray.
//
// Replaces the TPU kernel _window_kernel (tpu_pathtracer/ops/pallas_traverse.py,
// via intersect_bvh_window) in each of its forms: tritest="bw" or "mt", both
// latches, and hbm=True.  The TPU walked a whole ray tile in lockstep over
// 8-node windows only because it has no per-lane gather; a Hopper thread
// gathers, so this is the stackless per-ray walk of ops/traverse.py:walk over
// the same DFS-threaded layout: enter a hit internal node at node + 1,
// otherwise follow its miss link.
//
// Contract (the outputs, not the TPU algorithm): the same nearest hit, with
// strict < in visit order -- the 32-row big-triangle prepass first, then
// leaf rows in DFS order, ascending within a leaf -- which picks the same
// winner as the reference's latch="rows" (a sequential strict-< latch) and
// latch="argmin" (_argmin_pick's lowest-row rule) alike.  best_t starts at
// t_max.  Inactive lanes write (t_max, num_tris).
//
// Three compile-time flags replace the TPU kernel's:
//
// * kMT (tritest="mt"): leaf rows are tris8's 24-float Moller-Trumbore rows
//   [p0, e1, e2, orig, ...] in _mt_block's operation order, tested at the
//   world-space origin (the reference anchors only the BW planes); the
//   prepass reads lay.prepass, whose col 21 holds the global row.  A row is
//   96 bytes against BW's 64, and MT does a few more operations a row.
// * kOrig (with_orig=True, the fused path+shadow walk): also latches the
//   winner's original triangle id (BW col 13, MT col 9; -1 on a miss), so
//   the shadow lanes' nearest-hit-is-the-target test needs no gather.
// * kCounts (with_counts=True, the walk-utilization telemetry): two int32
//   rows beside the hits.  useful = the leaf rows this lane tested (the sum
//   of count over the leaves whose box it entered; prepass rows excluded) --
//   hardware-independent.  spent = n_prepass + the leaf-row test slots this
//   lane's WARP issued: the TPU charged every lane of a ray tile for each row
//   the tile tested, and Hopper's lockstep unit is the 32-lane warp, so at
//   each leaf-row iteration the lowest lane of __activemask() counts one
//   slot for the warp, and every lane of the warp writes the warp's total.
//   spent depends on how the warp's lanes diverge and reconverge, so it lies
//   between n_prepass + max(useful) and n_prepass + sum(useful) over the
//   warp's 32 consecutive lanes.
//
// The HBM route (hbm=True: the TPU streamed demanded row blocks from HBM
// through double-buffered VMEM because VMEM holds ~12 MiB) needs no variant
// here: every table already lives in device memory and the walk reads rows
// through L1/L2.  ops/hopper_traverse.py:window_walk_hbm launches this same
// kernel on that route's queries, nearest and t_max-capped.
//
// What bounds it on an H100: per-thread divergence and the latency of its
// dependent gathers.  The bundled scenes' tables (Water-plastic at leaf 56:
// 18 KB of nodes, 459 KB of BW rows) stay in the 50 MB L2 for the whole
// frame; a 1,045,460-triangle scene's rows (64 MiB BW, 96 MiB MT) do not,
// and its misses go to HBM.  This version keeps it simple: read-only-path
// (__ldg) 16-byte loads of each node and row, no shared-memory staging.
#include "walk_common.cuh"

namespace {

template <bool kMT, bool kOrig, bool kCounts>
__global__ void window_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ nodes, const int* __restrict__ meta,
    const float* __restrict__ tris, const float* __restrict__ pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, float* __restrict__ out_t, int* __restrict__ out_row,
    int* __restrict__ out_orig, int* __restrict__ out_spent,
    int* __restrict__ out_useful) {
  using R = tpupt::Rows<kMT>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the counting variant keeps every lane of the warp to the final warp sum
  if (!kCounts && i >= n) return;
  const bool lane = kCounts ? i < n : true;
  float best_t = lane ? t_max[i] : 0.0f;
  int best_row = num_tris;
  float best_orig = -1.0f;
  int useful = 0, slots = 0;
  if (lane && active[i]) {
    const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    // BW plane constants are anchored at the scene-AABB centre; MT rows
    // are world-space
    const float bx = kMT ? ox : ox - ax;
    const float by = kMT ? oy : oy - ay;
    const float bz = kMT ? oz : oz - az;
    float tt;

    // phase 0: big-triangle prepass; col R::kIndex holds the global row id
    for (int k = 0; k < n_prepass; ++k) {
      const float* row = pre + R::kStride * k;
      if (tpupt::row_test<kMT>(row, bx, by, bz, dx, dy, dz, t_min, &tt) &&
          tt < best_t) {
        best_t = tt;
        best_row = static_cast<int>(__ldg(row + R::kIndex));
        if (kOrig) best_orig = __ldg(row + R::kOrig);
      }
    }

    // phase 1: stackless DFS walk
    int cur = 0;
    while (cur < num_nodes) {
      const bool hit = tpupt::slab_hit(nodes + 8 * cur, ox, oy, oz, ix, iy, iz,
                                       t_min, best_t);
      const int2 m = __ldg(reinterpret_cast<const int2*>(meta) + cur);
      const int count = m.y & 63;
      if (hit && count > 0) {
        const int first = m.y >> 6;
        for (int k = 0; k < count; ++k) {
          if (kCounts) {
            const unsigned mask = __activemask();
            if ((threadIdx.x & 31) == __ffs(mask) - 1) ++slots;
            ++useful;
          }
          const float* row = tris + R::kStride * (first + k);
          if (tpupt::row_test<kMT>(row, bx, by, bz, dx, dy, dz, t_min, &tt) &&
              tt < best_t) {
            best_t = tt;
            best_row = first + k;
            if (kOrig) best_orig = __ldg(row + R::kOrig);
          }
        }
      }
      cur = (hit && count == 0) ? cur + 1 : m.x;
    }
  }
  if (kCounts) {
    const int warp_slots = __reduce_add_sync(0xffffffffu, slots);
    if (lane) {
      out_spent[i] = n_prepass + warp_slots;
      out_useful[i] = useful;
    }
  }
  if (lane) {
    out_t[i] = best_t;
    out_row[i] = best_row;
    if (kOrig) out_orig[i] = static_cast<int>(best_orig);
  }
}

template <bool kOrig, bool kCounts>
int launch(const float* o, const float* d, const unsigned char* active,
           const float* t_max, const float* nodes, const int* meta,
           const float* tris, const float* pre, int n_prepass, float ax,
           float ay, float az, int num_nodes, int num_tris, float t_min, int n,
           int mt, float* out_t, int* out_row, int* out_orig, int* out_spent,
           int* out_useful, void* stream) {
  if (n > 0) {
    const int threads = 128;  // a multiple of 32: warps are 32 consecutive lanes
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mt) {
      window_walk_kernel<true, kOrig, kCounts><<<blocks, threads, 0, s>>>(
          o, d, active, t_max, nodes, meta, tris, pre, n_prepass, ax, ay, az,
          num_nodes, num_tris, t_min, n, out_t, out_row, out_orig, out_spent,
          out_useful);
    } else {
      window_walk_kernel<false, kOrig, kCounts><<<blocks, threads, 0, s>>>(
          o, d, active, t_max, nodes, meta, tris, pre, n_prepass, ax, ay, az,
          num_nodes, num_tris, t_min, n, out_t, out_row, out_orig, out_spent,
          out_useful);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpupt_window_walk(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* nodes, const int* meta, const float* tris,
    const float* pre, int n_prepass, float ax, float ay, float az,
    int num_nodes, int num_tris, float t_min, int n, int mt, float* out_t,
    int* out_row, void* stream) {
  return launch<false, false>(o, d, active, t_max, nodes, meta, tris, pre,
                              n_prepass, ax, ay, az, num_nodes, num_tris, t_min,
                              n, mt, out_t, out_row, nullptr, nullptr, nullptr,
                              stream);
}

extern "C" int tpupt_window_walk_orig(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* nodes, const int* meta, const float* tris,
    const float* pre, int n_prepass, float ax, float ay, float az,
    int num_nodes, int num_tris, float t_min, int n, int mt, float* out_t,
    int* out_row, int* out_orig, void* stream) {
  return launch<true, false>(o, d, active, t_max, nodes, meta, tris, pre,
                             n_prepass, ax, ay, az, num_nodes, num_tris, t_min,
                             n, mt, out_t, out_row, out_orig, nullptr, nullptr,
                             stream);
}

extern "C" int tpupt_window_walk_counts(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* nodes, const int* meta, const float* tris,
    const float* pre, int n_prepass, float ax, float ay, float az,
    int num_nodes, int num_tris, float t_min, int n, int mt, float* out_t,
    int* out_row, int* out_spent, int* out_useful, void* stream) {
  return launch<false, true>(o, d, active, t_max, nodes, meta, tris, pre,
                             n_prepass, ax, ay, az, num_nodes, num_tris, t_min,
                             n, mt, out_t, out_row, nullptr, out_spent, out_useful,
                             stream);
}

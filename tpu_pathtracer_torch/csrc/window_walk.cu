// Nearest-hit BVH walk with Baldwin-Weber triangle rows, one thread per ray.
//
// Replaces the TPU kernel _window_kernel (tpu_pathtracer/ops/pallas_traverse.py,
// via intersect_bvh_window), default variant: tritest="bw", latch="argmin".
// The TPU walked a whole ray tile in lockstep over 8-node windows only
// because it has no per-lane gather; a Hopper thread gathers, so this is
// the stackless per-ray walk of ops/traverse.py:intersect_bvh over the same
// DFS-threaded layout: enter a hit internal node at node + 1, otherwise
// follow its miss link.
//
// Contract (the outputs, not the TPU algorithm): the same nearest hit, with
// strict < in visit order -- the 32-row big-triangle prepass first, then
// leaf rows in DFS order, ascending within a leaf -- which picks the same
// winner as _argmin_pick's lowest-row rule.  best_t starts at t_max.
// Inactive lanes write (t_max, num_tris).
//
// What bounds it on an H100: the scene tables are small (Water-plastic at
// leaf 56: 18 KB of nodes, 459 KB of BW rows) and stay in the 50 MB L2 for
// the whole frame, so the walk is bound by per-thread divergence and the
// latency of its dependent gathers, not by HBM bandwidth.  This first
// version keeps it simple: read-only-path (__ldg) 16-byte loads of each
// node and triangle row, no shared-memory staging.
#include "walk_common.cuh"

namespace {

// One Baldwin-Weber row [n0 d0 | n1 d1 | n2 d2 | leaf orig pad2] against a
// ray whose origin is already anchored (o - anchor): the op order of the
// reference's _hit8 "bw" branch.
__device__ __forceinline__ bool bw_row(const float* __restrict__ row,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float t_min, float* t_out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float4 c = __ldg(reinterpret_cast<const float4*>(row) + 2);
  const float den = a.x * dx + a.y * dy + a.z * dz;
  const float num = a.x * ox + a.y * oy + a.z * oz + a.w;
  const float inv = den != 0.0f ? 1.0f / den : 0.0f;
  const float tt = -num * inv;
  const float px = ox + tt * dx;
  const float py = oy + tt * dy;
  const float pz = oz + tt * dz;
  const float u = b.x * px + b.y * py + b.z * pz + b.w;
  const float v = c.x * px + c.y * py + c.z * pz + c.w;
  *t_out = tt;
  return (den != 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (tt > t_min);
}

__global__ void window_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ nodes, const int* __restrict__ meta,
    const float* __restrict__ tris, const float* __restrict__ pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, float* __restrict__ out_t, int* __restrict__ out_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t = t_max[i];
  int best_row = num_tris;
  if (active[i]) {
    const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    // BW plane constants are anchored at the scene-AABB centre
    const float bx = ox - ax, by = oy - ay, bz = oz - az;
    float tt;

    // phase 0: big-triangle prepass; col 12 holds the global row id
    for (int k = 0; k < n_prepass; ++k) {
      const float* row = pre + 16 * k;
      if (bw_row(row, bx, by, bz, dx, dy, dz, t_min, &tt) && tt < best_t) {
        best_t = tt;
        best_row = static_cast<int>(__ldg(row + 12));
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
          if (bw_row(tris + 16 * (first + k), bx, by, bz, dx, dy, dz, t_min, &tt) &&
              tt < best_t) {
            best_t = tt;
            best_row = first + k;
          }
        }
      }
      cur = (hit && count == 0) ? cur + 1 : m.x;
    }
  }
  out_t[i] = best_t;
  out_row[i] = best_row;
}

}  // namespace

extern "C" int tpupt_window_walk(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* nodes, const int* meta, const float* tris,
    const float* pre, int n_prepass, float ax, float ay, float az,
    int num_nodes, int num_tris, float t_min, int n, float* out_t, int* out_row,
    void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    window_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, active, t_max, nodes, meta, tris, pre, n_prepass, ax, ay, az,
        num_nodes, num_tris, t_min, n, out_t, out_row);
  }
  return static_cast<int>(cudaGetLastError());
}

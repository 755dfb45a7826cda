// Any-hit occlusion BVH walk with Moller-Trumbore rows and early lane death,
// one thread per ray: the shadow query of scenes with an environment light.
//
// Replaces the TPU kernel _occlusion_anyhit_kernel (tpu_pathtracer/ops/
// pallas_traverse.py, via occlusion_clear_anyhit).  The TPU kernel stepped a
// ray tile through min(node pointer), and an occluded lane jumped its cursor
// to the sentinel so the tile stopped visiting subtrees only it demanded.
// Here each thread walks its own ray over the same DFS-threaded leaf-8
// layout and simply stops at its first occluder.
//
// Per lane: clear = target >= 0 ? (target hit && !occluded) : !occluded,
// and 0 for inactive lanes.  The slab test bounds boxes by the fixed range
// cap (not a shrinking best_t).  A leaf row that passes the MT test (the op
// order of the reference's _mt_row):
//   * is an occluder when it is not the target and tt < cap - 4*eps: the
//     lane ends its walk at once;
//   * latches "target hit" when it is the target and eps <= tt < cap; the
//     walk goes on, since a nearer occluder may come later in DFS order.
// Environment lanes carry target -1 (never an original triangle id) and a
// cap of 1e30, so any scene hit occludes them.  The TPU packed the target
// into a float ray plane; here it is an int32 array compared with the row's
// orig column converted to int.
//
// What bounds it on an H100: the leaf-8 tables of Water-plastic (~116 KB of
// nodes, 680 KB of triangle rows) stay in L2; the walk is bound by
// per-thread divergence and dependent-gather latency.  Occluded lanes end
// early, which is the reason the kernel exists.  Plain __ldg 16-byte loads,
// no shared-memory staging; writes one byte per lane.
#include "walk_common.cuh"

namespace {

__global__ void anyhit_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ cap,
    const int* __restrict__ target, const float* __restrict__ nodes,
    const int* __restrict__ meta, const float* __restrict__ tris,
    int num_nodes, float t_min, float eps, float four_eps, int n,
    unsigned char* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned char clear = 0;
  if (active[i]) {
    const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    const float c = cap[i];
    const float thresh = c - four_eps;  // occluders must be nearer than the light
    const int tgt_id = target[i];
    bool occ = false, tgt = false;
    int cur = 0;
    while (cur < num_nodes && !occ) {
      const bool hit = tpupt::slab_hit(nodes + 8 * cur, ox, oy, oz, ix, iy, iz,
                                       t_min, c);
      const int2 m = __ldg(reinterpret_cast<const int2*>(meta) + cur);
      const int count = m.y & 63;
      if (hit && count > 0) {
        const int first = m.y >> 6;
        for (int k = 0; k < count; ++k) {
          const float4* row = reinterpret_cast<const float4*>(tris + 24 * (first + k));
          const float4 r0 = __ldg(row);      // p0x p0y p0z e1x
          const float4 r1 = __ldg(row + 1);  // e1y e1z e2x e2y
          const float4 r2 = __ldg(row + 2);  // e2z orig ...
          const float p0x = r0.x, p0y = r0.y, p0z = r0.z;
          const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
          const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float inv = det != 0.0f ? 1.0f / det : 0.0f;
          const float tx = ox - p0x;
          const float ty = oy - p0y;
          const float tz = oz - p0z;
          const float u = (tx * px + ty * py + tz * pz) * inv;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv;
          const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
          if ((det != 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
              (tt > t_min)) {
            const bool is_tgt = static_cast<int>(r2.y) == tgt_id;
            if (!is_tgt && tt < thresh) {
              occ = true;  // early death
              break;
            }
            if (is_tgt && tt >= eps && tt < c) tgt = true;
          }
        }
      }
      cur = (hit && count == 0) ? cur + 1 : m.x;
    }
    clear = (tgt_id >= 0 ? (tgt && !occ) : !occ) ? 1 : 0;
  }
  out[i] = clear;
}

}  // namespace

extern "C" int tpupt_anyhit_walk(
    const float* o, const float* d, const unsigned char* active,
    const float* cap, const int* target, const float* nodes, const int* meta,
    const float* tris, int num_nodes, float t_min, float eps, float four_eps,
    int n, unsigned char* out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    anyhit_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, active, cap, target, nodes, meta, tris, num_nodes, t_min, eps,
        four_eps, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Range-capped nearest-hit BVH walk with Moller-Trumbore rows, one thread
// per ray: the shadow-ray query.
//
// Replaces the TPU kernel _traverse_kernel (tpu_pathtracer/ops/
// pallas_traverse.py, via intersect_bvh_pallas with resolve=False and
// prepass=0).  The TPU kernel stepped a ray tile through min(node pointer)
// one node at a time; here each thread walks its own ray over the same
// DFS-threaded layout (ops/traverse.py:intersect_bvh).  best_t is seeded by
// the per-ray cap, so every subtree beyond the sampled light point is
// culled.  Latches t, u, v and the original triangle id with strict < in
// visit order; writes only those 4 rows (inactive lanes: cap, 0, 0, 0).
// The wrapper turns t >= cap into a miss.
//
// What bounds it on an H100: the leaf-8 tables (~116 KB of nodes, 680 KB of
// triangle rows for Water-plastic) stay in L2; the walk is bound by
// per-thread divergence and dependent-gather latency.  Shadow walks are
// short because the cap prunes them.  Plain __ldg 16-byte loads, no
// shared-memory staging.
#include "walk_common.cuh"

namespace {

__global__ void capped_walk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ cap,
    const float* __restrict__ nodes, const int* __restrict__ meta,
    const float* __restrict__ tris, int num_nodes, float t_min, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t = cap[i];
  float best_u = 0.0f, best_v = 0.0f, best_orig = 0.0f;
  if (active[i]) {
    const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    int cur = 0;
    while (cur < num_nodes) {
      const bool hit = tpupt::slab_hit(nodes + 8 * cur, ox, oy, oz, ix, iy, iz,
                                       t_min, best_t);
      const int2 m = __ldg(reinterpret_cast<const int2*>(meta) + cur);
      const int count = m.y & 63;
      if (hit && count > 0) {
        const int first = m.y >> 6;
        for (int k = 0; k < count; ++k) {
          // row [p0.xyz, e1.xyz, e2.xyz, orig, ...]: the op order of the
          // reference's _mt_row
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
              (tt > t_min) && (tt < best_t)) {
            best_t = tt;
            best_u = u;
            best_v = v;
            best_orig = r2.y;
          }
        }
      }
      cur = (hit && count == 0) ? cur + 1 : m.x;
    }
  }
  out[i] = best_t;
  out[n + i] = best_u;
  out[2 * n + i] = best_v;
  out[3 * n + i] = best_orig;
}

}  // namespace

extern "C" int tpupt_capped_walk(
    const float* o, const float* d, const unsigned char* active,
    const float* cap, const float* nodes, const int* meta, const float* tris,
    int num_nodes, float t_min, int n, float* out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    capped_walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, active, cap, nodes, meta, tris, num_nodes, t_min, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Nearest-hit BVH walk with Moller-Trumbore rows and the shading payload
// resolved in the kernel, one thread per ray (traversal_kernel="minwalk").
//
// Replaces the TPU kernel _traverse_kernel with resolve=True and a
// big-triangle prepass (tpu_pathtracer/ops/pallas_traverse.py, via
// intersect_bvh_pallas).  The TPU kernel stepped a ray tile through
// min(node pointer) one node at a time and then served the tile's unique hit
// triangles in a second min-loop ("phase 2"), because a TPU lane cannot
// gather.  Here each thread walks its own ray over the leaf-56 layout's MT
// rows, and phase 2 is one read of the winning row.
//
// Contract: strict < in visit order -- the prepass rows (lay.prepass, col 21
// = the global row id) first, then leaf rows in DFS order -- seeded by
// t_max.  Writes the 12 rows of the TPU kernel's output: t, u, v, orig,
// material, light+1, position (3) and unit shading normal (3), the normal
// through rsqrt(max(|n|^2, 1e-20)).  Inactive lanes and misses resolve the
// all-zero sentinel row: (t_max, 0, ..., 0).
//
// What bounds it on an H100: like the window walk, per-thread divergence and
// the latency of dependent gathers from L2-resident tables (Water-plastic at
// leaf 56: 18 KB of nodes, 680 KB of 96-byte MT rows); an MT row costs a few
// more operations than a BW row.  Plain __ldg loads, no shared memory.
#include "walk_common.cuh"

namespace {

__global__ void minwalk_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ nodes, const int* __restrict__ meta,
    const float* __restrict__ tris, const float* __restrict__ pre,
    int n_prepass, int num_nodes, int num_tris, float t_min, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t = t_max[i];
  float best_u = 0.0f, best_v = 0.0f;
  int best_row = num_tris;
  if (active[i]) {
    const float ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    const float dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    float tt, u, v;

    // phase 0: big-triangle prepass
    for (int k = 0; k < n_prepass; ++k) {
      const float* row = pre + 24 * k;
      if (tpupt::mt_row(row, ox, oy, oz, dx, dy, dz, t_min, &tt, &u, &v) &&
          tt < best_t) {
        best_t = tt;
        best_u = u;
        best_v = v;
        best_row = static_cast<int>(__ldg(row + 21));
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
          if (tpupt::mt_row(tris + 24 * (first + k), ox, oy, oz, dx, dy, dz,
                            t_min, &tt, &u, &v) &&
              tt < best_t) {
            best_t = tt;
            best_u = u;
            best_v = v;
            best_row = first + k;
          }
        }
      }
      cur = (hit && count == 0) ? cur + 1 : m.x;
    }
  }

  // phase 2: the winning row's payload (the reference's rbody arithmetic)
  const float* row = tris + 24 * best_row;
  const float w0 = 1.0f - best_u - best_v;
  const float px = __ldg(row + 0) + best_u * __ldg(row + 3) + best_v * __ldg(row + 6);
  const float py = __ldg(row + 1) + best_u * __ldg(row + 4) + best_v * __ldg(row + 7);
  const float pz = __ldg(row + 2) + best_u * __ldg(row + 5) + best_v * __ldg(row + 8);
  const float nx = __ldg(row + 10) * w0 + __ldg(row + 13) * best_u + __ldg(row + 16) * best_v;
  const float ny = __ldg(row + 11) * w0 + __ldg(row + 14) * best_u + __ldg(row + 17) * best_v;
  const float nz = __ldg(row + 12) * w0 + __ldg(row + 15) * best_u + __ldg(row + 18) * best_v;
  const float rlen = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
  out[i] = best_t;
  out[n + i] = best_u;
  out[2 * n + i] = best_v;
  out[3 * n + i] = __ldg(row + 9);
  out[4 * n + i] = __ldg(row + 19);
  out[5 * n + i] = __ldg(row + 20);
  out[6 * n + i] = px;
  out[7 * n + i] = py;
  out[8 * n + i] = pz;
  out[9 * n + i] = nx * rlen;
  out[10 * n + i] = ny * rlen;
  out[11 * n + i] = nz * rlen;
}

}  // namespace

extern "C" int tpupt_minwalk(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* nodes, const int* meta, const float* tris,
    const float* pre, int n_prepass, int num_nodes, int num_tris, float t_min,
    int n, float* out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    minwalk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, active, t_max, nodes, meta, tris, pre, n_prepass, num_nodes,
        num_tris, t_min, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

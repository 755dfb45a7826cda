// The first port's BVH walks, one thread per ray: the yardsticks that the
// warp-cooperative walks of window_walk.cu, minwalk.cu, capped_walk.cu and
// anyhit_walk.cu are timed against inside one run (chip_smoke.py's walk A/B
// phase and the card tests).  No frame path, CLI or bench reaches them, and
// they are no fallback.
//
// tpupt_window_walk_v1 is the window walk's default form (tritest "bw" or
// "mt", no original-id latch, no counts), tpupt_minwalk_v1 the minwalk,
// tpupt_capped_walk_v1 the capped shadow walk and tpupt_anyhit_walk_v1 the
// any-hit walk, as they stood before the redesigns: each thread walks its own
// ray over `nodes` (six scalar loads a node) and `nodes_meta`, and on entering
// a leaf tests its rows one after the other while the other lanes of its warp
// sit elsewhere; a fixed 128-thread block per 128 rays, no shared memory.
// Same contracts and the same bits as the new kernels: strict < in visit
// order, seeded by t_max or the cap; the any-hit walk stops at its first
// occluder.
#include "walk_common.cuh"

namespace {

template <bool kMT>
__global__ void window_walk_v1_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const unsigned char* __restrict__ active, const float* __restrict__ t_max,
    const float* __restrict__ nodes, const int* __restrict__ meta,
    const float* __restrict__ tris, const float* __restrict__ pre,
    int n_prepass, float ax, float ay, float az, int num_nodes, int num_tris,
    float t_min, int n, float* __restrict__ out_t, int* __restrict__ out_row) {
  using R = tpupt::Rows<kMT>;
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
    const float bx = kMT ? ox : ox - ax;
    const float by = kMT ? oy : oy - ay;
    const float bz = kMT ? oz : oz - az;
    float tt;
    for (int k = 0; k < n_prepass; ++k) {
      const float* row = pre + R::kStride * k;
      if (tpupt::row_test<kMT>(row, bx, by, bz, dx, dy, dz, t_min, &tt) &&
          tt < best_t) {
        best_t = tt;
        best_row = static_cast<int>(__ldg(row + R::kIndex));
      }
    }
    int cur = 0;
    while (cur < num_nodes) {
      const bool hit = tpupt::slab_hit(nodes + 8 * cur, ox, oy, oz, ix, iy, iz,
                                       t_min, best_t);
      const int2 m = __ldg(reinterpret_cast<const int2*>(meta) + cur);
      const int count = m.y & 63;
      if (hit && count > 0) {
        const int first = m.y >> 6;
        for (int k = 0; k < count; ++k) {
          const float* row = tris + R::kStride * (first + k);
          if (tpupt::row_test<kMT>(row, bx, by, bz, dx, dy, dz, t_min, &tt) &&
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

__global__ void minwalk_v1_kernel(
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
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (active[i]) {
    ox = o[i], oy = o[n + i], oz = o[2 * n + i];
    dx = d[i], dy = d[n + i], dz = d[2 * n + i];
    const float ix = tpupt::safe_inv(dx);
    const float iy = tpupt::safe_inv(dy);
    const float iz = tpupt::safe_inv(dz);
    float tt, u, v;
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
  tpupt::write_payload(tris + 24 * best_row, best_t, best_u, best_v, n, i, out);
}

__global__ void capped_walk_v1_kernel(
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

__global__ void anyhit_walk_v1_kernel(
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

extern "C" int tpupt_window_walk_v1(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* nodes, const int* meta, const float* tris,
    const float* pre, int n_prepass, float ax, float ay, float az,
    int num_nodes, int num_tris, float t_min, int n, int mt, float* out_t,
    int* out_row, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mt) {
      window_walk_v1_kernel<true><<<blocks, threads, 0, s>>>(
          o, d, active, t_max, nodes, meta, tris, pre, n_prepass, ax, ay, az,
          num_nodes, num_tris, t_min, n, out_t, out_row);
    } else {
      window_walk_v1_kernel<false><<<blocks, threads, 0, s>>>(
          o, d, active, t_max, nodes, meta, tris, pre, n_prepass, ax, ay, az,
          num_nodes, num_tris, t_min, n, out_t, out_row);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_minwalk_v1(
    const float* o, const float* d, const unsigned char* active,
    const float* t_max, const float* nodes, const int* meta, const float* tris,
    const float* pre, int n_prepass, int num_nodes, int num_tris, float t_min,
    int n, float* out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    minwalk_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, active, t_max, nodes, meta, tris, pre, n_prepass, num_nodes,
        num_tris, t_min, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_capped_walk_v1(
    const float* o, const float* d, const unsigned char* active,
    const float* cap, const float* nodes, const int* meta, const float* tris,
    int num_nodes, float t_min, int n, float* out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    capped_walk_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, active, cap, nodes, meta, tris, num_nodes, t_min, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_anyhit_walk_v1(
    const float* o, const float* d, const unsigned char* active,
    const float* cap, const int* target, const float* nodes, const int* meta,
    const float* tris, int num_nodes, float t_min, float eps, float four_eps,
    int n, unsigned char* out, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    anyhit_walk_v1_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, active, cap, target, nodes, meta, tris, num_nodes, t_min, eps,
        four_eps, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

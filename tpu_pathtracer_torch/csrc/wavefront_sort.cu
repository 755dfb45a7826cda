// The wavefront sort of one bounce around torch.sort: the int64 key in one
// launch, then every plane of the path state and its shadow pack gathered by
// the permutation in one more.
//
// Replaces a stage that XLA fused on the TPU: tpu_pathtracer/render/
// wavefront.py's ray_sort_key (:122) and sort_wavefront (:221), a variadic
// lax.sort over the key and every payload plane.  The port sorts one int64
// key with torch.sort (XLA's sort, not a Pallas kernel, on the TPU) and
// gathers the planes by the permutation; its plain versions
// (ops/wavefront_sort.py:sort_key_plain, gather_planes_plain) issue some 40
// elementwise launches for the key and one index_select a plane (14 planes at
// S = 3 without hero bins).
//
// Contract: bit-equal to the plain versions.
//   tpupt_sort_key       key = (ray_key << 32) | pixel, ray_key =
//                        (dead << 30) | (coarse << 20) | (octa << 12) | fine,
//                        in ray_key_plain's operation order: the L1 norm
//                        summed left to right, IEEE division, torch.sign's
//                        (0 < x) - (x < 0), NaN-propagating clamps before the
//                        truncating float -> int64 conversion; wmin and winv
//                        arrive as the float32 values the plain version
//                        subtracts and multiplies by.
//   tpupt_gather_planes  dst[r][i] = src[r][perm[i]] for every plane (rows r,
//                        element size 1, 4 or 8 bytes), the planes listed in
//                        a table passed by value (kernel parameter space, no
//                        copy of its own).
//
// What bounds them on an H100: bytes.  The key reads 33 bytes a lane
// (origin, direction, alive, pixel) and writes 8; the gather reads the
// permutation (8 bytes) and every plane's element once and writes it once:
// 70 + 12 S bytes each way a lane at S spectral planes without hero bins.  At
// 2,073,600 lanes and S = 3 the gather's 2 x 106 + 8 bytes a lane are 456 MB,
// 0.136 ms at 3.35 TB/s.  The design: one thread a lane, writes coalesced,
// the gather's reads follow the permutation (scattered within the sorted
// cells); no shared memory.  The measured share of the bound: PERF.md section
// 6, the table of the XLA-fused stages.
#include <cuda_runtime.h>

// One plane of the gather: (rows, n) elements of `elem` bytes at src, the
// same shape at dst (both contiguous).  Outside the anonymous namespace: the
// extern "C" launcher takes it (a type of internal linkage would hide the
// launcher's symbol).
struct Plane {
  const void* src;
  void* dst;
  int rows;
  int elem;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 16;  // ops/wavefront_sort.py:MAX_PLANES

// torch.clamp(x, lo, hi): NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// torch.sign on float32: (0 < x) - (x < 0), so +0 for zeros and NaN.
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

// Spread 5 bits to every 3rd position (ops/wavefront_sort.py:_morton5).
__device__ __forceinline__ long long morton5(long long q) {
  q = (q | (q << 8)) & 0x100F;
  q = (q | (q << 4)) & 0x10C3;
  q = (q | (q << 2)) & 0x1249;
  return q;
}

struct Box {
  float wmin[3], winv[3];
};

__global__ void __launch_bounds__(kThreads) sort_key_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const unsigned char* __restrict__ alive, const long long* __restrict__ pixel,
    Box box, int n, long long* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t sn = n;
  const float d0 = direction[i], d1 = direction[sn + i], d2 = direction[2 * sn + i];
  const float anorm = (fabsf(d0) + fabsf(d1)) + fabsf(d2);
  const float u = d0 / anorm;
  const float v = d1 / anorm;
  const bool back = d2 < 0.0f;
  const float uo = back ? (1.0f - fabsf(v)) * sign_of(u) : u;
  const float vo = back ? (1.0f - fabsf(u)) * sign_of(v) : v;
  const long long qu = static_cast<long long>(clamp_nan((uo * 0.5f + 0.5f) * 16.0f, 0.0f, 15.0f));
  const long long qv = static_cast<long long>(clamp_nan((vo * 0.5f + 0.5f) * 16.0f, 0.0f, 15.0f));
  const long long octa = (qu << 4) | qv;
  long long mort = 0;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    const float o = origin[axis * sn + i];
    const float q = clamp_nan((o - box.wmin[axis]) * box.winv[axis] * 32.0f, 0.0f, 31.0f);
    mort |= morton5(static_cast<long long>(q)) << (2 - axis);
  }
  const long long coarse = mort >> 6;
  const long long fine = mort & 63;
  const long long dead = alive[i] ? 0 : 1;
  const long long ray = (dead << 30) | (coarse << 20) | (octa << 12) | fine;
  key[i] = (ray << 32) | pixel[i];
}

struct Planes {
  Plane p[kMaxPlanes];
};

template <typename T>
__device__ __forceinline__ void take(const Plane& pl, int n, int i, long long j) {
  const T* __restrict__ src = static_cast<const T*>(pl.src);
  T* __restrict__ dst = static_cast<T*>(pl.dst);
  for (int r = 0; r < pl.rows; ++r) {
    const size_t row = static_cast<size_t>(r) * n;
    dst[row + i] = src[row + j];
  }
}

__global__ void __launch_bounds__(kThreads) gather_planes_kernel(
    Planes planes, int count, const long long* __restrict__ perm, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = perm[i];
  for (int k = 0; k < count; ++k) {
    const Plane& pl = planes.p[k];
    if (pl.elem == 8) {
      take<long long>(pl, n, i, j);
    } else if (pl.elem == 4) {
      take<unsigned int>(pl, n, i, j);
    } else {
      take<unsigned char>(pl, n, i, j);
    }
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// origin, direction: (3, n) float32; alive: (n,) bool; pixel: (n,) int64;
// the scene box's wmin and winv (render/wavefront.py:scene_sort_bounds);
// key: (n,) int64 out.
extern "C" int tpupt_sort_key(const float* origin, const float* direction,
                              const unsigned char* alive, const long long* pixel,
                              float wmin0, float wmin1, float wmin2, float winv0,
                              float winv1, float winv2, int n, long long* key,
                              void* stream) {
  const Box box = {{wmin0, wmin1, wmin2}, {winv0, winv1, winv2}};
  if (n > 0) {
    sort_key_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        origin, direction, alive, pixel, box, n, key);
  }
  return static_cast<int>(cudaGetLastError());
}

// planes: host array of `count` Plane entries (ops/wavefront_sort.py:_Plane);
// perm: (n,) int64.
extern "C" int tpupt_gather_planes(const Plane* planes, int count, const long long* perm,
                                   int n, void* stream) {
  if (count < 0 || count > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  Planes table = {};
  for (int k = 0; k < count; ++k) {
    const int e = planes[k].elem;
    if (e != 1 && e != 4 && e != 8) return static_cast<int>(cudaErrorInvalidValue);
    table.p[k] = planes[k];
  }
  if (n > 0 && count > 0) {
    gather_planes_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, count, perm, n);
  }
  return static_cast<int>(cudaGetLastError());
}

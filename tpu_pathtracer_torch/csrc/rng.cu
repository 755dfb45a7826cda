// The per-pixel uniforms of the counter-based RNG: the PCG4D mixer in native
// uint32, one thread a lane, written straight into the (count, N) float32
// rows the frame reads.
//
// Replaces a stage that XLA fused on the TPU: tpu_pathtracer/ops/rng.py's
// pcg4d (:24), uniforms (:56) and uniforms_r2 (:99), which the reference
// traces as plain uint32 array code.  The port's plain versions
// (ops/rng.py:uniforms_plain, uniforms_r2_plain) emulate uint32 in int64
// tensors with a mask after every step, some 145-431 torch launches a call;
// here one launch does all of it in registers.
//
// Contract: bit-equal to the plain versions.  The host (ops/rng.py:
// uniform_keys, uniform_r2_keys) forms each group's scalar keys with Python
// ints masked to 32 bits, exactly as the plain versions do, so frame, salt
// and bounce (negative bounce included) reach the kernel already wrapped.
// A lane keeps the low 32 bits of its int64 pixel id.  A row's value is
// (bits >> 8) * 2^-24: the top 24 bits convert to float32 exactly and the
// scale is a power of two, so no rounding differs.
//
//   tpupt_uniforms     group g (rows 4g .. 4g+3) = pcg4d(pid, k[3g],
//                      k[3g+1], k[3g+2]).
//   tpupt_uniforms_r2  pair p (rows 4p .. 4p+3): rot = pcg4d(pid, rot_b[p],
//                      mixed, rot_d[p]), scr = pcg4d(pid, scr_b[p], mixed,
//                      scr_d[p]); row 4p + j = rot[j] + (frame ^ scr[j / 2])
//                      * alpha[j % 2], wrapping mod 2^32.
//
// What bounds it on an H100: bytes.  A lane reads 8 bytes and writes 4 a
// row: at count 6 and 2,073,600 lanes 66.4 MB, 19.8 us at 3.35 TB/s.  Its
// integer work (~32 operations a pcg4d call) is below that.  The design:
// one thread a lane, the loops over groups unrolled to kMaxCount so the keys
// stay in the kernel's parameter space and the four words in registers,
// each row written by consecutive lanes (coalesced).  The measured share of
// the bound: PERF.md section 6, the table of the XLA-fused stages.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCount = 16;               // ops/rng.py:MAX_COUNT
constexpr int kMaxGroups = kMaxCount / 4;   // pcg4d calls of tpupt_uniforms
constexpr int kThreads = 256;

struct Keys {
  unsigned int k[3 * kMaxGroups];  // b, c, d of each group
};

struct R2Keys {
  unsigned int rot_b[kMaxGroups], rot_d[kMaxGroups];
  unsigned int scr_b[kMaxGroups], scr_d[kMaxGroups];
  unsigned int mixed, frame, alpha0, alpha1;
};

// PCG4D (Jarzynski & Olano 2020) in wrapping uint32, the reference's order.
__device__ __forceinline__ void pcg4d(unsigned int& v0, unsigned int& v1,
                                      unsigned int& v2, unsigned int& v3) {
  v0 = v0 * 1664525u + 1013904223u;
  v1 = v1 * 1664525u + 1013904223u;
  v2 = v2 * 1664525u + 1013904223u;
  v3 = v3 * 1664525u + 1013904223u;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  v3 ^= v3 >> 16;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
}

// uint32 -> float32 in [0, 1) from the top 24 bits (exact).
__device__ __forceinline__ float unit(unsigned int bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads) uniforms_kernel(
    const long long* __restrict__ pid, Keys keys, int count, int n,
    float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned int p = static_cast<unsigned int>(__ldg(pid + i));
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (4 * g < count) {
        unsigned int v[4] = {p, keys.k[3 * g], keys.k[3 * g + 1], keys.k[3 * g + 2]};
        pcg4d(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * g + j < count) out[static_cast<size_t>(4 * g + j) * n + i] = unit(v[j]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) uniforms_r2_kernel(
    const long long* __restrict__ pid, R2Keys keys, int count, int n,
    float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned int p = static_cast<unsigned int>(__ldg(pid + i));
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (4 * g < count) {
        unsigned int rot[4] = {p, keys.rot_b[g], keys.mixed, keys.rot_d[g]};
        unsigned int scr[4] = {p, keys.scr_b[g], keys.mixed, keys.scr_d[g]};
        pcg4d(rot[0], rot[1], rot[2], rot[3]);
        pcg4d(scr[0], scr[1], scr[2], scr[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * g + j < count) {
            const unsigned int idx = keys.frame ^ scr[j >> 1];
            const unsigned int bits = rot[j] + idx * ((j & 1) ? keys.alpha1 : keys.alpha0);
            out[static_cast<size_t>(4 * g + j) * n + i] = unit(bits);
          }
        }
      }
    }
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// pid: (n,) int64; keys: host array of 3 * kMaxGroups uint32 (b, c, d a
// group, ops/rng.py:uniform_keys); out: (count, n) float32.
extern "C" int tpupt_uniforms(const long long* pid, const unsigned int* keys, int count,
                              int n, float* out, void* stream) {
  if (count < 1 || count > kMaxCount) return static_cast<int>(cudaErrorInvalidValue);
  Keys k;
  for (int j = 0; j < 3 * kMaxGroups; ++j) k.k[j] = keys[j];
  if (n > 0) {
    uniforms_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pid, k, count, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys: host array of 4 * kMaxGroups + 4 uint32 (rot_b, rot_d, scr_b, scr_d
// of each pair in turn, then mixed, frame, alpha0, alpha1;
// ops/rng.py:uniform_r2_keys).
extern "C" int tpupt_uniforms_r2(const long long* pid, const unsigned int* keys,
                                 int count, int n, float* out, void* stream) {
  if (count < 1 || count > kMaxCount) return static_cast<int>(cudaErrorInvalidValue);
  R2Keys k;
  for (int g = 0; g < kMaxGroups; ++g) {
    k.rot_b[g] = keys[4 * g];
    k.rot_d[g] = keys[4 * g + 1];
    k.scr_b[g] = keys[4 * g + 2];
    k.scr_d[g] = keys[4 * g + 3];
  }
  k.mixed = keys[4 * kMaxGroups];
  k.frame = keys[4 * kMaxGroups + 1];
  k.alpha0 = keys[4 * kMaxGroups + 2];
  k.alpha1 = keys[4 * kMaxGroups + 3];
  if (n > 0) {
    uniforms_r2_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pid, k, count, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

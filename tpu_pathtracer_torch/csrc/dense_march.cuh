// The dense march shared by tpupt_rowtest_probe (probes.cu), tpupt_sweep_count
// and tpupt_sweep1 (candidate_sweep.cu): every lane of a block tests every
// row of one small table, in the same order (sweep1: up to its first hit).
//
// What bounds it on an H100: the float32 instruction rate.  The first port
// (march_v1.cu, kept as the yardstick) ran one lane a thread and read each row
// with __ldg: every lane issued a row's loads, its address increment, its
// compare and its branch, though all 32 threads of a warp read the same row.
// That put the row-test probe at 45% and the candidate count at 49% of their
// operations bounds on whole wavefronts (PERF.md section 6).  The design:
//
// * Row tiles in shared memory.  The block copies the table in tiles of rows
//   with cp.async (16 bytes a copy, L2 only), double-buffered so that the
//   next tile's copy runs under this tile's tests; a table that fits one tile
//   is copied once.  Every thread then reads the same row as a broadcast.
// * K lanes a thread.  A row is read into registers once and tested against
//   K rays, so the loads and the loop's own instructions are spread over K
//   lane tests.
// * No branch in the tests: the reciprocal is walk_common.cuh's rcp_fast
//   (nvcc's own fast path of 1.0f / x, the same bits), and the rare input off
//   that path is tested again exactly, once for all K lanes.  nvcc's 1.0f / x
//   puts a branch to its slow path, and its reconvergence, in every lane's
//   every row test.
// * Every thread of a block reaches every barrier: lanes past the tile or
//   past n are masked, never returned from.  A table of one tile is staged
//   once a block and synced once; the passes then hold no barrier.
// K is a constant of each kernel: 2 in the probe (probes.cu:kProbeK), 4 in
// the count (candidate_sweep.cu:kCountK), 2 in sweep1 (kSweep1K), the faster
// of 2 and 4 for each at full width (PERF.md section 6, the dense marches).  What bounds them now: the
// instructions a test issues beyond the operations the bound counts (the
// latch's selects, the reciprocal's Newton step and range test, the count's
// selects), which scripts/sass_census.py reads from the built library's SASS.
//
// The launch shape (scripts/dense_march.py:march_shape computes it, and the
// wrappers pass it in): a block covers `tile` lanes with `threads` threads
// in `passes` passes of threads * K lanes; slot j of thread t in pass p is
// lane blockIdx.x * tile + (p * K + j) * threads + t, live when that offset is
// below tile and the lane below n.  The table is staged `tile_rows` rows at a
// time, into one buffer when one tile holds it, else into two.  sweep1
// marches a list of its active lanes instead (scripts/dense_march.py:
// compact_shape, candidate_sweep.cu).
#pragma once

#include <cuda_runtime.h>

namespace tpupt {

constexpr int kMarchMaxThreads = 512;  // scripts/dense_march.py:MAX_THREADS

// Lane `j` of this thread in pass `pass`, or -1 when the slot is masked.
__device__ __forceinline__ int march_lane(int pass, int j, int lanes_per_thread,
                                          int tile, int n) {
  const int off = (pass * lanes_per_thread + j) * static_cast<int>(blockDim.x) +
                  static_cast<int>(threadIdx.x);
  const int lane = static_cast<int>(blockIdx.x) * tile + off;
  return (off < tile && lane < n) ? lane : -1;
}

// One 16-byte asynchronous copy from device to shared memory (cp.async.cg:
// through L2 only, L1 is left to the other blocks' tiles).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + nr) of a table whose rows lie `stride` float4 apart,
// the first kCols float4 of each, to `dst` packed at kCols float4 a row; every
// thread of the block issues its share.  The caller commits the group.
template <int kCols>
__device__ __forceinline__ void stage_rows(float4* dst, const float4* __restrict__ src,
                                           int r0, int nr, int stride) {
  const int total = nr * kCols;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    const int r = q / kCols;
    cp_async16(dst + q, src + static_cast<long long>(r0 + r) * stride + (q - r * kCols));
  }
}

}  // namespace tpupt

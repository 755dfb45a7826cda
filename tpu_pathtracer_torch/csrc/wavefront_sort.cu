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
//                        copy of its own); a pixel plane and an alive plane
//                        may instead be read from the sorted key (key[i] &
//                        0xFFFFFFFF, key bit 62 clear), which equals their
//                        gather when the key was made from them.
//
// What bounds them on an H100: bytes.  The key reads 33 bytes a lane
// (origin, direction, alive, pixel) and writes 8; the gather reads the
// permutation (8 bytes) and every plane's element once and writes it once:
// 70 + 12 S bytes each way a lane at S spectral planes without hero bins.  At
// 2,073,600 lanes and S = 3 the gather's 2 x 106 + 8 bytes a lane are 456 MB,
// 0.136 ms at 3.35 TB/s.
//
// The gather's design.  Its reads follow the permutation: a warp of 32
// consecutive outputs reads some 16-23 distinct 32-byte sectors of each row
// (4 of a float row when coalesced; PERF.md), so a read costs a sector
// unless other lanes take the rest of it while it is in L2.  Every source
// element is read exactly once, so each sector need come from memory once.
// At S = 3 the source rows are 220 MB, four times the 50 MB L2, so the
// gather runs in passes: each takes a group of rows (PASS_BYTES of source,
// at most kPassRows rows of 4 bytes, kPassRows8 of 8 and kPassRows of 1), on
// a grid of (lane tiles, passes) whose blocks start in that order, so the
// card works through one group at a time while its sectors stay in L2.  A
// pass reads its tile's permutation once (coalesced) for all its rows, and a
// thread takes kLanes lanes of the tile (one where a wavefront is too short
// for two blocks an SM; consecutive threads, consecutive lanes), issuing
// every load of a row group before its stores; the writes
// stream past L2 (__stcs).  pixel and alive need no gather: the sorted key
// holds them (the pixel id in its low 32 bits, the dead bit at bit 62), so
// where the caller passes it one pass reads the key in order instead.  The
// measured share of the bound: PERF.md section 6, the table of the
// XLA-fused stages.
#include <cuda_runtime.h>

// One plane of the gather: (rows, n) elements of `elem` bytes at src, the
// same shape at dst (both contiguous).  Outside the anonymous namespace: the
// extern "C" launcher takes it (a type of internal linkage would hide the
// launcher's symbol).
struct Plane {
  const void* src;  // null for a plane read from the sorted key
  void* dst;
  int rows;
  int elem;
  int kind;  // 0: gathered; read from the sorted key: 1 the pixel id, 2 alive
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

// The gather: one row of a plane is a Row.  A pass takes up to kPassRows
// rows of 4 bytes, kPassRows8 of 8 and kPassRows of 1 (each a group: first
// row, count), one after another on the permutation it read once; the pass
// that reads the sorted key (`key` set) takes only the rows read from it.
struct Row {
  const void* src;
  void* dst;
  int kind;  // Plane::kind
};

struct Group {
  int first, count;
};

struct Pass {
  Group g4, g8, g1;
  int key;
};

constexpr int kGatherThreads = 1024;
constexpr int kLanes = 6;      // lanes a thread takes in a pass (1 on a short wavefront)
constexpr int kPassRows = 6;   // the most rows of 4 bytes, and of 1 byte, a pass reads
constexpr int kPassRows8 = 2;  // the most rows of 8 bytes
constexpr int kMaxRows = 96;   // ops/wavefront_sort.py:MAX_ROWS
constexpr int kMaxPasses = 48;  // the table stays within 4 KB of kernel parameters

struct Table {
  Row row[kMaxRows];
  Pass pass[kMaxPasses];
};

// One group's rows at the thread's L lanes: every load, then every store.
template <typename T, int kRows, int L>
__device__ __forceinline__ void gather_group(const Table& tb, const Group& g,
                                             const long long (&j)[L], long long base,
                                             long long n) {
  T v[kRows][L];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < g.count) {
      const T* __restrict__ src = static_cast<const T*>(tb.row[g.first + r].src);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (base + k * kGatherThreads < n) v[r][k] = src[j[k]];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < g.count) {
      T* __restrict__ dst = static_cast<T*>(tb.row[g.first + r].dst);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const long long i = base + k * kGatherThreads;
        if (i < n) __stcs(dst + i, v[r][k]);
      }
    }
  }
}

// pixel = key & 0xFFFFFFFF, alive = key bit 62 clear (tpupt_sort_key's layout)
template <int L>
__device__ __forceinline__ void rows_from_key(const Table& tb, const Group& g,
                                              const long long* __restrict__ key, long long base,
                                              long long n) {
  long long kv[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const long long i = base + k * kGatherThreads;
    kv[k] = i < n ? key[i] : 0;
  }
  for (int r = 0; r < g.count; ++r) {
    const Row& row = tb.row[g.first + r];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const long long i = base + k * kGatherThreads;
      if (i >= n) continue;
      if (row.kind == 1) {
        __stcs(static_cast<long long*>(row.dst) + i, kv[k] & 0xFFFFFFFFLL);
      } else {
        __stcs(static_cast<unsigned char*>(row.dst) + i,
               static_cast<unsigned char>(((kv[k] >> 62) & 1) == 0));
      }
    }
  }
}

// L lanes a thread: kLanes, or 1 where a pass has too few tiles of kLanes to
// fill the card.  The table stays in the parameter space (__grid_constant__:
// indexed in place, never copied per thread).
template <int L>
__global__ void __launch_bounds__(kGatherThreads) gather_planes_kernel(
    const __grid_constant__ Table tb, const long long* __restrict__ perm,
    const long long* __restrict__ key, long long n) {
  const Pass& ps = tb.pass[blockIdx.y];
  const long long base = static_cast<long long>(blockIdx.x) * kGatherThreads * L + threadIdx.x;
  if (ps.key) {
    rows_from_key<L>(tb, ps.g4, key, base, n);
    return;
  }
  long long j[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const long long i = base + k * kGatherThreads;
    j[k] = i < n ? perm[i] : 0;
  }
  if (ps.g4.count) gather_group<unsigned int, kPassRows, L>(tb, ps.g4, j, base, n);
  if (ps.g8.count) gather_group<unsigned long long, kPassRows8, L>(tb, ps.g8, j, base, n);
  if (ps.g1.count) gather_group<unsigned char, kPassRows, L>(tb, ps.g1, j, base, n);
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

namespace {

// A row of a plane before it has its place in the table.
struct PendingRow {
  Row row;
  int elem;
};

}  // namespace

// planes: host array of `count` Plane entries (ops/wavefront_sort.py:_Plane);
// perm: (n,) int64; key: the sorted key (null when no plane has kind 1 or
// 2); pass_bytes: the source bytes one pass may read (it takes at least one
// row; at most kPassRows of 4 bytes, kPassRows8 of 8 and kPassRows of 1).
extern "C" int tpupt_gather_planes(const Plane* planes, int count, const long long* perm,
                                   const long long* key, int n, long long pass_bytes,
                                   void* stream) {
  if (count < 0 || count > kMaxPlanes || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  PendingRow pending[kMaxRows];
  int rows = 0;
  for (int k = 0; k < count; ++k) {
    const Plane& pl = planes[k];
    if (pl.elem != 1 && pl.elem != 4 && pl.elem != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (pl.kind != 0 && (key == nullptr || pl.rows != 1 || pl.kind < 0 || pl.kind > 2 ||
                         pl.elem != (pl.kind == 1 ? 8 : 1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int r = 0; r < pl.rows; ++r) {
      if (rows == kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
      const size_t off = static_cast<size_t>(r) * n * pl.elem;
      pending[rows++] = {{static_cast<const char*>(pl.src) + off,
                          static_cast<char*>(pl.dst) + off, pl.kind},
                         pl.elem};
    }
  }
  // which pass each row joins: the rows of 4 bytes in plane order, as many a
  // pass as pass_bytes holds; then each row of 8 and of 1 byte joins the pass
  // with the fewest source bytes that has room for it, else a new pass; the
  // rows read from the key make one pass of their own
  const long long lane = n > 0 ? n : 1;
  const int order[3] = {4, 8, 1};
  int pass_of[kMaxRows];
  int cnt[kMaxPasses][3] = {};  // a pass's rows of 4, 8 and 1 bytes
  long long bytes[kMaxPasses] = {};
  int passes = 0;
  for (int t = 0; t < 3; ++t) {
    const int elem = order[t];
    const int cap = elem == 8 ? kPassRows8 : kPassRows;
    for (int r = 0; r < rows; ++r) {
      if (pending[r].row.kind != 0 || pending[r].elem != elem) continue;
      const auto fits = [&](int q) {
        return cnt[q][t] < cap && (bytes[q] == 0 || bytes[q] + lane * elem <= pass_bytes);
      };
      int q = -1;
      if (t == 0) {
        if (passes > 0 && fits(passes - 1)) q = passes - 1;
      } else {
        for (int c = 0; c < passes; ++c) {
          if (fits(c) && (q < 0 || bytes[c] < bytes[q])) q = c;
        }
      }
      if (q < 0 && passes == kMaxPasses - 1) {
        // the last pass is the key's: past the budget, the emptiest pass with room
        for (int c = 0; c < passes; ++c) {
          if (cnt[c][t] < cap && (q < 0 || bytes[c] < bytes[q])) q = c;
        }
      }
      if (q < 0) q = passes++;
      pass_of[r] = q;
      ++cnt[q][t];
      bytes[q] += lane * elem;
    }
  }
  int key_pass = -1;
  for (int r = 0; r < rows; ++r) {
    if (pending[r].row.kind == 0) continue;
    if (key_pass < 0) key_pass = passes++;
    pass_of[r] = key_pass;
  }
  // the table: each pass's groups of rows, one after another
  Table tb = {};
  int at = 0;
  for (int q = 0; q < passes; ++q) {
    Pass& ps = tb.pass[q];
    ps.key = q == key_pass;
    Group* groups[3] = {&ps.g4, &ps.g8, &ps.g1};
    for (int t = 0; t < 3; ++t) {
      groups[t]->first = at;
      for (int r = 0; r < rows; ++r) {
        const bool in = pass_of[r] == q &&
                        (ps.key ? t == 0 : pending[r].row.kind == 0 && pending[r].elem == order[t]);
        if (in) {
          tb.row[at++] = pending[r].row;
          ++groups[t]->count;
        }
      }
    }
  }
  if (n == 0 || passes == 0) return static_cast<int>(cudaGetLastError());
  // kLanes lanes a thread where that leaves two blocks an SM or more
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wide_tile = static_cast<long long>(kGatherThreads) * kLanes;
  const long long wide_tiles = (n + wide_tile - 1) / wide_tile;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_tiles * passes >= 2LL * sms) {
    gather_planes_kernel<kLanes><<<dim3(wide_tiles, passes), kGatherThreads, 0, st>>>(
        tb, perm, key, n);
  } else {
    gather_planes_kernel<1><<<dim3((n + kGatherThreads - 1) / kGatherThreads, passes),
                              kGatherThreads, 0, st>>>(tb, perm, key, n);
  }
  return static_cast<int>(cudaGetLastError());
}

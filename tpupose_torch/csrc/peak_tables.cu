// The decode's sorted peak tables: the best K of each row of masked scores.
//
// Replaces no TPU kernel. The JAX package takes these tables from the
// library's lax.top_k (tpupose/decode/peaks.py:354, the overflow branch of
// peak_tables_tiered). The port's plain version, decode/peaks.py
// sorted_tables_plain, sorts an f64 key of every pixel of every row to keep
// K of them; on an HD batch (144 rows of 921,600 scores) that sort was most
// of the device's time. This kernel selects the K best and never sorts a
// row, bit-equal to the plain version:
//
//   * One 64-bit key per score, a total order: the high word is the
//     score's order-preserving bit image (NaN of any bits below -inf, all
//     equal; -0.0 as +0.0, which the f64 compare holds equal), the low
//     word 0xffffffff - index, so that equal scores rank lowest index
//     first. Key 0 is below every real key (a real key's low word is
//     nonzero for an index below 2^30, the most a row holds) and pads
//     short lists.
//   * The tables take the input's own bits at the selected indices (a
//     -0.0 stays -0.0), 0 where not finite, and the coordinates index % w,
//     index / w.
//
// What bounds it on the H100: reading the scores once, R x N x 4 bytes at
// 3.35 TB/s (0.158 ms an HD batch of 8). Design, two launches on the
// caller's stream:
//
//   * Stage 1, a block per (row, chunk), about 8 blocks an SM over all
//     rows (ops/peak_tables.py chunk_count). The block keeps the K best
//     keys seen so far sorted in shared memory and streams its chunk once,
//     coalesced, the next 8 loads of a thread in flight while it filters
//     the last 8. A score passes only if it beats the K-th best (the
//     threshold; within a chunk a 32-bit compare of the images decides);
//     passing keys are appended to a buffer behind the K best. When the
//     buffer could not take another tile, and at the end, a bitonic sort
//     of the K best and the buffer keeps the K best. Masked scores are
//     almost all -inf: once the first K scores of a chunk are in, a -inf
//     can no longer pass (its index is higher), so nearly nothing but the
//     chunk's peaks reaches the buffer. The chunk's K best go to a scratch
//     list.
//   * Stage 2, a block per row, runs the same selection over its chunks'
//     lists (a few thousand keys) and writes xs, ys, scores and valid.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

typedef unsigned long long Key;

constexpr int kThreads = 256;
constexpr int kPer = 8;                     // loads a thread keeps in flight
constexpr int kTile = kThreads * kPer;      // keys filtered between two barriers
constexpr int kSort = 4096;                 // keys the shared-memory sort holds
constexpr int kMaxK = 256;                  // ops/peak_tables.py MAX_K
static_assert(kMaxK + kTile <= kSort, "the buffer must take a whole tile behind the K best");
static_assert(kMaxK <= kThreads, "the first K keys are loaded one a thread");

// The high word of a score's key: its bits' order-preserving image.
__device__ __forceinline__ unsigned score_image(float v) {
  unsigned b = __float_as_uint(v);
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0u;   // NaN, any bits: last
  if (b == 0x80000000u) b = 0u;                     // -0.0 ranks as +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ Key score_key(float v, unsigned idx) {
  return (static_cast<Key>(score_image(v)) << 32) | static_cast<Key>(0xffffffffu - idx);
}

// Sorts a[0, n) in descending order; n a power of two. Every thread of the
// block calls it; it ends on a barrier where n > 1.
__device__ void bitonic_desc(Key* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const Key x = a[lo], y = a[hi];
        if ((lo & size) == 0 ? x < y : x > y) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// a[0, k) holds the K best keys so far (descending, 0 where fewer), a[k,
// k + *count) the keys appended since. Leaves the K best of both in a[0,
// k), empties the buffer and returns the K-th best, the new threshold.
// Called by every thread, after a barrier that follows the last append.
__device__ Key merge(Key* a, int k, int* count) {
  const int m = k + *count;
  int n = 1;
  while (n < m) n <<= 1;
  for (int i = m + threadIdx.x; i < n; i += kThreads) a[i] = 0;
  __syncthreads();                              // every thread has read *count
  if (threadIdx.x == 0) *count = 0;
  bitonic_desc(a, n);                           // m > k >= 1, so n > 1: ends on a barrier
  return a[k - 1];
}

// Loads the tile of the source's elements from base on, a thread's every
// kThreads-th; past len - 1 the last element again, so that no load waits
// on a branch.
template <typename Source>
__device__ __forceinline__ void fetch(const Source& src, typename Source::Raw* raw, int base,
                                      int len) {
  if (base + kTile <= len) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) raw[j] = src.load(base + j * kThreads + threadIdx.x);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      raw[j] = src.load(min(base + j * kThreads + static_cast<int>(threadIdx.x), len - 1));
    }
  }
}

// The K best keys of the source's elements 0 .. len - 1, left in a[0, k)
// in descending order (0 where len < k). Every thread of the block calls
// it. The next tile's loads are issued before this one is filtered, so
// that they stay in flight across its barrier.
template <typename Source>
__device__ void select_best(const Source& src, int len, int k, Key* a, int* count) {
  int kp = 1;
  while (kp < k) kp <<= 1;
  if (threadIdx.x < kp) {
    a[threadIdx.x] = threadIdx.x < k && threadIdx.x < len
        ? src.key(src.load(threadIdx.x), threadIdx.x) : 0;
  }
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  bitonic_desc(a, kp);
  Key thr = a[k - 1];
  // the buffer is full once it could not take another tile
  const int limit = kSort - k - kTile;
  typename Source::Raw next[kPer];
  if (len > k) fetch(src, next, k, len);
  for (int base = k; base < len; base += kTile) {
    typename Source::Raw raw[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) raw[j] = next[j];
    if (base + kTile < len) fetch(src, next, base + kTile, len);
    bool full = false;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = base + j * kThreads + threadIdx.x;
      if (e < len && src.beats(raw[j], thr)) {
        const int p = atomicAdd(count, 1);
        a[k + p] = src.key(raw[j], e);
        full |= p >= limit;
      }
    }
    if (__syncthreads_or(full)) thr = merge(a, k, count);
  }
  __syncthreads();
  if (*count > 0) merge(a, k, count);
}

// A chunk of a row's scores. Its indices rise, and the threshold is the
// key of an earlier one (the first K are in before the stream starts), so
// a score that only ties the threshold's image ranks below it: the filter
// compares the 32-bit images alone.
struct Scores {
  typedef float Raw;
  const float* row;     // the chunk's first score
  unsigned first;       // its index in the row
  __device__ float load(int e) const { return __ldcs(row + e); }
  __device__ bool beats(float v, Key thr) const {
    return score_image(v) > static_cast<unsigned>(thr >> 32);
  }
  __device__ Key key(float v, int e) const { return score_key(v, first + e); }
};

// A row's chunk lists, keys already.
struct Lists {
  typedef Key Raw;
  const Key* keys;
  __device__ Key load(int e) const { return keys[e]; }
  __device__ bool beats(Key v, Key thr) const { return v > thr; }
  __device__ Key key(Key v, int) const { return v; }
};

__global__ void __launch_bounds__(kThreads) chunk_kernel(const float* __restrict__ flat,
                                                         long long n, int chunks,
                                                         long long chunk_len, int k,
                                                         Key* __restrict__ lists) {
  __shared__ Key a[kSort];
  __shared__ int count;
  const long long row = blockIdx.x / chunks;
  const long long first = (blockIdx.x % chunks) * chunk_len;
  const int len = first < n ? static_cast<int>(min(chunk_len, n - first)) : 0;
  select_best(Scores{flat + row * n + first, static_cast<unsigned>(first)}, len, k, a, &count);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    lists[static_cast<long long>(blockIdx.x) * k + j] = a[j];
  }
}

__global__ void __launch_bounds__(kThreads) row_kernel(const float* __restrict__ flat, long long n,
                                                       int w, int chunks, int k, int k_out,
                                                       const Key* __restrict__ lists,
                                                       int* __restrict__ xs, int* __restrict__ ys,
                                                       float* __restrict__ scores,
                                                       unsigned char* __restrict__ valid) {
  __shared__ Key a[kSort];
  __shared__ int count;
  const long long row = blockIdx.x;
  select_best(Lists{lists + row * chunks * k}, chunks * k, k, a, &count);
  for (int j = threadIdx.x; j < k_out; j += kThreads) {
    const unsigned idx = 0xffffffffu - static_cast<unsigned>(a[j]);
    const float v = flat[row * n + idx];
    const bool ok = (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
    const long long o = row * k_out + j;
    xs[o] = static_cast<int>(idx % static_cast<unsigned>(w));
    ys[o] = static_cast<int>(idx / static_cast<unsigned>(w));
    scores[o] = ok ? v : 0.f;
    valid[o] = ok;
  }
}

}  // namespace

// flat (rows, n) f32 masked scores; lists rows * chunks * k 64-bit keys of
// scratch; xs, ys int32, scores f32 and valid bool, each (rows, min(n, k)).
extern "C" int tp_peak_tables(const void* flat, int rows, long long n, int w, int k, int chunks,
                              void* lists, void* xs, void* ys, void* scores, void* valid,
                              void* stream) {
  if (rows < 1 || n < 1 || n > (1LL << 30) || w < 1 || k < 1 || k > kMaxK || chunks < 1 ||
      static_cast<long long>(rows) * chunks > 2147483647LL ||
      static_cast<long long>(chunks) * k > (1LL << 30)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunk_len = (n + chunks - 1) / chunks;
  chunk_kernel<<<rows * chunks, kThreads, 0, st>>>(static_cast<const float*>(flat), n, chunks,
                                                   chunk_len, k, static_cast<Key*>(lists));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int k_out = n < k ? static_cast<int>(n) : k;
  row_kernel<<<rows, kThreads, 0, st>>>(static_cast<const float*>(flat), n, w, chunks, k, k_out,
                                        static_cast<const Key*>(lists), static_cast<int*>(xs),
                                        static_cast<int*>(ys), static_cast<float*>(scores),
                                        static_cast<unsigned char*>(valid));
  return cudaGetLastError();
}

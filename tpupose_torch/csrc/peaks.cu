// Peak scores of a materialised heatmap: sigma-blur + 4-neighbour NMS +
// threshold, for every part channel of every image of a batch.
//
// Replaces tpupose/ops/pallas_peaks.py::peak_scores_pallas (_peaks_kernel).
// Per channel map x (H, W):
//
//   xp     = x extended on both axes with the edge sample repeated
//            (d c b a | a b c d | d c b a; scipy 'reflect'), by index
//            arithmetic: no padded copy exists in device memory;
//   hb     = sum_k taps[k] * xp[:, j + k]        horizontal pass
//   smooth = sum_k taps[k] * hb[i + k, :]        vertical pass
//   peak   = smooth >= its 4 neighbours (0 outside the map) and
//            smooth > thre1
//   out    = x at peaks, -inf elsewhere.
//
// Both passes accumulate in tap order 0..2r with a separately rounded
// multiply and add per tap (__fmul_rn, __fadd_rn): nvcc contracts nothing
// into an FMA, so the blurred field, and with it every >= of the NMS, is
// bit-equal to the plain PyTorch version's separate multiply and add.
//
// What bounds it on the H100: bytes by the count (a batch of 8 at 368x368
// reads the 78 MB of its 18 scored channels and writes 78 MB: 0.047 ms);
// the instructions come close behind, because neither pass may fuse or
// fold a tap: two per tap and pass, about 100 per output pixel, 0.06 ms
// for 19.5 M outputs on 132 SMs.
//
// Design: one block of 18 warps per (image, strip of 62 output columns,
// band of at most 46 output rows); warp c owns channel c, and each lane
// two adjacent columns of the 64 the strip computes (the 62 and one NMS
// halo column each side). The block streams the band's input rows (plus
// the blur and NMS halo) through a ring of 16 rows in shared memory,
// 8 rows per barrier: each row's pixels are contiguous in NHWC, so
// consecutive threads copy consecutive words (cp.async, 4 bytes each,
// borders folded into the source address) and the copy transposes them
// into channel-major planes. Per input row a lane loads the 2r + 2 values
// its two horizontal outputs need (float2 loads) and keeps the last 2r+1
// horizontal results of each column in registers: the vertical pass reads
// no shared memory. The row loop takes 4 rows a step, then slides that
// window by 4 (2r moves a column). The last three blurred rows stay in
// registers too; the NMS takes the columns beside from the neighbouring
// lane (shuffles). The kernel is compiled for each radius up to 16 (sigma
// below 4.125), the default sigma 3 being radius 12.
//
// Wider blurs (radius 17 and up) take a generic kernel with the same
// arithmetic and the same NMS: its radius is a run-time value, so the
// last 2r + 1 horizontal results of a lane's two columns cannot stay in
// registers; they live in a ring of 2r + 1 float2 slots per thread in
// shared memory, each thread's own (no barrier guards them). The block
// has 6 channel warps, so that the ring of input rows and the rings of
// horizontal results fit 227 KB up to radius 50 (sigma 12.4); a wider
// blur raises in the wrapper.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

constexpr int kMaxTaps = 128;   // the generic path's radius 50 needs 101

// Passed by value to the kernel; mirrored by a ctypes.Structure in
// ops/peaks.py.
struct PeaksParams {
  int batch, h, w;
  int cstride;        // channels of the input (>= parts)
  int parts;          // channels 0..parts-1 are scored
  int radius;         // taps = 2 * radius + 1
  float thre1;
  float taps[kMaxTaps];
  const float* maps;  // (B, H, W, cstride), contiguous
  float* out;         // (B, parts, H * W)
};

namespace {

constexpr int kMaxRadius = 16;
constexpr int kWarps = 18;               // channels per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;                // computed columns: 62 outputs + NMS halo
constexpr int kStrip = kCols - 2;
constexpr int kBandRows = 46;            // output rows per block, at most
constexpr int kChunk = 8;                // input rows staged per barrier
constexpr int kUnroll = 4;               // rows per step of the row loop (divides kChunk)
constexpr int kRing = 2 * kChunk;
constexpr size_t kSmemLimit = 227 * 1024;

// floats per staged channel row: the strip and its blur halo, rounded up to
// 2 mod 32, so that the 18 planes of one column fall into distinct bank pairs
__host__ __device__ constexpr int row_pitch(int radius) {
  return (kCols + 2 * radius - 2 + 31) / 32 * 32 + 2;
}

__host__ __device__ constexpr size_t smem_bytes(int radius) {
  return sizeof(float) * kRing * kWarps * row_pitch(radius);
}

constexpr int kGenWarps = 6;   // channels per block of the generic path
constexpr int kGenThreads = 32 * kGenWarps;

// the generic path: the ring of input rows of 6 channels, each thread's
// 2r + 1 horizontal results (float2) and the taps
__host__ __device__ constexpr size_t generic_smem_bytes(int radius) {
  return sizeof(float) * (static_cast<size_t>(kRing) * kGenWarps * row_pitch(radius) +
                          static_cast<size_t>(2 * radius + 1) * (2 * kGenThreads + 1));
}

// index of the symmetric (edge-repeating) extension of an axis of length n
__device__ __forceinline__ int fold(int j, int n) {
  const int period = 2 * n;
  int m = j % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// input rows j0 .. j0 + kChunk - 1 (of n_in) into their slots of the ring: the
// same (column, channel) slots of every row
template <int kSlots, int kPitch>
__device__ __forceinline__ void stage_rows(float* s_in, const float* img, const PeaksParams& p,
                                           int first_row, int j0, int n_in,
                                           const int (&src_off)[kSlots],
                                           const int (&dst_off)[kSlots]) {
  for (int j = j0; j < min(j0 + kChunk, n_in); ++j) {
    const float* row = img + static_cast<size_t>(fold(first_row + j, p.h)) * p.w * p.cstride;
    float* dst = s_in + (j % kRing) * kWarps * kPitch;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (src_off[k] >= 0) cp_async4(dst + dst_off[k], row + src_off[k]);
  }
  cp_async_commit();
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) peaks_kernel(const __grid_constant__ PeaksParams p) {
  constexpr int T = 2 * R + 1;
  constexpr int kIn = kCols + 2 * R;   // staged columns
  constexpr int kPitch = row_pitch(R);
  constexpr int kSlots = (kWarps * kIn + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float s_in[];   // [ring row][channel][kPitch]

  const int tid = threadIdx.x, lane = tid & 31, c = tid >> 5;
  const int n_strips = (p.w + kStrip - 1) / kStrip;
  const int c0 = blockIdx.x / n_strips * kWarps, nc = min(kWarps, p.parts - c0);
  const int x0 = blockIdx.x % n_strips * kStrip;
  const int band = (p.h + gridDim.y - 1) / gridDim.y;
  const int y0 = blockIdx.y * band, rows = min(band, p.h - y0);
  const int b = blockIdx.z;
  if (rows <= 0) return;   // the whole block: no barrier is pending
  const int n_in = rows + 2 + 2 * R;   // blurred rows y0-1 .. y0+rows, with the blur halo

  // each thread copies the same (column, channel) slots of every staged row
  const float* img = p.maps + static_cast<size_t>(b) * p.h * p.w * p.cstride;
  int src_off[kSlots], dst_off[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int i = tid + k * kThreads, col = i / nc;
    src_off[k] = -1;
    if (col < kIn) {
      src_off[k] = fold(x0 - 1 - R + col, p.w) * p.cstride + c0 + i % nc;
      dst_off[k] = i % nc * kPitch + col;
    }
  }
  const int cc = 2 * lane;                 // computed columns cc, cc + 1
  const int xa = x0 - 1 + cc, xb = xa + 1;
  const bool in_a = xa >= 0 && xa < p.w, in_b = xb < p.w;
  const bool out_a = cc >= 1 && xa < p.w, out_b = cc + 1 <= kStrip && xb < p.w;
  const bool scored = c < nc;
  float* out = p.out + (static_cast<size_t>(b) * p.parts + c0 + c) * p.h * p.w;
  const float* x_at = img + c0 + c;
  // horizontal results of rows j - T + 1 .. j + kUnroll - 1 per column: a
  // group of kUnroll rows writes the last kUnroll, then the window slides
  float wa[T + kUnroll - 1], wb[T + kUnroll - 1];
  float a2 = 0.f, a1 = 0.f, b2 = 0.f, b1 = 0.f;   // blurred rows q-2, q-1

  stage_rows<kSlots, kPitch>(s_in, img, p, y0 - 1 - R, 0, n_in, src_off, dst_off);
  for (int jj = 0; jj < n_in; jj += kUnroll) {
    if (jj % kChunk == 0) {
      cp_async_wait_all();
      __syncthreads();
      if (jj + kChunk < n_in)
        stage_rows<kSlots, kPitch>(s_in, img, p, y0 - 1 - R, jj + kChunk, n_in, src_off, dst_off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = jj + u;
      if (j < n_in) {
        // horizontal pass of input row j at the two columns
        const float2* src =
            reinterpret_cast<const float2*>(s_in + ((j % kRing) * kWarps + c) * kPitch + cc);
        float v[2 * R + 2];
#pragma unroll
        for (int k = 0; k <= R; ++k) {
          const float2 t = src[k];
          v[2 * k] = t.x;
          v[2 * k + 1] = t.y;
        }
        float ha = __fmul_rn(p.taps[0], v[0]), hb = __fmul_rn(p.taps[0], v[1]);
#pragma unroll
        for (int k = 1; k < T; ++k) {
          ha = __fadd_rn(ha, __fmul_rn(p.taps[k], v[k]));
          hb = __fadd_rn(hb, __fmul_rn(p.taps[k], v[k + 1]));
        }
        wa[T - 1 + u] = ha;
        wb[T - 1 + u] = hb;
        if (j >= 2 * R) {
          // vertical pass: blurred row q = j - 2R from horizontal rows q .. j
          float ma = __fmul_rn(p.taps[0], wa[u]), mb = __fmul_rn(p.taps[0], wb[u]);
#pragma unroll
          for (int k = 1; k < T; ++k) {
            ma = __fadd_rn(ma, __fmul_rn(p.taps[k], wa[u + k]));
            mb = __fadd_rn(mb, __fmul_rn(p.taps[k], wb[u + k]));
          }
          const int q = j - 2 * R, y = y0 - 1 + q;
          const bool row_in = y >= 0 && y < p.h;   // the NMS reads zero outside
          if (!row_in || !in_a) ma = 0.f;
          if (!row_in || !in_b) mb = 0.f;
          if (q >= 2) {
            // NMS of row y - 1: the column left of a and right of b from the
            // neighbouring lanes
            const float left = __shfl_up_sync(0xffffffffu, b1, 1);
            const float right = __shfl_down_sync(0xffffffffu, a1, 1);
            if (scored) {
              const size_t at = static_cast<size_t>(y - 1) * p.w;
              const bool pa = a1 >= a2 && a1 >= ma && a1 >= left && a1 >= b1 && a1 > p.thre1;
              const bool pb = b1 >= b2 && b1 >= mb && b1 >= a1 && b1 >= right && b1 > p.thre1;
              if (out_a) out[at + xa] = pa ? __ldg(x_at + (at + xa) * p.cstride) : -INFINITY;
              if (out_b) out[at + xb] = pb ? __ldg(x_at + (at + xb) * p.cstride) : -INFINITY;
            }
          }
          a2 = a1;
          a1 = ma;
          b2 = b1;
          b1 = mb;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < T - 1; ++k) {
      wa[k] = wa[k + kUnroll];
      wb[k] = wb[k + kUnroll];
    }
  }
}

// input rows j0 .. j0 + kChunk - 1 into the generic path's ring: the
// strip's kCols + 2r columns of channels c0 .. c0 + nc - 1, borders folded
__device__ __forceinline__ void stage_rows_generic(float* s_in, const float* img,
                                                   const PeaksParams& p, int first_row, int j0,
                                                   int n_in, int x0, int c0, int nc, int pitch) {
  const int n_cols = kCols + 2 * p.radius;
  for (int j = j0; j < min(j0 + kChunk, n_in); ++j) {
    const float* row = img + static_cast<size_t>(fold(first_row + j, p.h)) * p.w * p.cstride;
    float* dst = s_in + (j % kRing) * kGenWarps * pitch;
    for (int i = threadIdx.x; i < n_cols * nc; i += kGenThreads) {
      const int col = i / nc, ch = i % nc;
      cp_async4(dst + ch * pitch + col,
                row + fold(x0 - 1 - p.radius + col, p.w) * p.cstride + c0 + ch);
    }
  }
  cp_async_commit();
}

// peaks_kernel<R> with the radius read at run time (see the note at the top)
__global__ void __launch_bounds__(kGenThreads)
peaks_generic_kernel(const __grid_constant__ PeaksParams p) {
  const int R = p.radius, T = 2 * R + 1, pitch = row_pitch(R);
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                                        // [ring row][channel][pitch]
  float2* s_h = reinterpret_cast<float2*>(s_in + kRing * kGenWarps * pitch);  // [T][thread]
  float* s_taps = reinterpret_cast<float*>(s_h + T * kGenThreads);

  const int tid = threadIdx.x, lane = tid & 31, c = tid >> 5;
  const int n_strips = (p.w + kStrip - 1) / kStrip;
  const int c0 = blockIdx.x / n_strips * kGenWarps, nc = min(kGenWarps, p.parts - c0);
  const int x0 = blockIdx.x % n_strips * kStrip;
  const int band = (p.h + gridDim.y - 1) / gridDim.y;
  const int y0 = blockIdx.y * band, rows = min(band, p.h - y0);
  const int b = blockIdx.z;
  if (rows <= 0) return;   // the whole block: no barrier is pending
  const int n_in = rows + 2 + 2 * R;
  for (int k = tid; k < T; k += kGenThreads) s_taps[k] = p.taps[k];

  const float* img = p.maps + static_cast<size_t>(b) * p.h * p.w * p.cstride;
  const int cc = 2 * lane;
  const int xa = x0 - 1 + cc, xb = xa + 1;
  const bool in_a = xa >= 0 && xa < p.w, in_b = xb < p.w;
  const bool out_a = cc >= 1 && xa < p.w, out_b = cc + 1 <= kStrip && xb < p.w;
  const bool scored = c < nc;
  float* out = p.out + (static_cast<size_t>(b) * p.parts + c0 + c) * p.h * p.w;
  const float* x_at = img + c0 + c;
  float2* ring = s_h + tid;
  float a2 = 0.f, a1 = 0.f, b2 = 0.f, b1 = 0.f;   // blurred rows q-2, q-1
  int slot = 0;                                   // j % T: row j's slot in the ring

  stage_rows_generic(s_in, img, p, y0 - 1 - R, 0, n_in, x0, c0, nc, pitch);
  for (int j = 0; j < n_in; ++j, slot = slot + 1 == T ? 0 : slot + 1) {
    if (j % kChunk == 0) {
      cp_async_wait_all();
      __syncthreads();
      if (j + kChunk < n_in)
        stage_rows_generic(s_in, img, p, y0 - 1 - R, j + kChunk, n_in, x0, c0, nc, pitch);
    }
    // horizontal pass of input row j at the two columns
    const float* src = s_in + ((j % kRing) * kGenWarps + c) * pitch + cc;
    float ha = __fmul_rn(s_taps[0], src[0]), hb = __fmul_rn(s_taps[0], src[1]);
    for (int k = 1; k < T; ++k) {
      const float t = s_taps[k];
      ha = __fadd_rn(ha, __fmul_rn(t, src[k]));
      hb = __fadd_rn(hb, __fmul_rn(t, src[k + 1]));
    }
    ring[slot * kGenThreads] = make_float2(ha, hb);
    if (j >= 2 * R) {
      // vertical pass: blurred row q = j - 2R from horizontal rows q .. j,
      // whose slots run on from row j's, the oldest first
      const int q = j - 2 * R;
      int at = slot + 1 == T ? 0 : slot + 1;
      float2 h = ring[at * kGenThreads];
      float ma = __fmul_rn(s_taps[0], h.x), mb = __fmul_rn(s_taps[0], h.y);
      for (int k = 1; k < T; ++k) {
        at = at + 1 == T ? 0 : at + 1;
        h = ring[at * kGenThreads];
        ma = __fadd_rn(ma, __fmul_rn(s_taps[k], h.x));
        mb = __fadd_rn(mb, __fmul_rn(s_taps[k], h.y));
      }
      const int y = y0 - 1 + q;
      const bool row_in = y >= 0 && y < p.h;   // the NMS reads zero outside
      if (!row_in || !in_a) ma = 0.f;
      if (!row_in || !in_b) mb = 0.f;
      if (q >= 2) {
        const float left = __shfl_up_sync(0xffffffffu, b1, 1);
        const float right = __shfl_down_sync(0xffffffffu, a1, 1);
        if (scored) {
          const size_t at = static_cast<size_t>(y - 1) * p.w;
          const bool pa = a1 >= a2 && a1 >= ma && a1 >= left && a1 >= b1 && a1 > p.thre1;
          const bool pb = b1 >= b2 && b1 >= mb && b1 >= a1 && b1 >= right && b1 > p.thre1;
          if (out_a) out[at + xa] = pa ? __ldg(x_at + (at + xa) * p.cstride) : -INFINITY;
          if (out_b) out[at + xb] = pb ? __ldg(x_at + (at + xb) * p.cstride) : -INFINITY;
        }
      }
      a2 = a1;
      a1 = ma;
      b2 = b1;
      b1 = mb;
    }
  }
}

template <int R>
cudaError_t launch(const PeaksParams& p, dim3 grid, cudaStream_t stream) {
  if (p.radius != R) {
    if constexpr (R > 0) return launch<R - 1>(p, grid, stream);
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(R);
  static_assert(smem_bytes(R) <= kSmemLimit, "the ring exceeds a block's shared memory");
  cudaError_t err = tp_allow_smem(peaks_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  peaks_kernel<R><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) the kernel asks for at a radius: the templated
// kernel's up to radius 16, the generic one's beyond; ops/peaks.py's
// smem_bytes computes the same.
extern "C" int tp_peaks_smem(int radius) {
  return static_cast<int>(radius <= kMaxRadius ? smem_bytes(radius) : generic_smem_bytes(radius));
}

extern "C" int tp_peaks(const PeaksParams* p, void* stream) {
  const bool generic = p->radius > kMaxRadius;
  if (p->batch < 1 || p->h < 1 || p->w < 1 || p->parts < 1 || p->cstride < p->parts ||
      p->radius < 0 || 2 * p->radius + 1 > kMaxTaps ||
      (generic && generic_smem_bytes(p->radius) > kSmemLimit)) {
    return cudaErrorInvalidValue;
  }
  const int warps = generic ? kGenWarps : kWarps;
  const long long strips = (p->w + kStrip - 1) / kStrip, groups = (p->parts + warps - 1) / warps;
  const long long bands = (p->h + kBandRows - 1) / kBandRows;
  if (bands > 65535 || p->batch > 65535 || strips * groups > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(strips * groups), static_cast<unsigned>(bands), p->batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!generic) return launch<kMaxRadius>(*p, grid, st);
  const size_t smem = generic_smem_bytes(p->radius);
  cudaError_t err = tp_allow_smem(peaks_generic_kernel, smem);
  if (err != cudaSuccess) return err;
  peaks_generic_kernel<<<grid, kGenThreads, smem, st>>>(*p);
  return cudaGetLastError();
}

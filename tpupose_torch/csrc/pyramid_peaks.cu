// Scale-space peak scores: per-scale low-res heatmaps -> masked
// full-res peak-score maps, one pass, on banded operators.
//
// Replaces tpupose/ops/pallas_pyramid_peaks.py::pyramid_peak_scores_pallas
// (_kernel). For every image b and part channel c:
//
//   avg    = sum_s  Wy_s  M_s WxT_s / n      (the scale-averaged chained
//   smooth = sum_s  Ay_s  M_s BxT_s / n       bilinear upsample, and the
//                                             same with the sigma=3
//                                             reflect blur folded in)
//
// then 4-neighbour NMS (zero outside the image) and smooth > thre1; the
// output is avg at peaks and -inf elsewhere, (B, C, H*W) f32.
//
// The operators are banded: each row of Ay_s and Wy_s, and each column of
// BxT_s and WxT_s, is one run of non-zero entries (4/5/7/8 wide for the
// blurred operators of the 4-scale 368x368 pyramid, 2 for the plain
// chain). The wrapper cuts each into a band table on the host once per
// geometry: per output row (column) the first low-res row (column) and
// the run's coefficients, padded with exact zeros to the operator's
// widest run. Every sum runs over its band in increasing index order, with
// the multiply-adds of the dense formulation (fmaf, then acc += part *
// inv_n per scale in scale order): an FMA with an exact-zero coefficient
// leaves a finite sum unchanged, so the result equals the dense chain's
// bit for bit. Maps that hold inf or NaN are the exception: the dense
// chain spreads NaN through 0 * inf, the banded one only within a band.
//
// What bounds it on the H100: bytes by the count (the low-res maps in,
// one f32 per output pixel out: 78 MB for a batch of 8 at 368x368, about
// 0.026 ms), against 24 multiply-adds per output pixel in the right
// product at that geometry (0.016 ms at the f32 rate). The products stay
// f32 (the reference runs them at HIGHEST precision and the NMS >= flips
// on one ulp), so the tensor cores are not used.
//
// Design: one block per (group of 3 channels, band of 14 output rows,
// tile of 382 columns, image). It forms the left products Ay_s M_s of
// its 16 blurred rows (the band plus one NMS halo row each side) for its
// channels and the low-res columns its tile reaches, in shared memory:
// a thread owns one (low-res column, channel) and accumulates all 16
// rows, reading each map value once (straight from the caller's tensor,
// through its strides) and the row coefficients four at a time. Then a
// thread owns one output column: per scale and tap it loads the column's
// coefficient once and the 16 left-product rows as four float4 loads,
// so each shared-memory load feeds four FMAs. The 16 blurred values stay
// in the thread's registers; the NMS takes the rows above and below from
// them, the columns beside from the neighbouring lanes (shuffles) and,
// at a warp's edge, from a column the neighbouring warp left in shared
// memory. The averaged map is evaluated only at peaks: the same threads
// form the plain chain's left products Wy_s M_s beside the blurred ones
// (their bands lie within), and a peak sums them over its column's 2- or
// 3-tap band of WxT_s. The NMS lists a channel's peaks (up to 1024 a
// block; beyond that a peak is averaged where it is found) and the whole
// block averages them after a barrier, so that one peak does not hold its
// warp (PERF.md has the times of the three ways).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

constexpr int kMaxScales = 8;

// Passed by value to the kernel; mirrored by a ctypes.Structure in
// ops/pyramid_peaks.py. Strides are in elements. A band table of an
// operator with n outputs is ``start`` (n,) int32, the first low-res
// index of each output's run, and ``coef`` (width, n) f32.
struct PyramidParams {
  int n_scales, batch, parts, out_h, out_w;
  int n_groups, n_bands, n_tiles;
  long long sb[kMaxScales], sh[kMaxScales], sw[kMaxScales], sc[kMaxScales];
  const float* maps[kMaxScales];    // (B, Hl, Wl, >= parts) f32, any strides
  const int* ay_start[kMaxScales];  // blurred rows (H)
  const float* ay_coef[kMaxScales];
  const int* bx_start[kMaxScales];  // blurred columns (W)
  const float* bx_coef[kMaxScales];
  const int* wy_start[kMaxScales];  // plain chain, rows (H)
  const float* wy_coef[kMaxScales];
  const int* wx_start[kMaxScales];  // plain chain, columns (W)
  const float* wx_coef[kMaxScales];
  int ay_w[kMaxScales], bx_w[kMaxScales], wy_w[kMaxScales], wx_w[kMaxScales];
  int hcap[kMaxScales];  // low-res rows a band of rows reaches, at most
  int wcap[kMaxScales];  // low-res columns a tile of columns reaches, at most
  float inv_n, thre1;
  float* out;            // (B, parts, H*W)
};

namespace {

constexpr int kRows = 16;               // blurred rows a thread holds
constexpr int kOutRows = kRows - 2;     // output rows per block
constexpr int kThreads = 384;           // one per column of the tile + halo
constexpr int kColTile = kThreads - 2;  // output columns per block
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 3;               // channels per block
constexpr int kLPitch = kRows + 4;      // floats per (channel, low-res column)
constexpr int kPeakList = 1024;         // peaks of a channel averaged after its NMS

__host__ __device__ inline size_t smem_floats(const PyramidParams& p) {
  size_t hsum = 0, wsum = 0;
  for (int s = 0; s < p.n_scales; ++s) {
    hsum += p.hcap[s];
    wsum += p.wcap[s];
  }
  return 2 * kRows * hsum + static_cast<size_t>(kGroup) * wsum * (kLPitch + kRows) +
         static_cast<size_t>(kGroup) * kWarps * 2 * kRows + kPeakList + kGroup;
}

// the averaged map at block row r, column x: per scale the rows Wy_s M_s
// of the block (s_v), summed over the column's band of WxT_s
__device__ float average_at(const PyramidParams& p, const float* s_v, int r, int x, int xa) {
  float avg = 0.f;
  for (int s = 0; s < p.n_scales; ++s) {
    const float* v = s_v + (p.wx_start[s][x] - p.bx_start[s][xa]) * kRows + r;
    float part = 0.f;
    for (int j = 0; j < p.wx_w[s]; ++j) part = fmaf(v[j * kRows], p.wx_coef[s][j * p.out_w + x], part);
    avg += part * p.inv_n;
    s_v += p.wcap[s] * kRows;
  }
  return avg;
}

// __grid_constant__: the parameters are indexed by scale at run time and
// read in place, never copied to local memory
__global__ void __launch_bounds__(kThreads, 2)
pyramid_peaks_kernel(const __grid_constant__ PyramidParams p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z / p.n_tiles, tile = blockIdx.z % p.n_tiles;
  const int c0 = blockIdx.x * kGroup, nc = min(kGroup, p.parts - c0);
  const int y0 = blockIdx.y * kOutRows, x0 = tile * kColTile;
  const int H = p.out_h, W = p.out_w, tid = threadIdx.x;
  // the block's blurred rows y0-1 .. y0+kRows-2 and columns x0-1 .. x0+kThreads-2,
  // clipped to the image: the first and last of each select the low-res range
  const int ya = max(y0 - 1, 0), yb = min(y0 + kRows - 2, H - 1);
  const int xa = max(x0 - 1, 0), xb = min(x0 + kThreads - 2, W - 1);

  int hsum = 0, wsum = 0;
  for (int s = 0; s < p.n_scales; ++s) {
    hsum += p.hcap[s];
    wsum += p.wcap[s];
  }
  float* s_a = smem;                                // Ay_s per scale [low-res row][kRows]
  float* s_wy = s_a + kRows * hsum;                 // Wy_s, the same rows
  float* s_l = s_wy + kRows * hsum;                 // Ay_s M_s [channel][low-res col][kLPitch]
  float* s_v = s_l + kGroup * wsum * kLPitch;       // Wy_s M_s [channel][low-res col][kRows]
  float* s_edge = s_v + kGroup * wsum * kRows;      // [channel][warp][2][kRows]
  int* s_list = reinterpret_cast<int*>(s_edge + kGroup * kWarps * 2 * kRows);  // row, column
  int* s_count = s_list + kPeakList;                // peaks of each channel
  if (tid < kGroup) s_count[tid] = 0;

  // --- row coefficients of the block's rows over the low-res rows they reach
  // (the plain chain's bands lie within the blurred ones: the wrapper checks)
  for (int s = 0, aoff = 0; s < p.n_scales; aoff += p.hcap[s] * kRows, ++s) {
    const int h0 = p.ay_start[s][ya];
    const int nh = p.ay_start[s][yb] + p.ay_w[s] - h0;
    for (int i = tid; i < nh * kRows; i += kThreads) {
      const int h = h0 + i / kRows, y = y0 - 1 + i % kRows;
      float a = 0.f, v = 0.f;
      if (y >= 0 && y < H) {
        const int k = h - p.ay_start[s][y], kv = h - p.wy_start[s][y];
        if (k >= 0 && k < p.ay_w[s]) a = p.ay_coef[s][k * H + y];
        if (kv >= 0 && kv < p.wy_w[s]) v = p.wy_coef[s][kv * H + y];
      }
      s_a[aoff + i] = a;
      s_wy[aoff + i] = v;
    }
  }
  __syncthreads();

  // --- left products Ay_s M_s: one (low-res column, channel) per thread ----
  for (int s = 0, aoff = 0, loff = 0; s < p.n_scales;
       aoff += p.hcap[s] * kRows, loff += p.wcap[s], ++s) {
    const int h0 = p.ay_start[s][ya], nh = p.ay_start[s][yb] + p.ay_w[s] - h0;
    const int w0 = p.bx_start[s][xa], nw = p.bx_start[s][xb] + p.bx_w[s] - w0;
    const int hv0 = p.wy_start[s][ya] - h0, hv1 = p.wy_start[s][yb] + p.wy_w[s] - h0;
    const long long sh = p.sh[s], sw = p.sw[s], sc = p.sc[s];
    const float* m = p.maps[s] + b * p.sb[s] + h0 * sh + w0 * sw + c0 * sc;
    // channel fastest: in the network's channels-last maps neighbouring
    // threads read neighbouring words
    for (int i = tid; i < nw * nc; i += kThreads) {
      const int w = i / nc, c = i % nc;
      const float* col = m + w * sw + c * sc;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int hh = 0; hh < nh; ++hh) {
        const float v = __ldg(col + hh * sh);
        const float4* a4 = reinterpret_cast<const float4*>(s_a + aoff + hh * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 a = a4[q];
          acc[4 * q] = fmaf(a.x, v, acc[4 * q]);
          acc[4 * q + 1] = fmaf(a.y, v, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a.z, v, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a.w, v, acc[4 * q + 3]);
        }
      }
      float4* dst = reinterpret_cast<float4*>(s_l + (c * wsum + loff + w) * kLPitch);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q)
        dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      // the same column through the plain chain, over its narrower reach
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int hh = hv0; hh < hv1; ++hh) {
        const float v = __ldg(col + hh * sh);
        const float4* a4 = reinterpret_cast<const float4*>(s_wy + aoff + hh * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 a = a4[q];
          acc[4 * q] = fmaf(a.x, v, acc[4 * q]);
          acc[4 * q + 1] = fmaf(a.y, v, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a.z, v, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a.w, v, acc[4 * q + 3]);
        }
      }
      dst = reinterpret_cast<float4*>(s_v + (c * wsum + loff + w) * kRows);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q)
        dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
  __syncthreads();

  // --- per channel: blurred column, NMS, masked output ----------------------
  const int x = x0 - 1 + tid;
  const bool x_in = x >= 0 && x < W;
  const bool x_out = tid >= 1 && tid <= kColTile && x < W;
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = 0; c < nc; ++c) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    if (x_in) {
      for (int s = 0, loff = 0; s < p.n_scales; loff += p.wcap[s], ++s) {
        const int bw = p.bx_w[s];
        const int first = p.bx_start[s][x] - p.bx_start[s][xa];
        const float* lp = s_l + (c * wsum + loff + first) * kLPitch;
        const float* coef = p.bx_coef[s] + x;
        float part[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < bw; ++k) {
          const float cb = __ldg(coef + k * W);
          const float4* l4 = reinterpret_cast<const float4*>(lp + k * kLPitch);
#pragma unroll
          for (int q = 0; q < kRows / 4; ++q) {
            const float4 v = l4[q];
            part[4 * q] = fmaf(v.x, cb, part[4 * q]);
            part[4 * q + 1] = fmaf(v.y, cb, part[4 * q + 1]);
            part[4 * q + 2] = fmaf(v.z, cb, part[4 * q + 2]);
            part[4 * q + 3] = fmaf(v.w, cb, part[4 * q + 3]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += part[r] * p.inv_n;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int y = y0 - 1 + r;
      if (!x_in || y < 0 || y >= H) acc[r] = 0.f;   // the NMS reads zero outside
    }
    float* edge = s_edge + (c * kWarps + warp) * 2 * kRows;
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) edge[r] = acc[r];
    }
    if (lane == 31) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) edge[kRows + r] = acc[r];
    }
    __syncthreads();
    float* out = p.out + (static_cast<size_t>(b) * p.parts + c0 + c) * H * W;
    const float* v = s_v + c * wsum * kRows;
#pragma unroll
    for (int r = 1; r <= kOutRows; ++r) {
      const float sm = acc[r];
      float left = __shfl_up_sync(0xffffffffu, sm, 1);
      float right = __shfl_down_sync(0xffffffffu, sm, 1);
      if (lane == 0 && warp > 0) left = edge[-2 * kRows + kRows + r];
      if (lane == 31 && warp < kWarps - 1) right = edge[2 * kRows + r];
      const int y = y0 - 1 + r;
      if (x_out && y < H) {
        const bool peak = sm >= acc[r - 1] && sm >= acc[r + 1] && sm >= left && sm >= right &&
                          sm > p.thre1;
        // a peak's average is taken by the whole block below, or here once
        // the list is full
        const int at = peak ? atomicAdd(s_count + c, 1) : kPeakList;
        if (peak && at < kPeakList)
          s_list[at] = r * kThreads + tid;
        else
          out[static_cast<size_t>(y) * W + x] = peak ? average_at(p, v, r, x, xa) : -INFINITY;
      }
    }
    __syncthreads();
    // the channel's peaks, spread over the block; the next channel's NMS
    // writes the list only after its own barrier above
    const int n_listed = min(s_count[c], kPeakList);
    for (int i = tid; i < n_listed; i += kThreads) {
      const int r = s_list[i] / kThreads, px = x0 - 1 + s_list[i] % kThreads;
      out[static_cast<size_t>(y0 - 1 + r) * W + px] = average_at(p, v, r, px, xa);
    }
  }
}

}  // namespace

// Shared memory (bytes) the kernel asks for at these parameters; the
// wrapper's pyramid_peaks.smem_bytes computes the same from the band tables.
extern "C" int tp_pyramid_peaks_smem(const PyramidParams* p) {
  return static_cast<int>(smem_floats(*p) * sizeof(float));
}

// Launch over (n_groups, n_bands, B * n_tiles) blocks. Returns
// cudaErrorInvalidValue for more than 8 scales, a grid beyond its limits
// or tables whose staged rows exceed a block's shared memory.
extern "C" int tp_pyramid_peaks(const PyramidParams* p, void* stream) {
  if (p->n_scales < 1 || p->n_scales > kMaxScales || p->parts < 1 ||
      p->n_groups != (p->parts + kGroup - 1) / kGroup ||
      p->n_bands != (p->out_h + kOutRows - 1) / kOutRows ||
      p->n_tiles != (p->out_w + kColTile - 1) / kColTile ||
      static_cast<long long>(p->batch) * p->n_tiles > 65535 || p->n_bands > 65535) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_floats(*p) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = tp_allow_smem(pyramid_peaks_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p->n_groups, p->n_bands, p->batch * p->n_tiles);
  pyramid_peaks_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

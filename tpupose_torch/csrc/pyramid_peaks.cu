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
// bit for bit.
//
// Maps that hold a NaN or an inf follow the contract of
// decode/scalespace.py, which is what the dense chain gives them: per
// (image, channel, scale) term, a NaN anywhere makes the term NaN at every
// output, and inf entries of one sign give +-inf where every one of them
// lies in the output's footprint (the non-zero coefficients of its row of
// Ay_s or Wy_s and of its column of BxT_s or WxT_s) and NaN elsewhere;
// terms add in IEEE arithmetic. A block sees only a band of the maps, so
// the census is a kernel of its own, launched first on the same stream:
// per image, chunk of kCensusRows low-res rows of a scale and channel, one
// word with a bit for NaN, +inf and -inf. The kernel below is the finite
// path, unchanged, whatever the census. A third kernel, one block per
// (group of channels, image), ORs its channels' words per scale; where they
// are clear the block is done, and where one is set it marks the rows and
// columns of that scale's inf entries from the whole map and writes every
// output of that channel again from the set scales' classes alone
// (poisoned_channels): a finite term adds nothing to a non-finite one,
// since a convex weighting of finite values cannot overflow, and the NMS
// of a field of classes needs only the classes.
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
  int hl[kMaxScales], wl[kMaxScales];  // low-res map sizes
  int* census;           // (B, census_chunks, parts) words, written by the census kernel
  int census_chunks;     // chunks of kCensusRows low-res rows over all scales, per image
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

constexpr int kCensusRows = 8;          // low-res rows a census block reads
constexpr int kCensusThreads = 512;

// words of one channel's row and column masks over all scales
__host__ __device__ inline int channel_mask_words(const PyramidParams& p) {
  int words = 0;
  for (int s = 0; s < p.n_scales; ++s) words += mask_words(p.hl[s]) + mask_words(p.wl[s]);
  return words;
}

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

// dynamic shared memory of the pass after the kernel: census words and
// masks of kGroup channels, then a byte per output row and column per scale
// for the blurred and the averaged map
__host__ __device__ inline size_t fix_smem_bytes(const PyramidParams& p) {
  return (kGroup * kMaxScales + kGroup * channel_mask_words(p)) * sizeof(int) +
         static_cast<size_t>(p.n_scales) * 2 * (p.out_h + p.out_w);
}

// Whether a band of an operator (its non-zero coefficients, at ``at`` of
// an output axis of ``stride``) covers every bit set in ``bits``: the
// inf entries' rows (or columns) all lie in the output's footprint.
__device__ __noinline__ bool band_holds(const int* bits, int words, int start,
                                        const float* coef, int width, int stride, int at) {
  int total = 0;
  for (int i = 0; i < words; ++i) total += __popc(bits[i]);
  int held = 0;
  for (int k = 0; k < width; ++k) {
    const int h = start + k;
    if (coef[k * stride + at] != 0.f && ((bits[h >> 5] >> (h & 31)) & 1)) ++held;
  }
  return held == total;
}

// The class of a term whose map holds a non-finite entry (census word f),
// at an output whose footprint holds all its inf entries or not.
__device__ __forceinline__ float census_class(int f, bool inside) {
  if ((f & kNaN) || (f & (kPosInf | kNegInf)) == (kPosInf | kNegInf) || !inside)
    return __int_as_float(0x7fffffff);
  return (f & kPosInf) ? INFINITY : -INFINITY;
}

// The census: one block per (chunk of kCensusRows low-res rows of a scale,
// image) ORs the bits of each channel's entries there into its word. Where
// the rows are dense in memory (channels innermost, no gap between rows, as
// the network's channels-last maps are) the block reads them as one run
// (census_run); elsewhere it reads channel by channel.
__global__ void __launch_bounds__(kCensusThreads)
pyramid_census_kernel(const __grid_constant__ PyramidParams p) {
  extern __shared__ int s_bits[];   // [parts]
  // the kernel that follows reads nothing this one writes: let it start
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int b = blockIdx.y, tid = threadIdx.x, parts = p.parts;
  int s = 0, first = 0;
  for (; s < p.n_scales - 1; ++s) {
    const int n = (p.hl[s] + kCensusRows - 1) / kCensusRows;
    if (static_cast<int>(blockIdx.x) < first + n) break;
    first += n;
  }
  const int h0 = (blockIdx.x - first) * kCensusRows, wl = p.wl[s];
  const int nh = min(kCensusRows, p.hl[s] - h0);
  const long long sh = p.sh[s], sw = p.sw[s], sc = p.sc[s];
  const float* m = p.maps[s] + b * p.sb[s] + h0 * sh;
  for (int c = tid; c < parts; c += kCensusThreads) s_bits[c] = 0;
  __syncthreads();
  if (sc == 1 && sh == wl * sw && sw >= parts) {
    census_run<kCensusThreads>(m, nh * sh, sw, parts, s_bits);
  } else {
    for (int i = tid; i < nh * wl * parts; i += kCensusThreads) {
      const int c = i % parts, pix = i / parts;
      const float v = __ldg(m + (pix / wl) * sh + (pix % wl) * sw + c * sc);
      if (!isfinite(v)) atomicOr(s_bits + c, nonfinite_bits(v));
    }
  }
  __syncthreads();
  int* out = p.census + (static_cast<size_t>(b) * p.census_chunks + blockIdx.x) * parts;
  for (int c = tid; c < parts; c += kCensusThreads) out[c] = s_bits[c];
}

// A group of channels of one image whose census is set: the rows and
// columns of their inf entries from the whole maps into masks (s_mask,
// zeroed here), then every output of those channels from the set scales'
// classes alone: each output's blurred class and its 4 neighbours' (zero
// outside the image), the NMS, and at a peak the averaged class. A finite
// term adds nothing to a non-finite one (a convex weighting of finite
// values cannot overflow), and the NMS of a field of classes needs only
// the classes.
__device__ __noinline__ void poisoned_channels(const PyramidParams& p, const int* s_census,
                                               int* s_mask, int b, int c0, int nc) {
  const int tid = threadIdx.x, H = p.out_h, W = p.out_w;
  const int mwords = channel_mask_words(p);
  for (int i = tid; i < kGroup * mwords; i += kThreads) s_mask[i] = 0;
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    int* mask = s_mask + c * mwords;
    for (int s = 0; s < p.n_scales; ++s) {
      const int f = s_census[c * kMaxScales + s];
      const int hl = p.hl[s], wl = p.wl[s], rw = mask_words(hl);
      if (f && !(f & kNaN) && (f & (kPosInf | kNegInf)) != (kPosInf | kNegInf)) {
        const float* m = p.maps[s] + b * p.sb[s] + (c0 + c) * p.sc[s];
        for (int i = tid; i < hl * wl; i += kThreads) {
          const int h = i / wl, w = i % wl;
          if (!isfinite(__ldg(m + h * p.sh[s] + w * p.sw[s]))) {
            atomicOr(mask + (h >> 5), 1 << (h & 31));
            atomicOr(mask + rw + (w >> 5), 1 << (w & 31));
          }
        }
      }
      mask += rw + mask_words(wl);
    }
  }
  __syncthreads();
  // per scale, whether each output row's and column's footprint holds the
  // inf entries' rows and columns: blurred rows [H], blurred columns [W],
  // averaged rows [H], averaged columns [W]
  unsigned char* s_lines = reinterpret_cast<unsigned char*>(s_mask + kGroup * mwords);
  const int lines = 2 * (H + W);
  for (int c = 0; c < nc; ++c) {
    const int* flags = s_census + c * kMaxScales;
    const int* masks = s_mask + c * mwords;
    int any = 0;
    bool all_nan = false;
    for (int s = 0; s < p.n_scales; ++s) {
      any |= flags[s];
      all_nan = all_nan || (flags[s] & kNaN) ||
                (flags[s] & (kPosInf | kNegInf)) == (kPosInf | kNegInf);
    }
    if (!any) continue;
    float* out = p.out + (static_cast<size_t>(b) * p.parts + c0 + c) * H * W;
    if (all_nan) {   // the blurred map is NaN everywhere: no peak
      for (int i = tid; i < H * W; i += kThreads) out[i] = -INFINITY;
      continue;
    }
    __syncthreads();   // the previous channel's lines are read
    for (int i = tid; i < p.n_scales * (H + W); i += kThreads) {
      const int s = i / (H + W), k = i % (H + W);
      if (!flags[s]) continue;
      const int* mask = masks;
      for (int t = 0; t < s; ++t) mask += mask_words(p.hl[t]) + mask_words(p.wl[t]);
      const int rw = mask_words(p.hl[s]), cw = mask_words(p.wl[s]);
      unsigned char* line = s_lines + s * lines;
      if (k < H) {
        line[k] = band_holds(mask, rw, p.ay_start[s][k], p.ay_coef[s], p.ay_w[s], H, k);
        line[H + W + k] = band_holds(mask, rw, p.wy_start[s][k], p.wy_coef[s], p.wy_w[s], H, k);
      } else {
        const int x = k - H;
        line[H + x] = band_holds(mask + rw, cw, p.bx_start[s][x], p.bx_coef[s], p.bx_w[s], W, x);
        line[2 * H + W + x] =
            band_holds(mask + rw, cw, p.wx_start[s][x], p.wx_coef[s], p.wx_w[s], W, x);
      }
    }
    __syncthreads();
    // a map's value at (y, x): the set scales' classes, added in scale order
    auto value = [&](int y, int x, int rows, int cols) {
      float v = 0.f;
      for (int s = 0; s < p.n_scales; ++s) {
        const unsigned char* line = s_lines + s * lines;
        if (flags[s]) v += census_class(flags[s], line[rows + y] && line[cols + x]) * p.inv_n;
      }
      return v;
    };
    for (int i = tid; i < H * W; i += kThreads) {
      const int y = i / W, x = i % W;
      const float sm = value(y, x, 0, H);
      const float up = y > 0 ? value(y - 1, x, 0, H) : 0.f;
      const float down = y < H - 1 ? value(y + 1, x, 0, H) : 0.f;
      const float left = x > 0 ? value(y, x - 1, 0, H) : 0.f;
      const float right = x < W - 1 ? value(y, x + 1, 0, H) : 0.f;
      const bool peak = sm >= up && sm >= down && sm >= left && sm >= right && sm > p.thre1;
      out[i] = peak ? value(y, x, H + W, 2 * H + W) : -INFINITY;
    }
  }
}

// After the kernel, on the same stream: one block per (group of channels,
// image) ORs the census of its channels per scale; where it is clear the
// block is done, and where it is set it writes those channels' outputs
// again (poisoned_channels).
__global__ void __launch_bounds__(kThreads)
pyramid_poisoned_kernel(const __grid_constant__ PyramidParams p) {
  extern __shared__ int s_fix[];
  int* s_census = s_fix;                            // [channel][scale] census words
  int* s_mask = s_fix + kGroup * kMaxScales;        // [channel] row and column masks
  const int b = blockIdx.y, c0 = blockIdx.x * kGroup, nc = min(kGroup, p.parts - c0);
  // the kernel's outputs, and through it the census, are complete and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (threadIdx.x < kGroup * kMaxScales) s_census[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < nc * p.census_chunks; i += kThreads) {
    const int c = i % nc, chunk = i / nc;
    const int f = __ldg(p.census + (static_cast<size_t>(b) * p.census_chunks + chunk) * p.parts +
                        c0 + c);
    if (f) {
      int s = 0;
      for (int first = 0; s < p.n_scales - 1; ++s) {
        first += (p.hl[s] + kCensusRows - 1) / kCensusRows;
        if (chunk < first) break;
      }
      atomicOr(s_census + c * kMaxScales + s, f);
    }
  }
  __syncthreads();
  int poisoned = 0;
  for (int i = 0; i < kGroup * kMaxScales; ++i) poisoned |= s_census[i];
  if (poisoned) poisoned_channels(p, s_census, s_mask, b, c0, nc);
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
  // launched beside the census: it ends after it, so that the pass after it
  // finds the census complete
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

}  // namespace

// Shared memory (bytes) the kernel asks for at these parameters; the
// wrapper's pyramid_peaks.smem_bytes computes the same from the band tables.
extern "C" int tp_pyramid_peaks_smem(const PyramidParams* p) {
  return static_cast<int>(smem_floats(*p) * sizeof(float));
}

// Chunks of kCensusRows low-res rows over all scales of one image.
extern "C" int tp_pyramid_census_chunks(const PyramidParams* p) {
  int chunks = 0;
  for (int s = 0; s < p->n_scales; ++s) chunks += (p->hl[s] + kCensusRows - 1) / kCensusRows;
  return chunks;
}

// The census alone, and the pass over the channels whose census is set
// alone (to time them; tp_pyramid_peaks launches both).
extern "C" int tp_pyramid_census(const PyramidParams* p, void* stream) {
  if (p->census_chunks != tp_pyramid_census_chunks(p) || p->batch > 65535)
    return cudaErrorInvalidValue;
  pyramid_census_kernel<<<dim3(p->census_chunks, p->batch), kCensusThreads,
                          p->parts * sizeof(int), static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

extern "C" int tp_pyramid_poisoned(const PyramidParams* p, void* stream) {
  const size_t fix_smem = fix_smem_bytes(*p);
  if (p->census_chunks != tp_pyramid_census_chunks(p) || p->batch > 65535 ||
      p->n_groups != (p->parts + kGroup - 1) / kGroup || fix_smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaError_t err = tp_allow_smem(pyramid_poisoned_kernel, fix_smem);
  if (err != cudaSuccess) return err;
  pyramid_poisoned_kernel<<<dim3(p->n_groups, p->batch), kThreads, fix_smem,
                            static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

// Launch, on one stream, the census over (census_chunks, B) blocks, the
// kernel over (n_groups, n_bands, B * n_tiles) blocks and the pass over
// the channels whose census is set over (n_groups, B) blocks. Returns
// cudaErrorInvalidValue for more than 8 scales, a grid beyond its limits,
// tables whose staged rows exceed a block's shared memory or a census
// buffer of another size.
extern "C" int tp_pyramid_peaks(const PyramidParams* p, void* stream) {
  if (p->n_scales < 1 || p->n_scales > kMaxScales || p->parts < 1 ||
      p->census_chunks != tp_pyramid_census_chunks(p) || p->batch > 65535 ||
      p->n_groups != (p->parts + kGroup - 1) / kGroup ||
      p->n_bands != (p->out_h + kOutRows - 1) / kOutRows ||
      p->n_tiles != (p->out_w + kColTile - 1) / kColTile ||
      static_cast<long long>(p->batch) * p->n_tiles > 65535 || p->n_bands > 65535) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_floats(*p) * sizeof(float);
  const size_t fix_smem = fix_smem_bytes(*p);
  if (smem > 227 * 1024 || fix_smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = tp_allow_smem(pyramid_peaks_kernel, smem);
  if (err != cudaSuccess) return err;
  if ((err = tp_allow_smem(pyramid_poisoned_kernel, fix_smem)) != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t census_smem = p->parts * sizeof(int);
  if (census_smem > 227 * 1024) return cudaErrorInvalidValue;
  if ((err = tp_allow_smem(pyramid_census_kernel, census_smem)) != cudaSuccess) return err;
  pyramid_census_kernel<<<dim3(p->census_chunks, p->batch), kCensusThreads, census_smem, s>>>(*p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the kernel and the pass after it are launched as programmatic
  // dependents: the kernel runs beside the census, the pass is set up
  // while the kernel ends and waits for it
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->n_groups, p->n_bands, p->batch * p->n_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, pyramid_peaks_kernel, *p)) != cudaSuccess) return err;
  cfg.gridDim = dim3(p->n_groups, p->batch);
  cfg.dynamicSmemBytes = fix_smem;
  if ((err = cudaLaunchKernelEx(&cfg, pyramid_poisoned_kernel, *p)) != cudaSuccess) return err;
  return cudaGetLastError();
}

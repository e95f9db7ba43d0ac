// Scale-space peak scores: per-scale low-res heatmaps -> masked
// full-res peak-score maps, one pass.
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
// What bounds it on the H100: f32 FMAs fed from L1/L2. Each output pixel
// costs sum_s Wl_s MACs per map in the second product (230 at the
// 4-scale 368x368 geometry) and the bytes moved are small (the low-res
// maps, the constant matrices, one f32 per output pixel); the matrices
// are f32 and the products must stay f32 (the reference runs them at
// HIGHEST precision), so the tensor cores' bf16/TF32 paths are not used.
// Design: one block per (image, channel, 16-row band, 382-column tile).
// It forms the left products Wy_s M_s and Ay_s M_s for its band (plus
// one halo row above and below for the NMS) in shared memory, reading
// the channel-major low-res maps straight from L1/L2; then each thread
// owns one output column (plus a halo column each side) and sums the
// right products over all scales for every row of the band at once, so
// each element of BxT_s is read once per block. The blurred band stays
// in shared memory for the NMS; the averaged map is evaluated only at
// peaks. Shared memory depends on the band and the low-res widths, not
// on the image width, and neither full-res map nor any per-scale
// intermediate reaches device memory.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

constexpr int kMaxScales = 8;

// Passed by value to the kernel; mirrored by a ctypes.Structure in
// ops/pyramid_peaks.py.
struct PyramidParams {
  int n_scales, batch, parts, out_h, out_w;
  int hl[kMaxScales], wl[kMaxScales];
  const float* maps[kMaxScales];  // (B, parts, Hl, Wl) f32, channel-major
  const float* wy[kMaxScales];    // (H, Hl)
  const float* wxt[kMaxScales];   // (Wl, W)
  const float* ay[kMaxScales];    // (H, Hl)
  const float* bxt[kMaxScales];   // (Wl, W)
  float inv_n, thre1;
  float* out;                     // (B, parts, H*W)
};

namespace {

constexpr int kBand = 16;                  // output rows per block
constexpr int kThreads = 384;              // one per column of the tile + halo
constexpr int kColTile = kThreads - 2;     // output columns per block

__global__ void __launch_bounds__(kThreads) pyramid_peaks_kernel(PyramidParams p) {
  extern __shared__ float smem[];
  const int bc = blockIdx.y;
  const int y0 = blockIdx.x * kBand;
  const int x0 = blockIdx.z * kColTile;
  const int H = p.out_h, W = p.out_w;
  const int tid = threadIdx.x;

  int sum_w = 0;
  for (int s = 0; s < p.n_scales; ++s) sum_w += p.wl[s];
  float* s_ravg = smem;                           // per scale (kBand, Wl)
  float* s_rsm = s_ravg + kBand * sum_w;          // per scale (kBand + 2, Wl)
  float* s_smooth = s_rsm + (kBand + 2) * sum_w;  // (kBand + 2, kThreads)

  // --- left products for the band: ravg rows y0.., rsm rows y0-1.. -----
  {
    int roff = 0;
    for (int s = 0; s < p.n_scales; ++s) {
      const int hl = p.hl[s], wl = p.wl[s];
      const float* m = p.maps[s] + static_cast<size_t>(bc) * hl * wl;
      for (int i = tid; i < (2 * kBand + 2) * wl; i += kThreads) {
        const int r = i / wl;
        const int w = i % wl;
        const bool is_avg = r < kBand;
        const int y = is_avg ? y0 + r : y0 - 1 + (r - kBand);
        float acc = 0.f;
        if (y >= 0 && y < H) {
          const float* row = (is_avg ? p.wy[s] : p.ay[s]) + static_cast<size_t>(y) * hl;
          for (int h = 0; h < hl; ++h) acc = fmaf(row[h], __ldg(m + h * wl + w), acc);
        }
        if (is_avg)
          s_ravg[roff * kBand + r * wl + w] = acc;
        else
          s_rsm[roff * (kBand + 2) + (r - kBand) * wl + w] = acc;
      }
      roff += wl;
    }
  }
  __syncthreads();

  // --- blurred rows y0-1 .. y0+kBand at column x0-1+tid (zero outside) -
  {
    const int x = x0 - 1 + tid;
    float acc[kBand + 2];
#pragma unroll
    for (int r = 0; r < kBand + 2; ++r) acc[r] = 0.f;
    if (x >= 0 && x < W) {
      int roff = 0;
      for (int s = 0; s < p.n_scales; ++s) {
        const int wl = p.wl[s];
        const float* rs = s_rsm + roff * (kBand + 2);
        const float* col = p.bxt[s] + x;
        float part[kBand + 2];
#pragma unroll
        for (int r = 0; r < kBand + 2; ++r) part[r] = 0.f;
#pragma unroll 4
        for (int w = 0; w < wl; ++w) {
          const float bw = __ldg(col + static_cast<size_t>(w) * W);
#pragma unroll
          for (int r = 0; r < kBand + 2; ++r) part[r] = fmaf(rs[r * wl + w], bw, part[r]);
        }
#pragma unroll
        for (int r = 0; r < kBand + 2; ++r) acc[r] += part[r] * p.inv_n;
        roff += wl;
      }
    }
#pragma unroll
    for (int r = 0; r < kBand + 2; ++r) {
      const int y = y0 - 1 + r;
      s_smooth[r * kThreads + tid] = (y >= 0 && y < H) ? acc[r] : 0.f;
    }
  }
  __syncthreads();

  // --- averaged rows, NMS, masked output ------------------------------
  float* out = p.out + static_cast<size_t>(bc) * H * W;
  for (int i = tid; i < kBand * kColTile; i += kThreads) {
    const int r = i / kColTile;
    const int j = i % kColTile + 1;  // column in the smooth tile
    const int y = y0 + r;
    const int x = x0 - 1 + j;
    if (y >= H || x >= W) continue;
    const float* sr = s_smooth + (r + 1) * kThreads;
    const float sm = sr[j];
    const bool peak = sm >= sr[j - kThreads] && sm >= sr[j + kThreads] &&
                      sm >= sr[j - 1] && sm >= sr[j + 1] && sm > p.thre1;
    float avg = -INFINITY;
    if (peak) {
      avg = 0.f;
      int roff = 0;
      for (int s = 0; s < p.n_scales; ++s) {
        const int wl = p.wl[s];
        const float* rrow = s_ravg + roff * kBand + r * wl;
        const float* col = p.wxt[s] + x;
        float part = 0.f;
        for (int w = 0; w < wl; ++w) part = fmaf(rrow[w], col[static_cast<size_t>(w) * W], part);
        avg += part * p.inv_n;
        roff += wl;
      }
    }
    out[static_cast<size_t>(y) * W + x] = avg;
  }
}

}  // namespace

// Launch over (ceil(H / 16), B * parts, ceil(W / 382)) blocks. Returns
// cudaErrorInvalidValue for more than 8 scales or low-res widths whose
// band products exceed shared memory.
extern "C" int tp_pyramid_peaks(const PyramidParams* p, void* stream) {
  if (p->n_scales < 1 || p->n_scales > kMaxScales) return cudaErrorInvalidValue;
  int sum_w = 0;
  for (int s = 0; s < p->n_scales; ++s) sum_w += p->wl[s];
  const size_t smem = sizeof(float) * ((2 * kBand + 2) * static_cast<size_t>(sum_w) +
                                       (kBand + 2) * static_cast<size_t>(kThreads));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = tp_allow_smem(pyramid_peaks_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p->out_h + kBand - 1) / kBand, p->batch * p->parts,
                  (p->out_w + kColTile - 1) / kColTile);
  pyramid_peaks_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

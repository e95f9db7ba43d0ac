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
// needs the 78 MB of its 18 scored channels and writes 78 MB, against
// 2 GFLOP over the two passes), but as
// built the shared-memory reads of the two 25-tap passes are what it
// waits for. The Pallas kernel keeps one whole padded channel resident
// in VMEM per grid step, one image per call. Here one launch covers the batch: a
// block owns a 32x32 output tile of one image and a group of 6 channels. It
// stages the tile plus the blur halo plus the 1-pixel NMS halo for the
// group from the NHWC input (the group's channels are adjacent in memory,
// and the groups of one tile are neighbours in the grid, so the sectors
// one group leaves unused are in L2 for the next), then per channel runs
// the horizontal pass into shared memory, the vertical pass from it, and
// compares and writes rows of the channel-major output.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

constexpr int kMaxTaps = 64;

// Passed by value to the kernel; mirrored by a ctypes.Structure in
// ops/peaks.py.
struct PeaksParams {
  int batch, h, w;
  int cstride;        // channels of the input (>= parts)
  int parts;          // channels 0..parts-1 are scored
  int radius;         // taps = 2 * radius + 1
  float thre1;
  float taps[kMaxTaps];
  const float* maps;  // (B, H, W, cstride)
  float* out;         // (B, parts, H * W)
};

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kGroup = 6;   // channels staged per block
constexpr size_t kSmemLimit = 227 * 1024;

// index of the symmetric (edge-repeating) extension of an axis of length n
__device__ __forceinline__ int fold(int j, int n) {
  const int period = 2 * n;
  int m = j % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

__host__ __device__ inline size_t smem_floats(int radius) {
  const int in_h = kTileH + 2 + 2 * radius, in_w = kTileW + 2 + 2 * radius;
  return static_cast<size_t>(kGroup) * in_h * in_w + in_h * (kTileW + 2) +
         (kTileH + 2) * (kTileW + 2);
}

__global__ void __launch_bounds__(kThreads) peaks_kernel(PeaksParams p) {
  extern __shared__ float smem[];
  const int r = p.radius, ntaps = 2 * r + 1;
  const int in_h = kTileH + 2 + 2 * r, in_w = kTileW + 2 + 2 * r;
  const int bl_h = kTileH + 2, bl_w = kTileW + 2;   // tile + NMS halo
  float* s_in = smem;                           // kGroup x in_h x in_w
  float* s_hb = s_in + kGroup * in_h * in_w;    // in_h x bl_w
  float* s_sm = s_hb + in_h * bl_w;             // bl_h x bl_w

  const int tid = threadIdx.x;
  const int n_groups = (p.parts + kGroup - 1) / kGroup;
  const int c0 = (blockIdx.x % n_groups) * kGroup;
  const int nc = min(kGroup, p.parts - c0);
  const int x0 = (blockIdx.x / n_groups) * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;

  // stage the group's input window, borders folded
  const float* img = p.maps + static_cast<size_t>(b) * p.h * p.w * p.cstride;
  for (int i = tid; i < in_h * in_w * nc; i += kThreads) {
    const int c = i % nc, pix = i / nc;
    const int col = pix % in_w, row = pix / in_w;
    const int gy = fold(y0 - 1 - r + row, p.h);
    const int gx = fold(x0 - 1 - r + col, p.w);
    s_in[(c * in_h + row) * in_w + col] =
        img[(static_cast<size_t>(gy) * p.w + gx) * p.cstride + c0 + c];
  }
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const float* sc = s_in + c * in_h * in_w;
    // horizontal pass: columns x0-1 .. x0+kTileW of every staged row
    for (int i = tid; i < in_h * bl_w; i += kThreads) {
      const float* src = sc + (i / bl_w) * in_w + i % bl_w;
      float acc = __fmul_rn(p.taps[0], src[0]);
      for (int k = 1; k < ntaps; ++k) acc = __fadd_rn(acc, __fmul_rn(p.taps[k], src[k]));
      s_hb[i] = acc;
    }
    __syncthreads();
    // vertical pass; outside the map the NMS field is zero
    for (int i = tid; i < bl_h * bl_w; i += kThreads) {
      const int row = i / bl_w, col = i % bl_w;
      const int gy = y0 - 1 + row, gx = x0 - 1 + col;
      float v = 0.f;
      if (gy >= 0 && gy < p.h && gx >= 0 && gx < p.w) {
        const float* src = s_hb + i;
        v = __fmul_rn(p.taps[0], src[0]);
        for (int k = 1; k < ntaps; ++k) v = __fadd_rn(v, __fmul_rn(p.taps[k], src[k * bl_w]));
      }
      s_sm[i] = v;
    }
    __syncthreads();
    // NMS + threshold; the next channel's passes rewrite s_hb before its
    // first barrier and s_sm after it, so no barrier is needed here
    float* out = p.out + (static_cast<size_t>(b) * p.parts + c0 + c) * p.h * p.w;
    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
      const int row = i / kTileW, col = i % kTileW;
      const int gy = y0 + row, gx = x0 + col;
      if (gy < p.h && gx < p.w) {
        const float* q = s_sm + (row + 1) * bl_w + col + 1;
        const float sm = q[0];
        const bool peak = sm >= q[-bl_w] && sm >= q[bl_w] && sm >= q[-1] && sm >= q[1] &&
                          sm > p.thre1;
        out[static_cast<size_t>(gy) * p.w + gx] =
            peak ? sc[(row + 1 + r) * in_w + col + 1 + r] : -INFINITY;
      }
    }
  }
}

}  // namespace

extern "C" int tp_peaks(const PeaksParams* p, void* stream) {
  if (p->batch < 1 || p->h < 1 || p->w < 1 || p->parts < 1 || p->cstride < p->parts ||
      p->radius < 0 || 2 * p->radius + 1 > kMaxTaps) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_floats(p->radius) * sizeof(float);
  const int n_groups = (p->parts + kGroup - 1) / kGroup;
  const long long tiles_x = (p->w + kTileW - 1) / kTileW, tiles_y = (p->h + kTileH - 1) / kTileH;
  if (smem > kSmemLimit || tiles_y > 65535 || p->batch > 65535 ||
      tiles_x * n_groups > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = tp_allow_smem(peaks_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles_x * n_groups), static_cast<unsigned>(tiles_y),
                  p->batch);
  peaks_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

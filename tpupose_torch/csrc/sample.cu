// Scale-space point readout: the scale-averaged chained-bilinear value of
// a limb's PAF channel pair at integer image points.
//
// Replaces tpupose/ops/pallas_sample.py::fused_sample_avg
// (_sample_kernel). For every point (iy, ix) of group (b, l) and both
// channels c of chans[l]:
//
//   out = sum_s sum_{i,j} wy_s[i] * wx_s[j] * M_s[b, y_s[i], x_s[j], c] / n
//
// with 4 y-taps and 4 x-taps per scale from the chain x8 upsample ->
// crop to (rh, rw) -> resize to (out_h, out_w), clipped, duplicate taps
// adding their weights (scalespace._axis_taps). The tap arithmetic uses
// explicitly rounded f32 operations (no FMA contraction), as the
// reference evaluates it.
//
// What bounds it on the H100: gathered reads. Each point reads 16 taps x
// 2 channels per scale (128 loads at 4 scales) from maps of a few
// hundred KB per image, which stay in L1/L2; the point coordinates and
// the result are the only device-memory streams (16 B per point). The
// Pallas kernel's one-hot row-selection matmuls exist only because the
// TPU has no fast gather; here one thread per point computes its taps
// and gathers directly, so nothing but the (points, 2) result is written.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

constexpr int kMaxScales = 8;

// Passed by value to the kernel; mirrored by a ctypes.Structure in
// ops/sample.py.
struct SampleParams {
  int n_scales, batch, groups, out_h, out_w;
  long long points;                // per (b, l) group
  int hl[kMaxScales], wl[kMaxScales], rh[kMaxScales], rw[kMaxScales],
      cstride[kMaxScales];
  float sy[kMaxScales], sx[kMaxScales];  // f32(rh / out_h), f32(rw / out_w)
  const float* maps[kMaxScales];   // (B, Hl, Wl, cstride) f32
  const int* iy;                   // (B, L, points)
  const int* ix;
  const int* chans;                // (L, 2)
  float* out;                      // (B, L, points, 2)
};

namespace {

constexpr int kThreads = 256;
constexpr int kStride = 8;

struct Taps {
  int idx[4];
  float w[4];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void low_taps(int mid, int size_low, int* i0, int* i1,
                                         float* w0, float* w1) {
  const float pos = __fsub_rn(__fdiv_rn(__fadd_rn(static_cast<float>(mid), 0.5f),
                                        static_cast<float>(kStride)), 0.5f);
  const float l0 = floorf(pos);
  const float f = __fsub_rn(pos, l0);
  *i0 = clampi(static_cast<int>(l0), 0, size_low - 1);
  *i1 = clampi(static_cast<int>(l0) + 1, 0, size_low - 1);
  *w0 = __fsub_rn(1.0f, f);
  *w1 = f;
}

__device__ __forceinline__ Taps axis_taps(int q, float scale, int size_mid, int size_low) {
  const float pos_mid = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(q), 0.5f), scale), 0.5f);
  const float m0 = floorf(pos_mid);
  const float f_mid = __fsub_rn(pos_mid, m0);
  const int m0i = clampi(static_cast<int>(m0), 0, size_mid - 1);
  const int m1i = clampi(static_cast<int>(m0) + 1, 0, size_mid - 1);
  Taps t;
  float wa0, wa1, wb0, wb1;
  low_taps(m0i, size_low, &t.idx[0], &t.idx[1], &wa0, &wa1);
  low_taps(m1i, size_low, &t.idx[2], &t.idx[3], &wb0, &wb1);
  const float w0 = __fsub_rn(1.0f, f_mid);
  const float w1 = f_mid;
  t.w[0] = __fmul_rn(w0, wa0);
  t.w[1] = __fmul_rn(w0, wa1);
  t.w[2] = __fmul_rn(w1, wb0);
  t.w[3] = __fmul_rn(w1, wb1);
  return t;
}

__global__ void __launch_bounds__(kThreads) sample_kernel(SampleParams p) {
  const long long total = static_cast<long long>(p.batch) * p.groups * p.points;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long g = i / p.points;  // b * L + l
    const int b = static_cast<int>(g / p.groups);
    const int l = static_cast<int>(g % p.groups);
    const int qy = p.iy[i];
    const int qx = p.ix[i];
    const int c0 = p.chans[2 * l];
    const int c1 = p.chans[2 * l + 1];
    float acc0 = 0.f, acc1 = 0.f;
    for (int s = 0; s < p.n_scales; ++s) {
      const Taps ty = axis_taps(qy, p.sy[s], p.rh[s], p.hl[s]);
      const Taps tx = axis_taps(qx, p.sx[s], p.rw[s], p.wl[s]);
      const int cs = p.cstride[s];
      const float* m = p.maps[s] + static_cast<size_t>(b) * p.hl[s] * p.wl[s] * cs;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* row = m + static_cast<size_t>(ty.idx[a]) * p.wl[s] * cs;
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* px = row + static_cast<size_t>(tx.idx[e]) * cs;
          r0 = fmaf(tx.w[e], __ldg(px + c0), r0);
          r1 = fmaf(tx.w[e], __ldg(px + c1), r1);
        }
        v0 = fmaf(ty.w[a], r0, v0);
        v1 = fmaf(ty.w[a], r1, v1);
      }
      acc0 += v0;
      acc1 += v1;
    }
    const float n = static_cast<float>(p.n_scales);
    p.out[2 * i] = acc0 / n;
    p.out[2 * i + 1] = acc1 / n;
  }
}

}  // namespace

extern "C" int tp_sample(const SampleParams* p, void* stream) {
  if (p->n_scales < 1 || p->n_scales > kMaxScales) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(p->batch) * p->groups * p->points;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks per SM
  sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

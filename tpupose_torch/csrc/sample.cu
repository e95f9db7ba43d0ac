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
// adding their weights (scalespace._axis_taps). The sum keeps its order
// (x taps, y taps, scales, then the division).
//
// What bounds it on the H100: not device memory (16 B per point in and out)
// and not arithmetic, but the gathers: 16 taps x 2 channels per scale and
// point, at addresses that differ from lane to lane. Through L1 each such
// load touches up to 32 sectors and uses 4 or 8 bytes of each. The Pallas
// kernel's one-hot row-selection matmuls exist only because the TPU has no
// fast gather; here the design makes the gather cheap instead:
//
//  * A tap set depends only on (scale, axis, coordinate), so the wrapper
//    builds the table of all of them (4 weights and 4 indices each) once
//    per geometry, with the plain version's own tap function, and keeps it
//    on the device; no point computes a tap and no launch a table.
//  * A block works on the points of one (b, l) at a time. It copies that
//    image's two channels of every scale into shared memory as one float2
//    per pixel (127 KB at 368 x 368 and 4 scales), with the tap table
//    beside it (71 KB), and gathers from there: one 8-byte shared-memory
//    load per tap, at the cost of bank conflicts only. One block per SM takes an equal,
//    contiguous share of all points, so it stages two or three groups (16
//    us each, L2 sectors of which a quarter is used) whatever the count
//    of groups and SMs.
//  * A point's 4 taps along an axis are mostly 2 distinct pixels (both
//    steps of the chain fall into one low-res cell 7 times in 8): a tap
//    equal to an earlier one reuses its value, and a row equal to an
//    earlier one its row sum, bit for bit. Where every lane reads the same
//    pixel (the main path's padded peak slots) a load is one broadcast.
//  * Maps that do not fit a block's shared memory with their table (the
//    496 x 656 bucket: 279 KB) take the direct variant: the same table and
//    reuse, gathered from L2 with one 8-byte load per tap where the pair is
//    (c, c + 1), c even, on an even channel pitch. Size alone decides.
//
// Measured times are in PERF.md (section 6).

#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kMaxScales = 8;

// Passed by value to the kernels; mirrored by a ctypes.Structure in
// ops/sample.py.
struct SampleParams {
  int n_scales, batch, groups, out_h, out_w;
  int paired;                      // every pair is (c, c + 1), c and the pitches even
  long long points;                // per (b, l) group
  int hl[kMaxScales], wl[kMaxScales], cstride[kMaxScales];
  const float* maps[kMaxScales];   // (B, Hl, Wl, cstride) f32
  const int* iy;                   // (B, L, points)
  const int* ix;
  const int* chans;                // (L, 2)
  float* out;                      // (B, L, points, 2)
  const float4* tap_w;             // n_scales x (out_h + out_w + 4) tap sets: weights ...
  const ushort4* tap_i;            // ... and low-res indices (ops/sample.py tap_table)
};

namespace {

constexpr int kDirectThreads = 256;
constexpr int kStagedThreads = 1024;

__device__ __forceinline__ float2 fma2(float w, float2 v, float2 acc) {
  return make_float2(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y));
}

// A coordinate's row in its axis's part of the table, which runs from -1 to
// size: a point outside the image takes the tap set of the first coordinate
// beyond that edge, where the plain version's clamped taps have settled on
// the edge pixel, so it reads inside the maps and agrees with it.
__device__ __forceinline__ int tap_row(int q, int size) { return min(max(q, -1), size) + 1; }

// One scale's value at a point: `pixel(i)` is the channel pair of low-res
// pixel i of this image and scale. A tap that repeats an earlier index
// takes the earlier value; the sum's order is that of 16 separate taps.
// A scale's table entries are its y tap sets at rows -1 .. out_h, then its
// x tap sets at columns -1 .. out_w.
template <typename Pixel>
__device__ __forceinline__ float2 scale_value(const float4 wy, const ushort4 ty, const float4 wx,
                                              const ushort4 tx, int wl, Pixel pixel) {
  auto row_sum = [&](int y) {
    const int base = y * wl;
    const float2 c0 = pixel(base + tx.x);
    const float2 c1 = tx.y == tx.x ? c0 : pixel(base + tx.y);
    const float2 c2 = tx.z == tx.x ? c0 : (tx.z == tx.y ? c1 : pixel(base + tx.z));
    const float2 c3 = tx.w == tx.y ? c1 : (tx.w == tx.z ? c2 : pixel(base + tx.w));
    float2 r = make_float2(0.f, 0.f);
    r = fma2(wx.x, c0, r);
    r = fma2(wx.y, c1, r);
    r = fma2(wx.z, c2, r);
    return fma2(wx.w, c3, r);
  };
  const float2 r0 = row_sum(ty.x);
  const float2 r1 = ty.y == ty.x ? r0 : row_sum(ty.y);
  const float2 r2 = ty.z == ty.x ? r0 : (ty.z == ty.y ? r1 : row_sum(ty.z));
  const float2 r3 = ty.w == ty.y ? r1 : (ty.w == ty.z ? r2 : row_sum(ty.w));
  float2 v = make_float2(0.f, 0.f);
  v = fma2(wy.x, r0, v);
  v = fma2(wy.y, r1, v);
  v = fma2(wy.z, r2, v);
  return fma2(wy.w, r3, v);
}

// Staged variant: one block per SM takes an equal, contiguous share of all
// points. For each group (b, l) its share touches (two or three) it copies
// the group's channel pair of every scale into shared memory, the tap
// table once, and serves the group's points from there.
template <bool kPaired>
__global__ void __launch_bounds__(kStagedThreads) sample_staged_kernel(SampleParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int entries = p.n_scales * (p.out_h + p.out_w + 4);
  float4* s_w = reinterpret_cast<float4*>(smem);
  ushort4* s_i = reinterpret_cast<ushort4*>(s_w + entries);
  int* s_first = reinterpret_cast<int*>(s_i + entries);     // a scale's first pixel in s_map
  float2* s_map = reinterpret_cast<float2*>(s_first + kMaxScales);

  for (int i = threadIdx.x; i < entries; i += kStagedThreads) {
    s_w[i] = p.tap_w[i];
    s_i[i] = p.tap_i[i];
  }
  const long long total = static_cast<long long>(p.batch) * p.groups * p.points;
  const long long share = (total + gridDim.x - 1) / gridDim.x;
  long long lo = blockIdx.x * share;
  const long long hi = lo + share < total ? lo + share : total;
  const int per_scale = p.out_h + p.out_w + 4;
  const float n = static_cast<float>(p.n_scales);
  while (lo < hi) {
    const long long group = lo / p.points;
    const long long group_end = (group + 1) * p.points;
    const long long end = group_end < hi ? group_end : hi;
    const int b = static_cast<int>(group / p.groups);
    const int l = static_cast<int>(group % p.groups);
    const int c0 = p.chans[2 * l];
    const int c1 = p.chans[2 * l + 1];
    __syncthreads();               // the previous group's points are served
    int n_px = 0;
    for (int s = 0; s < p.n_scales; ++s) {
      if (threadIdx.x == 0) s_first[s] = n_px;
      const int px = p.hl[s] * p.wl[s];
      const int cs = p.cstride[s];
      const float* m = p.maps[s] + static_cast<size_t>(b) * px * cs;
#pragma unroll 4
      for (int i = threadIdx.x; i < px; i += kStagedThreads) {
        const float* src = m + static_cast<size_t>(i) * cs;
        s_map[n_px + i] = kPaired ? __ldg(reinterpret_cast<const float2*>(src + c0))
                                  : make_float2(__ldg(src + c0), __ldg(src + c1));
      }
      n_px += px;
    }
    __syncthreads();
    for (long long i = lo + threadIdx.x; i < end; i += kStagedThreads) {
      const int qy = tap_row(p.iy[i], p.out_h);
      const int qx = tap_row(p.ix[i], p.out_w);
      float acc0 = 0.f, acc1 = 0.f;
      for (int s = 0; s < p.n_scales; ++s) {
        const int ey = s * per_scale + qy;
        const int ex = s * per_scale + p.out_h + 2 + qx;
        const float2* m = s_map + s_first[s];
        const float2 v = scale_value(s_w[ey], s_i[ey], s_w[ex], s_i[ex], p.wl[s],
                                     [m](int px) { return m[px]; });
        acc0 += v.x;
        acc1 += v.y;
      }
      reinterpret_cast<float2*>(p.out)[i] = make_float2(acc0 / n, acc1 / n);
    }
    lo = end;
  }
}

// Direct variant, for maps larger than a block's shared memory: a thread
// per point, the table and the maps read through L1/L2.
template <bool kPaired>
__global__ void __launch_bounds__(kDirectThreads) sample_direct_kernel(SampleParams p) {
  const long long total = static_cast<long long>(p.batch) * p.groups * p.points;
  const int per_scale = p.out_h + p.out_w + 4;
  const float n = static_cast<float>(p.n_scales);
  for (long long i = blockIdx.x * static_cast<long long>(kDirectThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kDirectThreads) {
    const long long g = i / p.points;  // b * L + l
    const int b = static_cast<int>(g / p.groups);
    const int l = static_cast<int>(g % p.groups);
    const int qy = tap_row(p.iy[i], p.out_h);
    const int qx = tap_row(p.ix[i], p.out_w);
    const int c0 = p.chans[2 * l];
    const int c1 = p.chans[2 * l + 1];
    float acc0 = 0.f, acc1 = 0.f;
    for (int s = 0; s < p.n_scales; ++s) {
      const int ey = s * per_scale + qy;
      const int ex = s * per_scale + p.out_h + 2 + qx;
      const int cs = p.cstride[s];
      const float* m = p.maps[s] + static_cast<size_t>(b) * p.hl[s] * p.wl[s] * cs;
      const float2 v = scale_value(
          __ldg(p.tap_w + ey), __ldg(p.tap_i + ey), __ldg(p.tap_w + ex), __ldg(p.tap_i + ex),
          p.wl[s], [m, cs, c0, c1](int px) {
            const float* src = m + static_cast<size_t>(px) * cs;
            return kPaired ? __ldg(reinterpret_cast<const float2*>(src + c0))
                           : make_float2(__ldg(src + c0), __ldg(src + c1));
          });
      acc0 += v.x;
      acc1 += v.y;
    }
    reinterpret_cast<float2*>(p.out)[i] = make_float2(acc0 / n, acc1 / n);
  }
}

}  // namespace

// Enqueues the readout: staged where the group's maps and the table fit a
// block's shared memory (ops/sample.py staged_bytes), direct otherwise.
extern "C" int tp_sample(const SampleParams* p, void* stream) {
  if (p->n_scales < 1 || p->n_scales > kMaxScales) return cudaErrorInvalidValue;
  const long long groups = static_cast<long long>(p->batch) * p->groups;
  const long long total = groups * p->points;
  if (total == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int entries = p->n_scales * (p->out_h + p->out_w + 4);
  cudaError_t err;
  int dev = 0, sms = 0, smem_max = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  long long staged_px = 0;
  for (int i = 0; i < p->n_scales; ++i) staged_px += static_cast<long long>(p->hl[i]) * p->wl[i];
  const long long smem = staged_px * sizeof(float2) + kMaxScales * sizeof(int) +
                         static_cast<long long>(entries) * (sizeof(float4) + sizeof(ushort4));
  if (smem > smem_max) {
    long long blocks = (total + kDirectThreads - 1) / kDirectThreads;
    if (blocks > sms * 64LL) blocks = sms * 64LL;  // grid-stride beyond 64 blocks per SM
    if (p->paired)
      sample_direct_kernel<true><<<static_cast<unsigned>(blocks), kDirectThreads, 0, s>>>(*p);
    else
      sample_direct_kernel<false><<<static_cast<unsigned>(blocks), kDirectThreads, 0, s>>>(*p);
    return cudaGetLastError();
  }
  // one block per SM; fewer where there is less than a round of points
  const long long rounds = (total + kStagedThreads - 1) / kStagedThreads;
  const unsigned grid = static_cast<unsigned>(rounds < sms ? rounds : sms);
  if (p->paired) {
    if ((err = tp_allow_smem(sample_staged_kernel<true>, smem)) != cudaSuccess) return err;
    sample_staged_kernel<true><<<grid, kStagedThreads, smem, s>>>(*p);
  } else {
    if ((err = tp_allow_smem(sample_staged_kernel<false>, smem)) != cudaSuccess) return err;
    sample_staged_kernel<false><<<grid, kStagedThreads, smem, s>>>(*p);
  }
  return cudaGetLastError();
}

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
// Maps that hold a NaN or an inf follow the contract of
// decode/scalespace.py, which is what the reference's dense one-hot
// readout gives them: per (image, channel, scale), a NaN anywhere makes the
// term NaN at every point, and inf entries of one sign give +-inf at a
// point whose taps of non-zero weight reach every one of their rows and
// columns, NaN elsewhere. The census of an (image, channel) is a record: per
// scale a word with a bit for NaN, +inf and -inf and a mask of the rows and
// of the columns that hold non-finite entries. The staged variant takes its group's two records
// while it copies the maps, at the cost of one __syncthreads_or, and serves
// a group whose records are clear by the loop of finite maps, unchanged,
// and one whose records are set by a loop in which the set scales' terms
// take their class (a finite scale's term adds nothing to a non-finite
// one but its own overflow, which a convex weighting of finite values
// cannot reach). The direct variant runs unchanged between two kernels on
// its stream: a census before it, one word per (image, chunk of low-res
// rows of a scale, channel), and after it one block per group that ORs its
// channels' words and, where one is set, takes their records from the
// whole maps and serves the group's points again with the classes.
//
// Measured times are in PERF.md (section 6).

#include <cuda_runtime.h>
#include <math.h>

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
  int* census;                     // direct variant: (B, census_chunks, channels) words
  int census_words;                // ops/sample.py census_words, one (image, channel) record
  int channels;                    // channels of the maps, at most
  int census_chunks;               // chunks of kCensusRows low-res rows over all scales
};

namespace {

constexpr int kDirectThreads = 256;
constexpr int kStagedThreads = 1024;
constexpr int kCensusThreads = 256;
constexpr int kCensusRows = 2;   // low-res rows a census block of the direct variant reads

// An (image, channel) census record: per scale its word, its row mask and
// its column mask.
__host__ __device__ inline int census_words(const SampleParams& p) {
  int words = 0;
  for (int s = 0; s < p.n_scales; ++s) words += 1 + mask_words(p.hl[s]) + mask_words(p.wl[s]);
  return words;
}

// Records the non-finite value v at pixel i of scale s in a census record
// (rec: the record, off: the scale's part of it).
__device__ __noinline__ void census_mark(int* rec, int off, int hl, int wl, int i, float v) {
  const int h = i / wl, w = i % wl;
  atomicOr(rec + off, nonfinite_bits(v));
  atomicOr(rec + off + 1 + (h >> 5), 1 << (h & 31));
  atomicOr(rec + off + 1 + mask_words(hl) + (w >> 5), 1 << (w & 31));
}

// Whether a point's taps along an axis (each listed index once, where its
// summed weight is non-zero) cover every bit set in ``bits``.
__device__ bool taps_hold(const int* bits, int words, float4 w, ushort4 t) {
  const int idx[4] = {t.x, t.y, t.z, t.w};
  const float wt[4] = {w.x, w.y, w.z, w.w};
  int total = 0;
  for (int i = 0; i < words; ++i) total += __popc(bits[i]);
  int held = 0;
  for (int a = 0; a < 4; ++a) {
    bool first = true, nonzero = false;
    for (int e = 0; e < 4; ++e) {
      if (idx[e] == idx[a]) {
        first = first && e >= a;
        nonzero = nonzero || wt[e] != 0.f;
      }
    }
    if (first && nonzero && ((bits[idx[a] >> 5] >> (idx[a] & 31)) & 1)) ++held;
  }
  return held == total;
}

// The class of one channel's term at a point, where the scale's part of its
// record (word, row mask, column mask at ``rec``) is set.
__device__ __noinline__ float census_class(const int* rec, int hl, int wl, float4 wy, ushort4 ty,
                                           float4 wx, ushort4 tx) {
  const int f = rec[0], rw = mask_words(hl);
  const bool inside = !(f & kNaN) && (f & (kPosInf | kNegInf)) != (kPosInf | kNegInf) &&
                      taps_hold(rec + 1, rw, wy, ty) &&
                      taps_hold(rec + 1 + rw, mask_words(wl), wx, tx);
  return inside ? ((f & kPosInf) ? INFINITY : -INFINITY) : __int_as_float(0x7fffffff);
}

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

// A staged group's points: per point the scales' values in order, then the
// division. With kPoisoned a scale whose record (rec0, rec1: the group's
// two channels) is set gives its class instead.
template <bool kPoisoned>
__device__ __forceinline__ void serve_staged(const SampleParams& p, long long lo, long long end,
                                             const float4* s_w, const ushort4* s_i,
                                             const int* s_first, const float2* s_map,
                                             const int* rec0, const int* rec1) {
  const int per_scale = p.out_h + p.out_w + 4;
  const float n = static_cast<float>(p.n_scales);
  for (long long i = lo + threadIdx.x; i < end; i += kStagedThreads) {
    const int qy = tap_row(p.iy[i], p.out_h);
    const int qx = tap_row(p.ix[i], p.out_w);
    float acc0 = 0.f, acc1 = 0.f;
    for (int s = 0, off = 0; s < p.n_scales; ++s) {
      const int ey = s * per_scale + qy;
      const int ex = s * per_scale + p.out_h + 2 + qx;
      const float2* m = s_map + s_first[s];
      float2 v = scale_value(s_w[ey], s_i[ey], s_w[ex], s_i[ex], p.wl[s],
                             [m](int px) { return m[px]; });
      if (kPoisoned) {
        if (rec0[off]) v.x = census_class(rec0 + off, p.hl[s], p.wl[s], s_w[ey], s_i[ey],
                                          s_w[ex], s_i[ex]);
        if (rec1[off]) v.y = census_class(rec1 + off, p.hl[s], p.wl[s], s_w[ey], s_i[ey],
                                          s_w[ex], s_i[ex]);
        off += 1 + mask_words(p.hl[s]) + mask_words(p.wl[s]);
      }
      acc0 += v.x;
      acc1 += v.y;
    }
    reinterpret_cast<float2*>(p.out)[i] = make_float2(acc0 / n, acc1 / n);
  }
}

// Staged variant: one block per SM takes an equal, contiguous share of all
// points. For each group (b, l) its share touches (two or three) it copies
// the group's channel pair of every scale into shared memory, with the
// census records of the two channels, the tap table once, and serves the
// group's points from there.
template <bool kPaired>
__global__ void __launch_bounds__(kStagedThreads) sample_staged_kernel(SampleParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int entries = p.n_scales * (p.out_h + p.out_w + 4);
  float4* s_w = reinterpret_cast<float4*>(smem);
  ushort4* s_i = reinterpret_cast<ushort4*>(s_w + entries);
  int* s_first = reinterpret_cast<int*>(s_i + entries);     // a scale's first pixel in s_map
  const int words = census_words(p);
  int* s_rec = s_first + kMaxScales;                        // the group's two census records
  float2* s_map = reinterpret_cast<float2*>(s_rec + 2 * words);

  for (int i = threadIdx.x; i < entries; i += kStagedThreads) {
    s_w[i] = p.tap_w[i];
    s_i[i] = p.tap_i[i];
  }
  for (int i = threadIdx.x; i < 2 * words; i += kStagedThreads) s_rec[i] = 0;
  int poisoned = 0;
  const long long total = static_cast<long long>(p.batch) * p.groups * p.points;
  const long long share = (total + gridDim.x - 1) / gridDim.x;
  long long lo = blockIdx.x * share;
  const long long hi = lo + share < total ? lo + share : total;
  while (lo < hi) {
    const long long group = lo / p.points;
    const long long group_end = (group + 1) * p.points;
    const long long end = group_end < hi ? group_end : hi;
    const int b = static_cast<int>(group / p.groups);
    const int l = static_cast<int>(group % p.groups);
    const int c0 = p.chans[2 * l];
    const int c1 = p.chans[2 * l + 1];
    __syncthreads();               // the previous group's points are served
    if (poisoned) {                // its records are cleared before this group's
      for (int i = threadIdx.x; i < 2 * words; i += kStagedThreads) s_rec[i] = 0;
      __syncthreads();
    }
    int n_px = 0, bad = 0;
    for (int s = 0, off = 0; s < p.n_scales;
         off += 1 + mask_words(p.hl[s]) + mask_words(p.wl[s]), ++s) {
      if (threadIdx.x == 0) s_first[s] = n_px;
      const int px = p.hl[s] * p.wl[s];
      const int cs = p.cstride[s];
      const float* m = p.maps[s] + static_cast<size_t>(b) * px * cs;
#pragma unroll 4
      for (int i = threadIdx.x; i < px; i += kStagedThreads) {
        const float* src = m + static_cast<size_t>(i) * cs;
        const float2 v = kPaired ? __ldg(reinterpret_cast<const float2*>(src + c0))
                                 : make_float2(__ldg(src + c0), __ldg(src + c1));
        s_map[n_px + i] = v;
        if (!isfinite(v.x + v.y)) {
          if (!isfinite(v.x)) {
            census_mark(s_rec, off, p.hl[s], p.wl[s], i, v.x);
            bad = 1;
          }
          if (!isfinite(v.y)) {
            census_mark(s_rec + words, off, p.hl[s], p.wl[s], i, v.y);
            bad = 1;
          }
        }
      }
      n_px += px;
    }
    poisoned = __syncthreads_or(bad);
    if (poisoned)
      serve_staged<true>(p, lo, end, s_w, s_i, s_first, s_map, s_rec, s_rec + words);
    else
      serve_staged<false>(p, lo, end, s_w, s_i, s_first, s_map, s_rec, s_rec + words);
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
  // launched beside the census: it ends after it, so that the pass after it
  // finds the census complete
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A direct-variant point: the scales' values in order, then the division;
// a scale whose census record (rec0, rec1: the group's two channels) is set
// gives its class.
template <bool kPaired>
__device__ float2 poisoned_point(const SampleParams& p, int b, int c0, int c1, int qy, int qx,
                                 const int* rec0, const int* rec1) {
  const int per_scale = p.out_h + p.out_w + 4;
  float acc0 = 0.f, acc1 = 0.f;
  for (int s = 0, off = 0; s < p.n_scales;
       off += 1 + mask_words(p.hl[s]) + mask_words(p.wl[s]), ++s) {
    const int ey = s * per_scale + qy;
    const int ex = s * per_scale + p.out_h + 2 + qx;
    const int cs = p.cstride[s];
    const float* m = p.maps[s] + static_cast<size_t>(b) * p.hl[s] * p.wl[s] * cs;
    const float4 wy = __ldg(p.tap_w + ey), wx = __ldg(p.tap_w + ex);
    const ushort4 ty = __ldg(p.tap_i + ey), tx = __ldg(p.tap_i + ex);
    float2 v = scale_value(wy, ty, wx, tx, p.wl[s], [m, cs, c0, c1](int px) {
      const float* src = m + static_cast<size_t>(px) * cs;
      return kPaired ? __ldg(reinterpret_cast<const float2*>(src + c0))
                     : make_float2(__ldg(src + c0), __ldg(src + c1));
    });
    if (rec0[off]) v.x = census_class(rec0 + off, p.hl[s], p.wl[s], wy, ty, wx, tx);
    if (rec1[off]) v.y = census_class(rec1 + off, p.hl[s], p.wl[s], wy, ty, wx, tx);
    acc0 += v.x;
    acc1 += v.y;
  }
  const float n = static_cast<float>(p.n_scales);
  return make_float2(acc0 / n, acc1 / n);
}

// The direct variant's census: one block per (chunk of kCensusRows low-res
// rows of a scale, image) ORs the bits of each channel's entries there into
// its word. The maps are dense (B, Hl, Wl, C): the block reads its rows as
// one run (census_run).
__global__ void __launch_bounds__(kCensusThreads) sample_census_kernel(SampleParams p) {
  extern __shared__ int s_bits[];   // [channels]
  // the kernel that follows reads nothing this one writes: let it start
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int b = blockIdx.y, tid = threadIdx.x;
  int s = 0, first = 0;
  for (; s < p.n_scales - 1; ++s) {
    const int n = (p.hl[s] + kCensusRows - 1) / kCensusRows;
    if (static_cast<int>(blockIdx.x) < first + n) break;
    first += n;
  }
  const int h0 = (blockIdx.x - first) * kCensusRows, wl = p.wl[s], cs = p.cstride[s];
  const int n = min(kCensusRows, p.hl[s] - h0) * wl * cs;
  const float* m = p.maps[s] + (static_cast<size_t>(b) * p.hl[s] + h0) * wl * cs;
  for (int c = tid; c < p.channels; c += kCensusThreads) s_bits[c] = 0;
  __syncthreads();
  census_run<kCensusThreads>(m, n, cs, cs, s_bits);
  __syncthreads();
  int* out = p.census + (static_cast<size_t>(b) * p.census_chunks + blockIdx.x) * p.channels;
  for (int c = tid; c < p.channels; c += kCensusThreads) out[c] = s_bits[c];
}

// After the direct variant, on the same stream: one block per group (b, l)
// ORs the census words of its two channels; where they are clear the block
// is done, and where one is set it takes the two channels' census records
// from the whole maps into shared memory and serves the group's points
// again (poisoned_point).
template <bool kPaired>
__global__ void __launch_bounds__(kCensusThreads) sample_poisoned_kernel(SampleParams p) {
  extern __shared__ int s_rec[];   // the group's two census records
  __shared__ int s_any;
  const int words = census_words(p);
  const long long g = blockIdx.x;
  const int b = static_cast<int>(g / p.groups), l = static_cast<int>(g % p.groups);
  const int c0 = p.chans[2 * l], c1 = p.chans[2 * l + 1];
  // the direct variant's outputs, and through it the census, are complete
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (threadIdx.x == 0) s_any = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < p.census_chunks; i += kCensusThreads) {
    const int* w = p.census + (static_cast<size_t>(b) * p.census_chunks + i) * p.channels;
    if (__ldg(w + c0) | __ldg(w + c1)) s_any = 1;
  }
  __syncthreads();
  if (!s_any) return;
  for (int i = threadIdx.x; i < 2 * words; i += kCensusThreads) s_rec[i] = 0;
  __syncthreads();
  for (int s = 0, off = 0; s < p.n_scales;
       off += 1 + mask_words(p.hl[s]) + mask_words(p.wl[s]), ++s) {
    const int px = p.hl[s] * p.wl[s], cs = p.cstride[s];
    const float* m = p.maps[s] + static_cast<size_t>(b) * px * cs;
    for (int i = threadIdx.x; i < px; i += kCensusThreads) {
      const float v0 = __ldg(m + static_cast<size_t>(i) * cs + c0);
      const float v1 = __ldg(m + static_cast<size_t>(i) * cs + c1);
      if (!isfinite(v0)) census_mark(s_rec, off, p.hl[s], p.wl[s], i, v0);
      if (!isfinite(v1)) census_mark(s_rec + words, off, p.hl[s], p.wl[s], i, v1);
    }
  }
  __syncthreads();
  for (long long i = g * p.points + threadIdx.x; i < (g + 1) * p.points; i += kCensusThreads) {
    const int qy = tap_row(p.iy[i], p.out_h), qx = tap_row(p.ix[i], p.out_w);
    reinterpret_cast<float2*>(p.out)[i] =
        poisoned_point<kPaired>(p, b, c0, c1, qy, qx, s_rec, s_rec + words);
  }
}

}  // namespace

// Words of an (image, channel) census record (ops/sample.py census_words mirrors it).
extern "C" int tp_sample_census_words(const SampleParams* p) { return census_words(*p); }

// The direct variant's census alone (to time it; tp_sample launches it).
extern "C" int tp_sample_census(const SampleParams* p, void* stream) {
  if (p->batch > 65535 || p->n_scales < 1 || p->n_scales > kMaxScales) return cudaErrorInvalidValue;
  sample_census_kernel<<<dim3(p->census_chunks, p->batch), kCensusThreads,
                         p->channels * sizeof(int), static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

// Enqueues the readout: staged where the group's maps and the table fit a
// block's shared memory (ops/sample.py staged_bytes), direct otherwise,
// after its census kernel.
extern "C" int tp_sample(const SampleParams* p, void* stream) {
  int chunks = 0;
  for (int i = 0; i < p->n_scales; ++i) chunks += (p->hl[i] + kCensusRows - 1) / kCensusRows;
  if (p->n_scales < 1 || p->n_scales > kMaxScales || p->census_words != census_words(*p) ||
      p->census_chunks != chunks || p->batch > 65535 ||
      static_cast<long long>(p->batch) * p->groups > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  for (int i = 0; i < p->n_scales; ++i)
    if (p->cstride[i] > p->channels) return cudaErrorInvalidValue;
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
                         2 * p->census_words * sizeof(int) +
                         static_cast<long long>(entries) * (sizeof(float4) + sizeof(ushort4));
  if (smem > smem_max) {
    sample_census_kernel<<<dim3(p->census_chunks, p->batch), kCensusThreads,
                           p->channels * sizeof(int), s>>>(*p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    long long blocks = (total + kDirectThreads - 1) / kDirectThreads;
    if (blocks > sms * 64LL) blocks = sms * 64LL;  // grid-stride beyond 64 blocks per SM
    const size_t rec_smem = 2 * p->census_words * sizeof(int);
    // the direct variant and the pass after it are launched as programmatic
    // dependents: it runs beside the census, the pass waits for it
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kDirectThreads);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    auto direct = p->paired ? sample_direct_kernel<true> : sample_direct_kernel<false>;
    auto poisoned = p->paired ? sample_poisoned_kernel<true> : sample_poisoned_kernel<false>;
    if ((err = cudaLaunchKernelEx(&cfg, direct, *p)) != cudaSuccess) return err;
    if ((err = tp_allow_smem(poisoned, rec_smem)) != cudaSuccess) return err;
    cfg.gridDim = dim3(static_cast<unsigned>(groups));
    cfg.blockDim = dim3(kCensusThreads);
    cfg.dynamicSmemBytes = rec_smem;
    if ((err = cudaLaunchKernelEx(&cfg, poisoned, *p)) != cudaSuccess) return err;
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

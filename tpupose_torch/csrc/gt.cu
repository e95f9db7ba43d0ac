// Ground-truth rasterisation: putGaussianMaps + putVecMaps for a batch.
//
// Replaces tpupose/ops/pallas_gt.py::create_labels_pallas (_gt_kernel).
// For every sample b and label pixel (row, col):
//
//   heat[part] = max over present persons of exp(-d2 / (2 sigma^2)) where
//                d2 / (2 sigma^2) <= 4.6052, on the image-space grid
//                g = col * stride + stride / 2 - 0.5;
//   heat[18]   = 1 - max over parts;
//   paf[2k..]  = sum over persons of the limb's unit vector where the pixel
//                lies in the limb's band (|perp| <= thre, 0 <= along <=
//                norm, label-grid coordinates (x + 0.5) / stride - 0.5),
//                divided by the number of persons whose band covers it;
//   all 57 channels times the miss-mask.
//
// Persons fold in index order 0..P-1, so sums round as the reference
// kernel's sequential person grid does. Everything that feeds a comparison
// (the exp cut-off, the three band tests) is computed with explicitly
// rounded f32 operations, so nvcc contracts nothing into an FMA and the
// discontinuities fall where the plain PyTorch version puts them.
//
// What bounds it on the H100: bytes, and at training shapes the launch.
// A batch of 10 at 46x46 writes 4.8 MB of labels from 52 KB of joints and
// 85 KB of mask; the arithmetic is a few MFLOP. The Pallas kernel walks a
// (sample, person) grid with the sample's output block resident in VMEM.
// Here a block takes one sample and a tile of whole label rows:
//
//   * it stages the sample's joints and per-limb geometry (origin, unit
//     vector, length) in shared memory, and from conservative row boxes
//     (a Gaussian reaches sqrt(4.6052 * 2 sigma^2) image pixels and one
//     more; a band its bone's rows and thre + 1 label rows beyond) lists
//     the (part, person) and (limb, person) pairs that can reach the tile,
//     channel by channel and in person order. In the training batch few
//     of the 24 persons are live and each reaches a few label rows, so
//     most pairs drop out. Only listed pairs are evaluated, with the exact
//     tests unchanged: a skipped pair adds nothing to a sum and nothing to
//     a maximum, so the result is the same bit for bit as evaluating
//     every pair;
//   * its threads split over pixel x channel (18 parts and 19 limbs), each
//     walking its channel's list;
//   * the output tile is staged in shared memory, finished per pixel (the
//     background, the mask) and written as contiguous float4 runs: a tile
//     of whole label rows is one contiguous range of each NHWC output.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

constexpr int kParts = 18;
constexpr int kLimbs = 19;

// Passed by value to the kernel; mirrored by a ctypes.Structure in
// ops/gt.py.
struct GtParams {
  int batch, persons, label;
  int tile_rows;      // label rows per block
  float stride;       // s
  float half_stride;  // s / 2
  float denom;        // 2 sigma^2
  float thre;         // paf_thre / s
  int limb_a[kLimbs], limb_b[kLimbs];
  const float* joints;  // (N, P, 18, 3)
  const float* mask;    // (N, L, L)
  float* paf;           // (N, L, L, 38)
  float* heat;          // (N, L, L, 19)
};

namespace {

constexpr int kThreads = 512;
constexpr int kJoint = kParts * 3;   // floats per person
constexpr int kLimbRec = 6;          // ax, ay, ux, uy, norm, ok
constexpr int kHeat = kParts + 1, kPaf = 2 * kLimbs;
constexpr float kExpCutoff = 4.6052f;

__host__ __device__ inline size_t smem_floats(int persons, int tile_pixels) {
  return static_cast<size_t>(persons) * (kJoint + kLimbs * kLimbRec + kParts + kLimbs) +
         (kParts + 1) + (kLimbs + 1) + static_cast<size_t>(tile_pixels) * (1 + kHeat + kPaf);
}

__device__ __forceinline__ float label_coord(float v, float s) {
  return __fsub_rn(__fdiv_rn(__fadd_rn(v, 0.5f), s), 0.5f);
}

// The pairs of channel c (0 .. n_ch - 1) and person q (entry c * P + q)
// whose flag is set, compacted in entry order by one warp: list[] holds
// c * P + q, start[c] the first of channel c, start[n_ch] the count.
template <typename Flag>
__device__ void build_list(int n_ch, int persons, Flag flag, int* list, int* start) {
  const int lane = threadIdx.x & 31;
  if (persons == 0) {
    if (lane <= n_ch) start[lane] = 0;
    return;
  }
  int count = 0;
  for (int base = 0; base < n_ch * persons; base += 32) {
    const int e = base + lane;
    const bool in = e < n_ch * persons;
    const bool f = in && flag(e / persons, e % persons);
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    const int at = count + __popc(bal & ((1u << lane) - 1u));
    if (f) list[at] = e;
    if (in && e % persons == 0) start[e / persons] = at;
    count += __popc(bal);
  }
  if (lane == 0) start[n_ch] = count;
}

// n floats of s to g, g's float4 runs written whole
__device__ void copy_out(float* g, const float* s, int n) {
  const int head = min(n, static_cast<int>((4 - (reinterpret_cast<size_t>(g) / 4) % 4) % 4));
  const int body = (n - head) / 4;
  for (int i = threadIdx.x; i < head; i += kThreads) g[i] = s[i];
  float4* g4 = reinterpret_cast<float4*>(g + head);
  for (int v = threadIdx.x; v < body; v += kThreads) {
    const float* sv = s + head + 4 * v;
    g4[v] = make_float4(sv[0], sv[1], sv[2], sv[3]);
  }
  for (int i = head + 4 * body + threadIdx.x; i < n; i += kThreads) g[i] = s[i];
}

__global__ void __launch_bounds__(kThreads) gt_kernel(GtParams p) {
  extern __shared__ float smem[];
  const int P = p.persons, L = p.label;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int r0 = blockIdx.x * p.tile_rows, nrows = min(p.tile_rows, L - r0);
  const int npix = nrows * L;
  float* sj = smem;                                 // P x 54
  float* sl = sj + P * kJoint;                      // P x 19 x 6
  int* part_list = reinterpret_cast<int*>(sl + P * kLimbs * kLimbRec);   // part * P + q
  int* limb_list = part_list + P * kParts;                                // limb * P + q
  int* part_start = limb_list + P * kLimbs;         // kParts + 1
  int* limb_start = part_start + kParts + 1;        // kLimbs + 1
  float* s_mask = reinterpret_cast<float*>(limb_start + kLimbs + 1);   // npix
  float* s_heat = s_mask + npix;                    // npix x 19
  float* s_paf = s_heat + npix * kHeat;             // npix x 38

  const float* jb = p.joints + static_cast<size_t>(b) * P * kJoint;
  for (int i = tid; i < P * kJoint; i += kThreads) sj[i] = jb[i];
  const size_t at0 = (static_cast<size_t>(b) * L + r0) * L;
  for (int i = tid; i < npix; i += kThreads) s_mask[i] = p.mask[at0 + i];
  __syncthreads();
  for (int i = tid; i < P * kLimbs; i += kThreads) {
    const int q = i / kLimbs, k = i % kLimbs;
    const float* ja = sj + q * kJoint + p.limb_a[k] * 3;
    const float* jc = sj + q * kJoint + p.limb_b[k] * 3;
    const float ax = label_coord(ja[0], p.stride), ay = label_coord(ja[1], p.stride);
    const float bx = label_coord(jc[0], p.stride), by = label_coord(jc[1], p.stride);
    const float dx = __fsub_rn(bx, ax), dy = __fsub_rn(by, ay);
    const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const bool ok = ja[2] < 2.0f && jc[2] < 2.0f && norm >= 1e-8f;
    const float ns = fmaxf(norm, 1e-8f);
    float* e = sl + i * kLimbRec;
    e[0] = ax;
    e[1] = ay;
    e[2] = __fdiv_rn(dx, ns);
    e[3] = __fdiv_rn(dy, ns);
    e[4] = norm;
    e[5] = ok ? 1.0f : 0.0f;
  }
  __syncthreads();

  // --- the pairs that can reach rows r0 .. r1 (ops/gt.py: reach_rows) -------
  const float r1 = static_cast<float>(r0 + nrows - 1), rf0 = static_cast<float>(r0);
  if (tid < 32) {
    // a Gaussian's rows, from the image-space radius of the exp cut-off
    const float rad = sqrtf(kExpCutoff * p.denom) + 1.0f;
    const float off = p.half_stride - 0.5f;
    build_list(kParts, P, [&](int part, int q) {
      const float* j = sj + q * kJoint + part * 3;
      return j[2] < 2.0f && (j[1] + rad - off) / p.stride >= rf0 &&
             (j[1] - rad - off) / p.stride <= r1;
    }, part_list, part_start);
  } else if (tid < 64) {
    // a band's rows: its bone's, and thre + 1 label rows beyond
    build_list(kLimbs, P, [&](int k, int q) {
      const float* e = sl + (q * kLimbs + k) * kLimbRec;
      const float by = label_coord(sj[q * kJoint + p.limb_b[k] * 3 + 1], p.stride);
      return e[5] != 0.f && fmaxf(e[1], by) + p.thre + 1.0f >= rf0 &&
             fminf(e[1], by) - p.thre - 1.0f <= r1;
    }, limb_list, limb_start);
  }
  __syncthreads();

  // --- pixel x channel: the listed pairs, exact tests --------------------------
  for (int t = tid; t < npix * (kParts + kLimbs); t += kThreads) {
    const int pix = t % npix, ch = t / npix;
    const float row = static_cast<float>(r0 + pix / L);
    const float col = static_cast<float>(pix % L);
    if (ch < kParts) {
      const float gx = __fsub_rn(__fadd_rn(__fmul_rn(col, p.stride), p.half_stride), 0.5f);
      const float gy = __fsub_rn(__fadd_rn(__fmul_rn(row, p.stride), p.half_stride), 0.5f);
      float hmax = 0.f;
      for (int i = part_start[ch]; i < part_start[ch + 1]; ++i) {
        const float* j = sj + (part_list[i] % P) * kJoint + ch * 3;
        const float dx = __fsub_rn(gx, j[0]);
        const float dy = __fsub_rn(gy, j[1]);
        const float expo = __fdiv_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), p.denom);
        if (expo <= kExpCutoff) hmax = fmaxf(hmax, expf(-expo));
      }
      s_heat[pix * kHeat + ch] = fminf(hmax, 1.0f);
    } else {
      const int k = ch - kParts;
      float vx = 0.f, vy = 0.f, cnt = 0.f;
      for (int i = limb_start[k]; i < limb_start[k + 1]; ++i) {
        const float* e = sl + ((limb_list[i] % P) * kLimbs + k) * kLimbRec;
        const float px = __fsub_rn(col, e[0]);
        const float py = __fsub_rn(row, e[1]);
        const float along = __fadd_rn(__fmul_rn(px, e[2]), __fmul_rn(py, e[3]));
        const float perp = fabsf(__fsub_rn(__fmul_rn(px, e[3]), __fmul_rn(py, e[2])));
        if (perp <= p.thre && along >= 0.f && along <= e[4]) {
          vx = __fadd_rn(vx, e[2]);
          vy = __fadd_rn(vy, e[3]);
          cnt = __fadd_rn(cnt, 1.0f);
        }
      }
      const float inv = __fdiv_rn(s_mask[pix], fmaxf(cnt, 1.0f));
      s_paf[pix * kPaf + 2 * k] = __fmul_rn(vx, inv);
      s_paf[pix * kPaf + 2 * k + 1] = __fmul_rn(vy, inv);
    }
  }
  __syncthreads();

  // --- per pixel: background and mask ------------------------------------------
  for (int pix = tid; pix < npix; pix += kThreads) {
    float* h = s_heat + pix * kHeat;
    const float m = s_mask[pix];
    float fg = 0.f;
    for (int part = 0; part < kParts; ++part) {
      fg = fmaxf(fg, h[part]);
      h[part] = __fmul_rn(h[part], m);
    }
    h[kParts] = __fmul_rn(__fsub_rn(1.0f, fg), m);
  }
  __syncthreads();

  copy_out(p.heat + at0 * kHeat, s_heat, npix * kHeat);
  copy_out(p.paf + at0 * kPaf, s_paf, npix * kPaf);
}

}  // namespace

// Shared memory (bytes) a block asks for; ops/gt.py's smem_bytes computes
// the same.
extern "C" int tp_gt_smem(int persons, int label, int tile_rows) {
  return static_cast<int>(smem_floats(persons, min(tile_rows, label) * label) * sizeof(float));
}

extern "C" int tp_gt(const GtParams* p, void* stream) {
  if (p->batch < 1 || p->persons < 0 || p->label < 1 || p->tile_rows < 1 ||
      p->batch > 65535) {
    return cudaErrorInvalidValue;
  }
  for (int k = 0; k < kLimbs; ++k) {
    if (p->limb_a[k] < 0 || p->limb_a[k] >= kParts || p->limb_b[k] < 0 ||
        p->limb_b[k] >= kParts) {
      return cudaErrorInvalidValue;
    }
  }
  const size_t smem =
      smem_floats(p->persons, min(p->tile_rows, p->label) * p->label) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = tp_allow_smem(gt_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p->label + p->tile_rows - 1) / p->tile_rows, p->batch);
  gt_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

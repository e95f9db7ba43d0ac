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
// (sample, person) grid with the sample's output block resident in VMEM;
// here a block stages one sample's joints and per-limb geometry (origin,
// unit vector, length) in shared memory once, each thread owns one pixel,
// loops over the persons keeping 18 running maxima and 19 x (sum x, sum y,
// count) in registers, and writes its 57 channels straight into the NHWC
// outputs — no per-person partial and no channel-major copy reaches
// device memory.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

constexpr int kParts = 18;
constexpr int kLimbs = 19;

// Passed by value to the kernel; mirrored by a ctypes.Structure in
// ops/gt.py.
struct GtParams {
  int batch, persons, label;
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

constexpr int kThreads = 128;
constexpr int kJoint = kParts * 3;   // floats per person
constexpr int kLimbRec = 6;          // ax, ay, ux, uy, norm, ok
constexpr float kExpCutoff = 4.6052f;

__device__ __forceinline__ float label_coord(float v, float s) {
  return __fsub_rn(__fdiv_rn(__fadd_rn(v, 0.5f), s), 0.5f);
}

__global__ void __launch_bounds__(kThreads) gt_kernel(GtParams p) {
  extern __shared__ float smem[];
  float* sj = smem;                          // persons x 54
  float* sl = smem + p.persons * kJoint;     // persons x 19 x 6
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  const float* jb = p.joints + static_cast<size_t>(b) * p.persons * kJoint;
  for (int i = tid; i < p.persons * kJoint; i += kThreads) sj[i] = jb[i];
  __syncthreads();
  for (int i = tid; i < p.persons * kLimbs; i += kThreads) {
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

  const int area = p.label * p.label;
  const int pix = blockIdx.x * kThreads + tid;
  if (pix >= area) return;
  const float row = static_cast<float>(pix / p.label);
  const float col = static_cast<float>(pix % p.label);
  const float gx = __fsub_rn(__fadd_rn(__fmul_rn(col, p.stride), p.half_stride), 0.5f);
  const float gy = __fsub_rn(__fadd_rn(__fmul_rn(row, p.stride), p.half_stride), 0.5f);

  float hmax[kParts], vx[kLimbs], vy[kLimbs], cnt[kLimbs];
#pragma unroll
  for (int part = 0; part < kParts; ++part) hmax[part] = 0.f;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) vx[k] = vy[k] = cnt[k] = 0.f;

  for (int q = 0; q < p.persons; ++q) {
    const float* j = sj + q * kJoint;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      if (j[part * 3 + 2] < 2.0f) {   // uniform over the block
        const float dx = __fsub_rn(gx, j[part * 3]);
        const float dy = __fsub_rn(gy, j[part * 3 + 1]);
        const float expo =
            __fdiv_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), p.denom);
        if (expo <= kExpCutoff) hmax[part] = fmaxf(hmax[part], expf(-expo));
      }
    }
    const float* lq = sl + q * kLimbs * kLimbRec;
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) {
      const float* e = lq + k * kLimbRec;
      if (e[5] != 0.f) {              // uniform over the block
        const float px = __fsub_rn(col, e[0]);
        const float py = __fsub_rn(row, e[1]);
        const float along = __fadd_rn(__fmul_rn(px, e[2]), __fmul_rn(py, e[3]));
        const float perp = fabsf(__fsub_rn(__fmul_rn(px, e[3]), __fmul_rn(py, e[2])));
        if (perp <= p.thre && along >= 0.f && along <= e[4]) {
          vx[k] = __fadd_rn(vx[k], e[2]);
          vy[k] = __fadd_rn(vy[k], e[3]);
          cnt[k] = __fadd_rn(cnt[k], 1.0f);
        }
      }
    }
  }

  const size_t at = static_cast<size_t>(b) * area + pix;
  const float m = p.mask[at];
  float* heat = p.heat + at * (kParts + 1);
  float fg = 0.f;
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    const float h = fminf(hmax[part], 1.0f);
    fg = fmaxf(fg, h);
    heat[part] = __fmul_rn(h, m);
  }
  heat[kParts] = __fmul_rn(__fsub_rn(1.0f, fg), m);
  float* paf = p.paf + at * (2 * kLimbs);
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const float inv = __fdiv_rn(m, fmaxf(cnt[k], 1.0f));
    paf[2 * k] = __fmul_rn(vx[k], inv);
    paf[2 * k + 1] = __fmul_rn(vy[k], inv);
  }
}

}  // namespace

extern "C" int tp_gt(const GtParams* p, void* stream) {
  if (p->batch < 1 || p->persons < 0 || p->label < 1) return cudaErrorInvalidValue;
  for (int k = 0; k < kLimbs; ++k) {
    if (p->limb_a[k] < 0 || p->limb_a[k] >= kParts || p->limb_b[k] < 0 ||
        p->limb_b[k] >= kParts) {
      return cudaErrorInvalidValue;
    }
  }
  const size_t smem =
      static_cast<size_t>(p->persons) * (kJoint + kLimbs * kLimbRec) * sizeof(float);
  cudaError_t err = tp_allow_smem(gt_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p->label * p->label + kThreads - 1) / kThreads, p->batch);
  gt_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return cudaGetLastError();
}

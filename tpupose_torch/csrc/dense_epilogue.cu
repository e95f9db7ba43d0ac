// The epilogue of a BODY_25 conv: bias + PReLU, written into a channel
// slice of the dense block's concatenation buffer.
//
// Replaces no TPU kernel: the JAX package has no BODY_25 network. Added
// for the dense blocks of models/body25.py, where every 3x3 conv is
// followed by a per-channel PReLU and a concatenation into its block's
// 3w-wide buffer; done with plain ops that is a bias pass, a PReLU pass and
// the concatenation's copy after each of the network's 102 stage convs a
// scale. The kernel takes the conv's output (cuDNN, without its bias) and,
// in one pass over it:
//
//   out[p, off + c] = round(v > 0 ? v : slope[c] * v),  v = y[p, c] + bias[c]
//
// in f32 and rounded once to the element type (bf16, round to nearest even;
// or f32). With ``keep`` the result is also written back over y, which the
// next conv of the block reads: cuDNN takes a dense input, and a channel
// slice of the buffer is not one, so without the copy PyTorch would make
// one before the conv.
//
// What bounds it on the H100: bytes. It moves 2 bytes (bf16) in and 2 or 4
// out a channel and pixel and does three f32 operations on them, far under
// the card's operations-per-byte line. Design: a thread moves 16 bytes (8
// bf16 or 4 f32 channels of one pixel) per load and store; a block is
// (vectors of a pixel) x (pixels), so neighbouring threads read
// neighbouring 16-byte runs of y and write neighbouring runs of a pixel's
// slice. The bias and slope (f32, a few hundred channels) are read through
// the read-only cache. The plain version is ops/dense_epilogue.py's
// ``dense_epilogue_plain``; the two are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// blockDim (vectors a pixel, pixels a block); y dense (pixels, w), out rows
// of ``pitch`` elements, the slice from ``off``
template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_epilogue_kernel(T* __restrict__ y, const float* __restrict__ bias,
                      const float* __restrict__ slope, T* __restrict__ out, int pixels, int w,
                      int pitch, int off, int keep) {
  constexpr int kVec = 16 / sizeof(T);
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= pixels) return;
  const int c0 = threadIdx.x * kVec;
  T* src = y + static_cast<size_t>(p) * w + c0;
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float a = __fadd_rn(to_f32(v[j]), __ldg(bias + c0 + j));
    v[j] = from_f32<T>(a > 0.f ? a : __fmul_rn(__ldg(slope + c0 + j), a));
  }
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * pitch + off + c0) = raw;
  if (keep) *reinterpret_cast<uint4*>(src) = raw;
}

template <typename T>
cudaError_t launch(void* y, const void* bias, const void* slope, void* out, int pixels, int w,
                   int pitch, int off, int keep, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = w / kVec;
  if (w % kVec || pitch % kVec || off % kVec || off + w > pitch || vecs > kThreads ||
      pixels < 0)
    return cudaErrorInvalidValue;
  if (pixels == 0 || w == 0) return cudaSuccess;
  const dim3 block(vecs, kThreads / vecs);
  const unsigned grid = (pixels + block.y - 1) / block.y;
  dense_epilogue_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(y), static_cast<const float*>(bias), static_cast<const float*>(slope),
      static_cast<T*>(out), pixels, w, pitch, off, keep);
  return cudaGetLastError();
}

}  // namespace

// y (pixels, w) dense, of bf16 (bf16 != 0) or f32, 16-byte aligned; bias and
// slope (w,) f32; out rows of ``pitch`` elements, 16-byte aligned, written at
// channels off .. off + w - 1; ``keep``: y is overwritten with the result
// too. w, pitch and off multiples of 8 (bf16) or 4 (f32), w at most 2048
// (bf16) or 1024 (f32).
extern "C" int tp_dense_epilogue(void* y, const void* bias, const void* slope, void* out,
                                 int bf16, int pixels, int w, int pitch, int off, int keep,
                                 void* stream) {
  return bf16 ? launch<__nv_bfloat16>(y, bias, slope, out, pixels, w, pitch, off, keep, stream)
              : launch<float>(y, bias, slope, out, pixels, w, pitch, off, keep, stream);
}

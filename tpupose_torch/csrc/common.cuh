// Shared by every kernel library of the port (see ops/_build.py).
//
// Each library is a plain C interface loaded with ctypes: launchers take
// device pointers and the CUDA stream as opaque pointers and return the
// cudaError_t of the launch, which the Python wrapper turns into an
// exception with the message from tp_error_string.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

extern "C" const char* tp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Raise a kernel's dynamic shared-memory limit before launching it.
template <typename Kernel>
inline cudaError_t tp_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The census of non-finite values that pyramid_peaks.cu and sample.cu take
// to follow the contract of decode/scalespace.py: a value's bits, and the
// 32-bit words of a mask of n rows or columns.
constexpr int kNaN = 1, kPosInf = 2, kNegInf = 4;

__host__ __device__ inline int mask_words(int n) { return (n + 31) / 32; }

__device__ __forceinline__ int nonfinite_bits(float v) {
  return isnan(v) ? kNaN : (isinf(v) ? (v > 0.f ? kPosInf : kNegInf) : 0);
}

// ORs into s_bits[c] the bits of every non-finite value of a dense run of n
// floats whose channel is its index modulo ``pitch`` (channels from
// ``channels`` on are not counted), a block of kThreads threads with
// kUnroll loads a thread in flight; a value's channel is worked out only
// where it is not finite.
template <int kThreads>
__device__ void census_run(const float* m, long long n, long long pitch, int channels,
                           int* s_bits) {
  constexpr int kUnroll = 8;
  for (long long e0 = threadIdx.x; e0 < n; e0 += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long e = e0 + k * kThreads;
      v[k] = e < n ? __ldg(m + e) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (!isfinite(v[k])) {
        const int c = static_cast<int>((e0 + k * kThreads) % pitch);
        if (c < channels) atomicOr(s_bits + c, nonfinite_bits(v[k]));
      }
    }
  }
}

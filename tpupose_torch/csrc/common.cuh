// Shared by every kernel library of the port (see ops/_build.py).
//
// Each library is a plain C interface loaded with ctypes: launchers take
// device pointers and the CUDA stream as opaque pointers and return the
// cudaError_t of the launch, which the Python wrapper turns into an
// exception with the message from tp_error_string.
#pragma once

#include <cuda_runtime.h>

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

// Shared by the chunk-step kernels. Each kernel source is its own shared
// library with a plain C interface (loaded with ctypes): every launch
// function selects the caller's device, launches on the caller's stream,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// launch that was refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#define KRT_EXPORT extern "C" __attribute__((visibility("default")))

KRT_EXPORT const char* krt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define KRT_NEG_INF (-CUDART_INF_F)

__device__ __forceinline__ float krt_to_float(float x) { return x; }
__device__ __forceinline__ float krt_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Opts a kernel into `smem` bytes of dynamic shared memory (needed above
// 48 KB) unless `*granted` already covers it, and reports whether the
// request was accepted. Each launch function keeps its own `granted`, so
// repeated launches (and launches inside a CUDA graph capture) make no
// further attribute calls.
template <typename K>
cudaError_t krt_allow_smem(K kernel, size_t smem, size_t* granted) {
  if (smem <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) *granted = smem;
  return err;
}

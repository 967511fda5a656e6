// Constants and helpers every neighbor-mass kernel shares: the 256-row
// block of the sparse graph's storage and the rounding of a replica factor
// to W's type. The mass kernels write their rows through the ordered routine
// of sparse_row.cuh: one warp per row, products added in a fixed order, no
// atomics.
#pragma once

#include "krt_common.cuh"

constexpr int kBlockR = 256;  // rows of a sparse-graph block

// A replica factor as the plain version's scaled one-hot tile holds it: cast
// to W's type (small integers are exact in bf16).
template <typename T>
__device__ __forceinline__ float krt_as_w(float x);
template <>
__device__ __forceinline__ float krt_as_w<float>(float x) { return x; }
template <>
__device__ __forceinline__ float krt_as_w<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

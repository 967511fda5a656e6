// The accumulate step of the sparse neighbor mass, used by the hub mass
// kernel (sparse_mass.cu) alone — the port of `_mass_body` in
// kubernetes_rescheduling_tpu/ops/sparse_mass.py — beside the constants
// and helpers every sparse kernel shares. The chunk mass kernel and the
// fused mass+score kernel add in a fixed order instead (sparse_row.cuh).
//
// The TPU body multiplies a [256, bu] tile of the block-local weights by
// the one-hot tile `one_hot(tgt) * rvu` [bu, nn] on the MXU. Against a
// one-hot matrix that product is a row-wise scatter: each nonzero
// W[r, u] lands in column tgt[u], scaled by rvu[u]. A CUDA block owns
// `rows` rows of one 256-row block and keeps their mass in shared memory
// (rows x nn floats); this step streams the rows' slice of one W tile once
// (16-byte loads, consecutive threads on consecutive columns) and adds the
// nonzero products into shared memory. Padding columns carry rvu = 0 and
// targets outside [0, nn) match no column, so both add nothing.
//
// Exactness: the shared-memory adds are unordered atomics. Every partial
// sum is an integer below 2^24 for the integer pair weights and replica
// counts of the solver's instances, so the sum is exact in f32 in any
// order and equals the plain version (an f32 product) bit for bit. The
// replica factor is first rounded to W's type, as the plain version casts
// the scaled one-hot tile to W's type.
#pragma once

#include "krt_common.cuh"

constexpr int kBlockR = 256;         // rows of a sparse-graph block
constexpr int kSparseThreads = 256;  // threads of every sparse kernel block

template <typename T>
__device__ __forceinline__ float krt_as_w(float x);
template <>
__device__ __forceinline__ float krt_as_w<float>(float x) { return x; }
template <>
__device__ __forceinline__ float krt_as_w<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void krt_zero(float* acc, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.0f;
}

// acc[r, tgt[u]] += W[row0 + r, wcol0 + u] * rvu[u] for r < rows, u < bu.
// W is row-major with leading dimension ld; bu and wcol0 are multiples of
// 16 bytes' worth of T, and W is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void krt_accumulate_tile(const T* __restrict__ W, long long ld,
                                                    int row0, int rows, long long wcol0,
                                                    const int* __restrict__ tgt,
                                                    const float* __restrict__ rvu, int bu,
                                                    int nn, float* acc) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs = bu / VEC;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += blockDim.x) {
    const int r = idx / vecs;
    const int u = (idx - r * vecs) * VEC;
    const int4 raw =
        *reinterpret_cast<const int4*>(W + static_cast<long long>(row0 + r) * ld + wcol0 + u);
    const T* w = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float x = krt_to_float(w[e]);
      if (x == 0.0f) continue;
      const int t = tgt[u + e];
      const float rv = krt_as_w<T>(rvu[u + e]);
      if (rv != 0.0f && t >= 0 && t < nn) atomicAdd(&acc[r * nn + t], __fmul_rn(x, rv));
    }
  }
}

// Copies the block's finished rows of M to device memory.
__device__ __forceinline__ void krt_store_rows(const float* acc, int n, float* out) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = acc[i];
}

// Neighbor mass of one solver chunk: replaces the Pallas kernel
// `fused_neighbor_mass` / `_mass_kernel` in
// kubernetes_rescheduling_tpu/ops/fused_admission.py.
//
//   M[r, n] = sum_j W[row(r), j] * [assign[j] == n] * valid[j]
//
// where chunk row r lives in W row-block block_ids[r / block_b]. The TPU
// kernel contracts W's row tiles with a one-hot occupancy tile rebuilt in
// VMEM on the MXU. Against a one-hot matrix that product is really a
// row-wise scatter: each nonzero W[row, j] lands in column assign[j]. This
// kernel does exactly that scatter, so it never spends the 2*C*SP*N
// operations of the dense product.
//
// Bound on the card: bytes. It must stream the chunk's C rows of W once
// (C * SP * sizeof(T): 21 MB at C = 1024, SP = 10240, bf16) and write M
// (C * N * 4 bytes); everything else is small. Design: a block owns R rows
// of M, held in shared memory (R * N floats), and streams those R rows of
// W once with 16-byte vector loads, sharing each loaded slice of `assign`
// and `valid` across its R rows. Zero weights, invalid services and
// out-of-range nodes are skipped, so the pair-weight matrix's sparsity
// costs no shared-memory traffic. The adds into shared memory are atomic
// and so unordered; for integer weights (the pair weights adj * rv * rv are
// integers) every partial sum is an integer below 2^24 and exact in f32, so
// M equals the plain version `W[ids].float() @ one_hot(assign).float()`
// bit for bit whatever the order.

#include "krt_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mass_kernel(const T* __restrict__ W, const int* __restrict__ assign,
            const uint8_t* __restrict__ valid, const int* __restrict__ block_ids,
            int SP, int N, int block_b, int rows, float* __restrict__ M) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float acc[];  // [rows, N]
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  const int row0 = blockIdx.x * rows;  // first chunk row of this block
  for (int j = threadIdx.x * VEC; j < SP; j += blockDim.x * VEC) {
    int a[VEC];
    bool live[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a[e] = assign[j + e];
      live[e] = valid[j + e] != 0 && a[e] >= 0 && a[e] < N;
    }
    for (int r = 0; r < rows; ++r) {
      const int crow = row0 + r;
      const long long wrow =
          static_cast<long long>(block_ids[crow / block_b]) * block_b + crow % block_b;
      const int4 raw = *reinterpret_cast<const int4*>(W + wrow * SP + j);
      const T* w = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float x = krt_to_float(w[e]);
        if (x != 0.0f && live[e]) atomicAdd(&acc[r * N + a[e]], x);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    M[static_cast<long long>(row0) * N + i] = acc[i];
  }
}

template <typename T>
int launch(const void* W, const int* assign, const uint8_t* valid, const int* block_ids,
           int SP, int N, int C, int block_b, int rows, float* M, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  mass_kernel<T><<<C / rows, kThreads, smem, stream>>>(
      static_cast<const T*>(W), assign, valid, block_ids, SP, N, block_b, rows, M);
  return cudaGetLastError();
}

}  // namespace

// W: [SP, SP] row-major bf16 (w_is_bf16 = 1) or f32; assign: i32[SP];
// valid: u8[SP]; block_ids: i32[C / block_b]; M: f32[C, N] output.
// `rows` must divide C; SP must be a multiple of 16 bytes' worth of W.
KRT_EXPORT int krt_mass_launch(int device, const void* W, int w_is_bf16, const int* assign,
                               const uint8_t* valid, const int* block_ids, int SP, int N,
                               int C, int block_b, int rows, float* M, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16
      ? launch<__nv_bfloat16>(W, assign, valid, block_ids, SP, N, C, block_b, rows, M, s)
      : launch<float>(W, assign, valid, block_ids, SP, N, C, block_b, rows, M, s);
}

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
// (C * SP * sizeof(T): 21 MB at C = 1024, SP = 10240, bf16; almost all
// zeros) and write M (C * N * 4 bytes: 4 MB at N = 1000): 0.0075 ms at
// 3.35 TB/s. The work is one add per nonzero weight, a few thousand per
// chunk. At C = 1024 there are only 1024 rows, about 8 per SM, so each
// row's stream must keep many bytes in flight, and no row may stall on its
// few nonzero weights. Design (the ordered row of sparse_row.cuh):
//  - one warp per output row, kLongRowWarps = 4 rows per CUDA block
//    (`mass_geometry` in ops/fused_admission.py);
//  - each warp streams its 20 KB row of W with 16-byte streaming loads
//    through two register buffers of kLongRowDepth = 8 vectors per lane
//    (up to 8 KB per warp, 64 KB per SM in flight); it issues the first
//    two groups, then writes its row of zeros straight to device memory
//    with 16-byte stores while they are in flight;
//  - a vector that is zero in every lane costs one vote; the nonzero
//    weights are listed as (W column, weight), and their columns are
//    resolved from assign and valid in device memory (51 KB at SP = 10240,
//    L2-resident) a whole list at a time, when the list is added:
//    resolving each weight as it was listed made every vector holding one
//    wait on device memory, and took 0.026 ms;
//  - the products are added in column order, no atomics: each column's
//    group (one match instruction) summed in lane order by its lowest lane,
//    W[row, j] going to column assign[j] unless valid[j] is 0 or assign[j]
//    is outside [0, N). So M is the same on every run for any weights, and
//    for integer weights (the pair weights adj * rv * rv are integers)
//    every partial sum is exact and M equals the plain version
//    `W[ids].float() @ one_hot(assign).float()` bit for bit.
// Register prefetch rather than a ring of shared-memory stages filled by
// bulk copies: depth 8 streams the row in 0.0144 ms where depth 2 takes
// 0.0174, and on all-zero weights (the stream and the zeros of M alone) the
// kernel takes 0.0108 ms of its 0.0144; bulk copies could shorten only that
// stream, by at most its 0.0033 ms above the bound, at the cost of a
// barrier protocol per stage. (`bench.mass_sweep` on an H100 80GB HBM3 at
// 700 W, PERF.md §6.)

#include "sparse_row.cuh"

namespace {

// The dense row (sparse_row.cuh): vector v of W row `w`
// (streamed: read once, so it should not displace what is read again); the
// key of element e of vector v is its W column j = v * VEC + e, which adds
// W[row, j] to column assign[j] when valid[j] is set and assign[j] lies in
// [0, N).
template <typename T>
struct DenseRow {
  const T* w;
  int vecs;
  const int* assign;
  const uint8_t* valid;
  int N;

  __device__ __forceinline__ int4 load(int v) const {
    return v < vecs ? __ldcs(reinterpret_cast<const int4*>(w) + v) : make_int4(0, 0, 0, 0);
  }

  __device__ __forceinline__ int key(int v, int e) const {
    return v * (16 / static_cast<int>(sizeof(T))) + e;
  }

  __device__ __forceinline__ void resolve(int j, float x, int& col, float& prod) const {
    const int a = __ldg(assign + j);
    const bool ok = __ldg(valid + j) != 0;
    col = ok && a >= 0 && a < N ? a : -1;
    prod = x;
  }
};

// Shared layout: one product list per warp, int2[krt_list_len<T>()].
template <typename T>
__global__ void __launch_bounds__(kLongRowWarps * 32)
mass_kernel(const T* __restrict__ W, const int* __restrict__ assign,
            const uint8_t* __restrict__ valid, const int* __restrict__ block_ids, int SP, int N,
            int block_b, float* __restrict__ M) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kList = krt_list_len<T>();
  extern __shared__ __align__(16) unsigned char shared[];
  int2* lists = reinterpret_cast<int2*>(shared);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kLongRowWarps + warp;  // chunk row of this warp
  const long long wrow =
      static_cast<long long>(block_ids[row / block_b]) * block_b + row % block_b;
  const DenseRow<T> strip{W + wrow * SP, SP / VEC, assign, valid, N};

  constexpr int G = kLongRowDepth;
  int4 a[G], b[G];
  krt_load_group<G>(strip, 0, lane, a);
  krt_load_group<G>(strip, G * 32, lane, b);
  float* out = M + static_cast<long long>(row) * N;
  krt_zero_row(out, N, lane);
  krt_stream_row<T, G>(strip, a, b, lists + warp * kList, out, lane);
}

template <typename T>
int launch(const void* W, const int* assign, const uint8_t* valid, const int* block_ids, int SP,
           int N, int C, int block_b, int grid, int smem, float* M, cudaStream_t stream) {
  // the wrapper's geometry (`mass_geometry`): whole rows of M per warp,
  // kLongRowWarps warps a block, one product list per warp in shared memory
  constexpr int VEC = 16 / sizeof(T);
  if (static_cast<long long>(grid) * kLongRowWarps != C || C < 1 || C % block_b || SP % VEC ||
      N < 1 || smem != kLongRowWarps * krt_list_len<T>() * 8) {
    return cudaErrorInvalidValue;
  }
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(mass_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  mass_kernel<T><<<grid, kLongRowWarps * 32, smem, stream>>>(
      static_cast<const T*>(W), assign, valid, block_ids, SP, N, block_b, M);
  return cudaGetLastError();
}

}  // namespace

// W: [SP, SP] row-major bf16 (w_is_bf16 = 1) or f32; assign: i32[SP];
// valid: u8[SP]; block_ids: i32[C / block_b]; M: f32[C, N] output. grid
// and smem: the wrapper's launch geometry (`mass_geometry`).
KRT_EXPORT int krt_mass_launch(int device, const void* W, int w_is_bf16, const int* assign,
                               const uint8_t* valid, const int* block_ids, int SP, int N,
                               int C, int block_b, int grid, int smem, float* M, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16 ? launch<__nv_bfloat16>(W, assign, valid, block_ids, SP, N, C, block_b, grid,
                                           smem, M, s)
                   : launch<float>(W, assign, valid, block_ids, SP, N, C, block_b, grid, smem,
                                   M, s);
}

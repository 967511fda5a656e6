// Neighbor mass over the block-local sparse pair weights: replaces the
// Pallas kernels `sparse_neighbor_mass` / `_chunk_kernel` and
// `hub_neighbor_mass` / `_hub_kernel` in
// kubernetes_rescheduling_tpu/ops/sparse_mass.py. Both run the same
// accumulate step (`krt_accumulate_tile`, sparse_tile.cuh), as the two
// Pallas kernels share `_mass_body`.
//
// Chunk mass: for block slot i of the chunk,
//   M[i*256 + r, n] = sum over j < reg_tiles, u < bu of
//       W[r, (toff[blocks[i]] + j)*bu + u] * rvu_c[(i*reg_tiles + j)*bu + u]
//       * [tgt_c[(i*reg_tiles + j)*bu + u] == n]
// with n < nn; nn is the node count for M, or the chunk width when the swap
// phase asks for the chunk-local pair weights. Hub mass: the same sum for
// output block o over the flat list of ragged hub tiles t with
// tile_out[t] == o (W column tile tile_col[t], slab tile tile_lcol[t]); the
// sum restarts at a tile flagged tile_first.
//
// Bound on the card: bytes. The chunk kernel reads the chunk's W strips
// once (KB*256 rows x reg_tiles*bu columns: 2.1 MB of bf16 at the 50k
// graph's KB = 4, bu = 512, reg_tiles = 2) and writes M (8.2 MB at nn =
// 2000); the work is one multiply-add per nonzero weight. Design: one CUDA
// block per (block slot, `rows`-row sub-tile). The Pallas grid's sequential
// tile axis becomes a loop inside the block; `pl.when(first)` becomes
// zeroing the shared-memory rows; each block loads its own strip offset
// (no scalar prefetch). At rows = 8 and nn = 2000 the rows take 64 KB of
// shared memory, granted through cudaFuncSetAttribute.
//
// Exactness: see sparse_tile.cuh; for integer weights and replica counts
// the result equals the plain version bit for bit.

#include "sparse_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kSparseThreads)
chunk_mass_kernel(const T* __restrict__ W, long long ld, const int* __restrict__ tgt_c,
                  const float* __restrict__ rvu_c, const int* __restrict__ blocks,
                  const int* __restrict__ toff, int bu, int reg_tiles, int nn, int rows,
                  float* __restrict__ M) {
  extern __shared__ float acc[];  // [rows, nn]
  const int subtiles = kBlockR / rows;
  const int slot = blockIdx.x / subtiles;
  const int row0 = (blockIdx.x % subtiles) * rows;
  krt_zero(acc, rows * nn);
  __syncthreads();
  const long long tile0 = toff[blocks[slot]];
  for (int j = 0; j < reg_tiles; ++j) {
    const long long lcol = static_cast<long long>(slot * reg_tiles + j) * bu;
    krt_accumulate_tile(W, ld, row0, rows, (tile0 + j) * bu, tgt_c + lcol, rvu_c + lcol, bu,
                        nn, acc);
  }
  __syncthreads();
  krt_store_rows(acc, rows * nn, M + static_cast<long long>(slot * kBlockR + row0) * nn);
}

template <typename T>
__global__ void __launch_bounds__(kSparseThreads)
hub_mass_kernel(const T* __restrict__ W, long long ld, const int* __restrict__ tgt_l,
                const float* __restrict__ rvu_l, const int* __restrict__ tile_col,
                const int* __restrict__ tile_lcol, const int* __restrict__ tile_out,
                const int* __restrict__ tile_first, int n_tiles, int bu, int nn, int rows,
                float* __restrict__ M) {
  extern __shared__ float acc[];  // [rows, nn]
  const int subtiles = kBlockR / rows;
  const int out = blockIdx.x / subtiles;
  const int row0 = (blockIdx.x % subtiles) * rows;
  krt_zero(acc, rows * nn);
  __syncthreads();
  // the tile list is short (tens of tiles): every block scans it for its
  // own output block; the branches are uniform across the block
  for (int t = 0; t < n_tiles; ++t) {
    if (tile_out[t] != out) continue;
    if (tile_first[t]) {
      __syncthreads();
      krt_zero(acc, rows * nn);
      __syncthreads();
    }
    const long long lcol = static_cast<long long>(tile_lcol[t]) * bu;
    krt_accumulate_tile(W, ld, row0, rows, static_cast<long long>(tile_col[t]) * bu,
                        tgt_l + lcol, rvu_l + lcol, bu, nn, acc);
  }
  __syncthreads();
  krt_store_rows(acc, rows * nn, M + static_cast<long long>(out * kBlockR + row0) * nn);
}

template <typename T>
int launch_chunk(const void* W, long long ld, const int* tgt_c, const float* rvu_c,
                 const int* blocks, const int* toff, int n_slots, int bu, int reg_tiles, int nn,
                 int rows, float* M, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * nn * sizeof(float);
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(chunk_mass_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  chunk_mass_kernel<T><<<n_slots * (kBlockR / rows), kSparseThreads, smem, stream>>>(
      static_cast<const T*>(W), ld, tgt_c, rvu_c, blocks, toff, bu, reg_tiles, nn, rows, M);
  return cudaGetLastError();
}

template <typename T>
int launch_hub(const void* W, long long ld, const int* tgt_l, const float* rvu_l,
               const int* tile_col, const int* tile_lcol, const int* tile_out,
               const int* tile_first, int n_tiles, int n_out, int bu, int nn, int rows, float* M,
               cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rows) * nn * sizeof(float);
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(hub_mass_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  hub_mass_kernel<T><<<n_out * (kBlockR / rows), kSparseThreads, smem, stream>>>(
      static_cast<const T*>(W), ld, tgt_l, rvu_l, tile_col, tile_lcol, tile_out, tile_first,
      n_tiles, bu, nn, rows, M);
  return cudaGetLastError();
}

}  // namespace

// W: [256, ld] row-major bf16 (w_is_bf16 = 1) or f32; tgt_c: i32 and rvu_c:
// f32 [n_slots * reg_tiles * bu] chunk-local slabs; blocks: i32[n_slots];
// toff: i32 per block id; M: f32[n_slots * 256, nn] output. `rows` divides
// 256.
KRT_EXPORT int krt_sparse_mass_launch(int device, const void* W, int w_is_bf16, long long ld,
                                      const int* tgt_c, const float* rvu_c, const int* blocks,
                                      const int* toff, int n_slots, int bu, int reg_tiles,
                                      int nn, int rows, float* M, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16 ? launch_chunk<__nv_bfloat16>(W, ld, tgt_c, rvu_c, blocks, toff, n_slots, bu,
                                                 reg_tiles, nn, rows, M, s)
                   : launch_chunk<float>(W, ld, tgt_c, rvu_c, blocks, toff, n_slots, bu,
                                         reg_tiles, nn, rows, M, s);
}

// tgt_l: i32 and rvu_l: f32 group-local slabs; tile_*: i32[n_tiles]; M:
// f32[n_out * 256, nn] output.
KRT_EXPORT int krt_hub_mass_launch(int device, const void* W, int w_is_bf16, long long ld,
                                   const int* tgt_l, const float* rvu_l, const int* tile_col,
                                   const int* tile_lcol, const int* tile_out,
                                   const int* tile_first, int n_tiles, int n_out, int bu, int nn,
                                   int rows, float* M, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16 ? launch_hub<__nv_bfloat16>(W, ld, tgt_l, rvu_l, tile_col, tile_lcol,
                                               tile_out, tile_first, n_tiles, n_out, bu, nn,
                                               rows, M, s)
                   : launch_hub<float>(W, ld, tgt_l, rvu_l, tile_col, tile_lcol, tile_out,
                                       tile_first, n_tiles, n_out, bu, nn, rows, M, s);
}

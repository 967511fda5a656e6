// Neighbor mass over the block-local sparse pair weights: replaces the
// Pallas kernels `sparse_neighbor_mass` / `_chunk_kernel` and
// `hub_neighbor_mass` / `_hub_kernel` in
// kubernetes_rescheduling_tpu/ops/sparse_mass.py.
//
// Chunk mass: for block slot i of the chunk,
//   M[i*256 + r, n] = sum over u < reg_tiles*bu of
//       W[r, toff[blocks[i]]*bu + u] * rvu_c[i*reg_tiles*bu + u]
//       * [tgt_c[i*reg_tiles*bu + u] == n]
// with n < nn; nn is the node count for M, or the chunk width when the swap
// phase asks for the chunk-local pair weights. Hub mass: the same sum for
// output block o over the flat list of ragged hub tiles t with
// tile_out[t] == o (W column tile tile_col[t], slab tile tile_lcol[t]); the
// sum restarts at a tile flagged tile_first.
//
// Bound on the card: bytes. The chunk kernel reads the chunk's W strips
// once (KB*256 rows x reg_tiles*bu columns: 2.1 MB of bf16 at the 50k
// graph's KB = 4, bu = 512, reg_tiles = 2) and writes M (8.2 MB at nn =
// 2000, almost all zeros); the work is one multiply per nonzero product, a
// few thousand per chunk. So the design serves the write and hides the
// reads' latency:
//  - one warp per output row, eight rows (all of one block slot) per CUDA
//    block: 1024 warps over the SMs at the 50k graph's chunk;
//  - each warp first issues its long reads: the strip's place (block table,
//    then tile offset), then its whole strip row (16-byte loads, up to 4 per
//    lane at once) and its share of the slot's tgt/rvu slab (which goes to
//    shared memory, shared by the block's rows); only then, while they are
//    in flight, does it write its row of zeros straight to device memory
//    with 16-byte stores (no shared-memory staging), so the reads are not
//    queued behind 8 MB of stores;
//  - each warp then adds its nonzero products in a fixed column order
//    (`krt_ordered_row`, sparse_row.cuh, shared with the fused mass+score
//    kernel): a per-warp list in shared memory, grouped by column with
//    shuffles, the group's lowest lane summing in lane order and writing
//    the column (a plain store in the row's first round, read-add-write
//    after it). No atomics, so M is the same on every run for any weights;
//    for integer weights and replica counts every partial sum is exact and
//    M equals the plain version (an f32 product) bit for bit.
//
// The hub kernel keeps the first port's design: one CUDA block per (output
// block, `rows`-row sub-tile), the Pallas grid's sequential tile axis a loop
// inside the block, `pl.when(first)` a zeroing of the shared-memory rows,
// the products added with the shared step of sparse_tile.cuh (unordered
// shared-memory atomics, exact for integer weights; see there).

#include "sparse_row.cuh"

namespace {

// Shared layout: the slot's slab tgt i32[U] | rvu f32[U] | one product list
// per warp, int2[32 * VEC]: 8 U + warps * 256 * VEC bytes.
template <typename T>
__global__ void __launch_bounds__(256)
chunk_mass_kernel(const T* __restrict__ W, long long ld, const int* __restrict__ tgt_c,
                  const float* __restrict__ rvu_c, const int* __restrict__ blocks,
                  const int* __restrict__ toff, int bu, int reg_tiles, int nn,
                  float* __restrict__ M) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kList = krt_list_len<T>();
  constexpr int kSlabBatch = 8;
  extern __shared__ __align__(16) unsigned char shared[];
  const int U = reg_tiles * bu;
  int* s_tgt = reinterpret_cast<int*>(shared);
  float* s_rvu = reinterpret_cast<float*>(s_tgt + U);
  int2* lists = reinterpret_cast<int2*>(s_rvu + U);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + warp;  // the block's rows share one slot
  const int slot = blockIdx.x * warps / kBlockR;
  float* out = M + static_cast<long long>(row) * nn;

  // the long reads first: the strip's place (two dependent loads), then
  // the strip row (kStripGroup vectors per lane) and the slot's slab ...
  const T* w = W + static_cast<long long>(row % kBlockR) * ld +
               static_cast<long long>(toff[blocks[slot]]) * bu;
  const int vecs = U / VEC;
  int4 raw[kStripGroup];
  krt_load_strip(w, vecs, 0, lane, raw);
  const int* tg = tgt_c + static_cast<long long>(slot) * U;
  const float* rv = rvu_c + static_cast<long long>(slot) * U;
  int t_reg[kSlabBatch];
  float r_reg[kSlabBatch];
#pragma unroll
  for (int b = 0; b < kSlabBatch; ++b) {
    const int i = b * blockDim.x + threadIdx.x;
    t_reg[b] = i < U ? tg[i] : 0;
    r_reg[b] = i < U ? rv[i] : 0.0f;
  }
  // ... then, while they are in flight, the row of zeros straight to device
  // memory (nothing waits on these stores) ...
  if ((nn & 3) == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int c = lane; c < (nn >> 2); c += 32) out4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int c = lane; c < nn; c += 32) out[c] = 0.0f;
  }
  // ... and the slab into shared memory (its first batch from registers)
  for (int i0 = 0; i0 < U; i0 += kSlabBatch * blockDim.x) {
#pragma unroll
    for (int b = 0; b < kSlabBatch; ++b) {
      const int i = i0 + b * blockDim.x + threadIdx.x;
      if (i0 > 0) {
        t_reg[b] = i < U ? tg[i] : 0;
        r_reg[b] = i < U ? rv[i] : 0.0f;
      }
      if (i < U) {
        s_tgt[i] = t_reg[b];
        s_rvu[i] = r_reg[b];
      }
    }
  }
  __syncthreads();  // the slab is in shared memory

  krt_ordered_row(w, vecs, raw, s_tgt, s_rvu, nn, lists + warp * kList, out, lane);
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
                 int warps, int grid, int smem, float* M, cudaStream_t stream) {
  // the wrapper's geometry (`chunk_mass_geometry`): whole blocks of rows of
  // one slot, the slab and one product list per warp in shared memory
  const long long n_rows = static_cast<long long>(n_slots) * kBlockR;
  const long long want = 8LL * reg_tiles * bu + warps * 256LL * static_cast<int>(16 / sizeof(T));
  if (warps < 1 || warps > 8 || kBlockR % warps || static_cast<long long>(grid) * warps != n_rows ||
      smem != want) {
    return cudaErrorInvalidValue;
  }
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(chunk_mass_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  chunk_mass_kernel<T><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(W), ld, tgt_c, rvu_c, blocks, toff, bu, reg_tiles, nn, M);
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
// toff: i32 per block id; M: f32[n_slots * 256, nn] output. warps, grid and
// smem: the wrapper's launch geometry (`chunk_mass_geometry`).
KRT_EXPORT int krt_sparse_mass_launch(int device, const void* W, int w_is_bf16, long long ld,
                                      const int* tgt_c, const float* rvu_c, const int* blocks,
                                      const int* toff, int n_slots, int bu, int reg_tiles,
                                      int nn, int warps, int grid, int smem, float* M,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16 ? launch_chunk<__nv_bfloat16>(W, ld, tgt_c, rvu_c, blocks, toff, n_slots, bu,
                                                 reg_tiles, nn, warps, grid, smem, M, s)
                   : launch_chunk<float>(W, ld, tgt_c, rvu_c, blocks, toff, n_slots, bu,
                                         reg_tiles, nn, warps, grid, smem, M, s);
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

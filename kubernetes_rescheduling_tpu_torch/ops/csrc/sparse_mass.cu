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
//    then tile offset), then its strip row's first two groups (16-byte
//    loads, 4 per lane: the whole 1024-column bf16 strip) and its share of the slot's tgt/rvu slab (which goes to
//    shared memory, shared by the block's rows); only then, while they are
//    in flight, does it write its row of zeros straight to device memory
//    with 16-byte stores (no shared-memory staging), so the reads are not
//    queued behind 8 MB of stores;
//  - each warp then adds its nonzero products in a fixed column order
//    (the strip row `KrtSlabRow` of sparse_row.cuh, shared with the fused
//    mass+score kernel): a per-warp list in shared memory, its slab columns
//    resolved from the shared slab a whole list at a time, grouped by
//    column with one match instruction, the group's lowest lane summing in
//    lane order and writing the column (a plain store in the row's first
//    round, read-add-write after it). No atomics, so M is the same on every run for any weights;
//    for integer weights and replica counts every partial sum is exact and
//    M equals the plain version (an f32 product) bit for bit.
//
// The hub kernel takes the same design over a longer row. One warp writes
// each row of M: 256 rows of each of the group's output blocks (about 1024
// warps at the 50k graph's groups of 4 hub blocks); a CUDA block's rows
// share one output block. The Pallas grid's sequential
// walk over the flat tile list becomes each row's own walk:
//  - the block's first warp scans the list (tens of tiles) for the tiles
//    of its output block and keeps, in shared memory, those from the last
//    one flagged tile_first on, in list order: the Pallas kernel resets its
//    sum there, and the earlier tiles add nothing;
//  - each warp then streams its row across those tiles as one row of
//    vectors (tiles in list order, each tile's columns in order) through
//    two register buffers (kLongRowDepth = 8 vectors per lane each, the
//    next group in flight while the warp lists the current one), its zeros
//    stored to device memory while the first two groups are in flight;
//  - the nonzero weights are listed as (slab column, weight), and the
//    group-local slab (tgt_l, rvu_l) is read from device memory a whole
//    list at a time, when the list is added in order (the row's state
//    carried from tile to tile), no atomics. The slab is not staged in
//    shared memory: its reads are one round per list of up to 256 products,
//    and all the listing and adding together cost 0.004 ms of the
//    kernel's 0.016 (on weights with every row of more than 32 nonzeros
//    cleared, against all-zero weights; `bench.mass_sweep`, PERF.md §6).
// So the hub mass too is the same on every run for any weights, and equals
// the plain version bit for bit for integer ones. Bound: bytes, the group's
// W tiles read once (about 5 MB at the 50k graph) and M written (8.2 MB at
// 4 blocks x 256 rows x 2000 nodes): 0.0040 ms. What holds it back is its
// densest rows (up to 621 nonzero weights, a hub's own row): one warp lists
// and adds them alone, each round of 32 after a list's first reading its
// columns back from device memory, 0.006 ms past the other rows.

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
  // the strip row's first two groups and the slot's slab ...
  const KrtSlabRow<T> strip{W + static_cast<long long>(row % kBlockR) * ld +
                                static_cast<long long>(toff[blocks[slot]]) * bu,
                            U / VEC, s_tgt, s_rvu, nn};
  int4 a[kStripDepth], b[kStripDepth];
  krt_load_group<kStripDepth>(strip, 0, lane, a);
  krt_load_group<kStripDepth>(strip, kStripDepth * 32, lane, b);
  const int* tg = tgt_c + static_cast<long long>(slot) * U;
  const float* rv = rvu_c + static_cast<long long>(slot) * U;
  int t_reg[kSlabBatch];
  float r_reg[kSlabBatch];
#pragma unroll
  for (int k = 0; k < kSlabBatch; ++k) {
    const int i = k * blockDim.x + threadIdx.x;
    t_reg[k] = i < U ? tg[i] : 0;
    r_reg[k] = i < U ? rv[i] : 0.0f;
  }
  // ... then, while they are in flight, the row of zeros straight to device
  // memory (nothing waits on these stores) ...
  krt_zero_row(out, nn, lane);
  // ... and the slab into shared memory (its first batch from registers)
  for (int i0 = 0; i0 < U; i0 += kSlabBatch * blockDim.x) {
#pragma unroll
    for (int k = 0; k < kSlabBatch; ++k) {
      const int i = i0 + k * blockDim.x + threadIdx.x;
      if (i0 > 0) {
        t_reg[k] = i < U ? tg[i] : 0;
        r_reg[k] = i < U ? rv[i] : 0.0f;
      }
      if (i < U) {
        s_tgt[i] = t_reg[k];
        s_rvu[i] = r_reg[k];
      }
    }
  }
  __syncthreads();  // the slab is in shared memory

  krt_stream_row<T, kStripDepth>(strip, a, b, lists + warp * kList, out, lane);
}

// The hub row (sparse_row.cuh): the row's tiles (W column
// tile, slab column tile) in walk order, `vpt` 16-byte vectors each; vector
// v lies in tile v / vpt (streamed: read once). The key of its element e is
// the element's column u in the group-local slab (`krt_slab_term`).
template <typename T>
struct HubRow {
  static constexpr int VEC = 16 / sizeof(T);
  const T* w;          // W row of this output row, at column 0
  const int2* tiles;   // shared: (tile_col, tile_lcol) of the walk's tiles
  int vpt;
  int vecs;            // tiles x vpt
  int bu;
  const int* tgt;
  const float* rvu;
  int nn;

  __device__ __forceinline__ int4 load(int v) const {
    if (v >= vecs) return make_int4(0, 0, 0, 0);
    const int k = v / vpt;
    const long long col = static_cast<long long>(tiles[k].x) * bu + (v - k * vpt) * VEC;
    return __ldcs(reinterpret_cast<const int4*>(w + col));
  }

  __device__ __forceinline__ int key(int v, int e) const {
    const int k = v / vpt;
    return tiles[k].y * bu + (v - k * vpt) * VEC + e;
  }

  __device__ __forceinline__ void resolve(int u, float x, int& col, float& prod) const {
    krt_slab_term<T>(__ldg(tgt + u), __ldg(rvu + u), x, nn, col, prod);
  }
};

// Shared layout: one product list per warp, int2[32 * VEC] each | the walk's
// tiles, int2[n_tiles] | their count, int: warps * 256 * VEC + 8 n_tiles + 16
// bytes.
template <typename T>
__global__ void __launch_bounds__(kLongRowWarps * 32)
hub_mass_kernel(const T* __restrict__ W, long long ld, const int* __restrict__ tgt_l,
                const float* __restrict__ rvu_l, const int* __restrict__ tile_col,
                const int* __restrict__ tile_lcol, const int* __restrict__ tile_out,
                const int* __restrict__ tile_first, int n_tiles, int bu, int nn,
                float* __restrict__ M) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kList = krt_list_len<T>();
  extern __shared__ __align__(16) unsigned char shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int warps = kLongRowWarps;
  int2* lists = reinterpret_cast<int2*>(shared);
  int2* tiles = lists + warps * kList;
  int* s_count = reinterpret_cast<int*>(tiles + n_tiles);
  const int row = blockIdx.x * warps + warp;  // the block's rows share one output block
  const int o = row / kBlockR;

  if (warp == 0) {
    // the output block's tiles from its last first-flagged one on, in list
    // order: a first-flagged tile restarts the walk
    int count = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      int out_t = -1, first_t = 0, col_t = 0, lcol_t = 0;
      if (t < n_tiles) {
        out_t = tile_out[t];
        first_t = tile_first[t];
        col_t = tile_col[t];
        lcol_t = tile_lcol[t];
      }
      const bool mine = out_t == o;
      const unsigned firsts = __ballot_sync(kFull, mine && first_t != 0);
      unsigned take = __ballot_sync(kFull, mine);
      if (firsts) {
        count = 0;
        take &= ~0u << (31 - __clz(firsts));
      }
      if ((take >> lane) & 1u) {
        tiles[count + __popc(take & ((1u << lane) - 1u))] = make_int2(col_t, lcol_t);
      }
      count += __popc(take);
    }
    if (lane == 0) *s_count = count;
  }
  __syncthreads();  // the walk's tiles are in shared memory

  const HubRow<T> strip{W + static_cast<long long>(row % kBlockR) * ld, tiles, bu / VEC,
                        *s_count * (bu / VEC), bu, tgt_l, rvu_l, nn};
  constexpr int G = kLongRowDepth;
  int4 a[G], b[G];
  krt_load_group<G>(strip, 0, lane, a);
  krt_load_group<G>(strip, G * 32, lane, b);
  float* out = M + static_cast<long long>(row) * nn;
  krt_zero_row(out, nn, lane);
  krt_stream_row<T, G>(strip, a, b, lists + warp * kList, out, lane);
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
               const int* tile_first, int n_tiles, int n_out, int bu, int nn, int grid,
               int smem, float* M, cudaStream_t stream) {
  // the wrapper's geometry (`hub_mass_geometry`): whole blocks of
  // kLongRowWarps rows of one output block, the product lists and the tile
  // table in shared memory
  constexpr int VEC = 16 / sizeof(T);
  const long long want = kLongRowWarps * krt_list_len<T>() * 8LL + 8LL * n_tiles + 16;
  if (static_cast<long long>(grid) * kLongRowWarps != static_cast<long long>(n_out) * kBlockR ||
      n_out < 1 || n_tiles < 0 || bu % VEC || nn < 1 || smem != want) {
    return cudaErrorInvalidValue;
  }
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(hub_mass_kernel<T>, smem, &granted);
  if (err != cudaSuccess) return err;
  hub_mass_kernel<T><<<grid, kLongRowWarps * 32, smem, stream>>>(
      static_cast<const T*>(W), ld, tgt_l, rvu_l, tile_col, tile_lcol, tile_out, tile_first,
      n_tiles, bu, nn, M);
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
// f32[n_out * 256, nn] output. grid and smem: the wrapper's launch geometry
// (`hub_mass_geometry`).
KRT_EXPORT int krt_hub_mass_launch(int device, const void* W, int w_is_bf16, long long ld,
                                   const int* tgt_l, const float* rvu_l, const int* tile_col,
                                   const int* tile_lcol, const int* tile_out,
                                   const int* tile_first, int n_tiles, int n_out, int bu, int nn,
                                   int grid, int smem, float* M, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return w_is_bf16 ? launch_hub<__nv_bfloat16>(W, ld, tgt_l, rvu_l, tile_col, tile_lcol,
                                               tile_out, tile_first, n_tiles, n_out, bu, nn,
                                               grid, smem, M, s)
                   : launch_hub<float>(W, ld, tgt_l, rvu_l, tile_col, tile_lcol, tile_out,
                                       tile_first, n_tiles, n_out, bu, nn, grid, smem, M, s);
}

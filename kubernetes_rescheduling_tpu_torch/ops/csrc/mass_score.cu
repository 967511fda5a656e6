// Fused sparse neighbor mass + score for one regular chunk: replaces the
// Pallas kernel `sparse_mass_score` / `_chunk_mass_score_kernel` in
// kubernetes_rescheduling_tpu/ops/sparse_mass.py. It computes the chunk
// mass of sparse_mass.cu, multiplies each row by its replica factor
// rv_row, and reduces it to the score stage's (prop, gain, wants,
// slack_cpu, slack_mem) in the same launch: the [C, N] mass never reaches
// device memory. Its outputs feed the admission kernel.
//
// The Pallas kernel keeps a [256, N] f32 scratch in VMEM (2 MB at N =
// 2000), which does not fit the 227 KB of shared memory a Hopper block can
// use. So a CUDA block owns `rows` rows of one 256-row block: it
// accumulates their mass in shared memory with the same step as the chunk
// mass kernel (`krt_accumulate_tile`), scales the rows, and scores them,
// one warp per row, with the same body as the score kernel
// (`krt_score_row`): decisions equal the two-kernel path's by
// construction.
//
// Seed law: the noise seed is seed + i for block slot i of the chunk (the
// standalone score kernel tiled at 256 rows gives the same), and the
// mixer's row index is the row within the 256-row block, not within this
// CUDA block's sub-tile: the block that owns rows 8..15 of slot i feeds
// rows 8..15.
//
// Bound on the card: operations. It reads the chunk's W strips once (2.1
// MB of bf16 at the 50k graph) and writes 5 x C values; the score body
// does about 30 f32 operations per (row, node) pair with noise on, C x N =
// 1024 x 2000 of them.
//
// Exactness: see sparse_tile.cuh (mass) and score_core.cuh (score).

#include "score_core.cuh"
#include "sparse_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kSparseThreads)
mass_score_kernel(const T* __restrict__ W, long long ld, const int* __restrict__ tgt_c,
                  const float* __restrict__ rvu_c, const int* __restrict__ blocks,
                  const int* __restrict__ toff, const float* __restrict__ rv_row, int bu,
                  int reg_tiles, int rows, const int* __restrict__ cur,
                  const int* __restrict__ home, const float* __restrict__ pen,
                  const float* __restrict__ c_cpu, const float* __restrict__ c_mem,
                  const uint8_t* __restrict__ valid, const float* __restrict__ cpu_load,
                  const float* __restrict__ mem_load, const float* __restrict__ cap,
                  const float* __restrict__ mem_cap, const uint8_t* __restrict__ node_valid,
                  float lam, float ow, float temp, int seed, int N, int enforce_capacity,
                  int use_noise, int use_move_pen, int* __restrict__ prop_out,
                  float* __restrict__ gain_out, int* __restrict__ wants_out,
                  float* __restrict__ slack_cpu_out, float* __restrict__ slack_mem_out) {
  extern __shared__ float acc[];  // [rows, N]
  const int subtiles = kBlockR / rows;
  const int slot = blockIdx.x / subtiles;
  const int row0 = (blockIdx.x % subtiles) * rows;
  krt_zero(acc, rows * N);
  __syncthreads();
  const long long tile0 = toff[blocks[slot]];
  for (int j = 0; j < reg_tiles; ++j) {
    const long long lcol = static_cast<long long>(slot * reg_tiles + j) * bu;
    krt_accumulate_tile(W, ld, row0, rows, (tile0 + j) * bu, tgt_c + lcol, rvu_c + lcol, bu, N,
                        acc);
  }
  __syncthreads();
  // the row replica factor, as the Pallas kernel's m_scr * rv_row
  const int base = slot * kBlockR + row0;
  for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
    acc[i] = __fmul_rn(acc[i], rv_row[base + i / N]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t block_seed = static_cast<uint32_t>(seed) + static_cast<uint32_t>(slot);
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    krt_score_row(acc + r * N, base + r, block_seed, static_cast<uint32_t>(row0 + r), lane, cur,
                  home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap, node_valid,
                  lam, ow, temp, N, enforce_capacity, use_noise, use_move_pen, prop_out,
                  gain_out, wants_out, slack_cpu_out, slack_mem_out);
  }
}

}  // namespace

// W, tgt_c, rvu_c, blocks, toff as krt_sparse_mass_launch; rv_row: f32[C]
// with C = n_slots * 256; the score operands as krt_score_launch.
KRT_EXPORT int krt_mass_score_launch(
    int device, const void* W, int w_is_bf16, long long ld, const int* tgt_c,
    const float* rvu_c, const int* blocks, const int* toff, const float* rv_row, int n_slots,
    int bu, int reg_tiles, int rows, const int* cur, const int* home, const float* pen,
    const float* c_cpu, const float* c_mem, const uint8_t* valid, const float* cpu_load,
    const float* mem_load, const float* cap, const float* mem_cap, const uint8_t* node_valid,
    float lam, float ow, float temp, int seed, int N, int enforce_capacity, int use_noise,
    int use_move_pen, int* prop, float* gain, int* wants, float* slack_cpu, float* slack_mem,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(rows) * N * sizeof(float);
  const int grid = n_slots * (kBlockR / rows);
  auto s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    static size_t granted = 48 * 1024;
    err = krt_allow_smem(mass_score_kernel<__nv_bfloat16>, smem, &granted);
    if (err != cudaSuccess) return err;
    mass_score_kernel<__nv_bfloat16><<<grid, kSparseThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(W), ld, tgt_c, rvu_c, blocks, toff, rv_row, bu,
        reg_tiles, rows, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap,
        node_valid, lam, ow, temp, seed, N, enforce_capacity, use_noise, use_move_pen, prop,
        gain, wants, slack_cpu, slack_mem);
  } else {
    static size_t granted = 48 * 1024;
    err = krt_allow_smem(mass_score_kernel<float>, smem, &granted);
    if (err != cudaSuccess) return err;
    mass_score_kernel<float><<<grid, kSparseThreads, smem, s>>>(
        static_cast<const float*>(W), ld, tgt_c, rvu_c, blocks, toff, rv_row, bu, reg_tiles,
        rows, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap,
        node_valid, lam, ow, temp, seed, N, enforce_capacity, use_noise, use_move_pen, prop,
        gain, wants, slack_cpu, slack_mem);
  }
  return cudaGetLastError();
}

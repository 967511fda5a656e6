// Chunk score -> first-max proposal -> per-row reductions: replaces the
// Pallas kernel `fused_score_admission` / `_score_kernel` (body
// `score_core`) in kubernetes_rescheduling_tpu/ops/fused_admission.py.
// The per-row body is `krt_score_row` (score_core.cuh), shared with the
// sparse fused mass+score kernel.
//
// Bound on the card: bytes. It reads the C x N mass block once (4.1 MB at
// C = 1024, N = 1000) and does about 20 f32 operations per element, far
// below the card's operation rate. Design: one warp per row; lanes stride
// over the row's columns (coalesced reads of M), each lane carries its
// (max value, lowest column) pair, and a shuffle reduction merges the
// pairs with the same tie rule. The score block never reaches device
// memory.
//
// Seed law: tile t = row / block_c uses seed + t, and the mixer's row
// index is the row within the tile.

#include "score_core.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
score_kernel(const float* __restrict__ M, const int* __restrict__ cur,
             const int* __restrict__ home, const float* __restrict__ pen,
             const float* __restrict__ c_cpu, const float* __restrict__ c_mem,
             const uint8_t* __restrict__ valid, const float* __restrict__ cpu_load,
             const float* __restrict__ mem_load, const float* __restrict__ cap,
             const float* __restrict__ mem_cap, const uint8_t* __restrict__ node_valid,
             float lam, float ow, float temp, int seed, int C, int N, int block_c,
             int enforce_capacity, int use_noise, int use_move_pen,
             int* __restrict__ prop_out, float* __restrict__ gain_out,
             int* __restrict__ wants_out, float* __restrict__ slack_cpu_out,
             float* __restrict__ slack_mem_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= C) return;  // whole warp exits together
  const uint32_t tile_seed = static_cast<uint32_t>(seed) + static_cast<uint32_t>(row / block_c);
  const uint32_t tile_row = static_cast<uint32_t>(row % block_c);
  krt_score_row(M + static_cast<long long>(row) * N, row, tile_seed, tile_row, lane, cur, home,
                pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap, node_valid, lam, ow,
                temp, N, enforce_capacity, use_noise, use_move_pen, prop_out, gain_out,
                wants_out, slack_cpu_out, slack_mem_out);
}

}  // namespace

// Row vectors [C]: cur, home (i32), pen, c_cpu, c_mem (f32), valid (u8).
// Node vectors [N]: cpu_load, mem_load, cap, mem_cap (f32), node_valid (u8).
// Outputs [C]: prop (i32), gain (f32), wants (i32), slack_cpu, slack_mem (f32).
KRT_EXPORT int krt_score_launch(int device, const float* M, const int* cur, const int* home,
                                const float* pen, const float* c_cpu, const float* c_mem,
                                const uint8_t* valid, const float* cpu_load,
                                const float* mem_load, const float* cap, const float* mem_cap,
                                const uint8_t* node_valid, float lam, float ow, float temp,
                                int seed, int C, int N, int block_c, int enforce_capacity,
                                int use_noise, int use_move_pen, int* prop, float* gain,
                                int* wants, float* slack_cpu, float* slack_mem, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (C + kWarps - 1) / kWarps;
  score_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      M, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap, node_valid,
      lam, ow, temp, seed, C, N, block_c, enforce_capacity, use_noise, use_move_pen, prop,
      gain, wants, slack_cpu, slack_mem);
  return cudaGetLastError();
}

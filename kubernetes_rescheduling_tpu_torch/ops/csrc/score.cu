// Chunk score -> first-max proposal -> per-row reductions: replaces the
// Pallas kernel `fused_score_admission` / `_score_kernel` (body
// `score_core`) in kubernetes_rescheduling_tpu/ops/fused_admission.py.
// The body is `krt_score_tile` (score_core.cuh), shared with the sparse
// fused mass+score kernel; its note gives the bound and the design.
//
// Grid: one CUDA block per tile of R consecutive rows of M (the last tile
// may be partial), `threads` threads each; the wrapper's `score_geometry`
// picks R and the threads so that about 32 warps run on each SM at the
// solvers' chunk of 1024 rows. The score block never reaches device
// memory.
//
// Seed law: tile t = row / block_c uses seed + t, and the mixer's row
// index is the row within the tile. The seed and the temperature are read
// from device memory, so a captured solve replays with the values its
// buffers hold at each replay.

#include "score_core.cuh"

namespace {

template <int R, bool NOISE>
__global__ void __launch_bounds__(kScoreMaxThreads, 4)
score_kernel(const float* __restrict__ M, const int* __restrict__ cur,
             const int* __restrict__ home, const float* __restrict__ pen,
             const float* __restrict__ c_cpu, const float* __restrict__ c_mem,
             const uint8_t* __restrict__ valid, const float* __restrict__ cpu_load,
             const float* __restrict__ mem_load, const float* __restrict__ cap,
             const float* __restrict__ mem_cap, const uint8_t* __restrict__ node_valid,
             float lam, float ow, const float* __restrict__ temp_p,
             const int* __restrict__ seed_p, int C, int N, int block_c, int enforce_capacity,
             int use_move_pen, int vec_ok, int* __restrict__ prop_out,
             float* __restrict__ gain_out, int* __restrict__ wants_out,
             float* __restrict__ slack_cpu_out, float* __restrict__ slack_mem_out) {
  __shared__ KrtScoreShared<R> sh;
  const int g0 = blockIdx.x * R;
  const int nr = min(R, C - g0);
  const float temp = NOISE ? *temp_p : 0.0f;
  krt_score_stage(sh, g0, nr, cur, home, pen, c_cpu, c_mem, static_cast<uint32_t>(*seed_p),
                  block_c);
  __syncthreads();
  krt_score_tile<R, NOISE>(sh, M + static_cast<long long>(g0) * N, N, vec_ok != 0, g0, nr,
                           valid, cpu_load, mem_load, cap, mem_cap, node_valid, lam, ow, temp,
                           N, enforce_capacity, use_move_pen, prop_out, gain_out, wants_out,
                           slack_cpu_out, slack_mem_out);
}

template <int R, bool NOISE>
cudaError_t launch(int threads, int blocks, cudaStream_t s, const float* M, const int* cur,
                   const int* home, const float* pen, const float* c_cpu, const float* c_mem,
                   const uint8_t* valid, const float* cpu_load, const float* mem_load,
                   const float* cap, const float* mem_cap, const uint8_t* node_valid, float lam,
                   float ow, const float* temp, const int* seed, int C, int N, int block_c,
                   int enforce_capacity, int use_move_pen, int vec_ok, int* prop, float* gain,
                   int* wants, float* slack_cpu, float* slack_mem) {
  score_kernel<R, NOISE><<<blocks, threads, 0, s>>>(
      M, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap, node_valid,
      lam, ow, temp, seed, C, N, block_c, enforce_capacity, use_move_pen, vec_ok, prop, gain,
      wants, slack_cpu, slack_mem);
  return cudaGetLastError();
}

}  // namespace

// Row vectors [C]: cur, home (i32), pen, c_cpu, c_mem (f32), valid (u8).
// Node vectors [N]: cpu_load, mem_load, cap, mem_cap (f32), node_valid (u8).
// temp (f32) and seed (i32): one value each, in device memory.
// Outputs [C]: prop (i32), gain (f32), wants (i32), slack_cpu, slack_mem (f32).
// threads, rows, blocks: the wrapper's launch geometry (`score_geometry`);
// vec_ok: M is 16-byte aligned and N a multiple of 4.
KRT_EXPORT int krt_score_launch(int device, const float* M, const int* cur, const int* home,
                                const float* pen, const float* c_cpu, const float* c_mem,
                                const uint8_t* valid, const float* cpu_load,
                                const float* mem_load, const float* cap, const float* mem_cap,
                                const uint8_t* node_valid, float lam, float ow,
                                const float* temp, const int* seed, int C, int N, int block_c,
                                int enforce_capacity,
                                int use_noise, int use_move_pen, int threads, int rows,
                                int blocks, int vec_ok, int* prop, float* gain, int* wants,
                                float* slack_cpu, float* slack_mem, void* stream) {
  if (C < 1 || N < 1 || block_c < 1 || threads < 32 || threads > kScoreMaxThreads ||
      threads % 32 || (rows != 1 && rows != 2) ||
      static_cast<long long>(blocks) * rows < C || static_cast<long long>(blocks - 1) * rows >= C) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto go = rows == 1 ? (use_noise ? &launch<1, true> : &launch<1, false>)
                      : (use_noise ? &launch<2, true> : &launch<2, false>);
  return go(threads, blocks, s, M, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap,
            mem_cap, node_valid, lam, ow, temp, seed, C, N, block_c, enforce_capacity,
            use_move_pen, vec_ok, prop, gain, wants, slack_cpu, slack_mem);
}

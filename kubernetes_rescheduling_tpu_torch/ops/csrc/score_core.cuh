// The score body of one chunk row, shared by score.cu (`score_stage`) and
// mass_score.cu (`sparse_mass_score`): the port of `score_core` in
// kubernetes_rescheduling_tpu/ops/fused_admission.py. Both kernels call
// exactly this function, so the fused kernel's decisions equal the
// two-kernel path's by construction, as in the JAX package.
//
// Per service row c and node column n:
//   proj_pct = (cpu_load[n] + (n == cur ? 0 : c_cpu)) / cap[n] * 100
//   score    = M[c, n] - lam * proj_pct - ow * max(proj_pct - 100, 0)
//              - (n == home ? 0 : pen) + temp * gumbel(seed, c, n)
// masked to -inf where the node is invalid or (with capacity enforcement)
// the service does not fit and it is not the current node. Outputs per
// row: the first-max node `prop` (lowest column among ties, clamped to
// N - 1), `gain` = max - score at the current node (unmasked), `wants`,
// and the CPU / memory slack left at `prop`.
//
// Exactness: every operation is the plain version's operation in the same
// order, written with the round-to-nearest intrinsics so the compiler
// cannot contract a multiply and an add into one fused operation; the
// division is IEEE and the logarithm is `logf`, as in PyTorch's own CUDA
// kernels. The noise is the u32 mixer `_stateless_uniform` of the JAX
// package, bit for bit.
#pragma once

#include "krt_common.cuh"

__device__ __forceinline__ float krt_stateless_uniform(uint32_t seed, uint32_t r, uint32_t c) {
  uint32_t x = seed * 0x9E3779B9u;
  x = x ^ (r * 0x85EBCA6Bu) ^ (c * 0xC2B2AE35u);
  x = x ^ (x >> 16);
  x = x * 0x7FEB352Du;
  x = x ^ (x >> 15);
  x = x * 0x846CA68Bu;
  x = x ^ (x >> 16);
  const float mant = static_cast<float>(x & 0x7FFFFFu);
  return __fmul_rn(__fadd_rn(mant, 0.5f), 1.0f / 8388608.0f);
}

// One warp scores chunk row `row`, whose N masses start at `m_row` (device
// or shared memory). The noise of column n is the mixer at (tile_seed,
// tile_row, n): the caller applies the seed law. The operands are plain
// `__restrict__` arguments, as they were the score kernel's own: nvcc then
// reads them through the read-only data cache and unrolls the loop as it
// did there (carrying them in a struct cost the score kernel 8-19% on the
// card).
__device__ __forceinline__ void krt_score_row(
    const float* __restrict__ m_row, int row, uint32_t tile_seed, uint32_t tile_row, int lane,
    const int* __restrict__ cur, const int* __restrict__ home, const float* __restrict__ pen,
    const float* __restrict__ c_cpu, const float* __restrict__ c_mem,
    const uint8_t* __restrict__ valid, const float* __restrict__ cpu_load,
    const float* __restrict__ mem_load, const float* __restrict__ cap,
    const float* __restrict__ mem_cap, const uint8_t* __restrict__ node_valid, float lam,
    float ow, float temp, int N, int enforce_capacity, int use_noise, int use_move_pen,
    int* __restrict__ prop_out, float* __restrict__ gain_out, int* __restrict__ wants_out,
    float* __restrict__ slack_cpu_out, float* __restrict__ slack_mem_out) {
  const int cu = cur[row];
  const int hm = home[row];
  const float pn = pen[row];
  const float ccpu = c_cpu[row];
  const float cmem = c_mem[row];

  float best = KRT_NEG_INF;
  int best_n = N;
  float cur_score = 0.0f;
  for (int n = lane; n < N; n += 32) {
    const bool is_cur = n == cu;
    const float proj_cpu = __fadd_rn(cpu_load[n], is_cur ? 0.0f : ccpu);
    const float pct = __fmul_rn(__fdiv_rn(proj_cpu, cap[n]), 100.0f);
    float s = __fsub_rn(m_row[n], __fmul_rn(lam, pct));
    s = __fsub_rn(s, __fmul_rn(ow, fmaxf(__fsub_rn(pct, 100.0f), 0.0f)));
    if (use_move_pen) s = __fsub_rn(s, n == hm ? 0.0f : pn);
    if (use_noise) {
      const float u = krt_stateless_uniform(tile_seed, tile_row, static_cast<uint32_t>(n));
      const float g = -logf(-logf(u));
      s = __fadd_rn(s, __fmul_rn(temp, g));
    }
    if (is_cur) cur_score = s;
    bool feasible;
    if (enforce_capacity) {
      const float proj_mem = __fadd_rn(mem_load[n], is_cur ? 0.0f : cmem);
      const bool fits = (proj_cpu <= cap[n]) && (proj_mem <= mem_cap[n]);
      feasible = (fits || is_cur) && node_valid[n] != 0;
    } else {
      feasible = node_valid[n] != 0;
    }
    const float v = feasible ? s : KRT_NEG_INF;
    if (v > best || (v == best && n < best_n)) {
      best = v;
      best_n = n;
    }
  }
  // merge (value, column) pairs: larger value wins, ties -> lower column
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int on = __shfl_down_sync(0xffffffffu, best_n, off);
    if (ov > best || (ov == best && on < best_n)) {
      best = ov;
      best_n = on;
    }
  }
  // the current node's score lives in exactly one lane (none if cur is
  // outside [0, N), where the plain version's masked sum gives 0)
  const bool cur_in = cu >= 0 && cu < N;
  cur_score = __shfl_sync(0xffffffffu, cur_score, cur_in ? (cu & 31) : 0);
  if (!cur_in) cur_score = 0.0f;
  if (lane == 0) {
    const int prop = min(best_n, N - 1);
    const float gain = __fsub_rn(best, cur_score);
    prop_out[row] = prop;
    gain_out[row] = gain;
    wants_out[row] = (valid[row] != 0 && gain > 0.0f && prop != cu) ? 1 : 0;
    slack_cpu_out[row] = __fsub_rn(__fsub_rn(cap[prop], cpu_load[prop]), ccpu);
    slack_mem_out[row] = __fsub_rn(__fsub_rn(mem_cap[prop], mem_load[prop]), cmem);
  }
}

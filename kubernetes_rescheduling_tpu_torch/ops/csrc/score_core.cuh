// The score body of a tile of chunk rows, shared by score.cu (`score_stage`)
// and mass_score.cu (`sparse_mass_score`): the port of `score_core` in
// kubernetes_rescheduling_tpu/ops/fused_admission.py. Both kernels call
// exactly this routine, so the fused kernel's decisions equal the
// two-kernel path's by construction, as in the JAX package.
//
// Per service row c and node column n:
//   proj_pct = (cpu_load[n] + (n == cur ? 0 : c_cpu)) / cap[n] * 100
//   score    = M[c, n] - lam * proj_pct - ow * max(proj_pct - 100, 0)
//              - (n == home ? 0 : pen) + temp * gumbel(seed, c, n)
// masked to -inf where the node is invalid or (with capacity enforcement)
// the service does not fit and it is not the current node. Outputs per
// row: the first-max node `prop` (lowest column among ties, clamped to
// N - 1), `gain` = max - score at the current node (unmasked; 0 when the
// current node is outside [0, N)), `wants`, and the CPU / memory slack
// left at `prop`.
//
// Exactness: every operation is the plain version's operation in the same
// order, written with the round-to-nearest intrinsics so the compiler
// cannot contract a multiply and an add into one fused operation; the
// division is IEEE and the logarithm is `logf`, as in PyTorch's own CUDA
// kernels. The noise is the u32 mixer `_stateless_uniform` of the JAX
// package, bit for bit.
//
// Bound on the card: operations. Per (row, node) pair the function needs an
// IEEE division (MUFU.RCP, its FFMA refinement and the range check FCHK),
// with noise the mixer (two IMAD multiplies and its shifts) and two `logf`
// (in nvcc's SASS for sm_90a a polynomial of FFMAs, no MUFU), and about 22
// adds, compares and selects; it reads 4 bytes of mass. So the instructions
// issued bound it (`score_bound` in chip_smoke.py counts them), and the
// design keeps many independent pairs in flight:
//  - the whole CUDA block scores a tile of R rows (R = 1 or 2). Each thread
//    owns groups of 4 consecutive columns, one group in each panel of
//    4 x blockDim.x columns; it loads a group's node values and its
//    column share of the mixer (n * 0xC2B2AE35) once, and reuses them for
//    every row of the tile;
//  - the tile's per-row scalars (cur, home, pen, c_cpu, c_mem and the row's
//    share of the mixer) are staged in shared memory once, in a step of
//    their own (`krt_score_stage`), so the fused kernel issues those loads
//    before its mass phase;
//  - per panel a thread first issues its R masses (a 16-byte load per row
//    where rows are 16-byte aligned, else four scalar loads), then scores
//    its 4 x R pairs, none of which depends on another (whole groups take
//    a copy of the loop without bounds checks);
//  - each thread keeps, per row, the (value, lowest column) pair of its own
//    columns; a shuffle tree merges the pairs of a warp and one thread per
//    row merges the warps' pairs from shared memory, with the same rule
//    (larger value wins, ties to the lower column). The rule is
//    associative and commutative, so any tree gives the plain version's
//    first max. The one thread that owns column `cur` keeps the row's
//    unmasked current score in a register and passes it on through shared
//    memory.
// The launch geometry (threads, rows per tile) is chosen in Python:
// `score_geometry` in ops/fused_admission.py.
#pragma once

#include "krt_common.cuh"

constexpr int kScoreMaxThreads = 256;  // threads of a score tile, at most
constexpr int kScoreCols = 4;          // consecutive columns a thread owns in each panel

// The mixer from its combined (seed, row, column) word on: `x` is
// seed * 0x9E3779B9 ^ row * 0x85EBCA6B ^ column * 0xC2B2AE35.
__device__ __forceinline__ float krt_mix_uniform(uint32_t x) {
  x = x ^ (x >> 16);
  x = x * 0x7FEB352Du;
  x = x ^ (x >> 15);
  x = x * 0x846CA68Bu;
  x = x ^ (x >> 16);
  const float mant = static_cast<float>(x & 0x7FFFFFu);
  return __fmul_rn(__fadd_rn(mant, 0.5f), 1.0f / 8388608.0f);
}

// The tile's per-row scalars and the merge's partial results, in shared
// memory. A kernel declares one and hands it to both steps below.
template <int R>
struct KrtScoreShared {
  int cur[R], home[R];
  float pen[R], c_cpu[R], c_mem[R], cur_score[R];
  uint32_t mix[R];
  float best[kScoreMaxThreads / 32][R];
  int best_n[kScoreMaxThreads / 32][R];
};

// Step 1: stages rows g0 .. g0 + nr - 1 (nr <= R) into `sh`, reading row
// g0 + r's scalars at index src0 + r (src0 = g0 for a chunk's own [C]
// vectors; the fused kernel read in place passes the rows' service ids);
// a null `home` is the row's `cur`, a null `pen` zero. Row g draws its
// noise with the seed law of both kernels: tile seed seed + g / block_c,
// mixer row g % block_c. Needs a __syncthreads() before step 2.
template <int R>
__device__ __forceinline__ void krt_score_stage(KrtScoreShared<R>& sh, int g0, int src0, int nr,
                                                const int* __restrict__ cur,
                                                const int* __restrict__ home,
                                                const float* __restrict__ pen,
                                                const float* __restrict__ c_cpu,
                                                const float* __restrict__ c_mem, uint32_t seed,
                                                int block_c) {
  const int tid = threadIdx.x;
  if (tid < R) {
    const bool live = tid < nr;
    const int g = g0 + tid;
    const int src = src0 + tid;
    const int c = live ? cur[src] : -1;
    sh.cur[tid] = c;
    sh.home[tid] = !live ? -1 : home != nullptr ? home[src] : c;
    sh.pen[tid] = live && pen != nullptr ? pen[src] : 0.0f;
    sh.c_cpu[tid] = live ? c_cpu[src] : 0.0f;
    sh.c_mem[tid] = live ? c_mem[src] : 0.0f;
    const uint32_t tile_seed = seed + static_cast<uint32_t>(g / block_c);
    const uint32_t tile_row = static_cast<uint32_t>(g % block_c);
    sh.mix[tid] = (tile_seed * 0x9E3779B9u) ^ (tile_row * 0x85EBCA6Bu);
    sh.cur_score[tid] = 0.0f;  // stays 0 when cur is outside [0, N)
  }
}

// One (row, column) pair: the score, its mask, the row's running first max
// and, at the current node, the unmasked score.
template <bool NOISE>
__device__ __forceinline__ void krt_score_pair(
    int n, float m, float cl, float cp, float ml, float mc, bool nv, uint32_t cmix, int cu,
    int hm, float pn, float ccpu, float cmem, uint32_t rmix, float lam, float ow, float temp,
    int enforce_capacity, int use_move_pen, float& best, int& best_n, float& cur_s) {
  const bool is_cur = n == cu;
  const float proj_cpu = __fadd_rn(cl, is_cur ? 0.0f : ccpu);
  const float pct = __fmul_rn(__fdiv_rn(proj_cpu, cp), 100.0f);
  float s = __fsub_rn(m, __fmul_rn(lam, pct));
  s = __fsub_rn(s, __fmul_rn(ow, fmaxf(__fsub_rn(pct, 100.0f), 0.0f)));
  if (use_move_pen) s = __fsub_rn(s, n == hm ? 0.0f : pn);
  if (NOISE) {
    const float u = krt_mix_uniform(rmix ^ cmix);
    const float g = -logf(-logf(u));
    s = __fadd_rn(s, __fmul_rn(temp, g));
  }
  cur_s = is_cur ? s : cur_s;
  bool feasible;
  if (enforce_capacity) {
    const float proj_mem = __fadd_rn(ml, is_cur ? 0.0f : cmem);
    const bool fits = (proj_cpu <= cp) && (proj_mem <= mc);
    feasible = (fits || is_cur) && nv;
  } else {
    feasible = nv;
  }
  const float v = feasible ? s : KRT_NEG_INF;
  if (v > best || (v == best && n < best_n)) {
    best = v;
    best_n = n;
  }
}

// Step 2: scores the staged rows with the whole block. Row r's N masses
// start at m + r * ldm (device or shared memory); `vec_ok` says that m and
// ldm allow 16-byte loads. Row g0 + r's flag is valid[src0 + r], as in step
// 1; its outputs go to index g0 + r.
template <int R, bool NOISE>
__device__ __forceinline__ void krt_score_tile(
    KrtScoreShared<R>& sh, const float* m, int ldm, bool vec_ok, int g0, int src0, int nr,
    const uint8_t* __restrict__ valid, const float* __restrict__ cpu_load,
    const float* __restrict__ mem_load, const float* __restrict__ cap,
    const float* __restrict__ mem_cap, const uint8_t* __restrict__ node_valid, float lam,
    float ow, float temp, int N, int enforce_capacity, int use_move_pen,
    int* __restrict__ prop_out, float* __restrict__ gain_out, int* __restrict__ wants_out,
    float* __restrict__ slack_cpu_out, float* __restrict__ slack_mem_out) {
  const int tid = threadIdx.x;
  int cu[R], hm[R];
  float pn[R], ccpu[R], cmem[R], best[R], cur_s[R];
  uint32_t rmix[R];
  int best_n[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cu[r] = sh.cur[r];
    hm[r] = sh.home[r];
    pn[r] = sh.pen[r];
    ccpu[r] = sh.c_cpu[r];
    cmem[r] = sh.c_mem[r];
    rmix[r] = sh.mix[r];
    best[r] = KRT_NEG_INF;
    best_n[r] = N;
    cur_s[r] = 0.0f;
  }
  for (int base = tid * kScoreCols; base < N; base += kScoreCols * blockDim.x) {
    const bool whole = base + kScoreCols <= N;
    // the group's node values and column shares, for every row of the tile
    float cl[kScoreCols], cp[kScoreCols], ml[kScoreCols], mc[kScoreCols];
    uint32_t cmix[kScoreCols];
    bool nv[kScoreCols];
#pragma unroll
    for (int e = 0; e < kScoreCols; ++e) {
      const int n = base + e;
      const bool in = whole || n < N;
      cl[e] = in ? cpu_load[n] : 0.0f;
      cp[e] = in ? cap[n] : 1.0f;
      ml[e] = in ? mem_load[n] : 0.0f;
      mc[e] = in ? mem_cap[n] : 0.0f;
      nv[e] = in && node_valid[n] != 0;
      cmix[e] = static_cast<uint32_t>(n) * 0xC2B2AE35u;
    }
    // the tile's masses of the group, issued together
    float mv[R][kScoreCols];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* mr = m + static_cast<long long>(r) * ldm + base;
      if (r < nr && whole && vec_ok) {
        const float4 q = *reinterpret_cast<const float4*>(mr);
        mv[r][0] = q.x;
        mv[r][1] = q.y;
        mv[r][2] = q.z;
        mv[r][3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < kScoreCols; ++e) mv[r][e] = (r < nr && base + e < N) ? mr[e] : 0.0f;
      }
    }
    // the 4 x R pairs: a copy without bounds checks for whole groups
    if (whole) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;
#pragma unroll
        for (int e = 0; e < kScoreCols; ++e) {
          krt_score_pair<NOISE>(base + e, mv[r][e], cl[e], cp[e], ml[e], mc[e], nv[e], cmix[e],
                                cu[r], hm[r], pn[r], ccpu[r], cmem[r], rmix[r], lam, ow, temp,
                                enforce_capacity, use_move_pen, best[r], best_n[r], cur_s[r]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= nr) continue;
#pragma unroll
        for (int e = 0; e < kScoreCols; ++e) {
          if (base + e >= N) continue;
          krt_score_pair<NOISE>(base + e, mv[r][e], cl[e], cp[e], ml[e], mc[e], nv[e], cmix[e],
                                cu[r], hm[r], pn[r], ccpu[r], cmem[r], rmix[r], lam, ow, temp,
                                enforce_capacity, use_move_pen, best[r], best_n[r], cur_s[r]);
        }
      }
    }
  }

  // merge (value, column) pairs: larger value wins, ties -> lower column
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // the current node's score lives with the one thread owning its column
    if (cu[r] >= 0 && cu[r] < N && (cu[r] / kScoreCols) % blockDim.x == tid) {
      sh.cur_score[r] = cur_s[r];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best[r], off);
      const int on = __shfl_down_sync(0xffffffffu, best_n[r], off);
      if (ov > best[r] || (ov == best[r] && on < best_n[r])) {
        best[r] = ov;
        best_n[r] = on;
      }
    }
    if (lane == 0) {
      sh.best[warp][r] = best[r];
      sh.best_n[warp][r] = best_n[r];
    }
  }
  __syncthreads();
  if (tid < nr) {
    const int r = tid;
    float b = sh.best[0][r];
    int bn = sh.best_n[0][r];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      const float ov = sh.best[w][r];
      const int on = sh.best_n[w][r];
      if (ov > b || (ov == b && on < bn)) {
        b = ov;
        bn = on;
      }
    }
    const int g = g0 + r;
    const int prop = min(bn, N - 1);
    const float gain = __fsub_rn(b, sh.cur_score[r]);
    prop_out[g] = prop;
    gain_out[g] = gain;
    wants_out[g] = (valid[src0 + r] != 0 && gain > 0.0f && prop != sh.cur[r]) ? 1 : 0;
    slack_cpu_out[g] = __fsub_rn(__fsub_rn(cap[prop], cpu_load[prop]), sh.c_cpu[r]);
    slack_mem_out[g] = __fsub_rn(__fsub_rn(mem_cap[prop], mem_load[prop]), sh.c_mem[r]);
  }
}

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
// use. So a CUDA block owns R rows (R = 1 or 2) of one 256-row block:
//  - mass: one warp per row issues its W strip row, the block zeroes the
//    rows in shared memory, and each of the R warps adds its row's products
//    in the chunk mass kernel's fixed order (the strip row `KrtSlabRow` of
//    sparse_row.cuh, reading the slot's tgt/rvu slab straight from device
//    memory: a row has a few nonzero products), so the mass equals kernel
//    4's bit for bit for any weights, run after run;
//  - the rows times rv_row, as the Pallas kernel's m_scr * rv_row;
//  - score: the whole block scores the R rows with the score kernel's body
//    (`krt_score_tile`, score_core.cuh): decisions equal the two-kernel
//    path's by construction.
// The wrapper's `mass_score_geometry` picks R and the threads so that the
// score phase runs about 32 warps on each SM at the 50k graph's chunk
// (1024 rows: 512 blocks of 8 warps), where the first port ran 8.
//
// Two read modes, one body (IN_PLACE of mass_score_kernel): gathered, on
// the caller's [KB * U] tgt/rvu slabs and [C] row vectors; and in place,
// the sparse solver's plain sweep, where the kernel reads slot i's slab
// through the block table (the strip's own columns of u_ids and rvu,
// targets from the assignment: `KrtInPlaceSlabRow`) and its rows at their
// service ids blocks[i] * 256 + row, so no gather runs between the chunk
// step's two launches. The products, their order and the seed law are the
// same, so the outputs are too, bit for bit.
//
// Seed law: the noise seed is seed + i for block slot i of the chunk (the
// standalone score kernel tiled at 256 rows gives the same), and the
// mixer's row index is the row within the 256-row block. The seed and the
// temperature are read from device memory, as in score.cu.
//
// Bound on the card: operations, those of the score body (see
// score_core.cuh) over C x N pairs; it reads the chunk's W strips once
// (2.1 MB of bf16 at the 50k graph) and writes 5 x C values.

#include <type_traits>

#include "score_core.cuh"
#include "sparse_row.cuh"

namespace {

// Shared layout: the R mass rows, f32[R, ldm] (ldm = N rounded up to 4, so
// every row is 16-byte aligned) | one product list per mass warp.
//
// IN_PLACE selects the read mode. Gathered: tgt_c / rvu_c hold the chunk's
// [KB * U] slabs and the row operands are the chunk's own [C] vectors. In
// place: tgt_c / rvu_c are the graph's whole u_ids / rvu arrays, read at
// slot i's strip columns toff[blocks[i]] * bu + u, with targets from
// `assign` [spx]; the row operands are the solver's service arrays [spx],
// read at the rows' ids blocks[i] * 256 + row (`cur` is `assign` then, and
// a null `home` / `pen` stands for the row's `cur` / zero).
template <typename T, int R, bool NOISE, bool IN_PLACE>
__global__ void __launch_bounds__(kScoreMaxThreads, 4)
mass_score_kernel(const T* __restrict__ W, long long ld, const int* __restrict__ tgt_c,
                  const float* __restrict__ rvu_c, const int* __restrict__ assign, int spx,
                  const int* __restrict__ blocks, const int* __restrict__ toff,
                  const float* __restrict__ rv_row, int bu, int reg_tiles, int ldm,
                  const int* __restrict__ cur, const int* __restrict__ home,
                  const float* __restrict__ pen, const float* __restrict__ c_cpu,
                  const float* __restrict__ c_mem, const uint8_t* __restrict__ valid,
                  const float* __restrict__ cpu_load, const float* __restrict__ mem_load,
                  const float* __restrict__ cap, const float* __restrict__ mem_cap,
                  const uint8_t* __restrict__ node_valid, float lam, float ow,
                  const float* __restrict__ temp_p, const int* __restrict__ seed_p, int N,
                  int enforce_capacity, int use_move_pen, int* __restrict__ prop_out,
                  float* __restrict__ gain_out, int* __restrict__ wants_out,
                  float* __restrict__ slack_cpu_out, float* __restrict__ slack_mem_out) {
  using Strip = typename std::conditional<IN_PLACE, KrtInPlaceSlabRow<T>, KrtSlabRow<T>>::type;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kList = krt_list_len<T>();
  extern __shared__ __align__(16) unsigned char shared[];
  float* acc = reinterpret_cast<float*>(shared);
  int2* lists = reinterpret_cast<int2*>(acc + R * ldm);
  constexpr int kSubtiles = kBlockR / R;
  const int slot = blockIdx.x / kSubtiles;
  const int row0 = (blockIdx.x % kSubtiles) * R;
  const int g0 = slot * kBlockR + row0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int U = reg_tiles * bu;
  const int block = blocks[slot];
  // the rows' index into the row operands: the chunk row, or the service id
  const int src0 = IN_PLACE ? block * kBlockR + row0 : g0;

  // the long reads first: each mass warp's strip row, the score's row
  // scalars and the row replica factors; then the zeros
  __shared__ KrtScoreShared<R> sh;
  const long long col0 = static_cast<long long>(toff[block]) * bu;
  const T* w_row = W + static_cast<long long>(row0 + warp) * ld + col0;
  Strip strip;
  if constexpr (IN_PLACE) {
    strip = Strip{w_row, U / VEC, tgt_c + col0, rvu_c + col0, assign, spx, N};
  } else {
    const long long slab = static_cast<long long>(slot) * U;
    strip = Strip{w_row, U / VEC, tgt_c + slab, rvu_c + slab, N};
  }
  int4 a[kStripDepth], b[kStripDepth];
  if (warp < R) {
    krt_load_group<kStripDepth>(strip, 0, lane, a);
    krt_load_group<kStripDepth>(strip, kStripDepth * 32, lane, b);
  }
  krt_score_stage(sh, g0, src0, R, cur, home, pen, c_cpu, c_mem,
                  static_cast<uint32_t>(*seed_p), kBlockR);
  const float temp = NOISE ? *temp_p : 0.0f;
  float rv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) rv[r] = rv_row[src0 + r];
  for (int i = threadIdx.x; i < R * ldm; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  if (warp < R) {
    krt_stream_row<T, kStripDepth>(strip, a, b, lists + warp * kList, acc + warp * ldm, lane);
  }
  __syncthreads();
  // the row replica factor, as the Pallas kernel's m_scr * rv_row
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* row = acc + r * ldm;
    for (int c = threadIdx.x; c < N; c += blockDim.x) row[c] = __fmul_rn(row[c], rv[r]);
  }
  __syncthreads();
  krt_score_tile<R, NOISE>(sh, acc, ldm, true, g0, src0, R, valid, cpu_load, mem_load, cap,
                           mem_cap, node_valid, lam, ow, temp, N, enforce_capacity, use_move_pen,
                           prop_out, gain_out, wants_out, slack_cpu_out, slack_mem_out);
}

template <typename T, int R, bool NOISE, bool IN_PLACE>
cudaError_t launch(int grid, int threads, int smem, cudaStream_t s, const void* W,
                   long long ld, const int* tgt_c, const float* rvu_c, const int* assign, int spx,
                   const int* blocks, const int* toff, const float* rv_row, int bu, int reg_tiles,
                   int ldm, const int* cur, const int* home, const float* pen,
                   const float* c_cpu, const float* c_mem, const uint8_t* valid,
                   const float* cpu_load, const float* mem_load, const float* cap,
                   const float* mem_cap, const uint8_t* node_valid, float lam, float ow,
                   const float* temp, const int* seed, int N, int enforce_capacity,
                   int use_move_pen, int* prop, float* gain, int* wants, float* slack_cpu,
                   float* slack_mem) {
  auto kernel = mass_score_kernel<T, R, NOISE, IN_PLACE>;
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const T*>(W), ld, tgt_c, rvu_c, assign, spx, blocks, toff, rv_row, bu,
      reg_tiles, ldm, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap,
      node_valid, lam, ow, temp, seed, N, enforce_capacity, use_move_pen, prop, gain, wants,
      slack_cpu, slack_mem);
  return cudaGetLastError();
}

using LaunchFn = decltype(&launch<float, 1, false, false>);

template <typename T, bool IN_PLACE>
LaunchFn pick(int rows, int use_noise) {
  return rows == 1 ? (use_noise ? &launch<T, 1, true, IN_PLACE> : &launch<T, 1, false, IN_PLACE>)
                   : (use_noise ? &launch<T, 2, true, IN_PLACE> : &launch<T, 2, false, IN_PLACE>);
}

template <typename T>
LaunchFn pick(int rows, int use_noise, bool in_place) {
  return in_place ? pick<T, true>(rows, use_noise) : pick<T, false>(rows, use_noise);
}

}  // namespace

// W, tgt_c, rvu_c, blocks, toff as krt_sparse_mass_launch; rv_row: f32[C]
// with C = n_slots * 256; the score operands (temp and seed in device
// memory) as krt_score_launch. threads, rows, ldm and smem: the wrapper's
// launch geometry (`mass_score_geometry`). With `assign` (i32[spx]) the
// launch reads in place (see mass_score_kernel): tgt_c and rvu_c are then the
// graph's u_ids and rvu, and rv_row, cur (= assign), home, pen, c_cpu,
// c_mem and valid the service arrays of spx entries; home and pen may be
// null. The outputs are [C] in both modes.
KRT_EXPORT int krt_mass_score_launch(
    int device, const void* W, int w_is_bf16, long long ld, const int* tgt_c,
    const float* rvu_c, const int* blocks, const int* toff, const float* rv_row, int n_slots,
    int bu, int reg_tiles, int threads, int rows, int ldm, int smem, const int* cur,
    const int* home, const float* pen, const float* c_cpu, const float* c_mem,
    const uint8_t* valid, const float* cpu_load, const float* mem_load, const float* cap,
    const float* mem_cap, const uint8_t* node_valid, float lam, float ow, const float* temp,
    const int* seed, int N, int enforce_capacity, int use_noise, int use_move_pen, int* prop,
    float* gain, int* wants, float* slack_cpu, float* slack_mem, const int* assign, int spx,
    void* stream) {
  const int list_bytes = 8 * (w_is_bf16 ? krt_list_len<__nv_bfloat16>() : krt_list_len<float>());
  const bool in_place = assign != nullptr;
  if (N < 1 || n_slots < 1 || (rows != 1 && rows != 2) || threads < 32 * rows ||
      threads > kScoreMaxThreads || threads % 32 || ldm < N || ldm % 4 ||
      smem != rows * (ldm * 4 + list_bytes) || (in_place && (spx < 1 || cur != assign)) ||
      (!in_place && (home == nullptr || pen == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = n_slots * (kBlockR / rows);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = w_is_bf16 ? pick<__nv_bfloat16>(rows, use_noise, in_place)
                      : pick<float>(rows, use_noise, in_place);
  return go(grid, threads, smem, s, W, ld, tgt_c, rvu_c, assign, spx, blocks, toff, rv_row, bu,
            reg_tiles, ldm, cur, home, pen, c_cpu, c_mem, valid, cpu_load, mem_load, cap,
            mem_cap, node_valid, lam, ow, temp, seed, N, enforce_capacity, use_move_pen, prop,
            gain, wants, slack_cpu, slack_mem);
}

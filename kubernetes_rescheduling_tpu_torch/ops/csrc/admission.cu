// Pairwise capacity race and commit arithmetic of one solver chunk:
// replaces the Pallas kernel `admission_stage` / `_admission_kernel` in
// kubernetes_rescheduling_tpu/ops/fused_admission.py.
//
// A wanting row i lands on prop[i] only if the slack there covers the
// CPU and memory of every same-target wanting row j that comes before it
// (greater gain, ties -> lower index). Then new_node = admitted ? prop :
// cur, optional one-hot occupancy rows x_rows[C, N], and the per-node net
// load deltas d[n] = (moved in) - (moved out).
//
// Bound on the card: launch latency. It reads and writes well under
// 0.1 MB and needs O(C log C) comparisons and adds (C = 1024). Design:
// one launch, one CUDA block for the whole chunk, so no sum crosses blocks:
//  1. stage the chunk's row arrays in shared memory (in a device-memory
//     scratch the wrapper allocates, past about 4,000 rows), and zero d.
//     x_rows (C x N, 2 MB at C = 1024, N = 1000 in bf16) is too much for
//     one block's stores: with x_rows the launch is one thread-block
//     cluster of kXRowsBlocks blocks, whose other blocks zero it while this
//     one races; a cluster barrier before step 3 orders their zeros before
//     the block's ones;
//  2. sort the rows by (prop, descending gain, index), rows that do not
//     want to move last. Up to 1024 rows one thread holds each key in a
//     register (22 bits of target, 32 of gain, 10 of index: one u64) and a
//     bitonic network runs on the registers: shuffles within a warp, shared
//     memory across warps. Wider chunks take a bitonic network in memory;
//  3. an exclusive segmented scan of CPU and memory over that order gives
//     each wanting row the load of the same-target rows ahead of it: it is
//     admitted if that plus itself fits the slack. A second segmented scan
//     of the admitted loads gives each target its moved-in total at the
//     end of its segment;
//  4. sort the admitted rows by (cur, index) (a u32 key up to 1024 rows)
//     and scan once more: each node's moved-out total, subtracted from its
//     moved-in total.
// With a block table (`blocks`, the sparse solver's plain sweep) the same
// body also commits: it reads row i's cur, valid, c_cpu and c_mem from the
// solver's service arrays at the row's id blocks[i / 256] * 256 + i % 256
// (cur from the assignment), and at the end writes the assignment at those
// ids, adds each node's delta to the carried loads in place (the one f32
// add load[n] + d[n] the caller would make) and its admitted count to a
// move counter (i64, exact). Its decisions and deltas are the same.
// Each scan is a shuffle scan inside every warp, the warp totals combined
// by one warp, and the carry added back: a fixed tree over positions. All
// adds are full f32 adds (no TF32, no bf16) and there are no float atomics
// (the commit's count is an integer), so two runs give the same decisions
// and deltas for any loads. The sums are
// exact for integer-valued loads, and then equal the plain version's
// bit for bit; non-integer loads may differ from it in the last bit.

#include <cooperative_groups.h>

#include "sparse_tile.cuh"

namespace {

namespace cg = cooperative_groups;

using u64 = unsigned long long;
using u32 = unsigned int;

constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kLast = ~0ull;           // key of the rows that sort last
constexpr u32 kNoSeg = 0xffffffffu;    // their segment
constexpr u32 kNoCarry = 0xfffffffeu;  // a segment no row has
constexpr int kXRowsBlocks = 8;        // cluster size with x_rows (the portable maximum)

// Scratch of one segmented scan step, per block.
struct ScanScratch {
  float wx[32], wy[32];       // each warp's running total of its last segment
  u32 wlast[32], wfirst[32];  // each warp's last and first segment
  float cx[32], cy[32];       // carry into each warp's first segment
  int cin[32];                // whether that carry applies
};

// Running total of the last segment of the tiles scanned so far.
struct Carry {
  float x, y;
  u32 seg;
};

// Key of a gain such that greater gains sort first; -0 ties +0.
__device__ __forceinline__ u32 descending(float g) {
  const u32 b = __float_as_uint(__fadd_rn(g, 0.0f));
  return ~((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

// Sorts key[0, P) ascending, ties by idx (unique), carrying idx along; P is
// a power of two (the path of chunks wider than one block of threads).
// The pairs (i, i + j) of a stage with j <= 32 lie in the 64-element window
// of the warp that handles them, for every such stage, so consecutive
// stages of that kind synchronise only the warp.
__device__ void bitonic_sort(u64* key, u32* idx, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const int l = i + j;
        const u64 ki = key[i], kl = key[l];
        const u32 ii = idx[i], il = idx[l];
        const bool up = (i & k) == 0;
        if ((ki > kl || (ki == kl && ii > il)) == up) {
          key[i] = kl;
          key[l] = ki;
          idx[i] = il;
          idx[l] = ii;
        }
      }
      const int next = j > 1 ? j >> 1 : k;  // the following stage's j
      if (j > 32 || next > 32) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

constexpr u32 kPackedLast = 0x3fffffu;  // packed segment of the rows that sort last

// Bitonic sort of one key per thread over the block's P = 2^LOGP threads,
// ascending: stages of distance j < 32 exchange by shuffle, wider ones
// through shared memory, two buffers in turn (one barrier a stage).
template <int LOGP, typename K>
__device__ __forceinline__ K bitonic_block(K v, K* buf0, K* buf1) {
  const int t = threadIdx.x;
  int turn = 0;
#pragma unroll
  for (int size = 2; size <= (1 << LOGP); size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      K o;
      if (j >= 32) {
        K* buf = turn ? buf1 : buf0;
        turn ^= 1;
        buf[t] = v;
        __syncthreads();
        o = buf[t ^ j];
      } else {
        o = __shfl_xor_sync(kFull, v, j);
      }
      const bool keep_min = ((t & j) == 0) == ((t & size) == 0);
      const bool o_less = o < v;
      v = keep_min == o_less ? o : v;
    }
  }
  return v;
}

template <typename K>
__device__ K sort_block(K v, K* buf0, K* buf1) {
  switch (blockDim.x) {
    case 32: return bitonic_block<5>(v, buf0, buf1);
    case 64: return bitonic_block<6>(v, buf0, buf1);
    case 128: return bitonic_block<7>(v, buf0, buf1);
    case 256: return bitonic_block<8>(v, buf0, buf1);
    case 512: return bitonic_block<9>(v, buf0, buf1);
    default: return bitonic_block<10>(v, buf0, buf1);
  }
}

// Sorts key[0, P) as bitonic_sort does, for P == blockDim.x <= 1024 and
// segments below kPackedLast: each thread packs its key into one register,
// unique by its index (10 bits) — 22 bits of segment and the low 32 bits
// in a u64, or, when the low bits are all 0 (`seg_only`, the moved-out
// sort), 22 bits of segment in a u32 — and the block sorts the registers
// (bitonic_block). The u32 sort halves that sort's shuffles and exchange
// bytes: with it a call took 12.2-12.4 us at C = 1024 and N = 1000 or
// 2000, with the u64 sort for both 13.8-14.2 us (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py's admission_instance timed with cuda_ms, the two
// builds in turns in one run). The first exchange goes through `aux` (P u64), so
// no thread overwrites a key another is still reading.
__device__ void sort_packed(u64* key, u64* aux, u32* idx, bool seg_only) {
  const int t = threadIdx.x;
  const u64 k = key[t];
  const u32 seg = static_cast<u32>(k >> 32);
  const u32 s22 = seg == kNoSeg ? kPackedLast : seg;
  u32 s;
  u32 low;
  u32 i;
  if (seg_only) {
    u32 v = (s22 << 10) | idx[t];
    v = sort_block<u32>(v, reinterpret_cast<u32*>(aux), reinterpret_cast<u32*>(key));
    s = v >> 10;
    low = 0;
    i = v & 1023u;
  } else {
    u64 v = (static_cast<u64>(s22) << 42) | (static_cast<u64>(static_cast<u32>(k)) << 10) | idx[t];
    v = sort_block<u64>(v, aux, key);
    s = static_cast<u32>(v >> 42);
    low = static_cast<u32>(v >> 10);
    i = static_cast<u32>(v & 1023u);
  }
  __syncthreads();  // every thread is done reading the exchange buffers
  key[t] = s == kPackedLast ? kLast : ((static_cast<u64>(s) << 32) | low);
  idx[t] = i;
  __syncthreads();
}

// One tile (one position per thread) of an inclusive segmented scan of
// (x, y) in position order; `carry` brings in the previous tiles' last
// segment and takes out this tile's. (ex, ey) get the exclusive values.
// Every thread of the block must call it.
__device__ void seg_scan(u32 seg, float& x, float& y, float& ex, float& ey, ScanScratch& s,
                         Carry& carry) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncwarp();  // the warp's lanes are done reading the previous step
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ux = __shfl_up_sync(kFull, x, d);
    const float uy = __shfl_up_sync(kFull, y, d);
    const u32 us = __shfl_up_sync(kFull, seg, d);
    if (lane >= d && us == seg) {
      x = __fadd_rn(ux, x);
      y = __fadd_rn(uy, y);
    }
  }
  if (lane == 31) {
    s.wx[warp] = x;
    s.wy[warp] = y;
    s.wlast[warp] = seg;
  }
  if (lane == 0) s.wfirst[warp] = seg;
  __syncthreads();
  if (warp == 0) {
    const float carry_x = carry.x, carry_y = carry.y;
    const u32 carry_seg = carry.seg;
    const bool on = lane < nw;
    float vx = on ? s.wx[lane] : 0.0f;
    float vy = on ? s.wy[lane] : 0.0f;
    const u32 first = on ? s.wfirst[lane] : kNoSeg;
    const u32 last = on ? s.wlast[lane] : kNoSeg;
    u32 prev = __shfl_up_sync(kFull, last, 1);
    if (lane == 0) prev = carry_seg;
    // warp l's last segment extends the run before the warp iff the warp
    // holds one segment only, the run's; otherwise it starts a new run
    int head = !(first == last && first == prev);
    if (lane == 0 && !head) {
      vx = __fadd_rn(carry_x, vx);
      vy = __fadd_rn(carry_y, vy);
      head = 1;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ux = __shfl_up_sync(kFull, vx, d);
      const float uy = __shfl_up_sync(kFull, vy, d);
      const int uh = __shfl_up_sync(kFull, head, d);
      if (lane >= d) {
        if (!head) {
          vx = __fadd_rn(ux, vx);
          vy = __fadd_rn(uy, vy);
        }
        head |= uh;
      }
    }
    // vx, vy: the total of warp l's last segment up to its end
    float px = __shfl_up_sync(kFull, vx, 1);
    float py = __shfl_up_sync(kFull, vy, 1);
    if (lane == 0) {
      px = carry_x;
      py = carry_y;
    }
    if (on) {
      s.cin[lane] = first == prev;
      s.cx[lane] = px;
      s.cy[lane] = py;
    }
    __syncwarp();  // every lane has read the carry
    if (lane == nw - 1) {
      carry.x = vx;
      carry.y = vy;
      carry.seg = last;
    }
  }
  __syncthreads();
  const bool cin = s.cin[warp] != 0;
  const float cx = s.cx[warp], cy = s.cy[warp];
  if (cin && seg == s.wfirst[warp]) {
    x = __fadd_rn(cx, x);
    y = __fadd_rn(cy, y);
  }
  const float ux = __shfl_up_sync(kFull, x, 1);
  const float uy = __shfl_up_sync(kFull, y, 1);
  const u32 us = __shfl_up_sync(kFull, seg, 1);
  if (lane == 0) {
    ex = cin ? cx : 0.0f;
    ey = cin ? cy : 0.0f;
  } else {
    ex = us == seg ? ux : 0.0f;
    ey = us == seg ? uy : 0.0f;
  }
}

__device__ void zero_bytes(void* p, long long n) {
  uint4* p4 = static_cast<uint4*>(p);
  const long long n4 = n >> 4;
  for (long long i = threadIdx.x; i < n4; i += blockDim.x) p4[i] = make_uint4(0u, 0u, 0u, 0u);
  unsigned char* pb = static_cast<unsigned char*>(p);
  for (long long i = (n4 << 4) + threadIdx.x; i < n; i += blockDim.x) pb[i] = 0;
}

// Shared (or scratch) layout for P sort slots and C rows:
// key, aux u64[P] | idx u32[P] | c_cpu, c_mem, slack_cpu, slack_mem f32[C] |
// prop, cur i32[C] | admitted u8[C]: 20 P + 25 C bytes.
template <typename XT>
__global__ void __launch_bounds__(1024)
admission_kernel(const int* __restrict__ prop, const float* __restrict__ gain,
                 const int* __restrict__ wants, const float* __restrict__ slack_cpu,
                 const float* __restrict__ slack_mem, const int* __restrict__ cur,
                 const uint8_t* __restrict__ valid, const float* __restrict__ c_cpu,
                 const float* __restrict__ c_mem, int C, int N, int P, int enforce_capacity,
                 int* __restrict__ new_node, uint8_t* __restrict__ admitted,
                 float* __restrict__ d_cpu, float* __restrict__ d_mem, XT* __restrict__ x_rows,
                 unsigned char* work, const int* __restrict__ blocks, int* assign,
                 float* __restrict__ cpu_load, float* __restrict__ mem_load,
                 long long* __restrict__ moves) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ ScanScratch scan;
  __shared__ Carry carries[2];
  __shared__ int n_admitted;
  unsigned char* base = work != nullptr ? work : dyn;
  u64* key = reinterpret_cast<u64*>(base);
  u64* aux = key + P;
  u32* idx = reinterpret_cast<u32*>(base + 16LL * P);
  float* s_cpu = reinterpret_cast<float*>(base + 20LL * P);
  float* s_mem = s_cpu + C;
  float* s_slack_cpu = s_mem + C;
  float* s_slack_mem = s_slack_cpu + C;
  int* s_prop = reinterpret_cast<int*>(s_slack_mem + C);
  int* s_cur = s_prop + C;
  uint8_t* s_adm = reinterpret_cast<uint8_t*>(s_cur + C);
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const bool packed = P == T && N < static_cast<int>(kPackedLast);
  const int helpers = static_cast<int>(gridDim.x) - 1;  // blocks that zero x_rows
  const long long x_bytes = static_cast<long long>(C) * N * sizeof(XT);
  // row i's index into the row operands: i, or with a block table its id
  const bool commit = blocks != nullptr;
  auto src = [&](int i) { return commit ? blocks[i / kBlockR] * kBlockR + i % kBlockR : i; };

  // 0. a helper block zeroes its share of x_rows (16-byte pieces, the
  // last helper the tail) and waits at the cluster barrier
  if (blockIdx.x > 0) {
    const long long n16 = x_bytes >> 4;
    const long long per = (n16 + helpers - 1) / helpers;
    const long long r = blockIdx.x - 1;
    const long long lo = min(n16, r * per) << 4;
    const long long hi = r == helpers - 1 ? x_bytes : min(n16, (r + 1) * per) << 4;
    zero_bytes(reinterpret_cast<unsigned char*>(x_rows) + lo, hi - lo);
    cg::this_cluster().sync();
    return;
  }

  // 1. zero what the sums and (without helpers) the one-hot rows cover only
  // in part; stage the rows; sort keys by (prop, descending gain), index as
  // the tie
  for (int n = tid; n < N; n += T) {
    d_cpu[n] = 0.0f;
    d_mem[n] = 0.0f;
  }
  if (x_rows != nullptr && helpers == 0) zero_bytes(x_rows, x_bytes);
  for (int i = tid; i < P; i += T) {
    u64 k = kLast;
    if (i < C) {
      const int p = prop[i];
      const int r = src(i);
      s_cpu[i] = c_cpu[r];
      s_mem[i] = c_mem[r];
      s_slack_cpu[i] = slack_cpu[i];
      s_slack_mem[i] = slack_mem[i];
      s_prop[i] = p;
      s_cur[i] = commit ? assign[r] : cur[i];
      if (wants[i] != 0) k = (static_cast<u64>(static_cast<u32>(p)) << 32) | descending(gain[i]);
    }
    key[i] = k;
    idx[i] = static_cast<u32>(i);
  }
  if (tid == 0) {
    carries[0] = carries[1] = Carry{0.0f, 0.0f, kNoCarry};
    n_admitted = 0;
  }
  __syncthreads();
  if (packed) {
    sort_packed(key, aux, idx, false);
  } else {
    bitonic_sort(key, idx, P);
  }

  // 2. the race, then each target's moved-in total
  for (int b = 0; b < P; b += T) {
    const int p = b + tid;
    const u64 k = p < P ? key[p] : kLast;
    const u32 seg = static_cast<u32>(k >> 32);
    const bool want = seg != kNoSeg;
    const int i = want ? static_cast<int>(idx[p]) : 0;
    float x = want ? s_cpu[i] : 0.0f;
    float y = want ? s_mem[i] : 0.0f;
    bool adm = want;
    if (enforce_capacity) {
      float land_cpu, land_mem;
      seg_scan(seg, x, y, land_cpu, land_mem, scan, carries[0]);
      adm = want && land_cpu <= s_slack_cpu[i] && land_mem <= s_slack_mem[i];
    }
    if (p < P && static_cast<int>(idx[p]) < C) s_adm[idx[p]] = adm;
    float in_cpu = adm ? s_cpu[i] : 0.0f;
    float in_mem = adm ? s_mem[i] : 0.0f;
    float unused_x, unused_y;
    seg_scan(seg, in_cpu, in_mem, unused_x, unused_y, scan, carries[1]);
    const u32 next = p + 1 < P ? static_cast<u32>(key[p + 1] >> 32) : kNoSeg;
    if (want && next != seg && seg < static_cast<u32>(N)) {
      d_cpu[seg] = in_cpu;
      d_mem[seg] = in_mem;
    }
  }
  __syncthreads();
  if (helpers > 0) cg::this_cluster().sync();  // x_rows is zero

  // 3. the rows' outputs; sort keys of the admitted rows by (cur, index)
  int mine = 0;
  for (int i = tid; i < P; i += T) {
    u64 k = kLast;
    if (i < C) {
      const bool a = s_adm[i] != 0;
      const int from = s_cur[i];
      const int to = a ? s_prop[i] : from;
      if (commit) {
        assign[src(i)] = to;
      } else {
        new_node[i] = to;
        admitted[i] = a ? 1 : 0;
      }
      mine += a;
      if (x_rows != nullptr && valid[src(i)] != 0 && to >= 0 && to < N) {
        x_rows[static_cast<long long>(i) * N + to] = XT(1.0f);
      }
      if (a && from >= 0 && from < N) k = static_cast<u64>(static_cast<u32>(from)) << 32;
    }
    key[i] = k;
    idx[i] = static_cast<u32>(i);
  }
  if (commit && mine > 0) atomicAdd(&n_admitted, mine);
  if (tid == 0) carries[0] = Carry{0.0f, 0.0f, kNoCarry};
  __syncthreads();
  if (packed) {
    sort_packed(key, aux, idx, true);
  } else {
    bitonic_sort(key, idx, P);
  }

  // 4. each node's moved-out total, taken off its moved-in total
  for (int b = 0; b < P; b += T) {
    const int p = b + tid;
    const u64 k = p < P ? key[p] : kLast;
    const u32 seg = static_cast<u32>(k >> 32);
    const bool out = seg != kNoSeg;
    const int i = out ? static_cast<int>(idx[p]) : 0;
    float x = out ? s_cpu[i] : 0.0f;
    float y = out ? s_mem[i] : 0.0f;
    float unused_x, unused_y;
    seg_scan(seg, x, y, unused_x, unused_y, scan, carries[0]);
    const u32 next = p + 1 < P ? static_cast<u32>(key[p + 1] >> 32) : kNoSeg;
    if (out && next != seg) {
      d_cpu[seg] = __fsub_rn(d_cpu[seg], x);
      d_mem[seg] = __fsub_rn(d_mem[seg], y);
    }
  }
  if (!commit) return;

  // 5. the commit: every node's delta onto its carried load, the count
  __syncthreads();
  for (int n = tid; n < N; n += T) {
    cpu_load[n] = __fadd_rn(cpu_load[n], d_cpu[n]);
    mem_load[n] = __fadd_rn(mem_load[n], d_mem[n]);
  }
  if (tid == 0) *moves += n_admitted;
}

template <typename XT>
int launch(const int* prop, const float* gain, const int* wants, const float* slack_cpu,
           const float* slack_mem, const int* cur, const uint8_t* valid, const float* c_cpu,
           const float* c_mem, int C, int N, int enforce_capacity, int* new_node,
           uint8_t* admitted, float* d_cpu, float* d_mem, void* x_rows, int threads, int P,
           void* work, long long work_bytes, const int* blocks, int* assign, float* cpu_load,
           float* mem_load, long long* moves, cudaStream_t stream) {
  // the wrapper's geometry (`admission_geometry`); a commit has every
  // operand of its own and neither x_rows nor per-row outputs
  const bool commit_ok = x_rows == nullptr && C % kBlockR == 0 && assign != nullptr &&
                         cpu_load != nullptr && mem_load != nullptr && moves != nullptr;
  if (threads < 32 || threads > 1024 || (threads & 31) || P < threads || (P & (P - 1)) ||
      P < C || work_bytes < 20LL * P + 25LL * C || (blocks != nullptr && !commit_ok) ||
      (blocks == nullptr && (cur == nullptr || new_node == nullptr || admitted == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = work != nullptr ? 0 : static_cast<size_t>(work_bytes);
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(admission_kernel<XT>, smem, &granted);
  if (err != cudaSuccess) return err;
  // the grid is one cluster: the racing block, and with x_rows its helpers
  const unsigned grid = x_rows != nullptr ? kXRowsBlocks : 1;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = grid;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, admission_kernel<XT>, prop, gain, wants, slack_cpu, slack_mem,
                           cur, valid, c_cpu, c_mem, C, N, P, enforce_capacity, new_node,
                           admitted, d_cpu, d_mem, static_cast<XT*>(x_rows),
                           static_cast<unsigned char*>(work), blocks, assign, cpu_load, mem_load,
                           moves);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Inputs [C]: prop, wants, cur (i32), gain, slack_cpu, slack_mem, c_cpu,
// c_mem (f32), valid (one byte each, nonzero = valid: a bool tensor as it
// is). A wanting row's prop is a node in [0, N), as the score stages give
// it (the packed sort keeps 22 bits of it). Outputs: new_node i32[C], admitted u8[C], d_cpu / d_mem f32[N], and
// x_rows [C, N] (x_kind 0: none, 1: bf16, 2: f32; 16-byte aligned).
// threads, P, work_bytes: the wrapper's geometry; work: a device scratch
// of work_bytes, or null to keep the rows in shared memory. A commit
// (`blocks`, i32[C / 256]) reads cur, valid, c_cpu and c_mem as the
// service arrays at the rows' ids (cur = assign, i32; cur, new_node and
// admitted are then null, x_kind 0), writes assign at those ids, adds the
// deltas (still written to d_cpu / d_mem) to cpu_load and mem_load (f32[N])
// and the admitted count to moves (one i64).
KRT_EXPORT int krt_admission_launch(int device, const int* prop, const float* gain,
                                    const int* wants, const float* slack_cpu,
                                    const float* slack_mem, const int* cur,
                                    const uint8_t* valid, const float* c_cpu,
                                    const float* c_mem, int C, int N, int enforce_capacity,
                                    int* new_node, uint8_t* admitted, float* d_cpu,
                                    float* d_mem, void* x_rows, int x_kind, int threads, int P,
                                    void* work, long long work_bytes, const int* blocks,
                                    int* assign, float* cpu_load, float* mem_load,
                                    long long* moves, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_kind == 2) {
    return launch<float>(prop, gain, wants, slack_cpu, slack_mem, cur, valid, c_cpu, c_mem, C,
                         N, enforce_capacity, new_node, admitted, d_cpu, d_mem, x_rows, threads,
                         P, work, work_bytes, blocks, assign, cpu_load, mem_load, moves, s);
  }
  return launch<__nv_bfloat16>(prop, gain, wants, slack_cpu, slack_mem, cur, valid, c_cpu,
                               c_mem, C, N, enforce_capacity, new_node, admitted, d_cpu, d_mem,
                               x_kind == 1 ? x_rows : nullptr, threads, P, work, work_bytes,
                               blocks, assign, cpu_load, mem_load, moves, s);
}

// The pairwise-exchange (swap) phase of one solver chunk, as two kernels.
// It replaces no TPU kernel: the JAX package's solver/swap.py is plain XLA,
// and the port's solver/swap.py (chunk_swap -> swap_subset ->
// swap_decisions, and the solvers' gathers of the chunk's rows before it
// and load commit after it, commit_swaps) stays as their plain twin and the
// CPU path. Here that chain of about 160 small device ops a chunk, the
// gathers and the commit's four index_puts become two launches.
//
// Both kernels read the chunk's rows through ids from the solver's
// service arrays (assign, validity, demands, move bill and anchor), with
// the rows the chunk's single phase moved and the nodes' validity: a row
// is eligible if its service is valid, unmoved and on a valid node.
//
// Kernel 7, swap_desire_kernel: each of the chunk's C <= 1024 rows takes
// the row max of M and M[i, cur_i]: key = (m_best - m_cur) - pen_home, -inf
// where the row is not eligible. With k >= C the keys are not needed and M
// is not read.
//
// Kernel 8, swap_decide_kernel, one thread-block cluster:
//  0. the desire-ranked top-k subset sel, by rank counting: rank_i =
//     #{j: key_j > key_i} + #{j < i: key_j == key_i}, sel[rank_i] = i for
//     rank_i < k. Max and compares are order-free, so this is the order of
//     torch.sort(stable=True, descending=True).indices[:k] bit for bit
//     (ops/swap.py: rank_select); with k >= C, sel is the identity;
//  1. the exchange gain G[a, b] of every subset pair, from M[sel_a, cur_b],
//     M[sel_b, cur_a], m_own and Wc, in swap.py's left-to-right order of
//     f32 operations (no contraction into FMAs: every op is an _rn
//     intrinsic). G is not bitwise symmetric, so each element is computed;
//     pair_ok & fits & (G > 0) mask it, and each row takes its first
//     argmax (max, then lowest column; an all -inf row gives 0);
//  2. mutual-best matching and the priority compare;
//  3. the cross-swap mass coupling I[s, t] = (A[s,t] + A[p_s,t]) +
//     (A[s,p_t] + A[p_s,p_t]) with A = Wc * D formed on the fly, which is
//     swap.py's (B @ A) @ B.T bit for bit: each stage of that product adds
//     at most two non-zero exact products (ops/swap.py:
//     interaction_gather). Where D is 0 the weight is not read;
//  4. the two-sided capacity race;
//  5. new_node and swapped at full width, assign[ids] = new_node, and the
//     load commit: the new CPU and memory loads, each
//     node's sum added in the order PyTorch's CUDA index_put(accumulate=
//     True) adds it (indexing_backward_kernel_stride_1: a node's rows in
//     ascending order, lane-strided partials over whole passes of 32, a
//     shuffle-down tree, then the rest one by one, then added to the load),
//     so the loads are torch.equal to commit_swaps' for any demands.
// The sums of steps 3 and 4 (neg_i and the race's `others`) are taken in a
// fixed order (lane-strided partials, then a fixed shuffle tree), with no
// atomics: two runs decide alike for any inputs, and the plain version's
// decisions are met exactly where those sums are exact (integer loads and
// weights); otherwise a decision can differ only where a sum of three or
// more terms rounds across the admission threshold.
// Wc is read only at sel x sel: from the dense solver's W (bf16 or f32) at
// the rows and columns ids[sel], or from the sparse solver's f32 Wc.
//
// Bound on the card: latency. Kernel 7 reads M once (1.6 MB at C = 1024,
// N = 400; 8.2 MB at N = 2000, in L2 from the mass kernel that wrote it),
// one warp a row over C / 8 blocks, so the whole card reads it; kernel 8
// reads k x k entries of M and Wc (256 KB each at k = 256) and does about
// 40 f32 operations a pair. Both are a few microseconds of memory time;
// what is left is barrier and load latency. Kernel 8 is one cluster of 8
// blocks: each ranks a slice of the chunk's rows against all C keys, keeps
// the subset's vectors in its shared memory, takes a slice of the subset's
// rows (one warp a row), and after each step pushes the O(k) results
// (sel, partners, best gains, surviving candidates, admissions) into all 8
// blocks' shared memory, followed by one cluster barrier: five in all, the
// first split (arrive at entry, wait before the first remote write).

#include <cooperative_groups.h>

#include "krt_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCluster = 8;         // blocks of kernel 8: one cluster
constexpr int kMaxRows = 1024;      // C and k at most
constexpr int kDesireThreads = 256; // kernel 7: 8 rows a block
constexpr int kDecideThreads = 512;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A fixed tree over the lanes: every lane ends with the same sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float max4(float4 v) {
  return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

// ------------------------------------------------------------- kernel 7

// A chunk row's service and its eligibility: valid, not moved by the
// chunk's single phase, on a valid node.
__device__ __forceinline__ bool eligible_row(const uint8_t* svc_valid, const uint8_t* moved,
                                             const uint8_t* node_valid, long long r, int i,
                                             int c) {
  return svc_valid[r] != 0 && moved[i] == 0 && node_valid[c] != 0;
}

__global__ void __launch_bounds__(kDesireThreads)
    swap_desire_kernel(const float* __restrict__ M, const int* __restrict__ assign,
                       const long long* __restrict__ ids, const uint8_t* __restrict__ svc_valid,
                       const uint8_t* __restrict__ moved, const uint8_t* __restrict__ node_valid,
                       const float* __restrict__ pen, const int* __restrict__ home, int C, int N,
                       int vec4, float* __restrict__ keys) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kDesireThreads / 32) + (threadIdx.x >> 5);
  if (i >= C) return;  // whole warps
  const float* row = M + static_cast<long long>(i) * N;
  float m = KRT_NEG_INF;
  if (vec4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = N >> 2;
    const float4 none = make_float4(KRT_NEG_INF, KRT_NEG_INF, KRT_NEG_INF, KRT_NEG_INF);
    for (int c = lane; c < n4; c += 128) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = c + 32 * u < n4 ? row4[c + 32 * u] : none;
#pragma unroll
      for (int u = 0; u < 4; ++u) m = fmaxf(m, max4(v[u]));
    }
  } else {
    for (int c = lane; c < N; c += 128) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = c + 32 * u < N ? row[c + 32 * u] : KRT_NEG_INF;
#pragma unroll
      for (int u = 0; u < 4; ++u) m = fmaxf(m, v[u]);
    }
  }
  m = warp_max(m);
  if (lane == 0) {
    const long long r = ids[i];
    const int ci = assign[r];
    const float pen_home =
        pen != nullptr ? __fmul_rn(pen[r], home[r] == ci ? 1.0f : 0.0f) : 0.0f;
    const float desire = __fsub_rn(__fsub_rn(m, row[ci]), pen_home);
    keys[i] = eligible_row(svc_valid, moved, node_valid, r, i, ci) ? desire : KRT_NEG_INF;
  }
}

// ------------------------------------------------------------- kernel 8

// The subset's vectors, one entry a subset row, and the chunk's full-width
// rows, in each block's shared memory (the same layout in all 8, so an
// address maps across the cluster).
struct Subset {
  long long* wrow;  // the row and column of W that holds the row's weights
  int *sel, *cur, *home, *p;
  float *c_cpu, *c_mem, *load, *cap, *free_cpu, *free_mem, *m_own, *t_old, *pen, *gbest, *gain;
  uint8_t *elig, *mutual, *cand, *cand2, *adm;
  // full width [C]: the service, the desire key, the demands, the current
  // and the new node, eligible, swapped
  long long* svc_full;
  float *key, *c_cpu_full, *c_mem_full;
  int *cur_full, *new_full;
  uint8_t *elig_full, *sw_full;
};

__host__ __device__ constexpr size_t subset_bytes(int k, int C) {
  return static_cast<size_t>(k) * (8 + 4 * 4 + 11 * 4 + 5) + static_cast<size_t>(C) * 30;
}

__device__ Subset carve(unsigned char* base, int k, int C) {
  Subset s;
  s.wrow = reinterpret_cast<long long*>(base);
  s.svc_full = s.wrow + k;
  int* i32 = reinterpret_cast<int*>(s.svc_full + C);
  s.sel = i32;
  s.cur = i32 + k;
  s.home = i32 + 2 * k;
  s.p = i32 + 3 * k;
  s.cur_full = i32 + 4 * k;
  s.new_full = i32 + 4 * k + C;
  float* f = reinterpret_cast<float*>(i32 + 4 * k + 2 * C);
  s.c_cpu = f;
  s.c_mem = f + k;
  s.load = f + 2 * k;
  s.cap = f + 3 * k;
  s.free_cpu = f + 4 * k;
  s.free_mem = f + 5 * k;
  s.m_own = f + 6 * k;
  s.t_old = f + 7 * k;
  s.pen = f + 8 * k;
  s.gbest = f + 9 * k;
  s.gain = f + 10 * k;
  s.key = f + 11 * k;
  s.c_cpu_full = f + 11 * k + C;
  s.c_mem_full = f + 11 * k + 2 * C;
  uint8_t* b = reinterpret_cast<uint8_t*>(f + 11 * k + 3 * C);
  s.elig = b;
  s.mutual = b + k;
  s.cand = b + 2 * k;
  s.cand2 = b + 3 * k;
  s.adm = b + 4 * k;
  s.sw_full = b + 5 * k;
  s.elig_full = b + 5 * k + C;
  return s;
}

__device__ __forceinline__ float pct_of(float load, float cap) {
  return __fmul_rn(__fdiv_rn(load, cap), 100.0f);
}

// -lam * pct - ow * relu(pct - 100), as swap.py writes it
__device__ __forceinline__ float balance_term(float pct, float neg_lam, float ow) {
  return __fsub_rn(__fmul_rn(neg_lam, pct), __fmul_rn(ow, fmaxf(__fsub_rn(pct, 100.0f), 0.0f)));
}

__device__ __forceinline__ float flag(bool x) { return x ? 1.0f : 0.0f; }

template <typename WT>
__device__ __forceinline__ float weight(const WT* W, long long w_stride, const Subset& s, int a,
                                        int b) {
  return krt_to_float(W[s.wrow[a] * w_stride + s.wrow[b]]);
}

// G[a, b] of swap_decisions, term for term and in its order, from
// m_ab = M[sel_a, cur_b], m_ba = M[sel_b, cur_a] and w = Wc[a, b]
__device__ __forceinline__ float pair_gain(float m_ab, float m_ba, float w, const Subset& s,
                                           int a, int b, float neg_lam, float ow, bool priced) {
  const int ca = s.cur[a], cb = s.cur[b];
  float g = __fsub_rn(__fsub_rn(__fsub_rn(__fadd_rn(m_ab, m_ba), s.m_own[a]), s.m_own[b]),
                      __fmul_rn(2.0f, w));
  // a lands on cb, which loses b: (L_b - c_b + c_a) / cap_b * 100
  const float new_ab = balance_term(
      pct_of(__fadd_rn(__fsub_rn(s.load[b], s.c_cpu[b]), s.c_cpu[a]), s.cap[b]), neg_lam, ow);
  const float new_ba = balance_term(
      pct_of(__fadd_rn(__fsub_rn(s.load[a], s.c_cpu[a]), s.c_cpu[b]), s.cap[a]), neg_lam, ow);
  g = __fadd_rn(__fadd_rn(g, __fsub_rn(new_ab, s.t_old[a])), __fsub_rn(new_ba, s.t_old[b]));
  if (priced) {
    const float p_ab = __fmul_rn(s.pen[a], __fsub_rn(flag(cb != s.home[a]), flag(ca != s.home[a])));
    const float p_ba = __fmul_rn(s.pen[b], __fsub_rn(flag(ca != s.home[b]), flag(cb != s.home[b])));
    g = __fsub_rn(__fsub_rn(g, p_ab), p_ba);
  }
  return g;
}

// A[x, y] = Wc[x, y] * D[x, y], D from the current and the partner nodes
template <typename WT>
__device__ __forceinline__ float coupling(const WT* W, long long w_stride, const Subset& s, int x,
                                          int y) {
  const int nx = s.cur[s.p[x]], ny = s.cur[s.p[y]], cx = s.cur[x], cy = s.cur[y];
  const int d = (nx == ny) - (nx == cy) - (cx == ny) + (cx == cy);
  return d == 0 ? 0.0f : __fmul_rn(weight(W, w_stride, s, x, y), static_cast<float>(d));
}

// the priority of swap t over swap s: greater gain, ties to the lower index
__device__ __forceinline__ bool before(const Subset& s, int t, int a) {
  return s.gain[t] > s.gain[a] || (s.gain[t] == s.gain[a] && t < a);
}

// Writes v into entry a of `arr` in every block of the cluster (lanes 0-7).
template <typename T>
__device__ __forceinline__ void push(cg::cluster_group& cluster, T* arr, int a, T v, int lane) {
  if (lane < kCluster) *cluster.map_shared_rank(arr + a, static_cast<unsigned>(lane)) = v;
}

// What index_put(accumulate=True) adds at one node, for the rows i whose
// index is that node (one warp; warp-uniform calls): the rows in ascending
// order at positions p = 0..m-1; with P = 32 * (m / 32), lane l sums the
// positions p < P with p % 32 == l in order, a shuffle-down tree brings the
// 32 partials to lane 0, which then adds positions P..m-1 in order.
struct RunSum {
  int m, whole, pos;
  bool tree;
  float pc, pm;

  __device__ void start(int count) {
    m = count;
    whole = count & ~31;
    pos = 0;
    tree = false;
    pc = pm = 0.0f;
  }
  __device__ void reduce() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      pc = __fadd_rn(pc, __shfl_down_sync(kFull, pc, o));
      pm = __fadd_rn(pm, __shfl_down_sync(kFull, pm, o));
    }
    tree = true;
  }
  // the next rows: `hits` of this 32-row block, lane j holding row j's values
  __device__ void add(unsigned hits, float vc, float vm, int lane) {
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const float xc = __shfl_sync(kFull, vc, j), xm = __shfl_sync(kFull, vm, j);
      if (pos == whole && !tree) reduce();
      if (pos >= whole || lane == (pos & 31)) {
        pc = __fadd_rn(pc, xc);
        pm = __fadd_rn(pm, xm);
      }
      ++pos;
    }
  }
  __device__ void finish() {
    if (!tree) reduce();
    pc = __shfl_sync(kFull, pc, 0);
    pm = __shfl_sync(kFull, pm, 0);
  }
};

template <typename WT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kDecideThreads)
    swap_decide_kernel(const float* __restrict__ M, int N, const float* __restrict__ keys,
                       const WT* __restrict__ W, long long w_stride,
                       const long long* __restrict__ w_ids, int* __restrict__ assign,
                       const long long* __restrict__ ids, const uint8_t* __restrict__ svc_valid,
                       const uint8_t* __restrict__ moved, const uint8_t* __restrict__ node_valid,
                       const float* __restrict__ svc_cpu, const float* __restrict__ svc_mem,
                       const float* __restrict__ cpu_load,
                       const float* __restrict__ mem_load, const float* __restrict__ cap,
                       const float* __restrict__ mem_cap, float lam, float ow,
                       const float* __restrict__ pen, const int* __restrict__ home, int C, int k,
                       int enforce, int* __restrict__ new_node, uint8_t* __restrict__ swapped,
                       long long* __restrict__ n_swaps, float* __restrict__ cpu_out,
                       float* __restrict__ mem_out) {
  // every block has started before the first remote write (the wait below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Subset s = carve(smem, k, C);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, warps = blockDim.x >> 5;
  const int per = (k + kCluster - 1) / kCluster;  // this block's subset rows
  const int a0 = rank * per, a1 = min(k, a0 + per);
  const int per_c = (C + kCluster - 1) / kCluster;  // and chunk rows
  const int i0 = rank * per_c, i1 = min(C, i0 + per_c);
  const float neg_lam = -lam;
  const bool priced = pen != nullptr;

  // 0. the loads as they are (the commit overwrites the nodes swaps touch,
  //    after the barriers below), the chunk's keys and current nodes
  for (int n = rank * blockDim.x + tid; n < N; n += kCluster * blockDim.x) {
    cpu_out[n] = cpu_load[n];
    mem_out[n] = mem_load[n];
  }
  for (int i = tid; i < C; i += blockDim.x) {
    const long long r = ids[i];
    const int c = assign[r];
    s.svc_full[i] = r;
    s.cur_full[i] = c;
    s.c_cpu_full[i] = svc_cpu[r];
    s.c_mem_full[i] = svc_mem[r];
    s.elig_full[i] = eligible_row(svc_valid, moved, node_valid, r, i, c);
    if (k < C) s.key[i] = keys[i];
  }
  __syncthreads();
  // the top-k: rank counting over this block's slice of the chunk's rows,
  // each warp's rows (i0 + warp + r * warps) against one key a lane at a time
  constexpr int kRankRows = (kMaxRows / kCluster) / (kDecideThreads / 32);
  int ranks[kRankRows];
  if (k < C) {
    float key[kRankRows];
#pragma unroll
    for (int r = 0; r < kRankRows; ++r) {
      const int i = i0 + warp + r * warps;
      key[r] = i < i1 ? s.key[i] : KRT_NEG_INF;
      ranks[r] = 0;
    }
    for (int j = lane; j < C; j += 32) {
      const float kj = s.key[j];
#pragma unroll
      for (int r = 0; r < kRankRows; ++r) {
        const int i = i0 + warp + r * warps;
        ranks[r] += (kj > key[r] || (kj == key[r] && j < i)) ? 1 : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kRankRows; ++r) ranks[r] = warp_sum(ranks[r]);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (k < C) {
#pragma unroll
    for (int r = 0; r < kRankRows; ++r) {
      const int i = i0 + warp + r * warps;
      if (i < i1 && ranks[r] < k) push(cluster, s.sel, ranks[r], i, lane);
    }
  } else {
    for (int a = tid; a < k; a += blockDim.x) s.sel[a] = a;
  }
  cluster.sync();

  // the subset's vectors, gathered through sel
  for (int a = tid; a < k; a += blockDim.x) {
    const int r = s.sel[a];
    const int c = s.cur_full[r];
    s.cur[a] = c;
    s.wrow[a] = w_ids != nullptr ? w_ids[r] : r;
    s.elig[a] = s.elig_full[r];
    s.c_cpu[a] = s.c_cpu_full[r];
    s.c_mem[a] = s.c_mem_full[r];
    const float L = cpu_load[c], cp = cap[c];
    s.load[a] = L;
    s.cap[a] = cp;
    s.free_cpu[a] = __fsub_rn(cp, L);
    s.free_mem[a] = __fsub_rn(mem_cap[c], mem_load[c]);
    s.m_own[a] = M[static_cast<long long>(r) * N + c];
    s.t_old[a] = balance_term(pct_of(L, cp), neg_lam, ow);
    s.pen[a] = priced ? pen[s.svc_full[r]] : 0.0f;
    s.home[a] = priced ? home[s.svc_full[r]] : 0;
  }
  __syncthreads();

  // 1. each row's best partner: masked gains, first argmax. A lane takes
  //    columns lane, lane + 32, ... in order, four at a time: the masks
  //    first, then the loads of the pairs they keep, all in flight before
  //    any gain
  constexpr int kCols = 4;
  for (int a = a0 + warp; a < a1; a += warps) {
    float best = KRT_NEG_INF;
    int at = lane;
    const long long row_a = static_cast<long long>(s.sel[a]) * N;
    for (int b0 = lane; b0 < k; b0 += 32 * kCols) {
      bool ok[kCols];
      float m_ab[kCols], m_ba[kCols], w[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int b = b0 + 32 * u;
        ok[u] = b < k && s.elig[a] && s.elig[b] && s.cur[a] != s.cur[b];
        if (ok[u] && enforce) {
          ok[u] = __fsub_rn(s.c_cpu[b], s.c_cpu[a]) <= s.free_cpu[a] &&
                  __fsub_rn(s.c_mem[b], s.c_mem[a]) <= s.free_mem[a] &&
                  __fsub_rn(s.c_cpu[a], s.c_cpu[b]) <= s.free_cpu[b] &&
                  __fsub_rn(s.c_mem[a], s.c_mem[b]) <= s.free_mem[b];
        }
        if (ok[u]) {
          m_ab[u] = M[row_a + s.cur[b]];
          m_ba[u] = M[static_cast<long long>(s.sel[b]) * N + s.cur[a]];
          w[u] = weight(W, w_stride, s, a, b);
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        if (!ok[u]) continue;
        const int b = b0 + 32 * u;
        const float g = pair_gain(m_ab[u], m_ba[u], w[u], s, a, b, neg_lam, ow, priced);
        if (g > 0.0f && g > best) {
          best = g;
          at = b;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, o);
      const int oa = __shfl_xor_sync(kFull, at, o);
      if (ob > best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    push(cluster, s.p, a, at, lane);
    push(cluster, s.gbest, a, best, lane);
  }
  cluster.sync();

  // 2. mutual-best matching: one candidate a pair, the lower index
  for (int a = tid; a < k; a += blockDim.x) {
    const int pa = s.p[a];
    const bool mutual = s.gbest[a] > 0.0f && s.p[pa] == a;
    const bool cand = mutual && a < pa;
    s.mutual[a] = mutual;
    s.cand[a] = cand;
    s.gain[a] = cand ? s.gbest[a] : KRT_NEG_INF;
  }
  __syncthreads();

  // 3. a candidate keeps a positive margin after the clamped-negative
  //    couplings of every higher-priority candidate
  for (int a = a0 + warp; a < a1; a += warps) {
    uint8_t keep = 0;
    if (s.cand[a]) {
      const int pa = s.p[a];
      float neg = 0.0f;
      for (int t = lane; t < k; t += 32) {
        if (!s.cand[t] || !before(s, t, a)) continue;
        const int pt = s.p[t];
        const float I = __fadd_rn(
            __fadd_rn(coupling(W, w_stride, s, a, t), coupling(W, w_stride, s, pa, t)),
            __fadd_rn(coupling(W, w_stride, s, a, pt), coupling(W, w_stride, s, pa, pt)));
        neg = __fadd_rn(neg, fminf(I, 0.0f));
      }
      keep = __fadd_rn(s.gain[a], warp_sum(neg)) > 0.0f;
    }
    push(cluster, s.cand2, a, keep, lane);
  }
  cluster.sync();
  for (int a = tid; a < k; a += blockDim.x) s.gain[a] = s.cand2[a] ? s.gbest[a] : KRT_NEG_INF;
  __syncthreads();

  // 4. the capacity race over the surviving candidates: each one's net
  //    delta at its own node a and its partner's node b, plus the clamped
  //    deltas there of every higher-priority candidate
  for (int a = a0 + warp; a < a1; a += warps) {
    uint8_t admit = s.cand2[a];
    if (admit && enforce) {
      const int pa = s.p[a];
      const int node_a = s.cur[a], node_b = s.cur[pa];
      float oac = 0.0f, oam = 0.0f, obc = 0.0f, obm = 0.0f;
      for (int t = lane; t < k; t += 32) {
        if (!s.cand2[t] || !before(s, t, a)) continue;
        const int pt = s.p[t];
        const int at = s.cur[t], bt = s.cur[pt];
        const float dc = __fsub_rn(s.c_cpu[pt], s.c_cpu[t]);
        const float dm = __fsub_rn(s.c_mem[pt], s.c_mem[t]);
        const float pac = fmaxf(dc, 0.0f), pbc = fmaxf(-dc, 0.0f);
        const float pam = fmaxf(dm, 0.0f), pbm = fmaxf(-dm, 0.0f);
        oac = __fadd_rn(oac, __fadd_rn(at == node_a ? pac : 0.0f, bt == node_a ? pbc : 0.0f));
        oam = __fadd_rn(oam, __fadd_rn(at == node_a ? pam : 0.0f, bt == node_a ? pbm : 0.0f));
        obc = __fadd_rn(obc, __fadd_rn(at == node_b ? pac : 0.0f, bt == node_b ? pbc : 0.0f));
        obm = __fadd_rn(obm, __fadd_rn(at == node_b ? pam : 0.0f, bt == node_b ? pbm : 0.0f));
      }
      oac = warp_sum(oac);
      oam = warp_sum(oam);
      obc = warp_sum(obc);
      obm = warp_sum(obm);
      const float in_c = __fsub_rn(s.c_cpu[pa], s.c_cpu[a]);
      const float in_m = __fsub_rn(s.c_mem[pa], s.c_mem[a]);
      admit = __fadd_rn(in_c, oac) <= s.free_cpu[a] && __fadd_rn(in_m, oam) <= s.free_mem[a] &&
              __fadd_rn(-in_c, obc) <= s.free_cpu[pa] && __fadd_rn(-in_m, obm) <= s.free_mem[pa];
    }
    push(cluster, s.adm, a, admit, lane);
  }
  cluster.sync();  // the last remote writes: no block reads another's memory after this

  // 5. both members of an admitted pair move to each other's node; every
  //    block works the full-width results out for itself
  for (int i = tid; i < C; i += blockDim.x) {
    s.new_full[i] = s.cur_full[i];
    s.sw_full[i] = 0;
  }
  __syncthreads();
  for (int a = tid; a < k; a += blockDim.x) {
    const int pa = s.p[a];
    const bool sw = s.adm[a] || (s.mutual[a] && s.adm[pa]);
    s.new_full[s.sel[a]] = sw ? s.cur[pa] : s.cur[a];
    s.sw_full[s.sel[a]] = sw;
  }
  __syncthreads();
  for (int i = i0 + tid; i < i1; i += blockDim.x) {
    new_node[i] = s.new_full[i];
    swapped[i] = s.sw_full[i];
    assign[s.svc_full[i]] = s.new_full[i];
  }
  if (rank == 0 && warp == 0) {
    int n = 0;
    for (int a = lane; a < k; a += 32) n += s.adm[a];
    n = warp_sum(n);
    if (lane == 0) *n_swaps = n;
  }
  // the load commit at the nodes an admitted swap touches (its two nodes),
  // each node by the warp of the lowest admitted subset row touching it:
  // arrivals added (index new_node, +demand), then departures (index cur,
  // -demand)
  for (int task = warp; task < 2 * (a1 - a0); task += warps) {
    const int a = a0 + (task >> 1);
    if (!s.adm[a]) continue;
    const int n = (task & 1) ? s.cur[s.p[a]] : s.cur[a];
    bool earlier = false;
    for (int b = lane; b < a; b += 32) {
      earlier |= s.adm[b] && (s.cur[b] == n || s.cur[s.p[b]] == n);
    }
    if (__any_sync(kFull, earlier)) continue;
    int m_in = 0, m_out = 0;
    for (int base = 0; base < C; base += 32) {
      const int i = base + lane;
      m_in += __popc(__ballot_sync(kFull, i < C && s.new_full[i] == n));
      m_out += __popc(__ballot_sync(kFull, i < C && s.cur_full[i] == n));
    }
    RunSum in, out;
    in.start(m_in);
    out.start(m_out);
    for (int base = 0; base < C; base += 32) {
      const int i = base + lane;
      const unsigned hit_in = __ballot_sync(kFull, i < C && s.new_full[i] == n);
      const unsigned hit_out = __ballot_sync(kFull, i < C && s.cur_full[i] == n);
      if ((hit_in | hit_out) == 0) continue;
      const bool sw = i < C && s.sw_full[i];
      const float dc = sw ? s.c_cpu_full[i] : 0.0f, dm = sw ? s.c_mem_full[i] : 0.0f;
      in.add(hit_in, dc, dm, lane);
      out.add(hit_out, -dc, -dm, lane);
    }
    in.finish();
    out.finish();
    if (lane == 0) {
      float lc = cpu_load[n], lm = mem_load[n];
      if (m_in > 0) {
        lc = __fadd_rn(lc, in.pc);
        lm = __fadd_rn(lm, in.pm);
      }
      if (m_out > 0) {
        lc = __fadd_rn(lc, out.pc);
        lm = __fadd_rn(lm, out.pm);
      }
      cpu_out[n] = lc;
      mem_out[n] = lm;
    }
  }
}

template <typename WT>
int launch_decide(const float* M, int N, const float* keys, const void* W, long long w_stride,
                  const long long* w_ids, int* assign, const long long* ids,
                  const uint8_t* svc_valid, const uint8_t* moved, const uint8_t* node_valid,
                  const float* svc_cpu, const float* svc_mem, const float* cpu_load,
                  const float* mem_load, const float* cap, const float* mem_cap, float lam,
                  float ow, const float* pen, const int* home, int C, int k, int enforce,
                  int* new_node, uint8_t* swapped, long long* n_swaps, float* cpu_out,
                  float* mem_out, cudaStream_t stream) {
  const size_t smem = subset_bytes(k, C);
  static size_t granted = 48 * 1024;
  cudaError_t err = krt_allow_smem(swap_decide_kernel<WT>, smem, &granted);
  if (err != cudaSuccess) return err;
  swap_decide_kernel<WT><<<kCluster, kDecideThreads, smem, stream>>>(
      M, N, keys, static_cast<const WT*>(W), w_stride, w_ids, assign, ids, svc_valid, moved,
      node_valid, svc_cpu, svc_mem, cpu_load, mem_load, cap, mem_cap, lam, ow, pen, home, C, k,
      enforce, new_node, swapped, n_swaps, cpu_out, mem_out);
  return cudaGetLastError();
}

}  // namespace

// The chunk's rows are services ids[i] (i64[C]) of the solver's arrays:
// assign (i32), svc_valid (bytes), svc_cpu, svc_mem (f32), and with
// move-cost pricing pen (f32) and home (i32), else both null; moved (bytes,
// [C]) marks the rows the chunk's single phase moved; node_valid (bytes,
// [N]). A row is eligible if its service is valid, not moved and on a valid
// node.

// Kernel 7. M f32[C, N] (16-byte aligned rows with vec4). Writes keys
// f32[C] where k < C; with k >= C it launches and returns. 1 <= C <= 1024.
KRT_EXPORT int krt_swap_desire_launch(int device, const float* M, const int* assign,
                                      const long long* ids, const uint8_t* svc_valid,
                                      const uint8_t* moved, const uint8_t* node_valid,
                                      const float* pen, const int* home, int C, int N, int k,
                                      int vec4, float* keys, void* stream) {
  if (C < 1 || C > kMaxRows || N < 1 || k < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int rows = kDesireThreads / 32;
  const int blocks = k < C ? (C + rows - 1) / rows : 1;
  swap_desire_kernel<<<blocks, kDesireThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      M, assign, ids, svc_valid, moved, node_valid, pen, home, k < C ? C : 0, N, vec4, keys);
  return cudaGetLastError();
}

// Kernel 8. M f32[C, N]; keys f32[C] from kernel 7 (read where k < C); the
// pair weight of subset rows a and b is W[wrow_a * w_stride + wrow_b] with
// wrow = w_ids[sel] (i64, null: sel itself); w_kind 1: bf16 W, 2: f32 W.
// Node vectors cpu_load, mem_load, cap, mem_cap (f32) [N]. Writes new_node
// i32[C], swapped u8[C], n_swaps (one i64), the committed loads cpu_out and
// mem_out f32[N], and assign[ids[i]] = new_node[i]. 1 <= k <= C <= 1024.
KRT_EXPORT int krt_swap_decide_launch(int device, const float* M, int N, const float* keys,
                                      const void* W, int w_kind, long long w_stride,
                                      const long long* w_ids, int* assign, const long long* ids,
                                      const uint8_t* svc_valid, const uint8_t* moved,
                                      const uint8_t* node_valid, const float* svc_cpu,
                                      const float* svc_mem, const float* cpu_load,
                                      const float* mem_load, const float* cap,
                                      const float* mem_cap, float lam, float ow, const float* pen,
                                      const int* home, int C, int k, int enforce, int* new_node,
                                      uint8_t* swapped, long long* n_swaps, float* cpu_out,
                                      float* mem_out, void* stream) {
  if (C < 1 || C > kMaxRows || N < 1 || k < 1 || k > C || (w_kind != 1 && w_kind != 2)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (w_kind == 2) {
    return launch_decide<float>(M, N, keys, W, w_stride, w_ids, assign, ids, svc_valid, moved,
                                node_valid, svc_cpu, svc_mem, cpu_load, mem_load, cap, mem_cap,
                                lam, ow, pen, home, C, k, enforce, new_node, swapped, n_swaps,
                                cpu_out, mem_out, s);
  }
  return launch_decide<__nv_bfloat16>(M, N, keys, W, w_stride, w_ids, assign, ids, svc_valid,
                                      moved, node_valid, svc_cpu, svc_mem, cpu_load, mem_load,
                                      cap, mem_cap, lam, ow, pen, home, C, k, enforce, new_node,
                                      swapped, n_swaps, cpu_out, mem_out, s);
}

// The ordered write of one row of the neighbor mass, shared by every mass
// kernel: the chunk mass and hub mass kernels (sparse_mass.cu) and the dense
// mass kernel (mass.cu) write their rows in device memory, the fused
// mass+score kernel (mass_score.cu) in shared memory.
//
// One warp owns the row. A row is a run of 16-byte vectors of W, described
// by a strip (`strip.load(v)`, zeros past the end; `strip.key(v, e)`;
// `strip.resolve(key, x, col, prod)`), streamed in groups of G vectors per
// lane through two register buffers, so that while the warp lists one group
// the next is in flight. A vector that is zero in every lane (the common
// case: pair weights are sparse) costs one vote. Each nonzero weight is
// listed as (key, weight) in a short per-warp list in shared memory, in
// column order (vectors in order, each lane's elements in order), the key
// naming the element (its W column, or its column in a tgt/rvu slab). The
// keys are resolved only when the list is added, a whole list at once (the
// target column, -1 when the element adds nothing, and the product), so a
// row of thousands of columns waits on device memory once per list of up to
// 256 entries, not once per vector that holds a weight. The list is added
// 32 entries at a time: a column's group comes from one match instruction,
// and its lowest lane sums it in lane order and writes the column.
//
// No atomics: the row is the same on every run for any weights, and the
// order does not depend on G, so two kernels that list the same strip (the
// chunk mass and fused kernels) write the same bits. For integer weights
// and replica counts every partial sum is exact, so the row also equals the
// plain version (an f32 product) bit for bit.
#pragma once

#include "sparse_tile.cuh"

constexpr unsigned kFull = 0xffffffffu;

// The long rows of the dense mass and hub mass kernels: rows (warps) per
// CUDA block, and vectors per lane in each register buffer (up to 2 x 8 KB
// in flight per warp; depth 8 against 2 and 4: `bench.mass_sweep`).
constexpr int kLongRowWarps = 4;
constexpr int kLongRowDepth = 8;

// Products one lane-round over 32 vectors of T can add: the per-warp list
// holds this many int2 entries.
template <typename T>
__host__ __device__ constexpr int krt_list_len() {
  return 32 * (16 / static_cast<int>(sizeof(T)));
}

// A warp's ordered row between vectors (both warp uniform): the entries
// listed and not yet added, and whether the row still holds only its zeros
// (so the first round stores over them instead of reading them back).
struct KrtRow {
  int count;
  bool fresh;
};

// Adds a row's listed entries (at most krt_list_len<T>(), a list's worth)
// into `out`: first every lane resolves its entries of every round (one
// wait on memory for the whole list), then the rounds of 32 are added in
// order; a column's group comes from one match instruction, and its lowest
// lane sums it in lane order over as many shuffle steps as the round's
// largest group holds (one or two on rows of sparse pair weights).
template <typename T, typename Strip>
__device__ __forceinline__ void krt_add_entries(const Strip& strip, const int2* list, int count,
                                                float* out, bool& fresh, int lane) {
  constexpr int kRounds = krt_list_len<T>() / 32;
  __syncwarp();  // the row's zeros and every lane's list entries, in order
  int col[kRounds];
  float p[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    col[r] = -1;
    p[r] = 0.0f;
    if (r * 32 + lane < count) {
      const int2 ent = list[r * 32 + lane];
      strip.resolve(ent.x, __int_as_float(ent.y), col[r], p[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r * 32 >= count) break;
    const unsigned group = __match_any_sync(kFull, col[r]);
    const int size = __popc(group);
    const int steps = static_cast<int>(__reduce_max_sync(kFull, col[r] >= 0 ? size : 0));
    unsigned rest = group;
    float sum = 0.0f;
    for (int k = 0; k < steps; ++k) {
      const int b = rest ? __ffs(rest) - 1 : lane;
      rest &= rest - 1;
      const float q = __shfl_sync(kFull, p[r], b);
      if (k < size) sum = __fadd_rn(sum, q);
    }
    if (col[r] >= 0 && __ffs(group) - 1 == lane) {
      out[col[r]] = fresh ? sum : __fadd_rn(out[col[r]], sum);
    }
    fresh = false;
    __syncwarp();
  }
}

// Lists the nonzero weights of vector v (one per lane: `raw`) as entries,
// lanes in order and each lane's own in element order, after the row's
// earlier ones; the list is added first when they would overflow it. Kept
// out of line: it runs only for vectors that hold a nonzero weight, and one
// copy serves every unrolled call site.
template <typename T, typename Strip>
__device__ __noinline__ KrtRow krt_list_vector(int4 raw, int v, Strip strip, int2* list,
                                               float* out, int lane, KrtRow row) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kList = krt_list_len<T>();
  const T* wv = reinterpret_cast<const T*>(&raw);
  int mine = 0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) mine += krt_to_float(wv[e]) != 0.0f;
  // positions from the bits of the counts (at most VEC), one ballot a bit:
  // no chain of shuffles
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
  int incl = 0;
  int total = 0;
#pragma unroll
  for (int bit = 0; (1 << bit) <= VEC; ++bit) {
    const unsigned plane = __ballot_sync(kFull, (mine >> bit) & 1);
    incl += __popc(plane & upto) << bit;
    total += __popc(plane) << bit;
  }
  if (total == 0) return row;
  if (row.count + total > kList) {
    krt_add_entries<T>(strip, list, row.count, out, row.fresh, lane);
    row.count = 0;
  }
  int pos = row.count + incl - mine;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float x = krt_to_float(wv[e]);
    if (x != 0.0f) list[pos++] = make_int2(strip.key(v, e), __float_as_int(x));
  }
  row.count += total;
  return row;
}

// Lists the vectors of one group (G per lane, vectors g0 + q * 32 + lane).
template <typename T, int G, typename Strip>
__device__ __forceinline__ void krt_list_group(const int4 (&raw)[G], int g0, const Strip& strip,
                                               int2* list, float* out, int lane, KrtRow& row) {
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int4 r = raw[q];
    if (!__any_sync(kFull, (r.x | r.y | r.z | r.w) != 0)) continue;
    row = krt_list_vector<T>(r, g0 + q * 32 + lane, strip, list, out, lane, row);
  }
}

template <int G, typename Strip>
__device__ __forceinline__ void krt_load_group(const Strip& strip, int g0, int lane,
                                               int4 (&raw)[G]) {
#pragma unroll
  for (int q = 0; q < G; ++q) raw[q] = strip.load(g0 + q * 32 + lane);
}

// The whole ordered row of `strip.vecs` vectors into `out`, which holds
// zeros; `a` and `b` hold groups 0 and 1, already loaded (krt_load_group at
// g0 = 0 and G * 32), so a caller can issue them before the row's zeros;
// `list` is the warp's own krt_list_len<T>() entries. The row is complete
// on return.
template <typename T, int G, typename Strip>
__device__ __forceinline__ void krt_stream_row(const Strip& strip, int4 (&a)[G], int4 (&b)[G],
                                               int2* list, float* out, int lane) {
  constexpr int kStep = G * 32;
  const int vecs = strip.vecs;
  KrtRow row{0, true};
  for (int g0 = 0; g0 < vecs; g0 += 2 * kStep) {
    krt_list_group<T, G>(a, g0, strip, list, out, lane, row);
    if (g0 + 2 * kStep < vecs) krt_load_group<G>(strip, g0 + 2 * kStep, lane, a);
    if (g0 + kStep < vecs) {
      krt_list_group<T, G>(b, g0 + kStep, strip, list, out, lane, row);
      if (g0 + 3 * kStep < vecs) krt_load_group<G>(strip, g0 + 3 * kStep, lane, b);
    }
  }
  krt_add_entries<T>(strip, list, row.count, out, row.fresh, lane);
}

// Slab column u's term for weight x: tgt[u] is the target column (adds
// nothing unless it lies in [0, nn) and the replica factor rvu[u], rounded
// to W's type as the plain version's scaled one-hot tile holds it, is
// nonzero), the product x * rvu[u].
template <typename T>
__device__ __forceinline__ void krt_slab_term(int t, float rvu, float x, int nn, int& col,
                                              float& prod) {
  const float r = krt_as_w<T>(rvu);
  col = r != 0.0f && t >= 0 && t < nn ? t : -1;
  prod = __fmul_rn(x, r);
}

// A strip row of the chunk mass and fused kernels: `vecs` vectors of W from
// `w`, element u (key v * VEC + e) adding to column tgt[u] through the slab
// (tgt, rvu) in shared or device memory.
template <typename T>
struct KrtSlabRow {
  const T* w;
  int vecs;
  const int* tgt;
  const float* rvu;
  int nn;

  __device__ __forceinline__ int4 load(int v) const {
    return v < vecs ? __ldg(reinterpret_cast<const int4*>(w) + v) : make_int4(0, 0, 0, 0);
  }

  __device__ __forceinline__ int key(int v, int e) const {
    return v * (16 / static_cast<int>(sizeof(T))) + e;
  }

  __device__ __forceinline__ void resolve(int u, float x, int& col, float& prod) const {
    krt_slab_term<T>(tgt[u], rvu[u], x, nn, col, prod);
  }
};

// Vectors per lane in each register buffer of a strip row: 4 vectors per
// lane in flight (2 KB per warp), the whole 1024-column bf16 strip of the
// 50k graph's chunk in its first two groups.
constexpr int kStripDepth = 2;

// A row of M's zeros straight to device memory from one warp: 16-byte
// stores where the row is whole float4s (nn a multiple of 4, M from the
// allocator), else scalar ones. Nothing waits on them.
__device__ __forceinline__ void krt_zero_row(float* out, int nn, int lane) {
  if ((nn & 3) == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int c = lane; c < (nn >> 2); c += 32) out4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int c = lane; c < nn; c += 32) out[c] = 0.0f;
  }
}

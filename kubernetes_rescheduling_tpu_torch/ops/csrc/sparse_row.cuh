// The ordered write of one row of the sparse neighbor mass, shared by the
// chunk mass kernel (sparse_mass.cu, output row in device memory) and the
// fused mass+score kernel (mass_score.cu, output row in shared memory).
//
// One warp owns the row. It streams the row's W strip (16-byte loads,
// kStripGroup vectors per lane at once), keeps the nonzero products in
// column order in a short per-warp list in shared memory, and adds them 32
// at a time: the lanes of one target column form a group (found by
// shuffles), and the group's lowest lane sums the group in lane order and
// writes the column. No atomics: the row is the same on every run for any
// weights, and the two kernels that share this routine write the same bits.
// For integer weights and replica counts every partial sum is exact, so the
// row also equals the plain version (an f32 product) bit for bit.
#pragma once

#include "sparse_tile.cuh"

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStripGroup = 4;  // 16-byte vectors of the strip each lane loads at once

// Products one lane-round over 32 vectors of T can add: the per-warp list
// holds this many int2 entries.
template <typename T>
__host__ __device__ constexpr int krt_list_len() {
  return 32 * (16 / static_cast<int>(sizeof(T)));
}

// Adds a warp's listed products (column, f32 bits) into its row `out`, 32
// at a time: the lanes of one target column form a group, whose lowest lane
// sums the group in lane order and writes the column. `fresh` (warp
// uniform) says no product of this row was written yet, so the first round
// stores over the zeros instead of reading them back.
__device__ __forceinline__ void krt_add_products(const int2* list, int count, float* out,
                                                 bool& fresh, int lane) {
  __syncwarp();  // the row's zeros and every lane's list entries, in order
  for (int r0 = 0; r0 < count; r0 += 32) {
    const int n = min(32, count - r0);
    const int2 ent = lane < n ? list[r0 + lane] : make_int2(-1, 0);
    const float p = __int_as_float(ent.y);
    float sum = 0.0f;
    int first = 32;  // the group's lowest lane
    for (int b = 0; b < n; ++b) {
      const int c = __shfl_sync(kFull, ent.x, b);
      const float q = __shfl_sync(kFull, p, b);
      if (c == ent.x) {
        sum = __fadd_rn(sum, q);
        first = min(first, b);
      }
    }
    if (lane < n && first == lane) out[ent.x] = fresh ? sum : __fadd_rn(out[ent.x], sum);
    fresh = false;
    __syncwarp();
  }
}

// Loads strip vectors g0 + q * 32 + lane (q < kStripGroup) of the row `w`
// (`vecs` 16-byte vectors long; past the end, zeros).
template <typename T>
__device__ __forceinline__ void krt_load_strip(const T* __restrict__ w, int vecs, int g0,
                                               int lane, int4 (&raw)[kStripGroup]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < kStripGroup; ++q) {
    const int v = g0 + q * 32 + lane;
    raw[q] = v < vecs ? *reinterpret_cast<const int4*>(w + static_cast<long long>(v) * VEC)
                      : make_int4(0, 0, 0, 0);
  }
}

// out[tgt[u]] += w[u] * rvu[u] for u < vecs * VEC, tgt in [0, nn), in the
// fixed order above. `raw` holds the strip's first group, already loaded
// (krt_load_strip at g0 = 0), so a caller can issue those loads early;
// `out` holds zeros; `list` is the warp's own krt_list_len<T>() entries.
template <typename T>
__device__ __forceinline__ void krt_ordered_row(const T* __restrict__ w, int vecs,
                                                int4 (&raw)[kStripGroup], const int* tgt,
                                                const float* rvu, int nn, int2* list,
                                                float* out, int lane) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kList = krt_list_len<T>();
  int count = 0;      // warp uniform
  bool fresh = true;  // warp uniform
  for (int g0 = 0; g0 < vecs; g0 += kStripGroup * 32) {
    if (g0 > 0) krt_load_strip(w, vecs, g0, lane, raw);
#pragma unroll
    for (int q = 0; q < kStripGroup; ++q) {
      const int v = g0 + q * 32 + lane;
      const T* wv = reinterpret_cast<const T*>(&raw[q]);
      int col[VEC];
      float prod[VEC];
      int mine = 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        col[e] = -1;
        const float x = krt_to_float(wv[e]);
        if (x == 0.0f) continue;
        const int u = v * VEC + e;
        const int t = tgt[u];
        const float r = krt_as_w<T>(rvu[u]);
        if (r != 0.0f && t >= 0 && t < nn) {
          col[e] = t;
          prod[e] = __fmul_rn(x, r);
          ++mine;
        }
      }
      // list positions in column order: lanes in order, each lane's own in e order
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      if (total == 0) continue;
      if (count + total > kList) {
        krt_add_products(list, count, out, fresh, lane);
        count = 0;
      }
      int pos = count + incl - mine;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (col[e] >= 0) list[pos++] = make_int2(col[e], __float_as_int(prod[e]));
      }
      count += total;
    }
  }
  krt_add_products(list, count, out, fresh, lane);
}

// Kernel 9: each directed edge's cross-node pod pairs, the general branch of
// the sparse solve's input cost (solver/sparse_solver.py:
// sparse_pod_comm_cost). It replaces no TPU kernel: the JAX package computes
// that branch in plain XLA behind a lax.cond, as a dense count grid
// cnt[SP, N] whose rows it gathers and multiplies an edge chunk at a time.
// The port has no conditional graph node, so it computes both branches on
// every solve; the grid form stays as ops/pod_cost.py's plain twin, the CPU
// path and the oracle this kernel is held to.
//
// Input: the pods' run lists (ops/pod_cost.py: run_lists). Every placed
// pod's key slot * (N + 1) + node, sorted; an unplaced pod's key is
// SP * (N + 1), which sorts after every placed one. offs[s] .. offs[s + 1]
// is slot s's range, sorted by node, and its length is the slot's pod count.
//
// One thread an edge (s, t, w). It walks the node runs of the shorter of
// the two ranges and finds each run's node in the longer one by a binary
// search that starts after the previous match (both ranges are sorted by
// node), then counts the matching run. kept = the sum of the run products,
// in 64-bit integers. The thread writes
//   out[e] = w * max(rv_s * rv_t - kept, 0)
// in f32, each operation rounded on its own (the _rn intrinsics: no FMA), as
// the grid form's separate torch ops round them, so the output equals the
// plain twin's bit for bit wherever the counts are below 2^24.
//
// Work an edge: O(min(rv_s, rv_t) * log max(rv_s, rv_t)), against the grid
// form's O(N) gather, multiply and sum. Memory: the keys and offsets,
// O(P + SP), against the grid's (SP + 1) x (N + 1) of int64 and f32.
//
// Bound on the card: bytes. Each edge reads its two slot ids and its weight
// and writes its term (16 B); the offsets (8 B a slot) and the keys (8 B a
// pod) are read at least once. At 150,000 pods of one pod a slot and
// 899,982 directed edges that is about 17 MB, 5 us at 3.35 TB/s. What is
// left is the latency of the dependent loads (ids -> offsets -> keys); one
// thread an edge keeps many of them in flight, and the offsets and keys
// (2.4 MB there) stay in L2.

#include "krt_common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;

// The first position in [lo, hi) whose key is not below `key`.
__device__ __forceinline__ long long first_not_below(const long long* __restrict__ keys,
                                                     long long lo, long long hi,
                                                     long long key) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    pod_cross_kernel(const long long* __restrict__ keys, const long long* __restrict__ offs,
                     const int* __restrict__ src, const int* __restrict__ dst,
                     const float* __restrict__ w, long long E2, long long n1,
                     float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= E2) return;
  long long s = __ldg(src + e), t = __ldg(dst + e);
  long long a = __ldg(offs + s), a_end = __ldg(offs + s + 1);
  long long b = __ldg(offs + t), b_end = __ldg(offs + t + 1);
  const long long na = a_end - a, nb = b_end - b;
  if (na > nb) {  // walk the shorter range
    long long x = a; a = b; b = x;
    x = a_end; a_end = b_end; b_end = x;
    x = s; s = t; t = x;
  }
  // a key of slot s on node n is s * n1 + n; the same node's key in slot t
  const long long to_b = (t - s) * n1;
  long long kept = 0;
  while (a < a_end && b < b_end) {
    const long long key = __ldg(keys + a);
    long long run_end = a + 1;
    while (run_end < a_end && __ldg(keys + run_end) == key) ++run_end;
    const long long target = key + to_b;
    b = first_not_below(keys, b, b_end, target);
    long long match_end = b;
    while (match_end < b_end && __ldg(keys + match_end) == target) ++match_end;
    kept += (run_end - a) * (match_end - b);
    a = run_end;
    b = match_end;
  }
  const float pairs = __fmul_rn(static_cast<float>(na), static_cast<float>(nb));
  const float cross = fmaxf(__fsub_rn(pairs, static_cast<float>(kept)), 0.0f);
  out[e] = __fmul_rn(__ldg(w + e), cross);
}

}  // namespace

// keys i64[P] sorted, offs i64[SP + 1]; src, dst i32[E2] slot ids below SP;
// w f32[E2]; n1 = N + 1. Writes out f32[E2]. Launches nothing when E2 is 0.
KRT_EXPORT int krt_pod_cross_launch(int device, const long long* keys, const long long* offs,
                                    const int* src, const int* dst, const float* w,
                                    long long E2, long long n1, float* out, void* stream) {
  if (E2 < 0 || n1 < 1) return cudaErrorInvalidValue;
  const long long blocks = (E2 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (E2 == 0) return cudaSuccess;
  pod_cross_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(keys, offs, src, dst, w, E2, n1, out);
  return cudaGetLastError();
}

// Pairwise capacity race and commit arithmetic of one solver chunk:
// replaces the Pallas kernel `admission_stage` / `_admission_kernel` in
// kubernetes_rescheduling_tpu/ops/fused_admission.py.
//
// A wanting row i lands on prop[i] only if the slack there covers the
// CPU and memory of every same-target arrival j that comes before it
// (greater gain, ties -> lower index) plus itself. Then new_node =
// admitted ? prop : cur, optional one-hot occupancy rows x_rows[C, N], and
// the per-node net load deltas d[n] = sum over rows of (moved in - moved
// out).
//
// Bound on the card: launch latency. It reads and writes well under
// 0.1 MB and does about C^2 comparisons (1M at C = 1024), microseconds of
// the card's issue rate. Design: two passes, one warp per output.
//  1. race: a warp per row; each lane walks one contiguous segment of j in
//     ascending order, summing the landed CPU and memory in full f32 (no
//     TF32, no bf16), and the lanes' sums are added in lane order, so the
//     whole sum runs over j in ascending order and two runs give the same
//     decisions. The same warp writes the row's one-hot occupancy row.
//  2. deltas: a warp per node, the same segmented ascending walk over the
//     rows. No float atomics anywhere.
// Rows >= C never exist in either pass. The sums are exact — and so equal
// to the plain version's whatever its order — for integer-valued loads.

#include "krt_common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block, in both passes

// sum over lanes in lane order: ((v_0 + v_1) + v_2) + ... on every lane
__device__ __forceinline__ float lane_ordered_sum(float v) {
  float total = 0.0f;
#pragma unroll
  for (int l = 0; l < 32; ++l) total = __fadd_rn(total, __shfl_sync(0xffffffffu, v, l));
  return total;
}

template <typename XT>
__global__ void __launch_bounds__(kWarps * 32)
race_kernel(const int* __restrict__ prop, const float* __restrict__ gain,
            const int* __restrict__ wants, const float* __restrict__ slack_cpu,
            const float* __restrict__ slack_mem, const int* __restrict__ cur,
            const uint8_t* __restrict__ valid, const float* __restrict__ c_cpu,
            const float* __restrict__ c_mem, int C, int N, int enforce_capacity,
            int* __restrict__ new_node, uint8_t* __restrict__ admitted,
            XT* __restrict__ x_rows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= C) return;  // whole warp exits together

  const int p = prop[r];
  const bool w = wants[r] != 0;
  bool adm = w;
  if (enforce_capacity && w) {
    const float g = gain[r];
    const int seg = (C + 31) / 32;
    const int j_end = min(C, (lane + 1) * seg);
    float land_cpu = 0.0f;
    float land_mem = 0.0f;
    for (int j = lane * seg; j < j_end; ++j) {
      if (wants[j] == 0 || prop[j] != p) continue;
      const float gj = gain[j];
      if (gj > g || (gj == g && j < r)) {
        land_cpu = __fadd_rn(land_cpu, c_cpu[j]);
        land_mem = __fadd_rn(land_mem, c_mem[j]);
      }
    }
    land_cpu = lane_ordered_sum(land_cpu);
    land_mem = lane_ordered_sum(land_mem);
    adm = land_cpu <= slack_cpu[r] && land_mem <= slack_mem[r];
  }
  const int nn = adm ? p : cur[r];
  if (lane == 0) {
    new_node[r] = nn;
    admitted[r] = adm ? 1 : 0;
  }
  if (x_rows != nullptr) {  // x[r, n] = [n == new_node[r]] * valid[r]
    const bool v = valid[r] != 0;
    XT* row = x_rows + static_cast<long long>(r) * N;
    for (int n = lane; n < N; n += 32) row[n] = XT((v && n == nn) ? 1.0f : 0.0f);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
delta_kernel(const int* __restrict__ new_node, const int* __restrict__ cur,
             const float* __restrict__ c_cpu, const float* __restrict__ c_mem, int C, int N,
             float* __restrict__ d_cpu, float* __restrict__ d_mem) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // whole warp exits together
  const int seg = (C + 31) / 32;
  const int r_end = min(C, (lane + 1) * seg);
  float dc = 0.0f;
  float dm = 0.0f;
  for (int r = lane * seg; r < r_end; ++r) {
    const int to = new_node[r];
    const int from = cur[r];
    if (to == from || (to != n && from != n)) continue;  // adds exactly 0
    // (moved in) - (moved out), per row
    dc = __fadd_rn(dc, __fsub_rn(to == n ? c_cpu[r] : 0.0f, from == n ? c_cpu[r] : 0.0f));
    dm = __fadd_rn(dm, __fsub_rn(to == n ? c_mem[r] : 0.0f, from == n ? c_mem[r] : 0.0f));
  }
  dc = lane_ordered_sum(dc);
  dm = lane_ordered_sum(dm);
  if (lane == 0) {
    d_cpu[n] = dc;
    d_mem[n] = dm;
  }
}

template <typename XT>
int launch(const int* prop, const float* gain, const int* wants, const float* slack_cpu,
           const float* slack_mem, const int* cur, const uint8_t* valid, const float* c_cpu,
           const float* c_mem, int C, int N, int enforce_capacity, int* new_node,
           uint8_t* admitted, float* d_cpu, float* d_mem, void* x_rows, cudaStream_t stream) {
  race_kernel<XT><<<(C + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      prop, gain, wants, slack_cpu, slack_mem, cur, valid, c_cpu, c_mem, C, N,
      enforce_capacity, new_node, admitted, static_cast<XT*>(x_rows));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  delta_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      new_node, cur, c_cpu, c_mem, C, N, d_cpu, d_mem);
  return cudaGetLastError();
}

}  // namespace

// Inputs [C]: prop, wants, cur (i32), gain, slack_cpu, slack_mem, c_cpu,
// c_mem (f32), valid (u8). Outputs: new_node i32[C], admitted u8[C],
// d_cpu / d_mem f32[N], and x_rows [C, N] (x_kind 0: none, 1: bf16, 2: f32).
KRT_EXPORT int krt_admission_launch(int device, const int* prop, const float* gain,
                                    const int* wants, const float* slack_cpu,
                                    const float* slack_mem, const int* cur,
                                    const uint8_t* valid, const float* c_cpu,
                                    const float* c_mem, int C, int N, int enforce_capacity,
                                    int* new_node, uint8_t* admitted, float* d_cpu,
                                    float* d_mem, void* x_rows, int x_kind, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_kind == 2) {
    return launch<float>(prop, gain, wants, slack_cpu, slack_mem, cur, valid, c_cpu, c_mem, C,
                         N, enforce_capacity, new_node, admitted, d_cpu, d_mem, x_rows, s);
  }
  return launch<__nv_bfloat16>(prop, gain, wants, slack_cpu, slack_mem, cur, valid, c_cpu,
                               c_mem, C, N, enforce_capacity, new_node, admitted, d_cpu,
                               d_mem, x_kind == 1 ? x_rows : nullptr, s);
}

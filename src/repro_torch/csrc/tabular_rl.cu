// Fused tabular-RL act+update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/tabular_rl.py
// (tabular_rl_kernel, body _kernel). Per fleet cell c, on a (cells, S, K)
// float32 Q-table:
//   td        = r + gamma * max_k q[c, s2, k] - q[c, s, a]   (pre-update)
//   q[c,s,a] += alpha * td                                     (in place)
//   greedy2   = first-index argmax of q[c, s2, :] after the update
//               (when s2 == s the freshly written entry takes part)
//
// Bound: memory. The work per cell is one K-wide row read plus a few
// scalars; there is no reuse across cells. Design: one warp per cell, the
// lanes stride over row s2 with neighbouring lanes on neighbouring
// addresses (coalesced), warp shuffles reduce the max and the first-index
// argmax, and lane 0 writes the one updated entry. A row of up to 256
// entries is read once, with all of a lane's loads issued together into
// registers (the gather of random rows is latency-bound, so the loads must
// be in flight at once); a wider row is read twice, the second time from
// L1. Cells own disjoint slabs, so there are no races. The TD arithmetic
// uses the _rn intrinsics so nvcc cannot contract it into an FMA: the
// result is bit-identical to the plain PyTorch version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPerLane = 8;  // rows up to 256 wide stay in registers

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ void merge_argmax(float& v, int& i, float ov,
                                             int oi, int empty) {
  // (value, index) pairs; `empty` marks a lane that saw no element
  if (oi == empty) return;
  if (i == empty || ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tabular_rl_kernel(float* __restrict__ q, const int* __restrict__ s,
                  const int* __restrict__ a, const float* __restrict__ r,
                  const int* __restrict__ s2, int* __restrict__ greedy2,
                  float* __restrict__ td_out, int cells, int n_states,
                  int n_actions, float alpha, float gamma) {
  const int lane = threadIdx.x & 31;
  const long long cell =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= cells) return;  // the whole warp leaves together
  const int sc = s[cell], ac = a[cell], s2c = s2[cell];
  if (sc < 0 || sc >= n_states || s2c < 0 || s2c >= n_states || ac < 0 ||
      ac >= n_actions) {
    if (lane == 0) {  // out-of-range index: flag it, touch no table entry
      greedy2[cell] = -1;
      td_out[cell] = NAN;
    }
    return;
  }
  float* slab = q + cell * (long long)n_states * n_actions;
  const float q_sa = slab[(long long)sc * n_actions + ac];
  const float* row2 = slab + (long long)s2c * n_actions;

  const bool same = (s2c == sc);
  float bv = -INFINITY;
  int bi = n_actions;  // "empty"
  float td, v_new;
  if (n_actions <= 32 * kPerLane) {
    // the row fits in registers: one unrolled, coalesced read of row s2
    float v[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      v[t] = j < n_actions ? row2[j] : -INFINITY;
    }
    float m = v[0];
#pragma unroll
    for (int t = 1; t < kPerLane; ++t) m = fmaxf(m, v[t]);
    m = warp_max(m);
    td = __fsub_rn(__fadd_rn(r[cell], __fmul_rn(gamma, m)), q_sa);
    v_new = __fadd_rn(q_sa, __fmul_rn(alpha, td));
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      const float x = (same && j == ac) ? v_new : v[t];
      if (j < n_actions && (bi == n_actions || x > bv)) {
        bv = x;
        bi = j;
      }
    }
  } else {
    // wide rows: pass 1 takes the pre-update max, pass 2 (from L1) the
    // post-update argmax
    float m = -INFINITY;
    for (int j = lane; j < n_actions; j += 32) m = fmaxf(m, row2[j]);
    m = warp_max(m);
    td = __fsub_rn(__fadd_rn(r[cell], __fmul_rn(gamma, m)), q_sa);
    v_new = __fadd_rn(q_sa, __fmul_rn(alpha, td));
    for (int j = lane; j < n_actions; j += 32) {
      const float x = (same && j == ac) ? v_new : row2[j];
      if (bi == n_actions || x > bv) {
        bv = x;
        bi = j;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    merge_argmax(bv, bi, ov, oi, n_actions);
  }
  if (lane == 0) {  // every lane's reads are done: the shuffles synced them
    slab[(long long)sc * n_actions + ac] = v_new;
    greedy2[cell] = bi;
    td_out[cell] = td;
  }
}

}  // namespace

extern "C" int tabular_rl_launch(void* q, const void* s, const void* a,
                                 const void* r, const void* s2,
                                 void* greedy2, void* td, int cells,
                                 int n_states, int n_actions, float alpha,
                                 float gamma, void* stream) {
  if (cells <= 0) return 0;
  const int blocks = (cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  tabular_rl_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(q), static_cast<const int*>(s),
      static_cast<const int*>(a), static_cast<const float*>(r),
      static_cast<const int*>(s2), static_cast<int*>(greedy2),
      static_cast<float*>(td), cells, n_states, n_actions, alpha, gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tabular_rl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

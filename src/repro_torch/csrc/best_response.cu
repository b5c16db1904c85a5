// One best-response round of the coupled-fleet oracle for Hopper (sm_90a).
//
// Port-only: the reference has no Pallas kernel here. This replaces the
// jitted fori_loop of repro/fleet/population.py _best_response_round, one
// Gauss-Seidel sweep of topology_bruteforce. Cells are visited in order;
// cell i scores each of the K candidate joint actions j by its nominal
// expected response given every other cell's current decision
//   n_e  = (edge_tot[e_i] - e_cnt_i + cand_e[i, j]) / edge_capacity[e_i]
//   mult = cloud_load_multiplier(cloud_tot - c_cnt_i + cand_c[i, j])
//   ms_j = mean over member users of the latency model at (n_e,
//          cand_c[i, j], mult), infinite where feas[i, j] is false
// takes the first-index argmin j* and switches only on a strict
// improvement, ms_j* < ms_cur - 1e-6; the running per-edge and cloud job
// totals then take the cell's new counts before cell i + 1 is scored.
//
// Bound: the sweep is sequential over cells (each cell reads the totals
// the previous one wrote), so the floor is the chain of cells x (one
// block reduction + two barriers), measured as the kernel's time at K = 1.
// Against it, the work per round is the three (cells, K) tables read
// once (9 bytes an entry) and ~(10 + 12 N) FP32 operations per entry.
// Design: one thread block walks the cells; its 256 threads split the K
// candidates (thread t takes j = t, t + 256, ...), so a round is one
// launch. A warp shuffle and one pass over the warps' results reduce
// (score, index) with ties to the lower index, and thread 0 applies the
// switch rule and updates the totals (edge totals in global scratch,
// the cloud total in shared memory). The host reads the `changed` flag
// once per round, as the reference reads (new_idx == idx).all().
//
// Exactness: one flipped argmin changes every later cell, so the kernel
// evaluates in the plain version's order of operations with the _rn
// intrinsics (nvcc cannot contract them into an FMA of its own): the
// link capacities as products with their float32 reciprocals, the
// capacity tier, the queue size and the member count as true quotients,
// users summed left to right, and the multiply-adds that the reference's
// XLA compiler fuses as one rounding of a float64 sum, as the plain
// version emulates them (dynamics.fma). The card's indices equal the
// plain version's bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxUsers = 8;
constexpr int kEdge = 8, kCloud = 9;  // per-user action ids
constexpr float kTol = 1e-6f;         // BEST_RESPONSE_TOL
constexpr float kQueueMax = 8.0f;     // CLOUD_QUEUE_MAX

// the latency model's float32 constants, in the plain version's values
struct Consts {
  float t_orch[2], t_up[2], t_hop[2], t_comp[8], t_comp0;
  float mem, inv_edge_cap, inv_cloud_cap;
};

// a * b + c with one rounding, as dynamics.fma emulates XLA's fused
// multiply-add: the float64 product of two floats is exact
__device__ __forceinline__ float fma_emul(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ void merge_argmin(float& v, int& i, float ov,
                                             int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
best_response_kernel(const int* __restrict__ idx_in, int* __restrict__ idx_out,
                     int* __restrict__ changed,
                     const int* __restrict__ pu_packed,
                     const int* __restrict__ end_b,
                     const int* __restrict__ edge_b,
                     const unsigned char* __restrict__ member,
                     const unsigned char* __restrict__ feas,
                     const int* __restrict__ cand_e,
                     const int* __restrict__ cand_c,
                     const int* __restrict__ cell_edge,
                     const float* __restrict__ edge_capacity,
                     int* __restrict__ edge_tot,
                     const float* __restrict__ calib_scale,
                     const float* __restrict__ calib_off, Consts c,
                     int cells, int n_actions, int users, int n_edges,
                     float cloud_servers) {
  __shared__ int s_cloud;
  __shared__ float s_cur;
  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool calibrated = calib_scale != nullptr;
  float scale[3] = {1.f, 1.f, 1.f}, off[3] = {0.f, 0.f, 0.f};
  if (calibrated) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      scale[k] = calib_scale[k];
      off[k] = calib_off[k];
    }
  }

  // the round's starting totals: edge jobs per edge, cloud jobs overall
  if (tid == 0) s_cloud = 0;
  for (int e = tid; e < n_edges; e += kThreads) edge_tot[e] = 0;
  __syncthreads();
  int my_c = 0;
  for (int i = tid; i < cells; i += kThreads) {
    const size_t at = (size_t)i * n_actions + idx_in[i];
    atomicAdd(&edge_tot[cell_edge[i]], cand_e[at]);
    my_c += cand_c[at];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    my_c += __shfl_xor_sync(0xffffffffu, my_c, o);
  if (lane == 0) atomicAdd(&s_cloud, my_c);
  __syncthreads();

  const float comp_e = c.t_comp0 * 0.5f;   // exact: / TIER_SPEED["E"]
  const float comp_c = c.t_comp0 * 0.25f;  // exact: / TIER_SPEED["C"]
  bool any_change = false;
  for (int i = 0; i < cells; ++i) {
    const size_t row = (size_t)i * n_actions;
    const int e_i = cell_edge[i];
    const int cur = idx_in[i];
    const int e_cnt = cand_e[row + cur], c_cnt = cand_c[row + cur];
    const int base_e = edge_tot[e_i] - e_cnt;
    const int base_c = s_cloud - c_cnt;
    const float cap = edge_capacity[e_i];
    const float hop0 = c.t_hop[edge_b[i]];
    int eb[kMaxUsers];
    bool mem[kMaxUsers];
    int n_mem = 0;
#pragma unroll
    for (int u = 0; u < kMaxUsers; ++u) {
      eb[u] = u < users ? end_b[(size_t)i * users + u] : 0;
      mem[u] = u < users && member[(size_t)i * users + u];
      n_mem += mem[u];
    }
    const float n_users = (float)(n_mem > 1 ? n_mem : 1);

    float best = INFINITY;
    int best_j = n_actions;
    for (int j = tid; j < n_actions; j += kThreads) {
      float score = INFINITY;
      if (feas[row + j]) {
        const float n_e = __fdiv_rn((float)(base_e + cand_e[row + j]), cap);
        const int cc = cand_c[row + j];
        const float n_c = (float)cc;
        const float rho = __fdiv_rn((float)(base_c + cc), cloud_servers);
        float mult = __fdiv_rn(1.0f, fmaxf(__fsub_rn(1.0f, rho),
                                           1.0f / kQueueMax));
        mult = fminf(fmaxf(mult, 1.0f), kQueueMax);
        const float cpu_e = fmaxf(__fmul_rn(n_e, 0.5f), 1.0f);
        const float link_e = fmaxf(__fmul_rn(n_e, c.inv_edge_cap), 1.0f);
        const float mem_e = n_e > 2.0f ? c.mem : 1.0f;
        const float cpu_c = fmaxf(__fmul_rn(n_c, 0.25f), 1.0f);
        const float link_c = fmaxf(__fmul_rn(n_c, c.inv_cloud_cap), 1.0f);
        const float mem_c = n_c > 3.0f ? c.mem : 1.0f;
        const float edge_comp = __fmul_rn(__fmul_rn(comp_e, cpu_e), mem_e);
        const float hop = __fmul_rn(__fmul_rn(hop0, link_c), mult);
        const float cloud_a = __fmul_rn(__fmul_rn(comp_c, cpu_c), mem_c);
        const float cloud_comp = __fmul_rn(cloud_a, mult);
        const int pu = pu_packed[j];
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < kMaxUsers; ++u) {
          if (u >= users) break;
          const int a = (pu >> (4 * u)) & 15;
          float t = 0.0f;
          if (mem[u]) {
            const float orch = c.t_orch[eb[u]], up = c.t_up[eb[u]];
            if (!calibrated) {
              float x;
              if (a < kEdge) {
                x = c.t_comp[a];
              } else if (a == kEdge) {
                x = fma_emul(up, link_e, edge_comp);
              } else {  // the compute term fuses only in a one-user cell
                x = fma_emul(up, link_c, hop);
                x = users == 1 ? fma_emul(cloud_a, mult, x)
                               : __fadd_rn(x, cloud_comp);
              }
              t = __fadd_rn(orch, x);
            } else {
              float comm = orch, comp;
              int tier;
              if (a < kEdge) {
                comp = c.t_comp[a];
                tier = 0;
              } else if (a == kEdge) {
                comm = __fadd_rn(comm, __fmul_rn(up, link_e));
                comp = edge_comp;
                tier = 1;
              } else {
                comm = __fadd_rn(comm, fma_emul(up, link_c, hop));
                comp = cloud_comp;
                tier = 2;
              }
              const float base = __fadd_rn(comm, off[tier]);
              t = fmaxf(fma_emul(scale[tier], comp, base), 0.0f);
            }
          }
          sum = u == 0 ? t : __fadd_rn(sum, t);
        }
        score = __fdiv_rn(sum, n_users);
      }
      if (j == cur) s_cur = score;
      if (score < best) {  // j rises within a thread: the first index wins
        best = score;
        best_j = j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      merge_argmin(best, best_j, __shfl_xor_sync(0xffffffffu, best, o),
                   __shfl_xor_sync(0xffffffffu, best_j, o));
    if (lane == 0) {
      s_v[warp] = best;
      s_i[warp] = best_j;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w)
        merge_argmin(best, best_j, s_v[w], s_i[w]);
      const int nxt =
          best_j < n_actions && best < __fsub_rn(s_cur, kTol) ? best_j : cur;
      idx_out[i] = nxt;
      any_change |= nxt != cur;
      edge_tot[e_i] = base_e + cand_e[row + nxt];
      s_cloud = base_c + cand_c[row + nxt];
    }
    __syncthreads();
  }
  if (tid == 0) *changed = any_change ? 1 : 0;
}

}  // namespace

extern "C" int best_response_launch(
    const void* idx_in, void* idx_out, void* changed, const void* pu_packed,
    const void* end_b, const void* edge_b, const void* member,
    const void* feas, const void* cand_e, const void* cand_c,
    const void* cell_edge, const void* edge_capacity, void* edge_tot,
    const void* calib_scale, const void* calib_off, const void* consts_host,
    int cells, int n_actions, int users, int n_edges, float cloud_servers,
    void* stream) {
  if (users < 1 || users > kMaxUsers) return (int)cudaErrorInvalidValue;
  Consts c = *static_cast<const Consts*>(consts_host);
  best_response_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx_in), static_cast<int*>(idx_out),
      static_cast<int*>(changed), static_cast<const int*>(pu_packed),
      static_cast<const int*>(end_b), static_cast<const int*>(edge_b),
      static_cast<const unsigned char*>(member),
      static_cast<const unsigned char*>(feas),
      static_cast<const int*>(cand_e), static_cast<const int*>(cand_c),
      static_cast<const int*>(cell_edge),
      static_cast<const float*>(edge_capacity), static_cast<int*>(edge_tot),
      static_cast<const float*>(calib_scale),
      static_cast<const float*>(calib_off), c, cells, n_actions, users,
      n_edges, cloud_servers);
  return (int)cudaGetLastError();
}

extern "C" const char* best_response_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Exactness of the speculation: cell i's choice is a pure function of
// its round-invariant rows and two integers, the job total of its edge
// and the cloud's at its turn (its current candidate is the round's
// input). A choice scored at the round's start totals is therefore the
// sweep's choice whenever the two integers at the cell's turn equal the
// start values, however the totals moved in between.
//
// Design: a round is a memset and three launches on the stream.
//  1. totals: the start totals, edge jobs per edge and cloud jobs
//     overall (integer atomics: the order of the sums changes no bit).
//  2. pre-pass, a warp per cell over the whole card: scores every cell
//     at the start totals; writes its speculative choice, a 32-byte cell
//     descriptor, and its candidates as one byte each (edge count << 4 |
//     cloud count, 0xFF infeasible) in rows padded to 16 bytes; the
//     first cell whose choice moves a count and the first that switches
//     are integer atomicMax of (cells - i), so deterministic.
//  3. walker, one block of 32 warps: if no cell moves a count every
//     speculative choice is exact and it only writes the `changed`
//     flag. Otherwise it walks from the first such cell in windows of
//     32 cells, a warp a cell. The counts each cell moves start as the
//     pre-pass's; a pass sets every cell's two integers to the window's
//     base totals plus the counts the earlier cells of the window move
//     (a warp reduction over the window) and scores each cell whose
//     integers moved since it was last scored, taking its speculative
//     choice unscored where they equal the start values; passes repeat
//     until no cell's integers move, two block barriers a pass. Then
//     each cell was scored at the integers its predecessors' choices
//     give it, which is the sweep's choice by induction from the
//     window's first cell (whose integers are exact). The window's
//     counts are then added to the edge totals' drift (shared memory up
//     to 1,024 edges) and the cloud's. A window takes at most 32
//     scoring passes, one for each cell whose counts came out other
//     than predicted and one; the walker reports the passes it took.
// A cell's latency terms depend on a candidate only through its edge
// count e or its cloud count c, so one function builds the cell's rows
// of 26 terms (8 local actions, 9 edge counts, 9 cloud counts) for each
// user, member and end-node class folded in, once a cell, and the
// pre-pass and the walker both score candidates from them: a lookup and
// a sum a user, then the divide by the member count (a multiply by its
// reciprocal where the count is a power of two: the same bits). Each
// kernel is compiled for every user count, 1 to 8.
//
// Bound: the (cells, K) tables read once (9 bytes an entry) by the
// pre-pass; the walker adds a chain of windows, each a few passes of a
// table build, a scoring of K candidates by a warp and two barriers.
//
// Exactness: one flipped argmin changes every later cell, so the terms
// are computed in the plain version's order of operations with the _rn
// intrinsics (nvcc cannot contract them into an FMA of its own): the
// link capacities as products with their float32 reciprocals, the
// capacity tier, the queue size and the member count as true quotients,
// users summed left to right, and the multiply-adds that the reference's
// XLA compiler fuses as one rounding of a float64 sum, as the plain
// version emulates them (dynamics.fma). Hoisting a term out of the
// candidate loop runs the same operations on the same values once. The
// card's indices equal the plain version's bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxUsers = 8;
constexpr int kEdge = 8;              // per-user action id of the edge
constexpr float kTol = 1e-6f;         // BEST_RESPONSE_TOL
constexpr float kQueueMax = 8.0f;     // CLOUD_QUEUE_MAX
constexpr int kCount = 8;             // the largest edge / cloud count
constexpr int kTerms = 26;            // 8 local, 9 edge counts, 9 cloud
constexpr int kEdgeTerm = 8, kCloudTerm = 17;
constexpr unsigned kInfeasible = 0xFF;
constexpr int kPrepassWarps = 8;      // cells a pre-pass block scores
constexpr int kWindow = 32;           // cells a walker step takes, a warp
                                      // each (a block of 1,024 threads)
constexpr int kSmemEdges = 1024;      // edge drift in shared memory

// Phase clocks of the walker for tools/walker_clocks.py, compiled in
// with -DBR_CLOCKS only: lane 0 of warps 0 and 31 stamps clock64() at
// each phase of the first kClockWindows windows of a round.
#ifdef BR_CLOCKS
constexpr int kClockWindows = 2048;
__device__ long long g_clocks[2][kClockWindows][8];
#define BR_CLOCK(win, k)                                                  \
  do {                                                                    \
    const int w_ = threadIdx.x >> 5;                                      \
    if ((threadIdx.x & 31) == 0 && (w_ == 0 || w_ == 31) &&               \
        (win) < kClockWindows)                                            \
      g_clocks[w_ != 0][win][k] = clock64();                              \
  } while (0)
#else
#define BR_CLOCK(win, k) \
  do {                   \
  } while (0)
#endif

// the latency model's float32 constants, in the plain version's values
struct Consts {
  float t_orch[2], t_up[2], t_hop[2], t_comp[8], t_comp0;
  float mem, inv_edge_cap, inv_cloud_cap;
};

// what the pre-pass leaves the walker of one cell
struct __align__(16) Cell {
  int edge;         // e_i
  int cur;          // the round's input choice
  int spec;         // the choice at the round's start totals
  unsigned counts;  // e_cnt | c_cnt << 4 | spec's e << 8 | spec's c << 12
                    // | member bits << 16 | end-node bits << 24
  float cap;        // edge_capacity[e_i]
  int start_e;      // e_i's job total at the round's start
  float hop0;       // t_hop_cloud[edge_b[i]]
  int pad;
};

struct Args {
  const int* idx_in;
  int* idx_out;
  int* changed;
  int* stats;  // first, first switch, rescored, scorings, passes; or null
  const int* pu_packed;
  const int* end_b;
  const int* edge_b;
  const unsigned char* member;
  const unsigned char* feas;
  const int* cand_e;
  const int* cand_c;
  const int* cell_edge;
  const float* edge_capacity;
  const float* calib_scale;  // null: uncalibrated
  const float* calib_off;
  int* tot;        // [n_edges] edge totals, cloud, cells - first moved,
                   // cells - first switch (zeroed before the round)
  Cell* cell_info;             // (cells,)
  unsigned char* codes;        // (cells, k_pad)
  int* drift;  // (n_edges,): the edge drift where it passes kSmemEdges
  Consts c;
  int cells, n_actions, k_pad, users, n_edges;
  float cloud_servers;
};

// a * b + c with one rounding, as dynamics.fma emulates XLA's fused
// multiply-add: the float64 product of two floats is exact
__device__ __forceinline__ float fma_emul(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// A cell's term rows: lane k < kTerms computes the latency of a member
// user of each end-node class under term k (local action k < 8, the
// edge at count k - 8, the cloud at count k - 17), given the job totals
// of the others (base_e on the cell's edge, base_c in the cloud), and
// writes rows[u * 32 + k] for each of the N users: the term of its
// class, or 0 for a user who is no member.
template <int N>
__device__ __forceinline__ void build_rows(float* rows, int lane,
                                           const Args& a, int base_e,
                                           int base_c, float cap, float hop0,
                                           unsigned mbits, unsigned ebits) {
  if (lane >= kTerms) return;
  const Consts& c = a.c;
  const bool calibrated = a.calib_scale != nullptr;
  const float comp_e = c.t_comp0 * 0.5f;   // exact: / TIER_SPEED["E"]
  const float comp_c = c.t_comp0 * 0.25f;  // exact: / TIER_SPEED["C"]
  float term[2];
  if (lane < kEdgeTerm) {
    const float comp = c.t_comp[lane];
#pragma unroll
    for (int eb = 0; eb < 2; ++eb) {
      const float orch = c.t_orch[eb];
      term[eb] = calibrated
                     ? fmaxf(fma_emul(a.calib_scale[0], comp,
                                      __fadd_rn(orch, a.calib_off[0])),
                             0.0f)
                     : __fadd_rn(orch, comp);
    }
  } else if (lane < kCloudTerm) {
    const float n_e = __fdiv_rn((float)(base_e + lane - kEdgeTerm), cap);
    const float cpu_e = fmaxf(__fmul_rn(n_e, 0.5f), 1.0f);
    const float link_e = fmaxf(__fmul_rn(n_e, c.inv_edge_cap), 1.0f);
    const float mem_e = n_e > 2.0f ? c.mem : 1.0f;
    const float edge_comp = __fmul_rn(__fmul_rn(comp_e, cpu_e), mem_e);
#pragma unroll
    for (int eb = 0; eb < 2; ++eb) {
      const float orch = c.t_orch[eb], up = c.t_up[eb];
      if (!calibrated) {
        term[eb] = __fadd_rn(orch, fma_emul(up, link_e, edge_comp));
      } else {
        const float comm = __fadd_rn(orch, __fmul_rn(up, link_e));
        term[eb] = fmaxf(fma_emul(a.calib_scale[1], edge_comp,
                                  __fadd_rn(comm, a.calib_off[1])),
                         0.0f);
      }
    }
  } else {
    const int cc = lane - kCloudTerm;
    const float n_c = (float)cc;
    const float rho = __fdiv_rn((float)(base_c + cc), a.cloud_servers);
    float mult = __fdiv_rn(1.0f, fmaxf(__fsub_rn(1.0f, rho),
                                       1.0f / kQueueMax));
    mult = fminf(fmaxf(mult, 1.0f), kQueueMax);
    const float cpu_c = fmaxf(__fmul_rn(n_c, 0.25f), 1.0f);
    const float link_c = fmaxf(__fmul_rn(n_c, c.inv_cloud_cap), 1.0f);
    const float mem_c = n_c > 3.0f ? c.mem : 1.0f;
    const float hop = __fmul_rn(__fmul_rn(hop0, link_c), mult);
    const float cloud_a = __fmul_rn(__fmul_rn(comp_c, cpu_c), mem_c);
    const float cloud_comp = __fmul_rn(cloud_a, mult);
#pragma unroll
    for (int eb = 0; eb < 2; ++eb) {
      const float orch = c.t_orch[eb], up = c.t_up[eb];
      if (!calibrated) {  // the compute term fuses only in a one-user cell
        float x = fma_emul(up, link_c, hop);
        x = N == 1 ? fma_emul(cloud_a, mult, x) : __fadd_rn(x, cloud_comp);
        term[eb] = __fadd_rn(orch, x);
      } else {
        const float comm = __fadd_rn(orch, fma_emul(up, link_c, hop));
        term[eb] = fmaxf(fma_emul(a.calib_scale[2], cloud_comp,
                                  __fadd_rn(comm, a.calib_off[2])),
                         0.0f);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u)
    rows[u * 32 + lane] = (mbits >> u) & 1u ? term[(ebits >> u) & 1u] : 0.0f;
}

// The divisor of a cell's sum: its member count (at least 1), and its
// reciprocal where that is a power of two, else 0. Dividing by a power
// of two and multiplying by its reciprocal round the same real number,
// so they give the same bits; any other count divides.
struct Mean {
  float n, inv;
};
__device__ __forceinline__ Mean mean_of(unsigned mbits) {
  const int n = max(__popc(mbits), 1);
  return {(float)n, (n & (n - 1)) == 0 ? 1.0f / (float)n : 0.0f};
}

// The mean over member users of candidate `pu` whose counts are `code`
// (feasible), from the cell's rows: users summed left to right, a
// non-member adding 0.
template <int N>
__device__ __forceinline__ float score(unsigned code, int pu,
                                       const float* rows, Mean mean) {
  const int e8 = kEdgeTerm + (int)(code >> 4);
  const int c17 = kCloudTerm + (int)(code & 15);
  float sum = 0.0f;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int act = (pu >> (4 * u)) & 15;
    const float t = rows[u * 32 + (act < kEdge ? act
                                   : act == kEdge ? e8 : c17)];
    sum = u == 0 ? t : __fadd_rn(sum, t);
  }
  return mean.inv != 0.0f ? __fmul_rn(sum, mean.inv)
                          : __fdiv_rn(sum, mean.n);
}

// What a lane keeps of its candidates: the lowest score, its index and
// counts (j rises within a lane, so the first index wins a tie), and the
// score of the cell's current candidate where the lane holds it.
struct Best {
  float v;
  int j;
  unsigned code;
  float cur;
};

template <int N>
__device__ __forceinline__ void consider(Best& b, unsigned code, int j,
                                         int cur, const Args& a,
                                         const float* rows, Mean mean) {
  if (code == kInfeasible) return;  // infinite: never below b.v
  const float s = score<N>(code, __ldg(a.pu_packed + j), rows, mean);
  if (j == cur) b.cur = s;
  if (s < b.v) {
    b.v = s;
    b.j = j;
    b.code = code;
  }
}

// (score, index, code) as one key whose unsigned order is the argmin's:
// scores are >= 0 or +inf (-0 is folded into +0, which compares equal),
// so their bits order as the floats do, and the lower index wins a tie.
__device__ __forceinline__ unsigned long long key_of(const Best& b) {
  return (unsigned long long)__float_as_uint(__fadd_rn(b.v, 0.0f)) << 32 |
         (unsigned)b.j << 8 | b.code;
}

// The warp's choice for a cell from its lanes' bests (candidate j in
// lane (j / 4) % 32): (choice, its edge count, its cloud count), the
// switch rule on the merged argmin.
__device__ __forceinline__ int3 decide(const Best& b, int cur, int e_cnt,
                                       int c_cnt) {
  unsigned long long k = key_of(b);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(0xffffffffu, k, o);
    k = x < k ? x : k;
  }
  const float s_cur = __shfl_sync(0xffffffffu, b.cur, (cur >> 2) & 31);
  const float v = __uint_as_float((unsigned)(k >> 32));
  if (v < __fsub_rn(s_cur, kTol)) {
    const unsigned code = (unsigned)k & 0xFF;
    return make_int3((int)((k >> 8) & 0xFFFFFF), code >> 4, code & 15);
  }
  return make_int3(cur, e_cnt, c_cnt);
}

__global__ void best_response_totals_kernel(Args a) {
  int my_c = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.cells;
       i += gridDim.x * blockDim.x) {
    const size_t at = (size_t)i * a.n_actions + a.idx_in[i];
    atomicAdd(&a.tot[a.cell_edge[i]], a.cand_e[at]);
    my_c += a.cand_c[at];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    my_c += __shfl_xor_sync(0xffffffffu, my_c, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(&a.tot[a.n_edges], my_c);
}

template <int N>
__global__ void __launch_bounds__(kPrepassWarps * 32)
best_response_prepass_kernel(Args a) {
  __shared__ float s_rows[kPrepassWarps][N * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kPrepassWarps + warp;
  if (i >= a.cells) return;  // the whole warp
  float* rows = s_rows[warp];
  const size_t row = (size_t)i * a.n_actions;
  const int e_i = a.cell_edge[i], cur = a.idx_in[i];
  const int e_cnt = a.cand_e[row + cur], c_cnt = a.cand_c[row + cur];
  const int start_e = a.tot[e_i];
  const float cap = a.edge_capacity[e_i];
  const float hop0 = a.c.t_hop[a.edge_b[i]];
  const bool user = lane < N;
  const size_t at = (size_t)i * N + lane;
  const unsigned mbits = __ballot_sync(0xffffffffu, user && a.member[at]);
  const unsigned ebits =
      __ballot_sync(0xffffffffu, user && a.end_b[at] != 0);
  build_rows<N>(rows, lane, a, start_e - e_cnt, a.tot[a.n_edges] - c_cnt,
                cap, hop0, mbits, ebits);
  __syncwarp();

  // lane l scores candidates 4l..4l+3 of each 128 and writes their bytes
  const Mean mean = mean_of(mbits);
  Best b = {INFINITY, 0xFFFFFF, kInfeasible, INFINITY};
  for (int j0 = 4 * lane; j0 < a.k_pad; j0 += 128) {
    unsigned word = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = j0 + t;
      unsigned code = kInfeasible;
      if (j < a.n_actions) {
        const int ce = a.cand_e[row + j], cc = a.cand_c[row + j];
        if ((unsigned)ce > kCount || (unsigned)cc > kCount) __trap();
        if (a.feas[row + j]) code = (unsigned)ce << 4 | (unsigned)cc;
      }
      word |= code << (8 * t);
      consider<N>(b, code, j, cur, a, rows, mean);
    }
    *reinterpret_cast<unsigned*>(a.codes + (size_t)i * a.k_pad + j0) = word;
  }
  const int3 d = decide(b, cur, e_cnt, c_cnt);
  if (lane == 0) {
    a.idx_out[i] = d.x;
    Cell m;
    m.edge = e_i;
    m.cur = cur;
    m.spec = d.x;
    m.counts = (unsigned)e_cnt | (unsigned)c_cnt << 4 | (unsigned)d.y << 8 |
               (unsigned)d.z << 12 | mbits << 16 | ebits << 24;
    m.cap = cap;
    m.start_e = start_e;
    m.hop0 = hop0;
    m.pad = 0;
    a.cell_info[i] = m;
    if (d.y != e_cnt || d.z != c_cnt)
      atomicMax(&a.tot[a.n_edges + 1], a.cells - i);
    if (d.x != cur) atomicMax(&a.tot[a.n_edges + 2], a.cells - i);
  }
}

// Cell i of a walker window scored by one warp at the totals (te, tc),
// the job totals of its edge and of the cloud at its turn (each
// counting its own current choice): (choice, its edge and cloud
// counts), the same in every lane.
template <int N>
__device__ __forceinline__ int3 score_cell(const Args& a, const Cell& m,
                                           int i, int te, int tc,
                                           float* rows, int lane, int win) {
  const int e_cnt = m.counts & 15, c_cnt = (m.counts >> 4) & 15;
  const unsigned mbits = (m.counts >> 16) & 0xFF, ebits = m.counts >> 24;
  BR_CLOCK(win, 2);
  build_rows<N>(rows, lane, a, te - e_cnt, tc - c_cnt, m.cap, m.hop0,
                mbits, ebits);
  __syncwarp();
  BR_CLOCK(win, 3);
  const unsigned* row =
      reinterpret_cast<const unsigned*>(a.codes + (size_t)i * a.k_pad);
  const Mean mean = mean_of(mbits);
  Best b = {INFINITY, 0xFFFFFF, kInfeasible, INFINITY};
  for (int j0 = 4 * lane; j0 < a.k_pad; j0 += 128) {
    const unsigned word = __ldg(row + j0 / 4);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      consider<N>(b, (word >> (8 * t)) & 0xFF, j0 + t, m.cur, a, rows,
                  mean);
  }
  BR_CLOCK(win, 4);
  const int3 d = decide(b, m.cur, e_cnt, c_cnt);
  __syncwarp();  // every lane has read the rows
  BR_CLOCK(win, 5);
  return d;
}

template <int N>
__global__ void __launch_bounds__(kWindow * 32, 1)
best_response_walker_kernel(Args a) {
  extern __shared__ int s_edge_drift[];  // n_edges, up to kSmemEdges
  __shared__ float s_rows[kWindow][N * 32];
  __shared__ int s_edge[kWindow], s_de[kWindow], s_dc[kWindow];
  __shared__ int s_cloud, s_any, s_rescored, s_scored;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cells = a.cells, n_edges = a.n_edges;
  const int first = cells - a.tot[n_edges + 1];
  const int first_switch = cells - a.tot[n_edges + 2];
  if (first >= cells) {  // no count moves: every speculative choice holds
    if (tid == 0) {
      *a.changed = first_switch < cells;
      if (a.stats) {
        const int st[5] = {first, first_switch, 0, 0, 0};
        for (int k = 0; k < 5; ++k) a.stats[k] = st[k];
      }
    }
    return;
  }
  int* drift = n_edges <= kSmemEdges ? s_edge_drift : a.drift;
  for (int e = tid; e < n_edges; e += blockDim.x) drift[e] = 0;
  if (tid == 0) {
    s_cloud = 0;
    s_any = first_switch < first;
    s_rescored = 0;
    s_scored = 0;
  }
  const int cloud_start = a.tot[n_edges];
  float* rows = s_rows[warp];
  int passes = 0, scored = 0;
  Cell m = a.cell_info[min(first + warp, cells - 1)];
  __syncthreads();

  // Window [w0, w0 + kWindow), cell w0 + warp on this warp. The counts
  // each cell moves start as the pre-pass's; then each pass sets every
  // cell's two integers to the window's base totals plus the counts the
  // earlier cells of the window move, and scores the cells whose
  // integers moved since they were last scored, until none moved. Then
  // every cell was scored at the integers its predecessors' choices
  // give it: the sweep's choice, by induction from the window's first
  // cell.
  for (int w0 = first, win = 0; w0 < cells; w0 += kWindow, ++win) {
    BR_CLOCK(win, 0);
    const int i = w0 + warp;
    const bool live = i < cells;
    const Cell next = a.cell_info[min(i + kWindow, cells - 1)];
    const int e_cnt = m.counts & 15, c_cnt = (m.counts >> 4) & 15;
    const int base_e = m.start_e + drift[m.edge];
    const int base_c = cloud_start + s_cloud;
    int te, tc;                             // the integers at its turn
    int sc_te = INT_MIN, sc_tc = INT_MIN;   // the integers last scored at
    int3 d = make_int3(m.spec, (m.counts >> 8) & 15, (m.counts >> 12) & 15);
    if (lane == 0) {
      s_edge[warp] = live ? m.edge : -1;
      s_de[warp] = live ? d.y - e_cnt : 0;
      s_dc[warp] = live ? d.z - c_cnt : 0;
    }
    __syncthreads();
    BR_CLOCK(win, 1);
    for (;;) {
      const bool before = lane < warp;
      te = base_e + __reduce_add_sync(
                        0xffffffffu,
                        before && s_edge[lane] == m.edge ? s_de[lane] : 0);
      tc = base_c + __reduce_add_sync(0xffffffffu, before ? s_dc[lane] : 0);
      const bool moved = live && (te != sc_te || tc != sc_tc);
      if (!__syncthreads_or(moved)) break;
      if (moved) {
        if (te == m.start_e && tc == cloud_start) {
          d = make_int3(m.spec, (m.counts >> 8) & 15, (m.counts >> 12) & 15);
        } else {
          d = score_cell<N>(a, m, i, te, tc, rows, lane, win);
          ++scored;
        }
        sc_te = te;
        sc_tc = tc;
        if (lane == 0) {
          s_de[warp] = d.y - e_cnt;
          s_dc[warp] = d.z - c_cnt;
        }
      }
      ++passes;
      __syncthreads();
    }
    if (live && lane == 0) {
      atomicAdd(&drift[m.edge], d.y - e_cnt);
      atomicAdd(&s_cloud, d.z - c_cnt);
      if (d.x != m.spec) a.idx_out[i] = d.x;
      if (d.x != m.cur) s_any = 1;
      if (te != m.start_e || tc != cloud_start) atomicAdd(&s_rescored, 1);
    }
    m = next;
    __syncthreads();
    BR_CLOCK(win, 6);
  }
  if (lane == 0) atomicAdd(&s_scored, scored);
  __syncthreads();
  if (tid == 0) {
    *a.changed = s_any;
    if (a.stats) {
      const int st[5] = {first, first_switch, s_rescored, s_scored,
                         passes};
      for (int k = 0; k < 5; ++k) a.stats[k] = st[k];
    }
  }
}

// The pre-pass and the walker of a round of cells of N users.
template <int N>
void launch_round(const Args& a, cudaStream_t st) {
  best_response_prepass_kernel<N>
      <<<(a.cells + kPrepassWarps - 1) / kPrepassWarps, kPrepassWarps * 32,
         0, st>>>(a);
  const size_t smem =
      a.n_edges <= kSmemEdges ? a.n_edges * sizeof(int) : 0;
  best_response_walker_kernel<N><<<1, kWindow * 32, smem, st>>>(a);
}

}  // namespace

extern "C" int best_response_launch(
    const void* idx_in, void* idx_out, void* changed, void* stats,
    const void* pu_packed, const void* end_b, const void* edge_b,
    const void* member, const void* feas, const void* cand_e,
    const void* cand_c, const void* cell_edge, const void* edge_capacity,
    void* tot, void* cell_info, void* codes, void* drift,
    const void* calib_scale, const void* calib_off, const void* consts_host,
    int cells, int n_actions, int users, int n_edges, float cloud_servers,
    void* stream) {
  if (users < 1 || users > kMaxUsers) return (int)cudaErrorInvalidValue;
  if (n_actions < 1 || n_actions >= (1 << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cells == 0) {
    cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), st);
    if (err == cudaSuccess && stats)
      err = cudaMemsetAsync(stats, 0, 5 * sizeof(int), st);
    return (int)err;
  }
  Args a;
  a.idx_in = static_cast<const int*>(idx_in);
  a.idx_out = static_cast<int*>(idx_out);
  a.changed = static_cast<int*>(changed);
  a.stats = static_cast<int*>(stats);
  a.pu_packed = static_cast<const int*>(pu_packed);
  a.end_b = static_cast<const int*>(end_b);
  a.edge_b = static_cast<const int*>(edge_b);
  a.member = static_cast<const unsigned char*>(member);
  a.feas = static_cast<const unsigned char*>(feas);
  a.cand_e = static_cast<const int*>(cand_e);
  a.cand_c = static_cast<const int*>(cand_c);
  a.cell_edge = static_cast<const int*>(cell_edge);
  a.edge_capacity = static_cast<const float*>(edge_capacity);
  a.calib_scale = static_cast<const float*>(calib_scale);
  a.calib_off = static_cast<const float*>(calib_off);
  a.tot = static_cast<int*>(tot);
  a.cell_info = static_cast<Cell*>(cell_info);
  a.codes = static_cast<unsigned char*>(codes);
  a.drift = static_cast<int*>(drift);
  a.c = *static_cast<const Consts*>(consts_host);
  a.cells = cells;
  a.n_actions = n_actions;
  a.k_pad = (n_actions + 15) & ~15;
  a.users = users;
  a.n_edges = n_edges;
  a.cloud_servers = cloud_servers;
  const cudaError_t err =
      cudaMemsetAsync(tot, 0, (n_edges + 3) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  int blocks = (cells + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  best_response_totals_kernel<<<blocks, 256, 0, st>>>(a);
  switch (users) {
    case 1: launch_round<1>(a, st); break;
    case 2: launch_round<2>(a, st); break;
    case 3: launch_round<3>(a, st); break;
    case 4: launch_round<4>(a, st); break;
    case 5: launch_round<5>(a, st); break;
    case 6: launch_round<6>(a, st); break;
    case 7: launch_round<7>(a, st); break;
    default: launch_round<8>(a, st); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* best_response_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef BR_CLOCKS
// copies the phase clocks of the last round, (2, kClockWindows, 8) int64
extern "C" int best_response_clocks(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks));
}
#endif

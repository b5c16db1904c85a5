// Fused featurize + constraint-aware greedy head of the fleet DQN, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dqn_head.py
// (dqn_head_kernel, body _kernel). Per cell of N users:
//   x_u  = [active_u, member_u, end_b_u, agg(8)]              (11 wide)
//   q_u  = w3^T relu(w2^T relu(w1^T x_u + b1) + b2) + b3      (A = 10)
//   q_u  = allowed[u] ? q_u : -1e30
//   plain_u = first-index argmax of q_u
// and with a QoS threshold: the stable top-k of each user's q_u, the k^N
// combinations scored by summed value over members, combos with a masked
// member entry (< -1e29) or a mean member accuracy below the threshold
// culled, the first-index best combo taken, else the plain argmax.
//
// Bound: operations on the CUDA cores. The MLP is ~38 kFLOP per user row
// (6.25 GFLOP at 32,768 cells x 5 users) against ~60 bytes per row in
// and out. Design: one persistent 512-thread block per SM holds one copy
// of the weights in dynamic shared memory (~78 KB f32 at hidden 128,
// hidden padded to a multiple of 32, actions to a multiple of 4) and
// walks over tiles of up to 128 user rows made of whole cells (25 cells
// = 125 rows at N = 5); with the tiles' activations and hand-off buffers
// the block takes ~206 KB, so the launcher raises its
// dynamic-shared-memory limit. Eight warps (the MLP warps) run the MLP,
// the q copy and the per-row top-k of tile t while the other eight (the
// search warps) search tile t - 1 and load the features of tile t + 1;
// one block barrier per tile, named barriers among the MLP warps.
//
// MLP: plain FP32 FMA (no TF32), since decisions are compared exactly
// against the plain version's decision logic on the kernel's own q.
// Activations are feature-major, (width, rows). In the hidden layers
// each thread owns a register micro-tile of 8 hidden units x 8 rows; per
// step of the reduction two float4s of weights and two of activations
// feed 64 FMAs. The second layer overwrites its input in place after a
// barrier. The output layer gives each thread 4 actions x 4 rows (A
// padded to 12) over half the reduction; the two halves meet in shared
// memory.
//
// Combo search: a group of 8 lanes takes a cell, no barrier inside. The
// stable top-k of a row is sorted descending, so the entries that are not
// masked (>= -1e29) are a prefix of length kv_u; a combo with a member
// digit past it scores -inf in the reference and is never enumerated, and
// only member users' digits are enumerated at all (a non-member's digit
// changes no score, and 0, the lowest index, wins every such tie). The
// reference sums scores and accuracies left to right in user order, and
// adding a non-member's 0.0 is exact, so a lane fixes the outer member
// digits (all but the last two), keeps their two sums in registers and
// adds the middle and the inner member's digits with one rounded add
// each: every sum is the reference's bit for bit. Feasibility fl(sum /
// m) >= thr32 is monotone in the sum, so it is the compare sum >=
// x_min[m], with x_min computed by the wrapper in float32. Rounded adds
// are monotone too, so an outer index or a middle digit whose best
// completion cannot beat the best found, or whose most accurate one
// cannot pass, is skipped. The group reduces (score, index) by shuffles,
// ties to the lower index. A cell with no member, or with a member whose
// every top-k entry is masked, takes the plain argmax (with no member the
// reference's first combo is the per-user top-1, which is the plain
// argmax).
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <math.h>

namespace {

constexpr int kMlpWarps = 8;     // the MLP, the top-k and the q copy
constexpr int kSearchWarps = 8;  // the previous tile's combo search
constexpr int kMlpThreads = 32 * kMlpWarps;
constexpr int kSearchThreads = 32 * kSearchWarps;
constexpr int kThreads = kMlpThreads + kSearchThreads;
constexpr int kTile = 8;         // a thread's micro-tile: 8 units x 8 rows
constexpr int kWarpUnits = 4 * kTile;   // a warp's lanes: 4 unit groups x
constexpr int kWarpRows = 8 * kTile;    //                 8 row groups
constexpr int kMaxRows = 128;    // user rows per tile
constexpr int kMaxActions = 16;  // per-user action width held in registers
constexpr int kMaxUsers = 32;    // a cell's members fit one mask
constexpr int kGroup = 8;        // lanes that search one cell
constexpr int kChunk = 4;        // outer indices a lane decodes at once
constexpr float kNegInf = -1e30f;

struct Params {
  const float *act, *mem, *endb, *agg, *w1, *b1, *w2, *b2, *w3, *b3,
      *allowed, *acc_table;
  int* dec;
  float* q;
  int cells, users, n_agg, hidden, n_act, use_threshold, topk;
};

// x_min[m]: the least float32 whose quotient by m passes the threshold
struct XMin {
  float v[kMaxUsers + 1];
};

struct Plan {  // the tile's shape: MLP warps over hidden units and rows
  int f, hp, ap, warps_h, warps_r, rows;
};

__host__ __device__ inline Plan make_plan(int n_agg, int hidden, int n_act) {
  Plan p;
  p.f = 3 + n_agg;
  p.hp = (hidden + kWarpUnits - 1) / kWarpUnits * kWarpUnits;
  p.ap = (n_act + 3) & ~3;
  p.warps_h = p.hp / kWarpUnits;
  p.warps_r = p.warps_h > kMlpWarps ? 0 : kMlpWarps / p.warps_h;
  if (p.warps_r > kMaxRows / kWarpRows) p.warps_r = kMaxRows / kWarpRows;
  p.rows = kWarpRows * p.warps_r;
  return p;
}

struct Layout {  // offsets (in floats) into dynamic shared memory
  int w1, b1, w2, b2, w3, b3, allowed, acc, pw, xmin, x, h, l3, qs, lvl,
      hand, hand_size, topv, topacc, topi, plain, kv, memb, total;
};

__host__ __device__ inline Layout make_layout(const Plan& p, int n_act,
                                              int k, int users) {
  Layout L;
  int o = 0;
  // every block starts on a 16-byte boundary (float4 reads)
  auto take = [&o](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  const int R = p.rows;
  L.w1 = take(p.f * p.hp);
  L.b1 = take(p.hp);
  L.w2 = take(p.hp * p.hp);
  L.b2 = take(p.hp);
  L.w3 = take(p.hp * p.ap);
  L.b3 = take(p.ap);
  L.allowed = take(users * n_act);
  L.acc = take(n_act);
  L.pw = take(users);
  L.xmin = take(kMaxUsers + 1);
  L.x = take(2 * p.f * R);  // one copy per tile parity
  L.h = take(p.hp * R);
  L.l3 = take(p.ap / 4 * (R / 4) * 16);
  L.qs = take(R * n_act);
  L.lvl = take(kSearchThreads / kGroup * 6 * kMaxUsers);
  // the hand-off from the MLP warps to the search warps, one copy per
  // tile parity (offsets relative to hand + parity * hand_size)
  const int o0 = o;
  o = 0;
  L.topv = take(R * k);
  L.topacc = take(R * k);
  L.topi = take(R * k);
  L.plain = take(R);
  L.kv = take(R);
  L.memb = take(R);
  L.hand_size = o;
  L.hand = o0;
  L.total = o0 + 2 * L.hand_size;
  return L;
}

__device__ __forceinline__ bool better(float s, int j, float bs, int bj) {
  return s > bs || (s == bs && j < bj);
}

// the MLP warps' own barrier (the search warps run on meanwhile)
__device__ __forceinline__ void mlp_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kMlpThreads) : "memory");
}

// out[j][r] = relu(b[j] + sum_k in[k][r] * w[k][j]) for the tile's rows
// and the hp (padded) units; in (K, R), w (K, hp), out (hp, R). MLP warp
// (wh, wr) of the plan's warps_h x warps_r covers units 32 wh.. and rows
// 64 wr..; its lane (lane & 3, lane >> 2) owns 8 units x 8 rows, so per
// step of the reduction four float4 reads feed 64 FMAs. With kInPlace
// the MLP warps wait for every read of `in` before writing (out == in);
// every MLP thread must call it then.
template <bool kInPlace>
__device__ __forceinline__ void dense_relu(const float* in, int K,
                                           const float* w, const float* b,
                                           float* out, const Plan& p,
                                           int mtid) {
  const int warp = mtid >> 5, lane = mtid & 31;
  const bool on = warp < p.warps_h * p.warps_r;
  const int hg = (warp % p.warps_h) * 4 + (lane & 3);
  const int rg = (warp / p.warps_h) * 8 + (lane >> 2);
  const int R = p.rows, hp = p.hp;
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[i][r] = 0.f;
  if (on) {
    const float* wp = w + kTile * hg;
    const float* xp = in + kTile * rg;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float4 w0 = *reinterpret_cast<const float4*>(wp + k * hp);
      const float4 w1 = *reinterpret_cast<const float4*>(wp + k * hp + 4);
      const float4 x0 = *reinterpret_cast<const float4*>(xp + k * R);
      const float4 x1 = *reinterpret_cast<const float4*>(xp + k * R + 4);
      const float ws[kTile] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
      const float xs[kTile] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int r = 0; r < kTile; ++r)
          acc[i][r] = fmaf(xs[r], ws[i], acc[i][r]);
    }
  }
  if (kInPlace) mlp_sync();
  if (on) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const float bj = b[kTile * hg + i];
      float4* o = reinterpret_cast<float4*>(out + (kTile * hg + i) * R +
                                            kTile * rg);
      o[0] = make_float4(fmaxf(acc[i][0] + bj, 0.f), fmaxf(acc[i][1] + bj, 0.f),
                         fmaxf(acc[i][2] + bj, 0.f), fmaxf(acc[i][3] + bj, 0.f));
      o[1] = make_float4(fmaxf(acc[i][4] + bj, 0.f), fmaxf(acc[i][5] + bj, 0.f),
                         fmaxf(acc[i][6] + bj, 0.f), fmaxf(acc[i][7] + bj, 0.f));
    }
  }
}

struct Tile {
  int cell0, cells, rows;
  long long row0;
};

__device__ __forceinline__ Tile tile_at(int t, int cells_per_tile, int cells,
                                        int users) {
  Tile T;
  T.cell0 = t * cells_per_tile;
  T.cells = min(cells_per_tile, cells - T.cell0);
  T.rows = T.cells * users;
  T.row0 = (long long)T.cell0 * users;
  return T;
}

// the tile's features into x, feature-major (f, R); padding rows are zero.
// Thread `t` of `n` loads its share.
__device__ __forceinline__ void load_features(const Params& P, const Tile& T,
                                              int f, int R, float* x, int t,
                                              int n) {
  for (int i = t; i < f * R; i += n) {
    const int c = i / R, r = i - c * R;
    const long long g = T.row0 + r;
    float v = 0.f;
    if (r < T.rows) {
      if (c == 0) v = P.act[g];
      else if (c == 1) v = P.mem[g];
      else if (c == 2) v = P.endb[g];
      else v = P.agg[(long long)(T.cell0 + r / P.users) * P.n_agg + (c - 3)];
    }
    x[i] = v;
  }
}

// The combo search of one tile's cells by the search warps (thread `st`
// of them). Each cell takes a group of kGroup lanes of one warp, so a warp
// searches 32 / kGroup cells at once.
__device__ __noinline__ void search_tile(
    const Tile& T, int users, int k, const float* topv,
    const float* topacc, const int* topi, const int* plain, const int* kvs,
    const int* memb, const int* pw, const float* sxmin, int* lvl, int* dec,
    int st) {
  const int lane = st & 31, gl = lane & (kGroup - 1);
  const int group = st / kGroup;  // of kSearchThreads / kGroup
  // this group's combo levels (member i of the cell being searched): its
  // top-k slot base, its count of valid digits, its place value and, for
  // the outer levels, the stride of its digit in the outer index and that
  // stride's double reciprocal (two words)
  int* lv_slot = lvl + group * 6 * kMaxUsers;
  int* lv_kv = lv_slot + kMaxUsers;
  int* lv_pw = lv_kv + kMaxUsers;
  int* lv_st = lv_pw + kMaxUsers;
  int* lv_rcp = lv_st + kMaxUsers;
  constexpr int kGroups = kSearchThreads / kGroup;
  const unsigned gmask = (kGroup == 32 ? 0xffffffffu
                                       : ((1u << kGroup) - 1u))
                         << (lane & ~(kGroup - 1));
  // every group of a warp runs the same number of passes, so the warp's
  // shuffles and ballots see all its lanes
  const int passes = (T.cells + kGroups - 1) / kGroups;
  for (int pass = 0; pass < passes; ++pass) {
    const int cc = pass * kGroups + group;
    const bool live = cc < T.cells;
    const int rb = cc * users;  // first row of this cell in the tile
    __syncwarp();               // the previous cell's levels are read
    // member users and their valid digit counts, kGroup users at a time
    unsigned mm = 0, empty = 0;
    for (int u0 = 0; u0 < users; u0 += kGroup) {
      const int u = u0 + gl;
      const bool is_m = live && u < users && memb[rb + u];
      const bool none = is_m && kvs[rb + u] == 0;
      const unsigned b = __ballot_sync(0xffffffffu, is_m) & gmask;
      const unsigned e = __ballot_sync(0xffffffffu, none) & gmask;
      const int sh = lane & ~(kGroup - 1);
      mm |= (b >> sh) << u0;
      empty |= (e >> sh) << u0;
      if (is_m) {
        const int li = __popc(mm & ((1u << u) - 1u));
        lv_slot[li] = (rb + u) * k;
        lv_kv[li] = kvs[rb + u];
        lv_pw[li] = pw[u];
      }
    }
    const int m = __popc(mm);
    float bs = -INFINITY;
    int bj = INT_MAX;
    __syncwarp();
    if (live && m > 0 && !empty) {
      // levels 0..m-3 are the outer index, m-2 the middle digit, m-1 the
      // inner digit
      int n_outer = 1;
      for (int i = m - 3; i >= 0; --i) {
        if (gl == 0) {
          const double rcp = __drcp_rn((double)n_outer);
          lv_st[i] = n_outer;
          lv_rcp[2 * i] = __double2loint(rcp);
          lv_rcp[2 * i + 1] = __double2hiint(rcp);
        }
        n_outer *= lv_kv[i];
      }
      __syncwarp(gmask);
      const int kvm = m >= 2 ? lv_kv[m - 2] : 1;
      const int slot_m = m >= 2 ? lv_slot[m - 2] : 0;
      const int pw_m = m >= 2 ? lv_pw[m - 2] : 0;
      const int kvl = lv_kv[m - 1], slot_l = lv_slot[m - 1];
      const int pw_l = lv_pw[m - 1];
      const float xm = sxmin[m];
      const float* vm = topv + slot_m;    // the middle member's digits
      const float* am = topacc + slot_m;  // (m >= 2)
      const float* vi = topv + slot_l;    // the inner member's digits
      const float* ai = topacc + slot_l;
      const float vm0 = m >= 2 ? vm[0] : 0.f, am0 = m >= 2 ? am[0] : 0.f;
      float amax_m = 0.f, amax_i = 0.f;  // the best accuracies left
      for (int d = 0; d < kvm && m >= 2; ++d) amax_m = fmaxf(amax_m, am[d]);
      for (int d = 0; d < kvl; ++d) amax_i = fmaxf(amax_i, ai[d]);
      // Lane l of the group takes outer indices l, l + kGroup, ... in
      // order, kChunk at a time, and every (middle, inner) digit pair of
      // each. Values fall with each digit (the top-k is sorted) and a
      // rounded add never falls as an addend grows, so an outer index or a
      // middle digit is skipped when its best completion cannot pass the
      // lane's best (score, index), found earlier in index order, or falls
      // short of the group's best score after the previous chunk, or when
      // even its most accurate completion misses the threshold.
      float gb = -INFINITY;  // the group's best score so far
      const int n_steps = (n_outer + kGroup - 1) / kGroup;
      for (int t0 = 0; t0 < n_steps; t0 += kChunk) {
        float cs[kChunk], ca[kChunk];  // the chunk's outer sums, in order
        int cj[kChunk], cr[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          cr[c] = min(gl + kGroup * (t0 + c), n_outer - 1);
          cs[c] = ca[c] = 0.f;
          cj[c] = 0;
        }
        for (int i = 0; i < m - 2; ++i) {  // one level for the whole chunk
          const int sti = lv_st[i], base = lv_slot[i], pwi = lv_pw[i];
          const double rcp = __hiloint2double(lv_rcp[2 * i + 1],
                                              lv_rcp[2 * i]);
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            // cr / sti from the double reciprocal is off by one at most
            int d = __double2int_rz(__int2double_rn(cr[c]) * rcp);
            d -= (long long)d * sti > cr[c];
            d += (long long)(d + 1) * sti <= cr[c];
            cr[c] -= d * sti;
            cs[c] = __fadd_rn(cs[c], topv[base + d]);
            ca[c] = __fadd_rn(ca[c], topacc[base + d]);
            cj[c] += d * pwi;
          }
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (gl + kGroup * (t0 + c) >= n_outer) break;
          const float so = cs[c], ao = ca[c];
          const float ub = __fadd_rn(__fadd_rn(so, vm0), vi[0]);
          if (!(ub > bs && ub >= gb) ||
              !(__fadd_rn(__fadd_rn(ao, amax_m), amax_i) >= xm))
            continue;
          float nv = vm0, na = am0;  // the next middle digit's, read ahead
          for (int dm = 0; dm < kvm; ++dm) {
            float sm = so, sa = ao;
            if (m >= 2) {
              sm = __fadd_rn(so, nv);
              sa = __fadd_rn(ao, na);
              if (dm + 1 < kvm) {
                nv = vm[dm + 1];
                na = am[dm + 1];
              }
            }
            const float um = __fadd_rn(sm, vi[0]);
            if (!(um > bs && um >= gb) || !(__fadd_rn(sa, amax_i) >= xm))
              continue;
            const int jm = cj[c] + dm * pw_m;
#pragma unroll
            for (int d = 0; d < kMaxActions; ++d) {
              if (d >= kvl) break;  // the same for the group's lanes
              const float sc = __fadd_rn(sm, vi[d]);
              const bool up = __fadd_rn(sa, ai[d]) >= xm && sc > bs;
              bs = up ? sc : bs;
              bj = up ? jm + d * pw_l : bj;
            }
          }
        }
        gb = bs;
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1)
          gb = fmaxf(gb, __shfl_xor_sync(gmask, gb, off));
      }
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (better(os, oj, bs, bj)) {
        bs = os;
        bj = oj;
      }
    }
    if (live) {
      for (int u = gl; u < users; u += kGroup) {
        int out = plain[rb + u];
        if (isfinite(bs)) out = topi[(rb + u) * k + (bj / pw[u]) % k];
        dec[T.row0 + rb + u] = out;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dqn_head_kernel(const Params P, const XMin xmin) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Plan p = make_plan(P.n_agg, P.hidden, P.n_act);
  const int users = P.users, n_act = P.n_act, k = P.topk, f = p.f;
  const int hidden = P.hidden, hp = p.hp, ap = p.ap, R = p.rows;
  const Layout L = make_layout(p, n_act, k, users);
  float* sw1 = smem + L.w1;
  float* sb1 = smem + L.b1;
  float* sw2 = smem + L.w2;
  float* sb2 = smem + L.b2;
  float* sw3 = smem + L.w3;
  float* sb3 = smem + L.b3;
  float* sallow = smem + L.allowed;
  float* sacc = smem + L.acc;
  int* pw = reinterpret_cast<int*>(smem + L.pw);
  float* sxmin = smem + L.xmin;
  float* hs = smem + L.h;
  float* l3 = smem + L.l3;
  float* qs = smem + L.qs;
  const int tid = threadIdx.x;

  // weights, zero-padded to (f, hp), (hp, hp), (hp, ap): staged once per
  // (persistent) block
  for (int i = tid; i < f * hp; i += kThreads) {
    const int r = i / hp, c = i - r * hp;
    sw1[i] = c < hidden ? P.w1[r * hidden + c] : 0.f;
  }
  for (int i = tid; i < hp * hp; i += kThreads) {
    const int r = i / hp, c = i - r * hp;
    sw2[i] = (r < hidden && c < hidden) ? P.w2[r * hidden + c] : 0.f;
  }
  for (int i = tid; i < hp * ap; i += kThreads) {
    const int r = i / ap, c = i - r * ap;
    sw3[i] = (r < hidden && c < n_act) ? P.w3[r * n_act + c] : 0.f;
  }
  for (int i = tid; i < hp; i += kThreads) {
    sb1[i] = i < hidden ? P.b1[i] : 0.f;
    sb2[i] = i < hidden ? P.b2[i] : 0.f;
  }
  for (int i = tid; i < ap; i += kThreads) sb3[i] = i < n_act ? P.b3[i] : 0.f;
  for (int i = tid; i < users * n_act; i += kThreads) sallow[i] = P.allowed[i];
  for (int i = tid; i < n_act; i += kThreads) sacc[i] = P.acc_table[i];
  if (tid == 0) {
#pragma unroll
    for (int m = 0; m <= kMaxUsers; ++m) sxmin[m] = xmin.v[m];
    int pv = 1;  // k^(N-1-u): the place value of user u's combo digit
    for (int u = users - 1; u >= 0; --u) {
      pw[u] = pv;
      pv *= k;
    }
  }
  // Iteration `it`: the MLP warps take this block's tile `it` into
  // hand-off copy it & 1 while the search warps take tile it - 1 from the
  // other copy and then load the features of tile it + 1; one block
  // barrier ends each iteration.
  const int cells_per_tile = R / users;
  const int n_tiles = (P.cells + cells_per_tile - 1) / cells_per_tile;
  const int mine = blockIdx.x < n_tiles
                       ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (mine > 0)
    load_features(P, tile_at(blockIdx.x, cells_per_tile, P.cells, users), f,
                  R, smem + L.x, tid, kThreads);
  __syncthreads();
  for (int it = 0; it <= mine; ++it) {
    const bool mlp = tid < kMlpThreads;  // the MLP warps come first
    if (mlp && it < mine) {
      const Tile T = tile_at(blockIdx.x + it * gridDim.x, cells_per_tile,
                             P.cells, users);
      const float* xs = smem + L.x + (it & 1) * f * R;
      float* hand = smem + L.hand + (it & 1) * L.hand_size;
      float* topv = hand + L.topv;
      float* topacc = hand + L.topacc;
      int* topi = reinterpret_cast<int*>(hand + L.topi);
      int* plain = reinterpret_cast<int*>(hand + L.plain);
      int* kvs = reinterpret_cast<int*>(hand + L.kv);
      int* memb = reinterpret_cast<int*>(hand + L.memb);
      dense_relu<false>(xs, f, sw1, sb1, hs, p, tid);
      mlp_sync();
      dense_relu<true>(hs, hp, sw2, sb2, hs, p, tid);
      mlp_sync();
      // output layer: 4 actions x 4 rows a thread, the reduction split in
      // two halves (kg), the second half's sums handed over in l3
      const int n3 = ap / 4 * (R / 4);
      float a3[4][4];
      const int kg = tid / n3, t3 = tid - kg * n3;
      const int rg3 = t3 % (R / 4), ag = t3 / (R / 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) a3[i][r] = 0.f;
      if (kg < 2) {
        const int k0 = kg * (hp / 2);
        const float* wp = sw3 + 4 * ag;
        const float* xp = hs + 4 * rg3;
#pragma unroll 4
        for (int kk = k0; kk < k0 + hp / 2; ++kk) {
          const float4 w = *reinterpret_cast<const float4*>(wp + kk * ap);
          const float4 x = *reinterpret_cast<const float4*>(xp + kk * R);
          const float ws[4] = {w.x, w.y, w.z, w.w};
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              a3[i][r] = fmaf(xv[r], ws[i], a3[i][r]);
        }
        if (kg == 1) {
          float4* o = reinterpret_cast<float4*>(l3 + t3 * 16);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[i] = make_float4(a3[i][0], a3[i][1], a3[i][2], a3[i][3]);
        }
      }
      mlp_sync();
      if (kg == 0) {
        const float4* o = reinterpret_cast<const float4*>(l3 + t3 * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = 4 * ag + i;
          const float4 h2 = o[i];
          const float part[4] = {h2.x, h2.y, h2.z, h2.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 4 * rg3 + r;
            if (a < n_act && row < T.rows) {
              float v = (a3[i][r] + part[r]) + sb3[a];
              if (!(sallow[(row % users) * n_act + a] > 0.5f)) v = kNegInf;
              qs[row * n_act + a] = v;
            }
          }
        }
      }
      mlp_sync();
      // the tile's q rows are contiguous in q: one coalesced copy
      for (int i = tid; i < T.rows * n_act; i += kMlpThreads)
        P.q[T.row0 * n_act + i] = qs[i];
      // per user row: plain first-index argmax, then the stable top-k
      for (int r = tid; r < T.rows; r += kMlpThreads) {
        float cur[kMaxActions];
#pragma unroll
        for (int a = 0; a < kMaxActions; ++a)
          cur[a] = a < n_act ? qs[r * n_act + a] : -INFINITY;
        int kv = 0;
        for (int t = 0; t < (P.use_threshold ? k : 1); ++t) {
          float bv = cur[0];
          int bi = 0;
#pragma unroll
          for (int a = 1; a < kMaxActions; ++a)
            if (cur[a] > bv) {
              bv = cur[a];
              bi = a;
            }
          if (t == 0) {
            plain[r] = bi;
            if (!P.use_threshold) P.dec[T.row0 + r] = bi;
          }
          if (P.use_threshold) {
            topv[r * k + t] = bv;
            topi[r * k + t] = bi;
            topacc[r * k + t] = sacc[bi];
            kv += !(bv < -1e29f);
          }
#pragma unroll
          for (int a = 0; a < kMaxActions; ++a)
            if (a == bi) cur[a] = kNegInf;
        }
        kvs[r] = kv;
        memb[r] = xs[R + r] > 0.5f;
      }
    } else if (!mlp) {
      if (it >= 1 && P.use_threshold) {
        const Tile T = tile_at(blockIdx.x + (it - 1) * gridDim.x,
                               cells_per_tile, P.cells, users);
        const float* hand = smem + L.hand + ((it - 1) & 1) * L.hand_size;
        search_tile(T, users, k, hand + L.topv, hand + L.topacc,
                    reinterpret_cast<const int*>(hand + L.topi),
                    reinterpret_cast<const int*>(hand + L.plain),
                    reinterpret_cast<const int*>(hand + L.kv),
                    reinterpret_cast<const int*>(hand + L.memb), pw, sxmin,
                    reinterpret_cast<int*>(smem + L.lvl), P.dec,
                    tid - kMlpThreads);
      }
      if (it + 1 < mine)
        load_features(P, tile_at(blockIdx.x + (it + 1) * gridDim.x,
                                 cells_per_tile, P.cells, users),
                      f, R, smem + L.x + ((it + 1) & 1) * f * R,
                      tid - kMlpThreads, kSearchThreads);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dqn_head_launch(
    const void* act, const void* mem, const void* endb, const void* agg,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w3, const void* b3, const void* allowed,
    const void* acc_table, void* dec, void* q, const float* x_min,
    int cells, int users, int n_agg, int hidden, int n_act,
    int use_threshold, int topk, void* stream) {
  if (cells <= 0) return 0;
  const Plan p = make_plan(n_agg, hidden, n_act);
  if (users < 1 || users > kMaxUsers || n_act < 1 || n_act > kMaxActions ||
      topk < 1 || topk > n_act || hidden < 1 || n_agg < 0 ||
      p.warps_r < 1 || users > p.rows || (use_threshold && !x_min))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(p, n_act, topk, users);
  const size_t bytes = sizeof(float) * (size_t)L.total;
  // device queries are cached: per launch they would cost host time
  // comparable to the kernel's own
  static int s_dev = -1, s_max_optin = 0, s_sms = 0, s_per_sm = 0;
  static size_t s_bytes = 0, s_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != s_dev) {
    cudaDeviceGetAttribute(&s_max_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&s_sms, cudaDevAttrMultiProcessorCount, dev);
    s_dev = dev;
    s_bytes = 0;
    s_set = 0;
  }
  if (bytes > (size_t)s_max_optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes != s_bytes) {
    if (bytes > s_set) {
      cudaError_t e = cudaFuncSetAttribute(
          dqn_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      s_set = bytes;
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s_per_sm, dqn_head_kernel,
                                                  kThreads, bytes);
    s_bytes = bytes;
  }
  XMin xm;
  for (int m = 0; m <= kMaxUsers; ++m)
    xm.v[m] = (use_threshold && m >= 1 && m <= users) ? x_min[m] : INFINITY;
  Params P{static_cast<const float*>(act),  static_cast<const float*>(mem),
           static_cast<const float*>(endb), static_cast<const float*>(agg),
           static_cast<const float*>(w1),   static_cast<const float*>(b1),
           static_cast<const float*>(w2),   static_cast<const float*>(b2),
           static_cast<const float*>(w3),   static_cast<const float*>(b3),
           static_cast<const float*>(allowed),
           static_cast<const float*>(acc_table),
           static_cast<int*>(dec),          static_cast<float*>(q),
           cells, users, n_agg, hidden, n_act, use_threshold, topk};
  const int cells_per_tile = p.rows / users;
  const int n_tiles = (cells + cells_per_tile - 1) / cells_per_tile;
  const int grid =
      std::max(1, std::min(n_tiles, s_sms * std::max(s_per_sm, 1)));
  dqn_head_kernel<<<grid, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(P, xm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dqn_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// and the combo scoring adds k^N * N simple operations per cell; the bytes
// in and out are ~60 per user row. Design: a persistent grid of 128-thread
// blocks. Each block stages the MLP weights in dynamic shared memory once
// (~77 KB f32 at hidden 128, so the launcher raises the block's
// dynamic-shared-memory limit above 48 KB) and then walks over tiles of
// up to 24 user rows (whole cells), two blocks to an SM at hidden 128.
// Activations are kept feature-major; thread t owns hidden units t,
// t+128, ... with one accumulator per row of the tile in registers, so
// each weight is read once per tile and one float4 broadcast of
// activations feeds four FMAs. The products are plain FP32 FMA (no
// TF32): decisions are compared exactly against the plain version's
// decision logic. Top-k is k rounds of (max,
// first-argmax, mask) per user row; combo j's digit for user u is
// (j / k^(N-1-u)) % k, itertools.product's order, so no combo table is
// needed. Only the member users' digits are enumerated (see the combo
// loop), each thread over a contiguous run; the block reduces (score,
// index) with ties to the lower index.
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 24;     // user rows per tile (2 blocks/SM at H=128)
constexpr int kMaxActions = 16;  // per-user action width held in registers
constexpr int kMaxUsers = kMaxRows;   // a tile holds at least one cell
constexpr float kNegInf = -1e30f;

struct Layout {  // offsets (in floats) into dynamic shared memory
  int w1, b1, w2, b2, w3, b3, x, h1, h2, qs, topv, topi, topacc, plain, pw,
      red_s, red_j, total;
};

__host__ __device__ inline Layout make_layout(int f, int h, int na, int k,
                                              int users) {
  Layout L;
  int o = 0;
  // every block starts on a 16-byte boundary (float4 reads of h1)
  auto take = [&o](int n) { const int at = o; o += (n + 3) & ~3; return at; };
  L.w1 = take(f * h);
  L.b1 = take(h);
  L.w2 = take(h * h);
  L.b2 = take(h);
  L.w3 = take(h * na);
  L.b3 = take(na);
  L.x = take(kMaxRows * f);
  L.h1 = take(kMaxRows * h);
  L.h2 = take(kMaxRows * h);
  L.qs = take(kMaxRows * na);
  L.topv = take(kMaxRows * k);
  L.topi = take(kMaxRows * k);
  L.topacc = take(kMaxRows * k);
  L.plain = take(kMaxRows);
  L.pw = take(users);
  L.red_s = take(kThreads / 32);
  L.red_j = take(kThreads / 32);
  L.total = o;
  return L;
}

__device__ __forceinline__ bool better(float s, int j, float bs, int bj) {
  return s > bs || (s == bs && j < bj);
}

// out[j][r] = relu(b[j] + sum_i in[i][r] * w[i][j]) for every row r of
// the tile and j < h. Activations are stored feature-major, (width,
// kMaxRows): thread j keeps one accumulator per row in registers, and a
// float4 broadcast read of in[i][r..r+3] feeds four FMAs, so the loop is
// bound by FMAs, not by shared-memory reads. Padding rows compute on
// zeros and are never written out.
__device__ __forceinline__ void dense_relu(const float* in, int width,
                                           const float* w, const float* b,
                                           float* out, int h) {
  for (int j = threadIdx.x; j < h; j += kThreads) {
    float acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
    for (int i = 0; i < width; ++i) {
      const float wij = w[i * h + j];
      const float4* x = reinterpret_cast<const float4*>(in + i * kMaxRows);
#pragma unroll
      for (int q = 0; q < kMaxRows / 4; ++q) {
        const float4 v = x[q];
        acc[4 * q] = fmaf(v.x, wij, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, wij, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, wij, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, wij, acc[4 * q + 3]);
      }
    }
    const float bj = b[j];
    float4* o = reinterpret_cast<float4*>(out + j * kMaxRows);
#pragma unroll
    for (int q = 0; q < kMaxRows / 4; ++q)
      o[q] = make_float4(fmaxf(acc[4 * q] + bj, 0.f),
                         fmaxf(acc[4 * q + 1] + bj, 0.f),
                         fmaxf(acc[4 * q + 2] + bj, 0.f),
                         fmaxf(acc[4 * q + 3] + bj, 0.f));
  }
}

__global__ void __launch_bounds__(kThreads)
dqn_head_kernel(const float* __restrict__ act, const float* __restrict__ mem,
                const float* __restrict__ endb,
                const float* __restrict__ agg, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3,
                const float* __restrict__ allowed,
                const float* __restrict__ acc_table, int* __restrict__ dec,
                float* __restrict__ q_out, int cells, int users, int n_agg,
                int hidden, int n_act, int use_threshold, float thr,
                int topk) {
  extern __shared__ float smem[];
  const int f = 3 + n_agg;
  const Layout L = make_layout(f, hidden, n_act, topk, users);
  float* sw1 = smem + L.w1;
  float* sb1 = smem + L.b1;
  float* sw2 = smem + L.w2;
  float* sb2 = smem + L.b2;
  float* sw3 = smem + L.w3;
  float* sb3 = smem + L.b3;
  float* xs = smem + L.x;
  float* h1 = smem + L.h1;
  float* h2 = smem + L.h2;
  float* qs = smem + L.qs;
  float* topv = smem + L.topv;
  int* topi = reinterpret_cast<int*>(smem + L.topi);
  float* topacc = smem + L.topacc;
  int* plain = reinterpret_cast<int*>(smem + L.plain);
  int* pw = reinterpret_cast<int*>(smem + L.pw);
  float* red_s = smem + L.red_s;
  int* red_j = reinterpret_cast<int*>(smem + L.red_j);
  const int tid = threadIdx.x;

  // weights: staged once per (persistent) block
  for (int i = tid; i < f * hidden; i += kThreads) sw1[i] = w1[i];
  for (int i = tid; i < hidden * hidden; i += kThreads) sw2[i] = w2[i];
  for (int i = tid; i < hidden * n_act; i += kThreads) sw3[i] = w3[i];
  for (int i = tid; i < hidden; i += kThreads) {
    sb1[i] = b1[i];
    sb2[i] = b2[i];
  }
  for (int i = tid; i < n_act; i += kThreads) sb3[i] = b3[i];
  if (tid == 0) {  // k^(N-1-u): the place value of user u's combo digit
    int p = 1;
    for (int u = users - 1; u >= 0; --u) {
      pw[u] = p;
      p *= topk;
    }
  }

  const int cells_per_tile = kMaxRows / users;
  const int n_tiles = (cells + cells_per_tile - 1) / cells_per_tile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int cell0 = tile * cells_per_tile;
    const int tcells = min(cells_per_tile, cells - cell0);
    const int rows = tcells * users;
    const long long row0 = (long long)cell0 * users;
    __syncthreads();  // previous tile (and the weight staging) done
    // features, feature-major (f, kMaxRows); padding rows are zero
    for (int i = tid; i < f * kMaxRows; i += kThreads) {
      const int c = i / kMaxRows, r = i % kMaxRows;
      const long long g = row0 + r;
      float v = 0.f;
      if (r < rows) {
        if (c == 0) v = act[g];
        else if (c == 1) v = mem[g];
        else if (c == 2) v = endb[g];
        else v = agg[(long long)(cell0 + r / users) * n_agg + (c - 3)];
      }
      xs[i] = v;
    }
    __syncthreads();
    dense_relu(xs, f, sw1, sb1, h1, hidden);
    __syncthreads();
    dense_relu(h1, hidden, sw2, sb2, h2, hidden);
    __syncthreads();
    // output layer: one thread per (action, quad of rows)
    for (int o = tid; o < n_act * (kMaxRows / 4); o += kThreads) {
      const int a = o % n_act, r0 = 4 * (o / n_act);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < hidden; ++k) {
        const float wk = sw3[k * n_act + a];
        const float4 v =
            *reinterpret_cast<const float4*>(h2 + k * kMaxRows + r0);
        acc.x = fmaf(v.x, wk, acc.x);
        acc.y = fmaf(v.y, wk, acc.y);
        acc.z = fmaf(v.z, wk, acc.z);
        acc.w = fmaf(v.w, wk, acc.w);
      }
      const float sums[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int e = 0; e < 4 && r0 + e < rows; ++e) {
        const int r = r0 + e;
        float v = sums[e] + sb3[a];
        if (!(allowed[(r % users) * n_act + a] > 0.5f)) v = kNegInf;
        qs[r * n_act + a] = v;
        q_out[(row0 + r) * n_act + a] = v;
      }
    }
    __syncthreads();
    // per user row: plain first-index argmax, then the stable top-k
    for (int r = tid; r < rows; r += kThreads) {
      float cur[kMaxActions];
      for (int a = 0; a < n_act; ++a) cur[a] = qs[r * n_act + a];
      int best = 0;
      for (int a = 1; a < n_act; ++a)
        if (cur[a] > cur[best]) best = a;
      plain[r] = best;
      if (!use_threshold) {
        dec[row0 + r] = best;
        continue;
      }
      for (int t = 0; t < topk; ++t) {
        int i = 0;
        for (int a = 1; a < n_act; ++a)
          if (cur[a] > cur[i]) i = a;
        topv[r * topk + t] = cur[i];
        topi[r * topk + t] = i;
        topacc[r * topk + t] = acc_table[i];
        cur[i] = kNegInf;
      }
    }
    if (!use_threshold) continue;
    __syncthreads();
    for (int cc = 0; cc < tcells; ++cc) {
      const int rb = cc * users;  // first row of this cell in the tile
      // Only member users' digits change a combo's score, and of combos
      // that differ in non-member digits the one with those digits 0 has
      // the lowest index, so it wins every tie: enumerating the member
      // digits alone (k^members combos) picks the reference's combo.
      int mu[kMaxUsers];
      int m = 0;
      for (int u = 0; u < users; ++u)
        if (xs[kMaxRows + rb + u] > 0.5f) mu[m++] = u;
      const float nm = (float)max(m, 1);
      int n_sub = 1;
      for (int i = 0; i < m; ++i) n_sub *= topk;
      // each thread walks one contiguous run of combos, in index order,
      // stepping its digits like an odometer (no divisions per combo)
      const int per = (n_sub + kThreads - 1) / kThreads;
      int t = tid * per;
      const int t_end = min(t + per, n_sub);
      float bs = -INFINITY;
      int bj = INT_MAX;
      if (t < t_end) {
        int d[kMaxUsers];
        int rem = t;
        for (int i = m - 1; i >= 0; --i) {
          d[i] = rem % topk;
          rem /= topk;
        }
        for (; t < t_end; ++t) {
          float score = 0.f, macc_sum = 0.f;
          bool invalid = false;
          int j = 0;
          for (int i = 0; i < m; ++i) {
            const int slot = (rb + mu[i]) * topk + d[i];
            const float v = topv[slot];
            score = __fadd_rn(score, v);
            macc_sum = __fadd_rn(macc_sum, topacc[slot]);
            invalid |= v < -1e29f;
            j += d[i] * pw[mu[i]];
          }
          const float macc = m > 0 ? __fdiv_rn(macc_sum, nm) : 100.f;
          const float sc = (macc >= thr && !invalid) ? score : -INFINITY;
          if (better(sc, j, bs, bj)) {
            bs = sc;
            bj = j;
          }
          for (int i = m - 1; i >= 0; --i) {
            if (++d[i] < topk) break;
            d[i] = 0;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (better(os, oj, bs, bj)) {
          bs = os;
          bj = oj;
        }
      }
      if ((tid & 31) == 0) {
        red_s[tid >> 5] = bs;
        red_j[tid >> 5] = bj;
      }
      __syncthreads();
      if (tid < users) {
        float s = red_s[0];
        int jj = red_j[0];
        for (int w = 1; w < kThreads / 32; ++w)
          if (better(red_s[w], red_j[w], s, jj)) {
            s = red_s[w];
            jj = red_j[w];
          }
        const int u = tid;
        int out = plain[rb + u];
        if (isfinite(s)) out = topi[(rb + u) * topk + (jj / pw[u]) % topk];
        dec[row0 + rb + u] = out;
      }
      __syncthreads();  // red_* are reused by the next cell
    }
  }
}

int g_max_smem_set = 0;

}  // namespace

extern "C" int dqn_head_launch(
    const void* act, const void* mem, const void* endb, const void* agg,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* w3, const void* b3, const void* allowed,
    const void* acc_table, void* dec, void* q, int cells, int users,
    int n_agg, int hidden, int n_act, int use_threshold, float thr,
    int topk, void* stream) {
  if (cells <= 0) return 0;
  if (users < 1 || users > kMaxUsers || n_act < 1 || n_act > kMaxActions ||
      topk < 1 || topk > n_act)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(3 + n_agg, hidden, n_act, topk, users);
  const size_t bytes = sizeof(float) * (size_t)L.total;
  // device queries are cached: per launch they would cost host time
  // comparable to the kernel's own
  static int s_dev = -1, s_max_optin = 0, s_sms = 0, s_per_sm = 0;
  static size_t s_bytes = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != s_dev) {
    cudaDeviceGetAttribute(&s_max_optin,
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&s_sms, cudaDevAttrMultiProcessorCount, dev);
    s_dev = dev;
    s_bytes = 0;
    g_max_smem_set = 0;
  }
  if (bytes > (size_t)s_max_optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes != s_bytes) {
    if ((int)bytes > g_max_smem_set) {
      cudaError_t e = cudaFuncSetAttribute(
          dqn_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      g_max_smem_set = (int)bytes;
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s_per_sm, dqn_head_kernel,
                                                  kThreads, bytes);
    s_bytes = bytes;
  }
  const int sms = s_sms, per_sm = s_per_sm;
  const int cells_per_tile = kMaxRows / users;
  const int n_tiles = (cells + cells_per_tile - 1) / cells_per_tile;
  const int grid = std::max(1, std::min(n_tiles, sms * std::max(per_sm, 1)));
  dqn_head_kernel<<<grid, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(act), static_cast<const float*>(mem),
      static_cast<const float*>(endb), static_cast<const float*>(agg),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(allowed),
      static_cast<const float*>(acc_table), static_cast<int*>(dec),
      static_cast<float*>(q), cells, users, n_agg, hidden, n_act,
      use_threshold, thr, topk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dqn_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Backward of the Mamba-1 selective scan (K6's gradient, P3) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through its jnp scans
// (repro/models/mamba.py selective_scan_ref, an associative scan) with
// jax.grad and has no Pallas backward. The port's forward runs through K6
// (selective_scan.cu), so its training needs a backward of its own; this is
// it, from the state K6's kStates instance writes at every 32-step chunk.
//
// The forward, per batch row b, channel d and state n (float32):
//   a_t = exp(dt_t A),  h_t = a_t h_{t-1} + (dt_t u_t) B_t,  h_{-1} = 0,
//   y_t = sum_n h_t C_t + D u_t.
// Given dy (and dh_last, the gradient of the final state; zero when null),
// the reverse recurrence with g the gradient of h_t:
//   g  = g_next + C_t dy_t            (g_next: a_{t+1} g_{t+1}, or dh_last)
//   dC_t += sum_d h_t dy_t            dB_t += sum_d g dt_t u_t
//   du_t  = D dy_t + dt_t sum_n g B_t
//   ddt_t = sum_n g (A a_t h_{t-1}) + u_t sum_n g B_t
//   dA   += g dt_t a_t h_{t-1}        dD += dy_t u_t
//   g_next = a_t g
// du is written in u's type (float32 or bfloat16), the rest in float32.
//
// Why it computes what it computes. The reverse walk needs h_{t-1} at every
// step. Running the recurrence backwards (h_{t-1} = (h_t - dt u B) / a_t)
// blows up where dt A is large and negative, and storing every state is
// (Bt, S, di, N) float32: 3.4 GB a layer at Hymba's 8 x 2,048 x 3,200 x 16.
// So the forward's kStates instance keeps only the state entering each
// 32-step chunk (1/32 of that), and this kernel rebuilds a chunk's states
// from it with K6's own arithmetic (each decay exp2(dt A log2(e)) as one
// ex2.approx, A scaled by log2(e) at load; h = fmaf(h, a, du B)), so the
// rebuilt states are K6's to the bit.
//
// Design. One block of 128 threads per (batch row, 32 channels): four
// neighbouring lanes share a channel and hold 4 of its 16 states each
// (states past N keep zero A, B, C and stay zero), with A, A log2(e), g and
// the dA sums in registers. The block walks the chunks from the last: it
// stages the chunk's u, dt, dy columns and B, C rows in shared memory (the
// previous chunk's loads and its entry state go out into registers before
// this one is computed), then takes the chunk in two 16-step halves, the
// later first. For each half it runs the recurrence forward from the
// chunk's entry state, keeping each lane's h_{t-1} in shared memory (its
// own float4 a step: 32 KB), then walks the half backwards with g in
// registers, computing each decay again. So every step takes 2.5
// exponentials an element (1.5 rebuilding, 1 in the walk); whole 32-step
// chunks of states would take 2 and 64 KB of shared memory, and fewer
// blocks a SM. Reductions, in fixed orders (no atomics: two runs give the
// same bits):
//  - over a channel's 4 lanes (du's and ddt's sums over n): two shuffles
//    that leave sum_n g B on the channel's lane 0 and sum_n g A a h_{t-1} on
//    its lane 1, written to shared memory; du and ddt are formed and written
//    out coalesced after the chunk, as K6 writes y;
//  - over channels (dB_t, dC_t, 16 values each a step): a warp halves its
//    4 x 2 values a lane across its 8 channels in 7 shuffles (xor 16, 8, 4),
//    leaving each of the 32 values on one lane; the 4 warps' sums are added
//    in order after the chunk and written as the block's partial sums,
//    (Bt, di / 32 blocks, S, N) each;
//  - over batch rows and time (dA, dD): each lane sums its own over time;
//    each block writes its (b, d) partials.
// A second launch (selective_scan_bwd_sum_kernel) adds the blocks' dB / dC
// partials and the rows' dA / dD partials, each in index order. The walk
// takes h_t for dC_t's term from the step after (its h_{t-1}, or the state
// the half's rebuild ended at) instead of computing it again, is compiled
// for 3 blocks of 4 warps a SM (what its 72 KB of shared memory allow), and
// unrolls the rebuild's steps by 8: together 5.5-6% faster at both
// training shapes (tools/scan_ab.py, parent and change in turns), the same
// bits.
//
// Bound: per (batch, step, channel) u, dy and du at 2 or 4 bytes and dt and
// ddt at 4; B, C, dB, dC per (batch, step, state); the boundary states; the
// operations, about 20 FP32 operations an element (the rebuilt h_t, the
// five products and sums above). At Hymba's shape (bf16 u) the bytes and
// the FP32 operations each take ~0.25 ms; the 2.5 exponentials an element
// on the special function units (16 a clock a SM) take 0.50 ms. None of
// them sets the pace (the walk runs at ~0.12-0.15 of its bound): taken out
// one at a time (tools/scan_bwd_ablate.py), the dB / dC shuffles cost
// 10-12% of its time, the rebuild's second pass over a chunk's first half
// 4%, the s1 / s2 shuffles and the exponentials 3% each; a warp spends
// ~46% of a chunk in the walk, ~25% rebuilding, ~18% staging and ~11% on
// du / ddt and the sums (tools/scan_bwd_clocks.py). Keeping the decays
// beside h_{t-1} (1.5 exponentials, 104 KB, 2 blocks a SM) walks 30%
// slower; summing dB / dC after each half from shared memory instead of
// the shuffles (64 KB more, 1 block a SM) 2x slower. The partial sums add
// (Bt, S, N) x di / 32 x 2 floats written and read again (210 MB at
// Hymba).
//
// A design with time across a warp's lanes (each decay computed once, a
// scan over the lanes per (channel, state) to rebuild the states and to
// carry the gradient, dB / dC summed in registers over a warp's channels)
// was built and measured against this one: 1.2x slower at Hymba's shape
// and 1.4x at Falcon-Mamba's. Its scans cost 21 shuffles a lane per
// (channel, state) and 400-600 cycles of latency a pass, it issues ~41
// instructions an element, and its 255 registers allow 8 warps a SM, too
// few to hide the scans; more warps a block spill (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                // lanes a block
constexpr int kLanes = 4;                    // lanes a channel
constexpr int kMaxState = 16;
constexpr int kPerLane = kMaxState / kLanes;  // states a lane
constexpr int kCh = kThreads / kLanes;       // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // K6's chunk: its states are kept at each start
constexpr int kSub = 16;    // steps whose h_{t-1} a pass keeps
constexpr int kUD = kChunk * kCh / kThreads;         // u / dt / dy a lane
constexpr int kBC = kChunk * kMaxState / kThreads;   // B / C a lane
constexpr int kRed = kChunk * 2 * kMaxState / kThreads;  // dB / dC a lane
constexpr int kBlocksPerSM = 3;  // what the shared memory allows (and
                                 // selective_scan.BWD_BLOCKS_PER_SM)
constexpr int kAdvanceUnroll = 8;  // rebuild steps unrolled
constexpr int kMaxDevices = 64;  // devices a process grants
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kPerLane == 4, "a lane's states are one float4");
static_assert(kChunk % kSub == 0, "halves of a chunk");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 2^x on the special function unit: one MUFU.EX2, as K6 takes it
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Smem {
  float u[kChunk][kCh];
  float dt[kChunk][kCh];
  float dy[kChunk][kCh];
  float s1[kChunk][kCh];  // sum_n g B_t, from each channel's lane 0
  float s2[kChunk][kCh];  // sum_n g A a_t h_{t-1}, from its lane 1
  float4 b[kChunk][kMaxState / 4];
  float4 c[kChunk][kMaxState / 4];
  float red[kWarps][kChunk][2 * kMaxState];  // a warp's dB_t, then dC_t
  float4 hp[kSub][kThreads];  // each lane's h_{t-1} over a half chunk
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
selective_scan_bwd_kernel(const T* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ D,
                          const float* __restrict__ states,
                          const T* __restrict__ dy,
                          const float* __restrict__ dh_last,
                          T* __restrict__ du, float* __restrict__ ddt,
                          float* __restrict__ dB_part,
                          float* __restrict__ dC_part,
                          float* __restrict__ dA_part,
                          float* __restrict__ dD_part, int S, int di,
                          int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  float* const b_flat = reinterpret_cast<float*>(&sm.b[0][0]);
  float* const c_flat = reinterpret_cast<float*>(&sm.c[0][0]);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ch = tid / kLanes;          // this lane's channel in the block
  const int l = tid % kLanes;           // its quarter of the states
  const int s0 = l * kPerLane;          // and its first state
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < di;
  const int b = blockIdx.y;
  const long long row = (long long)b * S;  // the (b, t = 0) row
  const int nc = (S + kChunk - 1) / kChunk;
  // the channel whose u, dt, dy, du and ddt this lane moves: element tid +
  // k * kThreads of a chunk's (step, channel) grid is step tid / kCh + k *
  // kLanes
  const int cw = tid % kCh, tw = tid / kCh;
  const bool live_w = d0 + cw < di;
  const float dd = live_w ? D[d0 + cw] : 0.f;
  // the lane's place in the warp's halving of dB / dC over its 8 channels
  const bool hi2 = lane & 16, hi1 = lane & 8, hi0 = lane & 4;
  const int red_at = (hi2 ? kMaxState : 0) + s0 + (hi1 ? 2 : 0) + (hi0 ? 1 : 0);

  for (int i = tid; i < kChunk * kMaxState; i += kThreads) {
    b_flat[i] = 0.f;
    c_flat[i] = 0.f;
  }
  float a2[kPerLane], af[kPerLane], g[kPerLane], dA_acc[kPerLane];
  float dD_acc = 0.f;
#pragma unroll
  for (int n = 0; n < kPerLane; ++n) {
    const bool ok = live && s0 + n < N;
    af[n] = ok ? A[(long long)d * N + s0 + n] : 0.f;
    a2[n] = af[n] * kLog2e;  // K6's scaled row of A
    g[n] = (ok && dh_last != nullptr)
               ? dh_last[((long long)b * di + d) * N + s0 + n]
               : 0.f;
    dA_acc[n] = 0.f;
  }

  // a chunk in flight in registers: this lane's share of its u / dt / dy
  // columns and of its B / C rows, and the lane's entry state
  float ur[kUD], dr[kUD], yr[kUD], br[kBC], cr[kBC], he[kPerLane];
  auto fetch = [&](int c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
#pragma unroll
    for (int k = 0; k < kUD; ++k) {
      const int t = tw + k * kLanes;
      const bool ok = t < len && live_w;
      const long long off = (row + t0 + t) * di + d0 + cw;
      ur[k] = ok ? to_float(u[off]) : 0.f;
      dr[k] = ok ? dt[off] : 0.f;
      yr[k] = ok ? to_float(dy[off]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      const bool ok = i < len * N;
      const long long off = (row + t0) * N + i;
      br[k] = ok ? Bm[off] : 0.f;
      cr[k] = ok ? Cm[off] : 0.f;
    }
    const float* st = states + (((long long)b * nc + c) * di + d) * N + s0;
#pragma unroll
    for (int n = 0; n < kPerLane; ++n)
      he[n] = (live && s0 + n < N) ? st[n] : 0.f;
  };
  // one step of the forward recurrence, as K6 takes it
  auto advance = [&](float (&h)[kPerLane], int i) {
    const float dtv = sm.dt[i][ch];
    const float duv = dtv * sm.u[i][ch];
    const float4 bv = sm.b[i][l];
    const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int n = 0; n < kPerLane; ++n)
      h[n] = fmaf(h[n], ex2(dtv * a2[n]), duv * bn[n]);
  };
  // one step of the reverse walk at step i of the chunk (j of its half):
  // hq = h_{t-1} (kept at hp[j]), hn = h_t (the step after's h_{t-1}, or
  // the state the half's rebuild ended at)
  auto back = [&](int i, int j, const float4 hq, const float4 hn) {
    const float dtv = sm.dt[i][ch], uv = sm.u[i][ch], dyv = sm.dy[i][ch];
    const float duv = dtv * uv;
    const float4 bv = sm.b[i][l], cv = sm.c[i][l];
    const float hp[4] = {hq.x, hq.y, hq.z, hq.w};
    const float ht[4] = {hn.x, hn.y, hn.z, hn.w};
    const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
    const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
    float s1 = 0.f, s2 = 0.f, v[2 * kPerLane];
#pragma unroll
    for (int n = 0; n < kPerLane; ++n) {
      const float a = ex2(dtv * a2[n]);
      g[n] = fmaf(cn[n], dyv, g[n]);
      v[n] = g[n] * duv;                                 // dB_t's term
      v[kPerLane + n] = ht[n] * dyv;                     // dC_t's: h_t dy
      s1 = fmaf(g[n], bn[n], s1);
      const float p = g[n] * a * hp[n];
      s2 = fmaf(af[n], p, s2);
      dA_acc[n] = fmaf(dtv, p, dA_acc[n]);
      g[n] *= a;
    }
    dD_acc = fmaf(dyv, uv, dD_acc);
    // s1 over the channel's lanes onto its even lanes, s2 onto its odd ones
    const bool odd = l & 1;
    float keep = odd ? s2 : s1;
    keep += __shfl_xor_sync(kFull, odd ? s1 : s2, 1);
    keep += __shfl_xor_sync(kFull, keep, 2);
    if (l == 0) sm.s1[i][ch] = keep;
    if (l == 1) sm.s2[i][ch] = keep;
    // dB_t / dC_t over the warp's 8 channels, halving the values each step
    float w[4], x[2];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (hi2 ? v[k + 4] : v[k]) +
             __shfl_xor_sync(kFull, hi2 ? v[k] : v[k + 4], 16);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      x[k] = (hi1 ? w[k + 2] : w[k]) +
             __shfl_xor_sync(kFull, hi1 ? w[k] : w[k + 2], 8);
    sm.red[warp][i][red_at] =
        (hi0 ? x[1] : x[0]) + __shfl_xor_sync(kFull, hi0 ? x[0] : x[1], 4);
  };

  if (nc > 0) fetch(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
#pragma unroll
    for (int k = 0; k < kUD; ++k) {
      sm.u[tw + k * kLanes][cw] = ur[k];
      sm.dt[tw + k * kLanes][cw] = dr[k];
      sm.dy[tw + k * kLanes][cw] = yr[k];
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      if (i < len * N) {
        b_flat[(i / N) * kMaxState + i % N] = br[k];
        c_flat[(i / N) * kMaxState + i % N] = cr[k];
      }
    }
    float h0[kPerLane];
#pragma unroll
    for (int n = 0; n < kPerLane; ++n) h0[n] = he[n];
    __syncthreads();
    if (c > 0) fetch(c - 1);  // loads overlap the compute
    for (int i0 = (len - 1) / kSub * kSub; i0 >= 0; i0 -= kSub) {
      const int i1 = min(len, i0 + kSub);
      float h[kPerLane];
#pragma unroll
      for (int n = 0; n < kPerLane; ++n) h[n] = h0[n];
#pragma unroll kAdvanceUnroll
      for (int i = 0; i < i0; ++i) advance(h, i);
#pragma unroll kAdvanceUnroll
      for (int i = i0; i < i1; ++i) {
        sm.hp[i - i0][tid] = make_float4(h[0], h[1], h[2], h[3]);
        advance(h, i);
      }
      float4 hn = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll 2
      for (int i = i1 - 1; i >= i0; --i) {
        const float4 hq = sm.hp[i - i0][tid];
        back(i, i - i0, hq, hn);
        hn = hq;
      }
    }
    __syncthreads();
    // du and ddt of the chunk, coalesced
#pragma unroll
    for (int k = 0; k < kUD; ++k) {
      const int t = tw + k * kLanes;
      if (t < len && live_w) {
        const float s1 = sm.s1[t][cw];
        const long long off = (row + t0 + t) * di + d0 + cw;
        du[off] = from_float<T>(fmaf(sm.dt[t][cw], s1, dd * sm.dy[t][cw]));
        ddt[off] = fmaf(sm.u[t][cw], s1, sm.s2[t][cw]);
      }
    }
    // the block's dB_t / dC_t: its warps' sums, added in order
    const long long part = (long long)b * gridDim.x + blockIdx.x;
#pragma unroll
    for (int k = 0; k < kRed; ++k) {
      const int e = tid + k * kThreads;
      const int i = e / (2 * kMaxState), v = e % (2 * kMaxState);
      const int n = v % kMaxState;
      if (i < len && n < N) {
        float sum = sm.red[0][i][v];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += sm.red[w][i][v];
        (v < kMaxState ? dB_part : dC_part)[(part * S + t0 + i) * N + n] =
            sum;
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kPerLane; ++n)
      if (s0 + n < N) dA_part[((long long)b * di + d) * N + s0 + n] = dA_acc[n];
    if (l == 0) dD_part[(long long)b * di + d] = dD_acc;
  }
}

// the sums over the blocks' partials: dB, dC (Bt, S, N) over the di / 32
// channel blocks of each row, dA (di, N) and dD (di,) over the batch rows,
// each in index order
__global__ void selective_scan_bwd_sum_kernel(
    const float* __restrict__ dB_part, const float* __restrict__ dC_part,
    const float* __restrict__ dA_part, const float* __restrict__ dD_part,
    float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ dA,
    float* __restrict__ dD, int Bt, int S, int di, int N, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long sn = (long long)S * N, nbc = Bt * sn;
  const long long an = (long long)di * N;
  if (i < nbc) {
    const long long b = i / sn, r = i - b * sn;
    const float* pb = dB_part + b * nblk * sn + r;
    const float* pc = dC_part + b * nblk * sn + r;
    float sb = 0.f, sc = 0.f;
#pragma unroll 4
    for (int k = 0; k < nblk; ++k) {
      sb += pb[k * sn];
      sc += pc[k * sn];
    }
    dB[i] = sb;
    dC[i] = sc;
  } else if (i < nbc + an) {
    const long long j = i - nbc;
    float s = 0.f;
    for (int b = 0; b < Bt; ++b) s += dA_part[b * an + j];
    dA[j] = s;
  } else if (i < nbc + an + di) {
    const long long j = i - nbc - an;
    float s = 0.f;
    for (int b = 0; b < Bt; ++b) s += dD_part[b * di + j];
    dD[j] = s;
  }
}

// grants the kernel its dynamic shared memory on the current device, once
// a device; only a grant that succeeded is kept
template <typename T>
cudaError_t grant() {
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(selective_scan_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Smem)));
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = true;
  return err;
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* states, const void* dy, const void* dh_last,
                   void* du, void* ddt, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, int Bt, int S, int di,
                   int N, cudaStream_t stream) {
  cudaError_t err = grant<T>();
  if (err != cudaSuccess) return err;
  const dim3 grid((di + kCh - 1) / kCh, Bt);
  selective_scan_bwd_kernel<T><<<grid, kThreads, sizeof(Smem), stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(states), static_cast<const T*>(dy),
      static_cast<const float*>(dh_last), static_cast<T*>(du),
      static_cast<float*>(ddt), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), S, di, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 u, dy and du, 1 = bfloat16; states: K6's kStates
// output (Bt, ceil(S / 32), di, N); dh_last (Bt, di, N) or null (zero);
// dB_part, dC_part: (Bt, ceil(di / 32), S, N) and dA_part (Bt, di, N),
// dD_part (Bt, di), float32 scratch. Two launches: the walk, then the sums.
extern "C" int selective_scan_backward_launch(
    const void* u, const void* dt, const void* A, const void* B,
    const void* C, const void* D, const void* states, const void* dy,
    const void* dh_last, void* du, void* ddt, void* dA, void* dB, void* dC,
    void* dD, void* dB_part, void* dC_part, void* dA_part, void* dD_part,
    int Bt, int S, int di, int N, int dtype, void* stream) {
  if (di <= 0) return 0;
  if (N <= 0 || N > kMaxState || S < 0 || Bt < 0 || Bt > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bt > 0) {
    const cudaError_t err =
        dtype == 0
            ? launch<float>(u, dt, A, B, C, D, states, dy, dh_last, du, ddt,
                            dB_part, dC_part, dA_part, dD_part, Bt, S, di, N,
                            s)
            : launch<__nv_bfloat16>(u, dt, A, B, C, D, states, dy, dh_last,
                                    du, ddt, dB_part, dC_part, dA_part,
                                    dD_part, Bt, S, di, N, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = (long long)Bt * S * N + (long long)di * N + di;
  const int threads = 256;
  selective_scan_bwd_sum_kernel<<<(total + threads - 1) / threads, threads, 0,
                                  s>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<const float*>(dD_part),
      static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), static_cast<float*>(dD), Bt, S, di, N,
      (di + kCh - 1) / kCh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* selective_scan_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

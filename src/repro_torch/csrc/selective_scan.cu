// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/selective_scan.py
// (selective_scan_kernel, body _kernel):
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * u_t) B_t,   h_0 = 0
//   y_t = h_t . C_t + D * u_t
// with u (Bt, S, di) float32 or bfloat16, dt (Bt, S, di) float32, A (di, N)
// float32, B and C (Bt, S, N) float32, D (di,) float32; outputs y (Bt, S, di)
// in u's type and the final state h_last (Bt, di, N) float32. All arithmetic
// is float32. Each decay is exp2(dt * A log2(e)) on the special function
// unit (ex2.approx.ftz.f32, relative error about 2^-22; a result below
// 2^-126 flushes to zero, where the decayed term is below float32's reach
// of the sum anyway). That error is far inside the parity tolerances (y
// within 1e-4 in float32, h_last within 1e-4), which the card checks hold.
//
// Bound: per (batch, step, channel) the kernel reads u and dt and writes y
// once, and per state it does one exponential and a few FP32 operations.
// Against the card's HBM rate and its FP32 peak the bytes bind. The
// Bt*S*di*N exponentials on the special function units (16 per clock per
// SM) take longer than the bytes: a floor that a design computing every
// exponential there, as this one does, cannot go under. It is not what sets
// this kernel's pace: its exponentials, its FP32 issue and its shared-memory
// reads of B and C each cost a share of the time, and the shares add up
// rather than overlap (tools/scan_ablate.py removes each in turn).
//
// Design: the recurrence is parallel over (batch, channel, state) and
// sequential in time. L = 2 or 4 consecutive lanes of a warp share one
// (batch, channel) and each keeps 16 / L of its states and the matching
// entries of its row of A, scaled by log2(e) once at load, in registers
// (entries past N are zero, which leaves those states at zero, so no lane
// is predicated). Per (state, step) that leaves one FMUL (dt * a'), one
// MUFU.EX2, one FMUL (du * B) and two FFMAs (the state and the C product),
// with B_t and C_t read from shared memory as float4 broadcasts. Each lane
// leaves its share of y_t in shared memory, and the shares are summed with
// D u_t when the chunk is written out, so no lane waits on another inside
// the recurrence. The wrapper's plan picks L from the shape: two lanes where
// the grid fills the card (Falcon-Mamba: 8,192 blocks), four where it is
// thin (Hymba's 8 x 3,200 channels: 800 blocks in place of 400). One lane a
// channel is no faster at Falcon-Mamba's shape and slower at Hymba's: its
// 16 states and a chunk in flight need 122 registers and a chunk cut to 16
// steps (tools/scan_ablate.py times it). Splitting the states adds no
// exponential and no second pass, unlike a scan chunked in time.
// A block of 128 threads covers 128 / L channels of one batch row and walks
// time in chunks of 32 steps: the block stages the chunk's u and dt columns
// and B_t / C_t rows in shared memory (neighbouring threads load
// neighbouring channels, so the loads are coalesced and all in flight at
// once), the next chunk's loads go out into registers before the current
// chunk is computed, and y is written out coalesced after the chunk, by the
// lanes that staged its u. Channels past di (di = 3,200 is no multiple of
// 128) are bounds-checked rather than padded.
//
// Training (template flag kStates): the flagged instance also writes the
// state entering every chunk, h before step 32 c, to states (Bt, ceil(S /
// 32), di, N) float32 (zeros for c = 0), from the registers it holds at the
// chunk's start. The backward (selective_scan_backward.cu, P3) rebuilds
// each chunk's states from there. The store is under if constexpr, so the
// serving instance's code is unchanged, and the flagged instance's y and
// h_last are the serving instance's bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // lanes per block
constexpr int kMaxState = 16;  // states per channel held in registers
constexpr int kChunk = 32;     // time steps staged per pass
constexpr int kUnroll = 4;     // steps unrolled in the inner loop
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^x on the special function unit: one MUFU.EX2
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int L, bool kStates>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D, T* __restrict__ y,
                      float* __restrict__ h_last,
                      float* __restrict__ states, int S, int di, int N) {
  constexpr int kPerLane = kMaxState / L; // states per lane
  constexpr int kCh = kThreads / L;       // channels per block
  constexpr int kUD = kChunk / L;         // u / dt values staged per lane
  constexpr int kBC = kChunk * kMaxState / kThreads;  // B/C per lane
  static_assert(kChunk * kMaxState % kThreads == 0, "B/C staging");
  static_assert(kPerLane % 4 == 0, "float4 reads of B and C");
  __shared__ float u_s[kChunk][kCh];
  __shared__ float dt_s[kChunk][kCh];
  __shared__ float part_s[kChunk][kThreads];  // each lane's share of y
  __shared__ __align__(16) float b_s[kChunk][kMaxState];
  __shared__ __align__(16) float c_s[kChunk][kMaxState];
  const int tid = threadIdx.x;
  const int ch = tid / L;                // this lane's channel in the block
  const int s0 = (tid % L) * kPerLane;   // and its first state
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < di;
  const int b = blockIdx.y;
  const long long row = (long long)b * S;  // the (b, t = 0) row
  // the channel whose u, dt and y this lane moves: element tid + k *
  // kThreads of a chunk's (step, channel) grid is step tid / kCh + k * L
  const int cw = tid % kCh, tw = tid / kCh;
  const bool live_w = d0 + cw < di;
  const float dd = live_w ? D[d0 + cw] : 0.f;

  // states past N stay zero: their A, B and C entries are zero
  for (int i = tid; i < kChunk * kMaxState; i += kThreads) {
    (&b_s[0][0])[i] = 0.f;
    (&c_s[0][0])[i] = 0.f;
  }
  float a[kPerLane], h[kPerLane];
#pragma unroll
  for (int n = 0; n < kPerLane; ++n) {
    a[n] = (live && s0 + n < N) ? A[(long long)d * N + s0 + n] * kLog2e
                                : 0.f;
    h[n] = 0.f;
  }

  // a chunk in flight in registers: this lane's share of the chunk's u /
  // dt columns and of its B / C rows
  float ur[kUD], dr[kUD], br[kBC], cr[kBC];
  auto fetch = [&](int t0) {
    const int len = min(kChunk, S - t0);
#pragma unroll
    for (int k = 0; k < kUD; ++k) {
      const int t = tw + k * L;
      const bool ok = t < len && live_w;
      const long long off = (row + t0 + t) * di + d0 + cw;
      ur[k] = ok ? to_float(u[off]) : 0.f;
      dr[k] = ok ? dt[off] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      const bool ok = i < len * N;
      const long long off = (row + t0) * N + i;
      br[k] = ok ? Bm[off] : 0.f;
      cr[k] = ok ? Cm[off] : 0.f;
    }
  };

  if (S > 0) fetch(0);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    // each lane stages the slots whose y it wrote out last pass
#pragma unroll
    for (int k = 0; k < kUD; ++k) {
      u_s[tw + k * L][cw] = ur[k];
      dt_s[tw + k * L][cw] = dr[k];
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      if (i < len * N) {
        b_s[i / N][i % N] = br[k];
        c_s[i / N][i % N] = cr[k];
      }
    }
    if constexpr (kStates) {  // the state entering this chunk
      if (live) {
        float* out = states + (((long long)b * ((S + kChunk - 1) / kChunk) +
                                t0 / kChunk) * di + d) * N;
#pragma unroll
        for (int n = 0; n < kPerLane; ++n)
          if (s0 + n < N) out[s0 + n] = h[n];
      }
    }
    __syncthreads();
    if (t0 + kChunk < S) fetch(t0 + kChunk);  // loads overlap the compute
#pragma unroll(kUnroll)
    for (int i = 0; i < len; ++i) {
      const float dtv = dt_s[i][ch];
      const float du = dtv * u_s[i][ch];
      const float4* bq = reinterpret_cast<const float4*>(&b_s[i][s0]);
      const float4* cq = reinterpret_cast<const float4*>(&c_s[i][s0]);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kPerLane / 4; ++q) {
        const float4 bv = bq[q], cv = cq[q];
        const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cn[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * q + j;
          h[n] = fmaf(h[n], ex2(dtv * a[n]), du * bn[j]);
          acc = fmaf(h[n], cn[j], acc);
        }
      }
      part_s[i][tid] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kUD; ++k) {
      const int t = tw + k * L;
      float yv = u_s[t][cw] * dd;  // and the lanes' shares, in order
#pragma unroll
      for (int l = 0; l < L; ++l) yv += part_s[t][cw * L + l];
      if (t < len && live_w)
        y[(row + t0 + t) * di + d0 + cw] = from_float<T>(yv);
    }
  }
  if (live) {
    float* out = h_last + ((long long)b * di + d) * N;
#pragma unroll
    for (int n = 0; n < kPerLane; ++n)
      if (s0 + n < N) out[s0 + n] = h[n];
  }
}

template <typename T, int L, bool kStates>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* B, const void* C, const void* D, void* y,
                   void* h_last, void* states, int Bt, int S, int di, int N,
                   cudaStream_t stream) {
  constexpr int kCh = kThreads / L;
  const dim3 grid((di + kCh - 1) / kCh, Bt);
  selective_scan_kernel<T, L, kStates><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h_last),
      static_cast<float*>(states), S, di, N);
  return cudaGetLastError();
}

template <typename T, bool kStates>
cudaError_t launch_lanes(int lanes, const void* u, const void* dt,
                         const void* A, const void* B, const void* C,
                         const void* D, void* y, void* h_last, void* states,
                         int Bt, int S, int di, int N, cudaStream_t s) {
  switch (lanes) {
    case 2:
      return launch<T, 2, kStates>(u, dt, A, B, C, D, y, h_last, states, Bt,
                                   S, di, N, s);
    case 4:
      return launch<T, 4, kStates>(u, dt, A, B, C, D, y, h_last, states, Bt,
                                   S, di, N, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_flag(int lanes, const void* u, const void* dt,
                        const void* A, const void* B, const void* C,
                        const void* D, void* y, void* h_last, void* states,
                        int Bt, int S, int di, int N, cudaStream_t s) {
  return states != nullptr
             ? launch_lanes<T, true>(lanes, u, dt, A, B, C, D, y, h_last,
                                     states, Bt, S, di, N, s)
             : launch_lanes<T, false>(lanes, u, dt, A, B, C, D, y, h_last,
                                      states, Bt, S, di, N, s);
}

}  // namespace

// dtype: 0 = float32 u and y, 1 = bfloat16 u and y; lanes: 2 or 4 lanes
// per (batch, channel), from the wrapper's plan; states: null for the
// serving instance, else the (Bt, ceil(S / 32), di, N) float32 chunk-entry
// states the kStates instance writes
extern "C" int selective_scan_launch(const void* u, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, const void* D, void* y,
                                     void* h_last, void* states, int Bt,
                                     int S, int di, int N, int dtype,
                                     int lanes, void* stream) {
  if (Bt <= 0 || di <= 0) return 0;
  if (N <= 0 || N > kMaxState || S < 0 || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_flag<float>(lanes, u, dt, A, B, C, D, y, h_last, states, Bt,
                             S, di, N, s);
  else if (dtype == 1)
    err = launch_flag<__nv_bfloat16>(lanes, u, dt, A, B, C, D, y, h_last,
                                     states, Bt, S, di, N, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

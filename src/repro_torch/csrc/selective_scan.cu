// Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/selective_scan.py
// (selective_scan_kernel, body _kernel):
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * u_t) B_t,   h_0 = 0
//   y_t = h_t . C_t + D * u_t
// with u (Bt, S, di) float32 or bfloat16, dt (Bt, S, di) float32, A (di, N)
// float32, B and C (Bt, S, N) float32, D (di,) float32; outputs y (Bt, S, di)
// in u's type and the final state h_last (Bt, di, N) float32. All arithmetic
// is float32; expf (not __expf) and no fast-math, so the kernel stays within
// float32 rounding of the plain PyTorch version.
//
// Bound: per (batch, step, channel) the kernel reads u and dt and writes y
// once, and per state it does one exponential and a few FP32 operations.
// Against the card's HBM rate and its FP32 peak the bytes bind. The
// Bt*S*di*N exponentials on the special function units (16 per clock per
// SM) take longer than the bytes, so a design that computes every one of
// them there, as this one does, cannot go under that SFU floor.
//
// Design: the recurrence is parallel over (batch, channel) and sequential
// in time. One thread owns one (batch, channel) and keeps its N <= 16 states
// and its row of A in registers (entries past N are zero, which leaves
// those states at zero, so no lane is predicated). A block of 128 threads
// covers 128 channels of one batch row and walks time in chunks of 32
// steps: each thread stages its own u and dt column of the chunk in shared
// memory (neighbouring threads read neighbouring channels, so the loads are
// coalesced and all in flight at once), and the block stages the chunk's
// B_t and C_t rows once, since all channels of a batch row share them.
// The next chunk's loads go out into registers before the current chunk
// is computed, so their latency hides behind the exponentials.
// Channels past di (di = 3,200 is no multiple of 128) are bounds-checked
// rather than padded. Chunked or parallel-in-time scans are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps staged per pass
constexpr int kMaxState = 16;  // states held in registers per thread

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D, T* __restrict__ y,
                      float* __restrict__ h_last, int S, int di, int N) {
  constexpr int kBC = kChunk * kMaxState / kThreads;  // B/C per thread
  static_assert(kChunk * kMaxState % kThreads == 0, "B/C staging");
  __shared__ float u_s[kChunk][kThreads];
  __shared__ float dt_s[kChunk][kThreads];
  __shared__ float b_s[kChunk][kMaxState];
  __shared__ float c_s[kChunk][kMaxState];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < di;
  const long long row = (long long)b * S;  // the (b, t = 0) row

  // states past N stay zero: their A, B and C entries are zero
  for (int i = tid; i < kChunk * kMaxState; i += kThreads) {
    (&b_s[0][0])[i] = 0.f;
    (&c_s[0][0])[i] = 0.f;
  }
  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int n = 0; n < kMaxState; ++n) {
    a[n] = (live && n < N) ? A[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = live ? D[d] : 0.f;

  // a chunk in flight in registers: this thread's u / dt column and its
  // share of the chunk's B / C rows
  float ur[kChunk], dr[kChunk], br[kBC], cr[kBC];
  auto fetch = [&](int t0) {
    const int len = min(kChunk, S - t0);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool ok = live && i < len;
      const long long off = (row + t0 + i) * di + d;
      ur[i] = ok ? to_float(u[off]) : 0.f;
      dr[i] = ok ? dt[off] : 0.f;
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
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      u_s[i][tid] = ur[i];
      dt_s[i][tid] = dr[i];
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      if (i < len * N) {
        b_s[i / N][i % N] = br[k];
        c_s[i / N][i % N] = cr[k];
      }
    }
    __syncthreads();
    if (t0 + kChunk < S) fetch(t0 + kChunk);  // loads overlap the compute
    if (!live) continue;
    for (int i = 0; i < len; ++i) {
      const float dtv = dt_s[i][tid], uv = u_s[i][tid];
      const float du = dtv * uv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxState; ++n) {
        const float da = expf(dtv * a[n]);
        h[n] = h[n] * da + du * b_s[i][n];
        acc += h[n] * c_s[i][n];
      }
      y[(row + t0 + i) * di + d] = from_float<T>(acc + uv * dd);
    }
  }
  if (live) {
    float* out = h_last + ((long long)b * di + d) * N;
#pragma unroll
    for (int n = 0; n < kMaxState; ++n)
      if (n < N) out[n] = h[n];
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* B, const void* C, const void* D, void* y,
                   void* h_last, int Bt, int S, int di, int N,
                   cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, Bt);
  selective_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(h_last), S, di, N);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 u and y, 1 = bfloat16 u and y
extern "C" int selective_scan_launch(const void* u, const void* dt,
                                     const void* A, const void* B,
                                     const void* C, const void* D, void* y,
                                     void* h_last, int Bt, int S, int di,
                                     int N, int dtype, void* stream) {
  if (Bt <= 0 || di <= 0) return 0;
  if (N <= 0 || N > kMaxState || S < 0 || Bt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(u, dt, A, B, C, D, y, h_last, Bt, S, di, N, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(u, dt, A, B, C, D, y, h_last, Bt, S, di, N,
                                s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

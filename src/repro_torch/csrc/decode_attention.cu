// Single-token (decode) attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_kernel, body _kernel). For q (B, H, hd), caches
// (B, S, KV, hd) and an additive float32 bias row (B, S) that carries the
// validity of each slot (0 valid, -1e30 empty or out of window -- the
// caller derives it from the slots' absolute positions, so ring and linear
// cache layouts are the same to the kernel):
//   s[h, j] = (q[h] . k[j, h / G]) * scale + bias[j]
//   o[h]    = sum_j softmax_j(s[h, :]) v[j, h / G]          (G = H / KV)
// with the softmax state and the accumulator in float32 and the output
// in q's type.
//
// Bound: bytes. Every decode step reads the whole cache of the layer
// (2 B S KV hd elements) for ~4 B H S hd FLOP: one or two operations per
// byte, far under the card's ridge. Design: one 128-thread block per
// (batch, kv head), so the G query heads that share a kv head read its
// cache once. The block sweeps the cache in 64-slot tiles staged in
// shared memory as float32: (1) each thread scores (slot, head) pairs
// with the bias added before the max, (2) one warp per head takes the
// tile max, rescales the running sum and turns the scores into
// probabilities, (3) each thread owns (head, dim) pairs of the
// accumulator in registers and adds the tile's probability-weighted V
// rows. The Pallas kernel's online softmax, one tile at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTS = 64;          // cache slots per tile (two per lane)
constexpr int kThreads = 128;    // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;        // query heads per kv head
constexpr int kMaxPairs = 8;     // (head, dim) pairs per thread: G*hd <= 1024
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const float* __restrict__ bias, T* __restrict__ o,
                        int S, int H, int KV, float scale) {
  __shared__ float Ks[kTS][HD + 1];
  __shared__ float Vs[kTS][HD];
  __shared__ float Ps[kMaxG][kTS];
  __shared__ float Qs[kMaxG][HD];
  __shared__ float Bs[kTS];
  __shared__ float Ms[kMaxG], Ls[kMaxG], Cs[kMaxG];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int h0 = kvh * G;  // first query head of this kv head

  for (int e = tid; e < G * HD; e += kThreads)
    Qs[e / HD][e % HD] = to_f(q[((long long)b * H + h0) * HD + e]);
  if (tid < G) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;

  const long long slot_row = (long long)KV * HD;  // elements per cache slot
  for (int s0 = 0; s0 < S; s0 += kTS) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int e = tid; e < kTS * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const int sj = s0 + r;
      float kk = 0.f, vv = 0.f;
      if (sj < S) {
        const long long off =
            ((long long)b * S + sj) * slot_row + (long long)kvh * HD + d;
        kk = to_f(kc[off]);
        vv = to_f(vc[off]);
      }
      Ks[r][d] = kk;
      Vs[r][d] = vv;
    }
    if (tid < kTS)
      Bs[tid] = (s0 + tid < S) ? bias[(long long)b * S + s0 + tid] : kNegInf;
    __syncthreads();

    // (1) scores of every (slot, head) pair of the tile
    for (int p = tid; p < kTS * G; p += kThreads) {
      const int j = p % kTS, g = p / kTS;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[g][d], Ks[j][d], dot);
      Ps[g][j] = dot * scale + Bs[j];
    }
    __syncthreads();

    // (2) one warp per head: tile max, probabilities, running sum
    for (int g = warp; g < G; g += kWarps) {
      const float v0 = Ps[g][lane], v1 = Ps[g][lane + 32];
      float mt = fmaxf(v0, v1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = expf(v0 - m_new), p1 = expf(v1 - m_new);
      Ps[g][lane] = p0;
      Ps[g][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        Ls[g] = Ls[g] * c + sum;
        Ms[g] = m_new;
        Cs[g] = c;
      }
    }
    __syncthreads();

    // (3) the accumulator: thread owns pairs tid, tid + 128, ...
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      if (p < G * HD) {
        const int g = p / HD, d = p % HD;
        float a = acc[i] * Cs[g];
#pragma unroll 8
        for (int j = 0; j < kTS; ++j) a = fmaf(Ps[g][j], Vs[j][d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = tid + i * kThreads;
    if (p < G * HD) {
      const int g = p / HD, d = p % HD;
      o[((long long)b * H + h0 + g) * HD + d] =
          from_f<T>(acc[i] / fmaxf(Ls[g], 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* bias, void* o, int B, int S, int H, int KV,
                   float scale, cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const float*>(bias),
      static_cast<T*>(o), S, H, KV, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kc, const void* vc,
                      const void* bias, void* o, int B, int S, int H, int KV,
                      float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, kc, vc, bias, o, B, S, H, KV, scale, stream);
    case 32:
      return launch<T, 32>(q, kc, vc, bias, o, B, S, H, KV, scale, stream);
    case 64:
      return launch<T, 64>(q, kc, vc, bias, o, B, S, H, KV, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, caches and o share it; bias is float32)
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* bias,
                                       void* o, int B, int S, int H, int KV,
                                       int hd, float scale, int dtype,
                                       void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S <= 0 || H / KV > kMaxG ||
      (H / KV) * hd > kMaxPairs * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, kc, vc, bias, o, B, S, H, KV, scale, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, kc, vc, bias, o, B, S, H, KV, scale,
                                   st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocked online-softmax attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_kernel, body _kernel). For q (B, Sq, H, hd) and k, v
// (B, Skv, KV, hd) in the model's own layout (no transposes, no padding in
// device memory), q head h reads kv head h / (H / KV) (GQA without
// repeating K/V), q row i sits at position i + q_offset (right-aligned,
// q_offset = Skv - Sq), and kv position j is kept where
//   j < Skv,  (causal) j <= q_pos,  (window > 0) j > q_pos - window;
// a masked score is -1e30, as in the Pallas kernel. Scores, softmax state
// and the accumulator are float32; the output is written in q's type.
//
// Bound: at the prefill shapes on the path (S = 32..256, head_dim 32) the
// work is ~4 S^2 hd FLOP per (batch, head) (halved by the causal mask)
// against ~6 S hd bytes per (batch, head) in and out, so by the card's
// peaks the bound is operations for S >= ~128 and bytes below. This first
// version computes on the CUDA cores in float32 (no tensor cores), so in
// practice it is bound by FMA throughput; mma/wgmma tiles are later work.
//
// Design: one 256-thread block per (batch x head, 64-row q tile). Each q
// row is owned by four neighbouring threads of one warp; each keeps the q
// row in registers and takes every fourth kv column of a tile, with its
// own running (max, sum, accumulator) -- the Pallas kernel's per-tile
// online softmax, applied to a quarter of the columns. 64-row K and V
// tiles are staged in shared memory as float32 (rows padded by one word
// so the four column groups hit distinct banks). Tiles that the causal
// mask or the window rules out for the whole q tile are skipped, as the
// Pallas kernel's pl.when does. At the end the four partial states of a
// row are merged with warp shuffles and the row is normalised by its sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                  // q rows per block
constexpr int kBK = 64;                  // kv rows per tile
constexpr int kSplit = 4;                // threads per q row
constexpr int kThreads = kBQ * kSplit;   // 256
constexpr int kCols = kBK / kSplit;      // kv columns per thread per tile
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
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int KV, int causal, int window,
                       int q_offset, float scale) {
  __shared__ float Ks[kBK][HD + 1];
  __shared__ float Vs[kBK][HD + 1];
  const int tid = threadIdx.x;
  const int row = tid / kSplit, sub = tid % kSplit;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const int qi = q0 + row;
  const bool q_valid = qi < Sq;
  const int q_pos = qi + q_offset;
  const long long q_row = (long long)H * HD;     // elements per q token
  const long long kv_row = (long long)KV * HD;   // elements per kv token

  float qr[HD];
  {
    const T* qp = q + ((long long)b * Sq + (q_valid ? qi : 0)) * q_row +
                  (long long)h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = q_valid ? to_f(qp[d]) : 0.f;
  }

  // the kv range any row of this q tile can see (whole-tile skips)
  const int last_q = min(q0 + kBQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m = kNegInf, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const int kj = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (kj < Skv) {
        const long long off =
            ((long long)b * Skv + kj) * kv_row + (long long)kvh * HD + d;
        kk = to_f(k[off]);
        vv = to_f(v[off]);
      }
      Ks[r][d] = kk;
      Vs[r][d] = vv;
    }
    __syncthreads();

    float s[kCols];
    float m_t = kNegInf;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = sub + kSplit * c;
      const int kj = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
      bool ok = kj < Skv;
      if (causal) ok = ok && kj <= q_pos;
      if (window > 0) ok = ok && kj > q_pos - window;
      s[c] = ok ? dot * scale : kNegInf;
      m_t = fmaxf(m_t, s[c]);
    }
    const float m_new = fmaxf(m, m_t);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      s[c] = expf(s[c] - m_new);
      psum += s[c];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = sub + kSplit * c;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(s[c], Vs[j][d], acc[d]);
    }
    m = m_new;
  }

  // merge the kSplit partial states of the row (neighbouring lanes)
  float m_all = m;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, off));
  const float f = expf(m - m_all);
  l *= f;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    float a = acc[d] * f;
#pragma unroll
    for (int off = 1; off < kSplit; off <<= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    acc[d] = a;
  }
  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + ((long long)b * Sq + qi) * q_row + (long long)h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (d % kSplit == sub) op[d] = from_f<T>(acc[d] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int KV, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int Sq, int Skv, int H, int KV,
                      int causal, int window, int q_offset, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                           q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                           q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                           q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it)
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int causal, int window, int q_offset,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KV, causal, window,
                           q_offset, scale, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KV, causal,
                                   window, q_offset, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

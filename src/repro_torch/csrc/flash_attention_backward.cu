// Backward of blocked online-softmax attention (K3's gradient, P2) for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its jnp mirrors of
// the attention (repro/models/layers.py chunked_attention and
// local_banded_attention) with jax.grad and has no Pallas backward. The
// port's forward runs through K3 (flash_attention.cu), so its training
// needs a backward of its own; this is it, from K3's output o and the row
// log-sum-exp lse that K3 writes under its kLse flag.
//
// For q, dO, dq (B, Sq, H, hd), k, v, dk, dv (B, Skv, KV, hd) in the model's
// own layout, q head h reading kv head h / G (G = H / KV), q row i at
// position i + q_offset (right-aligned), and the forward's masks (causal
// j <= q_pos, window j > q_pos - window):
//   s  = (q . k) scale, capped as cap tanh(s / cap) where cap > 0
//   P  = exp(s - lse)                 (0 where masked)
//   D  = rowsum(dO o)                 (flash_bwd_dot_kernel)
//   dS = P (dO . v - D), times 1 - tanh^2 under the cap
//   dv = sum_i P dO,  dk = scale sum_i dS q   (flash_bwd_dkdv_kernel)
//   dq = scale sum_j dS k                     (flash_bwd_dq_kernel)
// P is recomputed in float32 from lse, as FlashAttention-2's backward does:
// nothing of size Sq x Skv is stored. Accumulation is float32; the outputs
// are written in the input type (float32 or bfloat16).
//
// Design (simple first; tensor cores and TMA are later work): the CUDA
// cores, kLanes neighbouring lanes a row (4 at hd 16, 8 at 32 and 64, 16 at
// 128 and 256), each with every (4 kLanes)-th group of 4 dims of the row in
// registers, so a group is one 16-byte shared-memory read and a row's lanes
// read neighbouring 16-byte words (no bank conflict); dot products are
// reduced over the row's lanes by shuffles.
//  - dK/dV: one 256-thread block per (b, kv head, 256 / kLanes kv rows),
//    each row's k, v, dk, dv in registers; it loops over the G q heads of
//    its group and over the 16-row q tiles the mask keeps, each staged in
//    shared memory as float32 with its lse and D.
//  - dQ: one block per (b, q head, 256 / kLanes q rows), each row's q, dO,
//    dq in registers; it loops over the 16-row kv tiles the mask keeps.
// No atomics: every output element is written by one lane once, so two runs
// give identical bits.
//
// Bound: 10 hd operations per kept (q, k) pair (four products of hd
// multiply-adds and D's share; the kernels recompute S and dP in both
// passes, 14 hd executed) against q, k, v, o, dO read and dq, dk, dv
// written once. At training lengths (2,048) the operations bind; on the
// CUDA cores this kernel runs at most at the FP32 rate, 1/15 of the bf16
// tensor cores'.
//
// Binding: plain C entry point flash_attention_backward_launch (ctypes),
// dtype 0 float32, 1 bfloat16; it returns cudaGetLastError() after the
// three launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;        // q rows (dK/dV) or kv rows (dQ) staged

template <int HD>
struct Rows {
  static constexpr int kLanes = HD >= 128 ? 16 : (HD >= 32 ? 8 : 4);
  static constexpr int kDims = HD / kLanes;      // 4, 4, 8, 8, 16
  static constexpr int kGroups = kDims / 4;      // 16-byte groups a lane
  static constexpr int kRows = kThreads / kLanes;  // rows a block
  // dim of this lane's element e (group e / 4)
  static __device__ __forceinline__ int dim(int sub, int e) {
    return (e / 4) * 4 * kLanes + 4 * sub + (e % 4);
  }
  // the sum of x over the row's lanes, in every lane of the row
  static __device__ __forceinline__ float reduce(float x) {
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  }
};

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

// this lane's dims of a shared-memory row, as float4 reads
template <int HD>
__device__ __forceinline__ void read_row(const float* row, int sub,
                                         float (&out)[Rows<HD>::kDims]) {
#pragma unroll
  for (int g = 0; g < Rows<HD>::kGroups; ++g) {
    const float4 t = *reinterpret_cast<const float4*>(
        row + g * 4 * Rows<HD>::kLanes + 4 * sub);
    out[4 * g + 0] = t.x;
    out[4 * g + 1] = t.y;
    out[4 * g + 2] = t.z;
    out[4 * g + 3] = t.w;
  }
}

__device__ __forceinline__ bool kept(int j, int q_pos, int Skv, int causal,
                                     int window) {
  bool ok = j < Skv;
  if (causal) ok = ok && j <= q_pos;
  if (window > 0) ok = ok && j > q_pos - window;
  return ok;
}

// D[b, h, i] = sum_d dO[b, i, h, d] o[b, i, h, d]; a row per kLanes lanes
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                     float* __restrict__ D, int Sq, int H, long long rows) {
  using R = Rows<HD>;
  const int tid = threadIdx.x, r = tid / R::kLanes, sub = tid % R::kLanes;
  const long long row = (long long)blockIdx.x * R::kRows + r;
  float acc = 0.f;
  if (row < rows) {
    const T* op = o + row * HD;
    const T* dp = dO + row * HD;
#pragma unroll
    for (int e = 0; e < R::kDims; ++e) {
      const int d = R::dim(sub, e);
      acc = fmaf(to_f(op[d]), to_f(dp[d]), acc);
    }
  }
  acc = R::reduce(acc);
  if (row < rows && sub == 0) {
    const long long bi = row / H;            // b * Sq + i
    const int h = row % H;
    const long long b = bi / Sq, i = bi % Sq;
    D[(b * H + h) * Sq + i] = acc;
  }
}

// dk, dv of 256 / kLanes kv rows of one (b, kv head)
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                      int causal, int window, int q_offset, float scale,
                      float cap) {
  using R = Rows<HD>;
  constexpr int kDims = R::kDims;
  __shared__ __align__(16) float Qs[kTile][HD];
  __shared__ __align__(16) float dOs[kTile][HD];
  __shared__ float Ls[kTile], Ds[kTile];
  const int tid = threadIdx.x, r = tid / R::kLanes, sub = tid % R::kLanes;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int j0 = blockIdx.y * R::kRows;
  const int j = j0 + r;
  const bool kv_valid = j < Skv;
  const long long q_ld = (long long)H * HD, kv_ld = (long long)KV * HD;

  float kk[kDims], vv[kDims], dkk[kDims], dvv[kDims];
  {
    const long long off =
        ((long long)b * Skv + (kv_valid ? j : 0)) * kv_ld + (long long)kvh * HD;
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      const int d = R::dim(sub, e);
      kk[e] = kv_valid ? to_f(k[off + d]) : 0.f;
      vv[e] = kv_valid ? to_f(v[off + d]) : 0.f;
      dkk[e] = 0.f;
      dvv[e] = 0.f;
    }
  }

  // the q rows any kv row of this block is kept by (whole-tile skips)
  const int j_last = min(j0 + R::kRows, Skv) - 1;
  int i_begin = causal ? max(0, j0 - q_offset) : 0;
  int i_end = Sq;
  if (window > 0) i_end = min(Sq, j_last + window - q_offset);
  i_begin = (i_begin / kTile) * kTile;

  for (int hq = 0; hq < G; ++hq) {
    const int h = kvh * G + hq;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* D_h = D + ((long long)b * H + h) * Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();        // the previous tile is consumed
      for (int e = tid; e < kTile * HD; e += kThreads) {
        const int rr = e / HD, d = e % HD;
        const int i = i0 + rr;
        float qx = 0.f, gx = 0.f;
        if (i < Sq) {
          const long long off = ((long long)b * Sq + i) * q_ld +
                                (long long)h * HD + d;
          qx = to_f(q[off]);
          gx = to_f(dO[off]);
        }
        Qs[rr][d] = qx;
        dOs[rr][d] = gx;
      }
      if (tid < kTile) {
        const int i = i0 + tid;
        Ls[tid] = i < Sq ? lse_h[i] : 0.f;
        Ds[tid] = i < Sq ? D_h[i] : 0.f;
      }
      __syncthreads();

#pragma unroll 2
      for (int ii = 0; ii < kTile; ++ii) {
        float qr[kDims], gr[kDims];
        read_row<HD>(Qs[ii], sub, qr);
        read_row<HD>(dOs[ii], sub, gr);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < kDims; ++e) {
          s = fmaf(qr[e], kk[e], s);
          dp = fmaf(gr[e], vv[e], dp);
        }
        s = R::reduce(s);
        dp = R::reduce(dp);
        const int i = i0 + ii;
        const bool ok = i < Sq && kept(j, i + q_offset, Skv, causal, window);
        float x = s * scale, dcap = 1.f;
        if constexpr (kCap) {
          const float t = tanhf(x / cap);
          x = t * cap;
          dcap = 1.f - t * t;
        }
        const float p = ok ? expf(x - Ls[ii]) : 0.f;
        const float ds = p * (dp - Ds[ii]) * dcap;
#pragma unroll
        for (int e = 0; e < kDims; ++e) {
          dvv[e] = fmaf(p, gr[e], dvv[e]);
          dkk[e] = fmaf(ds, qr[e], dkk[e]);
        }
      }
    }
  }

  if (kv_valid) {
    const long long off =
        ((long long)b * Skv + j) * kv_ld + (long long)kvh * HD;
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      const int d = R::dim(sub, e);
      dk[off + d] = from_f<T>(dkk[e] * scale);
      dv[off + d] = from_f<T>(dvv[e]);
    }
  }
}

// dq of 256 / kLanes q rows of one (b, q head)
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dO,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, T* __restrict__ dq, int Sq,
                    int Skv, int H, int KV, int causal, int window,
                    int q_offset, float scale, float cap) {
  using R = Rows<HD>;
  constexpr int kDims = R::kDims;
  __shared__ __align__(16) float Ks[kTile][HD];
  __shared__ __align__(16) float Vs[kTile][HD];
  const int tid = threadIdx.x, r = tid / R::kLanes, sub = tid % R::kLanes;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int i0 = blockIdx.y * R::kRows;
  const int i = i0 + r;
  const bool q_valid = i < Sq;
  const int q_pos = i + q_offset;
  const long long q_ld = (long long)H * HD, kv_ld = (long long)KV * HD;

  float qr[kDims], gr[kDims], dqq[kDims];
  {
    const long long off =
        ((long long)b * Sq + (q_valid ? i : 0)) * q_ld + (long long)h * HD;
#pragma unroll
    for (int e = 0; e < kDims; ++e) {
      const int d = R::dim(sub, e);
      qr[e] = q_valid ? to_f(q[off + d]) : 0.f;
      gr[e] = q_valid ? to_f(dO[off + d]) : 0.f;
      dqq[e] = 0.f;
    }
  }
  const long long row = ((long long)b * H + h) * Sq + (q_valid ? i : 0);
  const float L = q_valid ? lse[row] : 0.f;
  const float Dr = q_valid ? D[row] : 0.f;

  // the kv range any row of this block keeps (whole-tile skips)
  const int last_q = min(i0 + R::kRows, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, i0 + q_offset - window + 1);
  k_begin = (k_begin / kTile) * kTile;

  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();          // the previous tile is consumed
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int rr = e / HD, d = e % HD;
      const int kj = k0 + rr;
      float kx = 0.f, vx = 0.f;
      if (kj < Skv) {
        const long long off =
            ((long long)b * Skv + kj) * kv_ld + (long long)kvh * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[rr][d] = kx;
      Vs[rr][d] = vx;
    }
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < kTile; ++jj) {
      float kr[kDims], vr[kDims];
      read_row<HD>(Ks[jj], sub, kr);
      read_row<HD>(Vs[jj], sub, vr);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        s = fmaf(qr[e], kr[e], s);
        dp = fmaf(gr[e], vr[e], dp);
      }
      s = R::reduce(s);
      dp = R::reduce(dp);
      const bool ok = q_valid && kept(k0 + jj, q_pos, Skv, causal, window);
      float x = s * scale, dcap = 1.f;
      if constexpr (kCap) {
        const float t = tanhf(x / cap);
        x = t * cap;
        dcap = 1.f - t * t;
      }
      const float p = ok ? expf(x - L) : 0.f;
      const float ds = p * (dp - Dr) * dcap;
#pragma unroll
      for (int e = 0; e < kDims; ++e) dqq[e] = fmaf(ds, kr[e], dqq[e]);
    }
  }

  if (q_valid) {
    const long long off = ((long long)b * Sq + i) * q_ld + (long long)h * HD;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      dq[off + R::dim(sub, e)] = from_f<T>(dqq[e] * scale);
  }
}

// ------------------------------------------------------------ launch ----
template <typename T, int HD, bool kCap>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* o, const void* lse, const void* dO,
                         void* dq, void* dk, void* dv, void* D, int B, int Sq,
                         int Skv, int H, int KV, int causal, int window,
                         int q_offset, float scale, float cap,
                         cudaStream_t stream) {
  using R = Rows<HD>;
  const long long rows = (long long)B * Sq * H;
  flash_bwd_dot_kernel<T, HD>
      <<<(unsigned)((rows + R::kRows - 1) / R::kRows), kThreads, 0, stream>>>(
          static_cast<const T*>(o), static_cast<const T*>(dO),
          static_cast<float*>(D), Sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(B * KV, (Skv + R::kRows - 1) / R::kRows);
  flash_bwd_dkdv_kernel<T, HD, kCap><<<grid_kv, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KV, causal,
      window, q_offset, scale, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(B * H, (Sq + R::kRows - 1) / R::kRows);
  flash_bwd_dq_kernel<T, HD, kCap><<<grid_q, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<T*>(dq), Sq, Skv, H, KV, causal, window, q_offset, scale,
      cap);
  return cudaGetLastError();
}

template <int HD, bool kCap>
cudaError_t launch_cap(int dtype, const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dO,
                       void* dq, void* dk, void* dv, void* D, int B, int Sq,
                       int Skv, int H, int KV, int causal, int window,
                       int q_offset, float scale, float cap,
                       cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<float, HD, kCap>(q, k, v, o, lse, dO, dq, dk, dv, D,
                                         B, Sq, Skv, H, KV, causal, window,
                                         q_offset, scale, cap, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16, HD, kCap>(
        q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Skv, H, KV, causal, window,
        q_offset, scale, cap, stream);
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* dO, void* dq,
                   void* dk, void* dv, void* D, int B, int Sq, int Skv, int H,
                   int KV, int causal, int window, int q_offset, float scale,
                   float cap, cudaStream_t stream) {
  if (cap > 0.f)
    return launch_cap<HD, true>(dtype, q, k, v, o, lse, dO, dq, dk, dv, D, B,
                                Sq, Skv, H, KV, causal, window, q_offset,
                                scale, cap, stream);
  return launch_cap<HD, false>(dtype, q, k, v, o, lse, dO, dq, dk, dv, D, B,
                               Sq, Skv, H, KV, causal, window, q_offset,
                               scale, cap, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dO, dq, dk and dv share it);
// lse and D (scratch, written here): (B, H, Sq) float32; cap: the logit
// soft-cap, 0 for none. Three launches on the stream, in order: D, then
// dk/dv, then dq.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dO, void* dq, void* dk, void* dv, void* D,
    int B, int Sq, int Skv, int H, int KV, int hd, int causal, int window,
    int q_offset, float scale, float cap, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16:
      err = launch<16>(dtype, q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Skv,
                       H, KV, causal, window, q_offset, scale, cap, st);
      break;
    case 32:
      err = launch<32>(dtype, q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Skv,
                       H, KV, causal, window, q_offset, scale, cap, st);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Skv,
                       H, KV, causal, window, q_offset, scale, cap, st);
      break;
    case 128:
      err = launch<128>(dtype, q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Skv,
                        H, KV, causal, window, q_offset, scale, cap, st);
      break;
    case 256:
      err = launch<256>(dtype, q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Skv,
                        H, KV, causal, window, q_offset, scale, cap, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

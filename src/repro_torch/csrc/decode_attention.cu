// Single-token (decode) attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_kernel, body _kernel). For q (B, H, hd), caches
// (B, S, KV, hd) and an additive float32 bias row (B, S) that carries the
// validity of each slot (0 valid, -1e30 empty or out of window -- the
// caller derives it from the slots' absolute positions, so ring and linear
// cache layouts are the same to the kernel):
//   s[h, j] = cap(q[h] . k[j, h / G] * scale) + bias[j]
//   o[h]    = sum_j softmax_j(s[h, :]) v[j, h / G]          (G = H / KV)
// with the softmax state and the accumulator in float32 and the output
// in q's type. cap(x) is x, or with a logit soft-cap (cap > 0, the
// reference model layer's logit_softcap) tanh(x / cap) * cap by an
// accurate tanhf, once per finished (head, slot) score. The cap is a
// template flag (kCap), so the instances without one are the kernels
// they were. A cross-attention cache (an encoder's frames, every slot
// valid) comes with a zero bias.
//
// Bound: bytes. Every decode step reads the whole cache of the layer
// (2 B S KV hd elements) for ~4 B H S hd FLOP: one or two operations per
// byte, far under the card's ridge. So the design is about keeping the
// card's memory busy: enough blocks, and enough loads in flight in each.
//
// Design: the cache is split into ranges of whole 64-slot tiles (the
// last may be partial), and a partial kernel runs one 128-thread block
// per (split, kv head, batch), so the G query heads of a kv head read
// each slot once; the wrapper's plan (kernels/decode_attention.py
// split_plan) picks the span so the grid reaches two blocks per SM
// where the cache allows. The lanes of a warp split a slot row into
// 16-byte chunks (hd / 8 lanes per row in bf16, hd / 4 in f32), each
// lane keeps its chunk of every head's q in registers, and K and V rows
// come straight from the cache into registers by 16-byte loads, kept
// bf16 until the lane's own FMAs, the next rows in flight while the
// current ones are used (a lane takes two chunks of a row where the row
// has more than 32: float32 at hd 256). Pass 1 scores every (head, slot) of the range
// into shared memory (dot products reduced by shuffles over the row's
// lanes, bias added before the max); each warp then turns its heads'
// scores into probabilities with the range's max and sum, while the
// first V rows are in flight; pass 2 accumulates p v per (head, chunk)
// in registers, reduced over the warp's rows by shuffles and over the
// warps in shared memory. Four block barriers in all, none per tile.
// Each split writes its f32 state (m, l, acc[hd]) per q head to a
// workspace, and a merge kernel rescales the splits of each (batch, q
// head) by exp(m - max m) and writes o; with one split the partial kernel
// writes o itself. A split whose slots are all masked has m = -1e30 and
// weighs exp(-1e30 - m) = 0 beside any unmasked one; a row with every
// slot masked stays the uniform average over its S slots, as in the
// reference. The G query heads of a kv head take a compiled group of 1,
// 2, 8 or 16 heads (GB), the heads past G skipped: 1 serves d7 and
// Gemma-7B, 2 the edge ladder's d0/d4 and Gemma3-4B, 8 Hymba's 5,
// InternLM2's and DBRX's 6, Yi's 7 and PaliGemma's 8, 16 the limit kMaxG
// (G x hd at most kMaxGroupDims, so no 16 at hd 256).
//
// Binding: plain C entry point decode_attention_launch (ctypes), dtype 0
// float32, 1 bfloat16; it launches both kernels and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTS = 64;          // cache slots per tile: spans are whole tiles
constexpr int kThreads = 128;    // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;        // query heads per kv head
constexpr int kMaxGroupDims = 2048;  // G * hd
constexpr float kNegInf = -1e30f;

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

// a 16-byte chunk (8 bf16 or 4 f32) widened to float into x[at ...],
// without taking addresses (bf16 is the top half of a float32)
template <int E>
__device__ __forceinline__ void widen(const uint4& w, float (&x)[E], int at,
                                      const __nv_bfloat16*) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[at + 2 * i] = __uint_as_float(u[i] << 16);
    x[at + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
template <int E>
__device__ __forceinline__ void widen(const uint4& w, float (&x)[E], int at,
                                      const float*) {
  x[at] = __uint_as_float(w.x);
  x[at + 1] = __uint_as_float(w.y);
  x[at + 2] = __uint_as_float(w.z);
  x[at + 3] = __uint_as_float(w.w);
}
// a lane's NCH chunks of one row widened to its E = NCH * VEC floats
template <typename T, int NCH, int E>
__device__ __forceinline__ void widen_row(const uint4 (&w)[NCH],
                                          float (&x)[E]) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
    widen(w[ch], x, ch * (E / NCH), static_cast<const T*>(nullptr));
}

// shared memory of a block, in floats: the range's scores (G x span;
// reused for the warps' partial accumulators), m and l (G)
__host__ __device__ constexpr int smem_floats(int G, int span, int hd) {
  return (G * span > kWarps * G * hd ? G * span : kWarps * G * hd) + 2 * G;
}

// this lane's NCH chunks of rows r, r + RB, ..., r + (U - 1) RB of the
// range (ld elements apart; a range's offsets fit 32 bits), rows past n
// zero
template <typename T, int U, int RB, int NCH>
__device__ __forceinline__ void load_rows(uint4 (&x)[U][NCH], const T* base,
                                          int ld, int r, int n) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      x[u][ch] = r + u * RB < n
                     ? __ldg(reinterpret_cast<const uint4*>(
                                 base + (r + u * RB) * ld) + ch)
                     : make_uint4(0u, 0u, 0u, 0u);
}

// (the minimum of one block per SM keeps ptxas from spilling a few
// registers to reach a higher occupancy that these bytes-bound blocks do
// not need)
template <typename T, int HD, int GB, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc,
                      const float* __restrict__ bias, float* __restrict__ ws,
                      T* __restrict__ o, int S, int H, int KV, int span,
                      float scale, float cap) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte chunk
  // 16-byte chunks per lane: one, but two where a row has more than 32
  // (float32 at hd 256)
  constexpr int NCH = HD / VEC > 32 ? HD / VEC / 32 : 1;
  constexpr int E = NCH * VEC;          // elements of a row per lane
  constexpr int C = HD / E;             // lanes per slot row
  constexpr int R = 32 / C;             // rows per warp step
  constexpr int RB = kWarps * R;        // rows per block step
  constexpr int U = GB * E >= 128 ? 2 : 4;   // rows per lane per step
  constexpr int STEP = RB * U;
  extern __shared__ float sm[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = H / KV, h0 = kvh * G;
  const int s_lo = split * span;
  const int n = min(S, s_lo + span) - s_lo;
  float* sc = sm;                       // [G][span], later [kWarps][G][HD]
  float* ms = sm + smem_floats(G, span, HD) - 2 * G;   // [G]
  float* ls = ms + G;                   // [G]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane % C, rsub = lane / C;
  const int r_first = warp * R + rsub;  // this lane's first row

  const int ld = KV * HD;               // elements per cache slot
  const long long row0 = ((long long)b * S + s_lo) * ld + kvh * HD + c * E;
  const T* kbase = kc + row0;
  const T* vbase = vc + row0;
  const float* brow = bias + (long long)b * S + s_lo;

  // the first K rows in flight while q comes in
  uint4 kr[U][NCH];
  load_rows<T, U, RB, NCH>(kr, kbase, ld, r_first, n);
  // this lane's chunks of each head's q, pre-scaled, in registers
  float qx[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int i = 0; i < E; ++i) qx[g][i] = 0.f;
    if (g >= G) continue;
    uint4 qw[NCH];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      qw[ch] = __ldg(reinterpret_cast<const uint4*>(
                         q + ((long long)b * H + h0 + g) * HD + c * E) + ch);
    widen_row<T>(qw, qx[g]);
#pragma unroll
    for (int i = 0; i < E; ++i) qx[g][i] *= scale;
  }

  // pass 1: scores of every (head, slot) of the range, the next rows
  // in flight while these are scored
  for (int rw = warp * R; rw < n; rw += STEP) {
    uint4 kn[U][NCH];
    load_rows<T, U, RB, NCH>(kn, kbase, ld, rw + STEP + rsub, n);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rw + rsub + u * RB;
      float kx[E];
      widen_row<T>(kr[u], kx);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) continue;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) dot = fmaf(qx[g][i], kx[i], dot);
#pragma unroll
        for (int off = 1; off < C; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (c == 0 && r < n) {
          if constexpr (kCap) dot = tanhf(dot / cap) * cap;
          sc[g * span + r] = dot + brow[r];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) kr[u][ch] = kn[u][ch];
  }
  // the first V rows in flight through the softmax
  uint4 vr[U][NCH];
  load_rows<T, U, RB, NCH>(vr, vbase, ld, r_first, n);
  __syncthreads();

  // the range's softmax per head: one warp per head
  for (int g = warp; g < G; g += kWarps) {
    float* row = sc + g * span;
    float mx = kNegInf;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(row[r] - mx);
      row[r] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ms[g] = mx;
      ls[g] = sum;
    }
  }
  __syncthreads();

  // pass 2: acc[g][chunks of lane c] = sum over this lane's rows of p v
  float acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  for (int rw = warp * R; rw < n; rw += STEP) {
    uint4 vn[U][NCH];
    load_rows<T, U, RB, NCH>(vn, vbase, ld, rw + STEP + rsub, n);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rw + rsub + u * RB;
      if (r >= n) continue;
      float vx[E];
      widen_row<T>(vr[u], vx);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) continue;
        const float p = sc[g * span + r];
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] = fmaf(p, vx[i], acc[g][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) vr[u][ch] = vn[u][ch];
  }
  // over the warp's rows (lanes of one chunk are C apart)
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int i = 0; i < E; ++i)
#pragma unroll
      for (int off = C; off < 32; off <<= 1)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
  }
  __syncthreads();              // every warp is done reading the scores
  float* red = sc;              // [kWarps][G][HD]
  if (rsub == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) continue;
#pragma unroll
      for (int i = 0; i < E; ++i)
        red[(warp * G + g) * HD + c * E + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * G * HD + e];
    const int g = e / HD, d = e % HD;
    const long long bh = (long long)b * H + h0 + g;
    if (splits == 1) {
      o[bh * HD + d] = from_f<T>(a / fmaxf(ls[g], 1e-30f));
    } else {
      float* st = ws + (bh * splits + split) * (HD + 2);
      st[d] = a;
      if (d == 0) {
        st[HD] = ms[g];
        st[HD + 1] = ls[g];
      }
    }
  }
}

// one warp per (batch, q head): rescale the splits to the largest max
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ ws, T* __restrict__ o, int BH,
                    int splits) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= BH) return;
  const float* st = ws + (long long)w * splits * (HD + 2);
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, st[s * (HD + 2) + HD]);
  float l = 0.f;
  float a[(HD + 31) / 32];
#pragma unroll
  for (int i = 0; i < (HD + 31) / 32; ++i) a[i] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = st + s * (HD + 2);
    const float f = expf(p[HD] - mx);
    l += p[HD + 1] * f;
#pragma unroll
    for (int i = 0; i < (HD + 31) / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) a[i] = fmaf(p[d], f, a[i]);
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < (HD + 31) / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) o[(long long)w * HD + d] = from_f<T>(a[i] * inv);
  }
}

template <typename T, int HD, int GB>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* bias, void* ws, void* o, int B, int S, int H,
                   int KV, int span, float scale, float cap,
                   cudaStream_t stream) {
  const int G = H / KV;
  const int splits = (S + span - 1) / span;
  const size_t smem = sizeof(float) * smem_floats(G, span, HD);
  const dim3 grid(splits, KV, B);
  if (cap > 0.f)
    decode_partial_kernel<T, HD, GB, true><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc),
        static_cast<const T*>(vc), static_cast<const float*>(bias),
        static_cast<float*>(ws), static_cast<T*>(o), S, H, KV, span, scale,
        cap);
  else
    decode_partial_kernel<T, HD, GB, false><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc),
        static_cast<const T*>(vc), static_cast<const float*>(bias),
        static_cast<float*>(ws), static_cast<T*>(o), S, H, KV, span, scale,
        cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int bh = B * H;
  decode_merge_kernel<T, HD><<<(bh + kWarps - 1) / kWarps, kThreads, 0,
                               stream>>>(static_cast<const float*>(ws),
                                         static_cast<T*>(o), bh, splits);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const void* q, const void* kc, const void* vc,
                     const void* bias, void* ws, void* o, int B, int S, int H,
                     int KV, int span, float scale, float cap,
                     cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch<T, HD, 1>(q, kc, vc, bias, ws, o, B, S, H, KV, span, scale,
                            cap, stream);
  if (G <= 2)
    return launch<T, HD, 2>(q, kc, vc, bias, ws, o, B, S, H, KV, span, scale,
                            cap, stream);
  if (G <= 8)
    return launch<T, HD, 8>(q, kc, vc, bias, ws, o, B, S, H, KV, span, scale,
                            cap, stream);
  if constexpr (16 * HD <= kMaxGroupDims)
    return launch<T, HD, 16>(q, kc, vc, bias, ws, o, B, S, H, KV, span,
                             scale, cap, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kc, const void* vc,
                      const void* bias, void* ws, void* o, int B, int S,
                      int H, int KV, int span, float scale, float cap,
                      cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_g<T, 16>(q, kc, vc, bias, ws, o, B, S, H, KV, span,
                             scale, cap, stream);
    case 32:
      return launch_g<T, 32>(q, kc, vc, bias, ws, o, B, S, H, KV, span,
                             scale, cap, stream);
    case 64:
      return launch_g<T, 64>(q, kc, vc, bias, ws, o, B, S, H, KV, span,
                             scale, cap, stream);
    case 128:
      return launch_g<T, 128>(q, kc, vc, bias, ws, o, B, S, H, KV, span,
                              scale, cap, stream);
    case 256:
      return launch_g<T, 256>(q, kc, vc, bias, ws, o, B, S, H, KV, span,
                              scale, cap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, caches and o share it; bias and the
// workspace are float32). span: slots per split, a multiple of 64; ws:
// (B, H, ceil(S / span), hd + 2) float32, unused with one split. cap: the
// logit soft-cap, 0 for none.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* bias,
                                       void* ws, void* o, int B, int S, int H,
                                       int KV, int hd, int span, float scale,
                                       float cap, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S <= 0 || H / KV > kMaxG ||
      (H / KV) * hd > kMaxGroupDims || span <= 0 || span % kTS != 0 ||
      sizeof(float) * smem_floats(H / KV, span, hd) > 48 * 1024 ||
      !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, kc, vc, bias, ws, o, B, S, H, KV, span,
                           scale, cap, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, kc, vc, bias, ws, o, B, S, H, KV,
                                   span, scale, cap, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
//   dv = sum_i P dO,  dk = scale sum_i dS q   (flash_bwd_dkdv_*kernel)
//   dq = scale sum_j dS k                     (flash_bwd_dq_*kernel)
// P is recomputed in float32 from lse, as FlashAttention-2's backward does:
// nothing of size Sq x Skv is stored. Accumulation is float32; the outputs
// are written in the input type (float32 or bfloat16).
//
// Design. D: one row per kLanes neighbouring lanes (below), both dtypes.
//
// bfloat16 (every trained config): the tensor cores, as K3's forward
// (flash_attention.cu) runs them, with its swizzled 64-row tiles, its
// cp.async ring and its wgmma descriptors copied here (the file stands
// alone). A warpgroup is 128 threads.
//  - dK/dV: one block per (b, kv head, 64 kv rows); K and V stay in
//    shared memory, and the block walks the G q heads of its group and the
//    64-row q tiles the mask keeps, their Q and dO tiles (with 64 values of
//    lse log2(e) and of D beside them) through a 2-stage cp.async ring.
//    Per q tile: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both
//    operands K-major in shared memory); P^T = exp2(S^T scale log2(e) -
//    lse log2(e)) by ex2.approx, lse by column; dS^T = P^T (dP^T - D)
//    (times 1 - t^2 under the cap, t the tanh); then dV += P^T dO and
//    dK += dS^T Q (wgmma m64n{hd}k16), the A operand P^T or dS^T rounded
//    to bf16 and packed straight from the accumulator (K3's P V trick),
//    the B operand the dO or Q tile read MN-major, so nothing is
//    transposed. At hd <= 64 one warpgroup does it all, S^T and dP^T in
//    two commit groups, so that P^T is taken while dP^T runs and dS^T
//    while dV's product runs. At hd 128 and 256 two warpgroups:
//    warpgroup 0 computes S^T, P^T and dV, warpgroup 1 dP^T, dS^T and dK,
//    each holding one hd-wide accumulator; P^T (times the cap's factor)
//    passes to warpgroup 1 through shared memory as float32 in
//    accumulator order (thread t's values at t, t + 128, ...), so each
//    product is computed once.
//  - dQ: one block per (b, q head, 64 q rows), the rows with the most kv
//    tiles launched first; Q, dO, lse and D stay resident, and the kept
//    K and V tiles come through a 2-stage ring. S = Q K^T and dP = dO V^T
//    (ss; P taken while dP runs), dS, then dQ += dS K (rs, K read
//    MN-major). At hd 256 two warpgroups: warpgroup 0 computes S and P,
//    warpgroup 1 dP and dS, handed over through shared memory as above
//    (dS as its packed bf16 A fragment), and each accumulates 128
//    columns of dQ.
//  - The mask runs element by element only on tiles that cross one of
//    its boundaries (or Sq's or Skv's end).
//  P and dS are rounded to bf16 as operands, as the reference's model path
//  rounds P (repro/models/layers.py, p.astype(vb.dtype)); every sum is
//  float32.
//
// float32 (no trained config; the tensor cores take no full-precision
// float32 and TF32 stays off): the CUDA cores, kLanes neighbouring lanes a
// row (4 at hd 16, 8 at 32 and 64, 16 at 128 and 256), each with every
// (4 kLanes)-th group of 4 dims of the row in registers, so a group is
// one 16-byte shared-memory read and a row's lanes read neighbouring
// 16-byte words (no bank conflict); dot products are reduced over the
// row's lanes by shuffles.
//  - dK/dV: one 256-thread block per (b, kv head, 256 / kLanes kv rows),
//    each row's k, v, dk, dv in registers; it loops over the G q heads of
//    its group and over the 16-row q tiles the mask keeps, each staged in
//    shared memory as float32 with its lse and D.
//  - dQ: one block per (b, q head, 256 / kLanes q rows), each row's q, dO,
//    dq in registers; it loops over the 16-row kv tiles the mask keeps.
// No atomics in either: every output element is written by one thread
// once, so two runs give identical bits.
//
// Bound: 10 hd operations per kept (q, k) pair (four products of hd
// multiply-adds and D's share; both kernels recompute S and dP, 14 hd
// executed) against q, k, v, o, dO read and dq, dk, dv written once. At
// training lengths (2,048) the operations bind.
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

// ------------------------------------------ bfloat16: the tensor cores ----
// Copied from K3's forward (flash_attention.cu), so this file stands alone.
constexpr int kBR = 64;                  // rows of a tile (q or kv)
constexpr int kWgThreads = 128;          // one warpgroup
constexpr int kMaxDevices = 64;          // devices a process grants
constexpr float kLog2e = 1.4426950408889634f;

// warpgroups of the dK/dV kernel (one hd-wide accumulator each at 128 and
// 256) and of the dQ kernel (128 columns of dQ each at 256)
__host__ __device__ constexpr int dkdv_groups(int hd) {
  return hd >= 128 ? 2 : 1;
}
__host__ __device__ constexpr int dq_groups(int hd) {
  return hd >= 256 ? 2 : 1;
}

// A 64-row tile of hd bf16 per row in shared memory, stored as column
// atoms of at most 64 columns: one atom whose span is the row for hd 16,
// 32 and 64 (the 32/64/128-byte swizzle), hd / 64 atoms of 64 rows x 128
// bytes in the 128-byte swizzle for hd 128 and 256. 16-byte chunk c of
// row r sits in atom c / 8 at chunk c ^ (address bits 7..9), the layout
// the wgmma descriptors below name. The shared memory is 1024-byte aligned
// and a tile a multiple of 1024 bytes, so the swizzle of an offset is that
// of the address.
template <int HD>
struct TcTile {
  static constexpr int kChunks = HD / 8;
  static constexpr int kAtomChunks = kChunks < 8 ? kChunks : 8;
  static constexpr int kAtomRowBytes = kAtomChunks * 16;
  static constexpr int kAtomBytes = kBR * kAtomRowBytes;
  static constexpr int kBytes = kBR * HD * 2;
  static constexpr uint64_t kLayout =
      kAtomRowBytes == 128 ? 1 : (kAtomRowBytes == 64 ? 2 : 3);
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const int a = c / kAtomChunks, cc = c % kAtomChunks;
    return a * kAtomBytes + r * kAtomRowBytes +
           ((cc ^ ((r * kAtomRowBytes >> 7) & (kAtomChunks - 1))) << 4);
  }
  // byte offset of k-step kk (16 columns, 32 bytes) in a K-major tile
  static __device__ __forceinline__ uint32_t kstep(int kk) {
    return (kk * 32 / kAtomRowBytes) * kAtomBytes + (kk * 32) % kAtomRowBytes;
  }
  // byte offset of k-step kt (16 rows) in an MN-major tile
  static __device__ __forceinline__ uint32_t mnstep(int kt) {
    return kt * 16 * kAtomRowBytes;
  }
  // wgmma shared-memory descriptor: start, leading and stride byte
  // offsets (16-byte units), swizzle mode; the stride offset steps 8 rows
  static __device__ __forceinline__ uint64_t desc(uint32_t addr,
                                                  uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)((8 * kAtomRowBytes) >> 4) << 32) | (kLayout << 62);
  }
  // K-major operand: a k-step stays inside one atom's row
  static __device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
    return desc(addr, 16);
  }
  // MN-major operand (a tile read as rows x hd = K x N): 8-row groups
  // along K, and along N the next 64-column atom (the leading offset)
  static __device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
    return desc(addr, kAtomBytes);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-filled when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the copies this thread saw land are made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N committed groups of products still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of wgmma registers across the
// asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// named barriers between the two warpgroups (0 is __syncthreads')
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 2^x on the special function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragments (m64nN f32): index i = 4 j + e of thread t of a
// warpgroup holds row 16 (t / 32) + (t % 32) / 4 + 8 (e >> 1), column
// 8 j + 2 (t % 4) + (e & 1). Columns 16 u .. 16 u + 15 of a 64 x 64
// accumulator, rounded to bf16 in that order, are exactly the A fragment
// of the u-th k-step of a product that takes it as its left operand.
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    a[u][0] = pack_bf16(s[8 * u + 0], s[8 * u + 1]);
    a[u][1] = pack_bf16(s[8 * u + 2], s[8 * u + 3]);
    a[u][2] = pack_bf16(s[8 * u + 4], s[8 * u + 5]);
    a[u][3] = pack_bf16(s[8 * u + 6], s[8 * u + 7]);
  }
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) B (16 x 64, smem), both
// K-major; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, f32) += A (64 x 16, registers) B (16 x N, smem, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Load rows [row0, row0 + 64) of one head (row stride ld elements) into a
// swizzled tile, spread over NT threads; rows at or past n_rows are
// zero-filled.
template <int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int n_rows,
                                          int tid) {
  using Tile = TcTile<HD>;
  static_assert(kBR * Tile::kChunks % NT == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < kBR * Tile::kChunks / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / Tile::kChunks, c = i % Tile::kChunks;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + Tile::offset(r, c),
               src + (long long)(ok ? row0 + r : 0) * ld + c * 8, ok);
  }
}

// P = exp(s - lse) in base 2 from the raw product x = q . k and lse2 =
// lse log2(e): score_mul is scale log2(e), or with kCap scale / cap, and
// then cap_log2 = cap log2(e) multiplies the tanh t, and dcap = 1 - t^2
// (1 without a cap) is the cap's factor in dS
template <bool kCap>
__device__ __forceinline__ float prob(float x, float lse2, float score_mul,
                                      float cap_log2, float& dcap) {
  if constexpr (kCap) {
    const float t = tanhf(x * score_mul);
    dcap = 1.f - t * t;
    return ex2(fmaf(t, cap_log2, -lse2));
  } else {
    dcap = 1.f;
    return ex2(fmaf(x, score_mul, -lse2));
  }
}

// rows r0 and r0 + 8 of a 64 x N accumulator, times mul, into the rows
// row0 + r of stride ld at out; rows at or past n_rows are not written
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld,
                                           int row0, int n_rows,
                                           const float (&a)[N / 2],
                                           float mul, int r0, int c0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* p = out + (long long)row * ld;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j + c0) =
          __floats2bfloat162_rn(a[4 * j + 2 * r] * mul,
                                a[4 * j + 2 * r + 1] * mul);
  }
}

// dk, dv of 64 kv rows of one (b, kv head)
template <int HD, bool kCap>
__global__ void __launch_bounds__(kWgThreads * dkdv_groups(HD))
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ D,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                         int H, int KV, int causal, int window, int q_offset,
                         float scale, float score_mul, float cap_log2) {
  using Tile = TcTile<HD>;
  constexpr int kWG = dkdv_groups(HD), NT = kWgThreads * kWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // K and V; Q and dO, two stages each; lse log2(e) and D of each stage;
  // with two warpgroups P^T times the cap's factor in accumulator order
  const uint32_t sK = base, sV = base + Tile::kBytes,
                 sQ = base + 2 * Tile::kBytes, sdO = base + 4 * Tile::kBytes;
  float* const sL =
      reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * Tile::kBytes);
  float* const sD = sL + 2 * kBR;
  float* const sP = sD + 2 * kBR;
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int j0 = blockIdx.y * kBR;
  const long long q_ld = (long long)H * HD, kv_ld = (long long)KV * HD;

  // the q rows any kv row of this tile is kept by (whole-tile skips)
  const int j_last = min(j0 + kBR, Skv) - 1;
  const int i_begin = causal ? max(0, j0 - q_offset) : 0;
  int i_end = Sq;
  if (window > 0) i_end = min(Sq, j_last + window - q_offset);
  const int n_qt = i_end > i_begin ? (i_end - i_begin + kBR - 1) / kBR : 0;
  const int n = G * n_qt;                  // (q head, q tile) steps

  // step s's Q and dO tiles, lse and D into stage st
  auto stage = [&](int s, int st) {
    const int h = kvh * G + s / n_qt, i0 = i_begin + (s % n_qt) * kBR;
    const long long off = (long long)b * Sq * q_ld + (long long)h * HD;
    load_tile<HD, NT>(sQ + st * Tile::kBytes, q + off, q_ld, i0, Sq, tid);
    load_tile<HD, NT>(sdO + st * Tile::kBytes, dO + off, q_ld, i0, Sq, tid);
    if (tid < kBR) {
      const int i = i0 + tid;
      const long long row = ((long long)b * H + h) * Sq + i;
      sL[st * kBR + tid] = i < Sq ? lse[row] * kLog2e : 0.f;
      sD[st * kBR + tid] = i < Sq ? D[row] : 0.f;
    }
  };
  const long long kv_off = (long long)b * Skv * kv_ld + (long long)kvh * HD;
  load_tile<HD, NT>(sK, k + kv_off, kv_ld, j0, Skv, tid);
  load_tile<HD, NT>(sV, v + kv_off, kv_ld, j0, Skv, tid);
  if (n > 0) stage(0, 0);
  cp_async_commit();

  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  // dV (and, one warpgroup, dK in acc_k); two warpgroups: dV in warpgroup
  // 0, dK in warpgroup 1
  float acc[HD / 2], acc_k[kWG == 1 ? HD / 2 : 1];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kWG == 1 ? HD / 2 : 1); ++i) acc_k[i] = 0.f;

  for (int s = 0; s < n; ++s) {
    const int st = s & 1;
    if (s + 1 < n) {            // the next step into the other stage
      stage(s + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();            // this step (and K, V) have landed

    const int i0 = i_begin + (s % n_qt) * kBR;
    const uint32_t cQ = sQ + st * Tile::kBytes, cdO = sdO + st * Tile::kBytes;
    const float* L = sL + st * kBR;
    const float* Dq = sD + st * kBR;
    const bool edge = j0 + kBR > Skv || i0 + kBR > Sq ||
                      (causal && j0 + kBR - 1 > i0 + q_offset) ||
                      (window > 0 && j0 <= i0 + kBR - 1 + q_offset - window);
    // fragment element i: kv row j0 + r0 + 8 ((i >> 1) & 1), q column col
    auto col = [&](int i) { return 8 * (i >> 2) + c0 + (i & 1); };
    auto keep = [&](int i) {
      const int qi = i0 + col(i);
      return qi < Sq && kept(j0 + r0 + 8 * ((i >> 1) & 1), qi + q_offset,
                             Skv, causal, window);
    };

    if constexpr (kWG == 1) {
      // S^T = K Q^T and dP^T = V dO^T, two groups, so that P^T is taken
      // while dP^T runs and dS^T while dV += P^T dO runs
      float x[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = dp[i] = 0.f;
      fence_regs(x);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss64(x, Tile::desc_k(sK + Tile::kstep(kk)),
                   Tile::desc_k(cQ + Tile::kstep(kk)), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss64(dp, Tile::desc_k(sV + Tile::kstep(kk)),
                   Tile::desc_k(cdO + Tile::kstep(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(x);
      // P^T, and the cap's factor (1 without a cap, folded away)
      float c[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float p = prob<kCap>(x[i], L[col(i)], score_mul, cap_log2, c[i]);
        if (edge && !keep(i)) p = 0.f;
        x[i] = p;
      }
      // dV += P^T dO: A from registers, B MN-major
      uint32_t pa[4][4];
      pack_a(x, pa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_rs<HD>(acc, pa[u], Tile::desc_mn(cdO + Tile::mnstep(u)));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);
      // dS^T = P^T (dP^T - D), times the cap's factor; dK += dS^T Q
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = x[i] * c[i] * (dp[i] - Dq[col(i)]);
      uint32_t da[4][4];
      pack_a(dp, da);
      fence_regs(acc_k);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_rs<HD>(acc_k, da[u], Tile::desc_mn(cQ + Tile::mnstep(u)));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(acc_k);
    } else {
      // S^T = K Q^T in warpgroup 0, dP^T = V dO^T in warpgroup 1
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = 0.f;
      fence_regs(x);
      wgmma_fence();
      const uint32_t a = wg == 0 ? sK : sV, bk = wg == 0 ? cQ : cdO;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss64(x, Tile::desc_k(a + Tile::kstep(kk)),
                   Tile::desc_k(bk + Tile::kstep(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      if (wg == 0) {            // P^T; P^T times the cap's factor handed on
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float dcap;
          float p = prob<kCap>(x[i], L[col(i)], score_mul, cap_log2, dcap);
          if (edge && !keep(i)) p = 0.f;
          x[i] = p;
          sP[i * kWgThreads + t] = p * dcap;
        }
        bar_arrive(1, NT);
      } else {                  // dS^T
        bar_sync(1, NT);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          x[i] = sP[i * kWgThreads + t] * (x[i] - Dq[col(i)]);
      }
      // dV += P^T dO in warpgroup 0, dK += dS^T Q in warpgroup 1
      uint32_t pa[4][4];
      pack_a(x, pa);
      fence_regs(acc);
      wgmma_fence();
      const uint32_t bn = wg == 0 ? cdO : cQ;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_rs<HD>(acc, pa[u], Tile::desc_mn(bn + Tile::mnstep(u)));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();            // the stage may be refilled, sP rewritten
  }

  const long long out = (long long)b * Skv * kv_ld + (long long)kvh * HD;
  if constexpr (kWG == 1) {
    store_rows<HD>(dv + out, kv_ld, j0, Skv, acc, 1.f, r0, c0);
    store_rows<HD>(dk + out, kv_ld, j0, Skv, acc_k, scale, r0, c0);
  } else {
    store_rows<HD>((wg == 0 ? dv : dk) + out, kv_ld, j0, Skv, acc,
                   wg == 0 ? 1.f : scale, r0, c0);
  }
}

// dq of 64 q rows of one (b, q head)
template <int HD, bool kCap>
__global__ void __launch_bounds__(kWgThreads * dq_groups(HD))
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dO,
                       const float* __restrict__ lse,
                       const float* __restrict__ D,
                       __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                       int KV, int causal, int window, int q_offset,
                       float scale, float score_mul, float cap_log2) {
  using Tile = TcTile<HD>;
  constexpr int kWG = dq_groups(HD), NT = kWgThreads * kWG;
  constexpr int kN = HD / kWG;             // dq columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // Q and dO; K and V, two stages each; with two warpgroups P times the
  // cap's factor in accumulator order, then dS as packed A fragments
  const uint32_t sQ = base, sdO = base + Tile::kBytes,
                 sK = base + 2 * Tile::kBytes, sV = base + 4 * Tile::kBytes;
  float* const sP =
      reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * Tile::kBytes);
  uint4* const sS = reinterpret_cast<uint4*>(sP + 32 * kWgThreads);
  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  const int warp = t >> 5, lane = t & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR;
  const long long q_ld = (long long)H * HD, kv_ld = (long long)KV * HD;

  // the kv range any row of this q tile keeps (whole-tile skips)
  const int last_q = min(q0 + kBR, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  const int n = k_end > k_begin ? (k_end - k_begin + kBR - 1) / kBR : 0;

  const long long q_off = (long long)b * Sq * q_ld + (long long)h * HD;
  const long long kv_off = (long long)b * Skv * kv_ld + (long long)kvh * HD;
  load_tile<HD, NT>(sQ, q + q_off, q_ld, q0, Sq, tid);
  load_tile<HD, NT>(sdO, dO + q_off, q_ld, q0, Sq, tid);
  if (n > 0) {
    load_tile<HD, NT>(sK, k + kv_off, kv_ld, k_begin, Skv, tid);
    load_tile<HD, NT>(sV, v + kv_off, kv_ld, k_begin, Skv, tid);
  }
  cp_async_commit();

  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float lse2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    const long long row = ((long long)b * H + h) * Sq + qi;
    lse2[r] = qi < Sq ? lse[row] * kLog2e : 0.f;
    Dr[r] = qi < Sq ? D[row] : 0.f;
  }
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  for (int s = 0; s < n; ++s) {
    const int st = s & 1;
    const int k0 = k_begin + s * kBR;
    if (s + 1 < n) {            // the next tile into the other stage
      const uint32_t next = (st ^ 1) * Tile::kBytes;
      load_tile<HD, NT>(sK + next, k + kv_off, kv_ld, k0 + kBR, Skv, tid);
      load_tile<HD, NT>(sV + next, v + kv_off, kv_ld, k0 + kBR, Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();            // this tile (and Q, dO) have landed

    const uint32_t cK = sK + st * Tile::kBytes, cV = sV + st * Tile::kBytes;
    const bool edge = k0 + kBR > Skv || q0 + kBR > Sq ||
                      (causal && k0 + kBR - 1 > q0 + q_offset) ||
                      (window > 0 && k0 <= q0 + kBR - 1 + q_offset - window);
    // fragment element i: q row q0 + r0 + 8 ((i >> 1) & 1), kv column
    auto keep = [&](int i) {
      const int qi = q0 + r0 + 8 * ((i >> 1) & 1);
      return qi < Sq && kept(k0 + 8 * (i >> 2) + c0 + (i & 1),
                             qi + q_offset, Skv, causal, window);
    };
    uint32_t pa[4][4];          // dS, the A operand of dQ += dS K
    if constexpr (kWG == 1) {
      // S = Q K^T and dP = dO V^T
      float x[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = dp[i] = 0.f;
      fence_regs(x);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss64(x, Tile::desc_k(sQ + Tile::kstep(kk)),
                   Tile::desc_k(cK + Tile::kstep(kk)), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss64(dp, Tile::desc_k(sdO + Tile::kstep(kk)),
                   Tile::desc_k(cV + Tile::kstep(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();          // S has landed: P while dP runs
      fence_regs(x);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float dcap;
        float p = prob<kCap>(x[i], lse2[(i >> 1) & 1], score_mul, cap_log2,
                             dcap);
        if (edge && !keep(i)) p = 0.f;
        x[i] = p * dcap;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = x[i] * (dp[i] - Dr[(i >> 1) & 1]);
      pack_a(dp, pa);
    } else {
      // S = Q K^T in warpgroup 0, dP = dO V^T in warpgroup 1
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = 0.f;
      fence_regs(x);
      wgmma_fence();
      const uint32_t a = wg == 0 ? sQ : sdO, bk = wg == 0 ? cK : cV;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss64(x, Tile::desc_k(a + Tile::kstep(kk)),
                   Tile::desc_k(bk + Tile::kstep(kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      if (wg == 0) {            // P times the cap's factor handed on
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float dcap;
          float p = prob<kCap>(x[i], lse2[(i >> 1) & 1], score_mul, cap_log2,
                               dcap);
          if (edge && !keep(i)) p = 0.f;
          sP[i * kWgThreads + t] = p * dcap;
        }
        bar_arrive(1, NT);
        bar_sync(2, NT);        // dS back, as packed A fragments
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint4 w = sS[u * kWgThreads + t];
          pa[u][0] = w.x;
          pa[u][1] = w.y;
          pa[u][2] = w.z;
          pa[u][3] = w.w;
        }
      } else {                  // dS = P (dP - D)
        bar_sync(1, NT);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          x[i] = sP[i * kWgThreads + t] * (x[i] - Dr[(i >> 1) & 1]);
        pack_a(x, pa);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sS[u * kWgThreads + t] =
              make_uint4(pa[u][0], pa[u][1], pa[u][2], pa[u][3]);
        bar_arrive(2, NT);
      }
    }
    // dQ (this warpgroup's kN columns) += dS K, K read MN-major
    fence_regs(acc);
    wgmma_fence();
    const uint32_t bn = cK + (kWG == 1 ? 0 : wg * (kN / 64) * Tile::kAtomBytes);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wgmma_rs<kN>(acc, pa[u], Tile::desc_mn(bn + Tile::mnstep(u)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();            // the stage may be refilled, sP and sS too
  }

  store_rows<kN>(dq + q_off + wg * kN, q_ld, q0, Sq, acc, scale, r0, c0);
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

// grants a kernel its dynamic shared memory on the current device, once a
// device (an attribute of the device's context; a refused launch never
// runs, and cudaGetLastError reports it); only a grant that succeeded is
// kept
template <typename Kernel>
cudaError_t grant(Kernel kernel, int bytes, bool (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) granted[dev] = true;
  return err;
}

template <int HD, bool kCap>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dO,
                      void* dq, void* dk, void* dv, void* D, int B, int Sq,
                      int Skv, int H, int KV, int causal, int window,
                      int q_offset, float scale, float cap,
                      cudaStream_t stream) {
  using R = Rows<HD>;
  using bf16 = __nv_bfloat16;
  const long long rows = (long long)B * Sq * H;
  flash_bwd_dot_kernel<bf16, HD>
      <<<(unsigned)((rows + R::kRows - 1) / R::kRows), kThreads, 0, stream>>>(
          static_cast<const bf16*>(o), static_cast<const bf16*>(dO),
          static_cast<float*>(D), Sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // six tiles (K, V and two stages of Q and dO; or Q, dO and two stages of
  // K and V), the dK/dV kernel's lse and D stages, the hand-over between
  // two warpgroups, and the alignment slack: at hd 256 210 KB (dK/dV) and
  // 217 KB (dQ), at 128 114 and 97 KB, at 64 50 and 49 KB
  constexpr int kv_groups = dkdv_groups(HD), q_groups = dq_groups(HD);
  constexpr int tiles = 6 * TcTile<HD>::kBytes;
  constexpr int smem_kv =
      tiles + 4 * kBR * 4 + (kv_groups == 2 ? 32 * kWgThreads * 4 : 0) + 1024;
  constexpr int smem_q =
      tiles + (q_groups == 2 ? 48 * kWgThreads * 4 : 0) + 1024;
  static bool granted_kv[kMaxDevices] = {}, granted_q[kMaxDevices] = {};
  err = grant(flash_bwd_dkdv_tc_kernel<HD, kCap>, smem_kv, granted_kv);
  if (err != cudaSuccess) return err;
  err = grant(flash_bwd_dq_tc_kernel<HD, kCap>, smem_q, granted_q);
  if (err != cudaSuccess) return err;
  const float score_mul = kCap ? scale / cap : scale * kLog2e;
  const float cap_log2 = cap * kLog2e;
  flash_bwd_dkdv_tc_kernel<HD, kCap>
      <<<dim3(B * KV, (Skv + kBR - 1) / kBR), kWgThreads * kv_groups, smem_kv,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(D), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), Sq, Skv, H, KV, causal, window,
                   q_offset, scale, score_mul, cap_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<HD, kCap>
      <<<dim3(B * H, (Sq + kBR - 1) / kBR), kWgThreads * q_groups, smem_q,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(D), static_cast<bf16*>(dq), Sq,
                   Skv, H, KV, causal, window, q_offset, scale, score_mul,
                   cap_log2);
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
    return launch_tc<HD, kCap>(q, k, v, o, lse, dO, dq, dk, dv, D, B, Sq, Skv,
                               H, KV, causal, window, q_offset, scale, cap,
                               stream);
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

// Blocked online-softmax attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_kernel, body _kernel). For q (B, Sq, H, hd) and k, v
// (B, Skv, KV, hd) in the model's own layout (no transposes, no padding in
// device memory), q head h reads kv head h / (H / KV) (GQA without
// repeating K/V), q row i sits at position i + q_offset (right-aligned,
// q_offset = Skv - Sq), and kv position j is kept where
//   j < Skv,  (causal) j <= q_pos,  (window > 0) j > q_pos - window;
// a masked score is -1e30, as in the Pallas kernel. Softmax state and the
// accumulator are float32; the output is written in q's type. Tiles that
// the causal mask or the window rule out for a whole q tile are skipped,
// as the Pallas kernel's pl.when does. Without causal mask or window (an
// encoder's self-attention, a decoder's cross-attention onto the encoder's
// frames) every kv row is kept, and only the last kv tile, where Skv is no
// multiple of 64, is masked row by row.
//
// Row log-sum-exp (kLse, training): with the flag, each instance also writes
// lse (B, H, Sq) float32 in natural log, the softmax's log normaliser
// m + log l of each q row over the scores it kept, which the backward
// (flash_attention_backward.cu) reads to recompute P = exp(s - lse). The
// wgmma instance keeps m in base 2, so there lse = (m + log2 l) ln 2. It is
// a template flag, so the serving instances (a null lse pointer) are the
// kernels they were.
//
// Logit soft-capping (cap > 0, the reference model layer's logit_softcap):
// each scaled score s = (q . k) * scale becomes tanh(s / cap) * cap before
// the mask, by an accurate tanhf in both instances. It is a template flag
// (kCap), so the instances without a cap are the kernels they were.
//
// Bound: ~4 hd FLOP per kept (q, k) pair against ~2 (2 H + 2 KV) hd bytes
// per token in and out, so by the card's peaks operations bind from ~128
// tokens up (Hymba's 2,048-token prefill) and bytes below.
//
// bfloat16 (every served config): the tensor cores, one warpgroup (128
// threads) per (batch x head, 64-row q tile), the tiles with the most
// kv tiles launched first. The q tile and a 2-stage ring of 64-row K and
// V tiles come into shared memory by 16-byte cp.async straight from the
// model's layout (rows past Sq or Skv zero-filled), stored in the
// 128/64/32-byte swizzle of the hd*2-byte rows at hd 64/32/16, and at hd
// 128 and 256 as 64-column atoms in the 128-byte swizzle (81 and 161 KB
// of shared memory a block, so one block a SM at hd 256). S = Q K^T is
// wgmma m64n64k16 with both operands K-major in shared memory (hd/16
// k-steps, atom by atom);
// the online softmax runs on the f32 accumulator fragments in registers
// (base-2 exponentials by ex2.approx on the special function unit, row
// max and sum across the 4 lanes of a quad), and P, rounded to bf16
// as the reference's model path rounds it, is the register A operand of
// O += P V, a wgmma m64n{hd}k16 whose B operand is the V tile read
// MN-major (the transpose bit; its 64-column atoms the descriptor's
// leading offset apart), so V is never transposed. The per-element
// mask runs only on tiles that cross a mask boundary.
//
// float32 (no served config; the tensor cores take no full-precision
// float32 and TF32 stays off): the CUDA cores, one 256-thread block per
// (batch x head, 32-row q tile); eight neighbouring lanes own a q row,
// each with every eighth of its dims of q and of the accumulator in
// registers (hd / 8: 2 to 32), so a q row fits at every head dim up to
// 256. A 16-row K/V tile is staged in shared memory as float32.
//
// Binding: plain C entry point flash_attention_launch (ctypes), dtype 0
// float32, 1 bfloat16; it returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                  // q rows per block (bf16)
constexpr int kBK = 64;                  // kv rows per tile (bf16)
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;          // devices a process grants

// ------------------------------------------ float32: the CUDA cores ----
// kFLanes neighbouring lanes own a q row, each with every kFLanes-th of
// its dims of q and of the accumulator in registers (hd / 8), so a row
// fits one lane's registers at every head dim; the dot products are
// reduced over the row's lanes by shuffles, so each lane holds the whole
// softmax state. A 16-row K/V tile is staged in shared memory as float32
// (32 KB at hd 256), read conflict-free (a row's lanes take neighbouring
// words, the warp's four rows the same ones).
constexpr int kFBQ = 32;                 // q rows per block
constexpr int kFLanes = 8;               // lanes per q row
constexpr int kFThreads = kFBQ * kFLanes;  // 256
constexpr int kFBK = 16;                 // kv rows per tile

template <int HD, bool kCap, bool kLse>
__global__ void __launch_bounds__(kFThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse,
                           int Sq, int Skv, int H, int KV, int causal,
                           int window, int q_offset, float scale, float cap) {
  constexpr int kDims = HD / kFLanes;    // dims of a row per lane
  __shared__ float Ks[kFBK][HD];
  __shared__ float Vs[kFBK][HD];
  const int tid = threadIdx.x;
  const int row = tid / kFLanes, sub = tid % kFLanes;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kFBQ;
  const int qi = q0 + row;
  const bool q_valid = qi < Sq;
  const int q_pos = qi + q_offset;
  const long long q_row = (long long)H * HD;
  const long long kv_row = (long long)KV * HD;

  float qr[kDims], acc[kDims];
  {
    const float* qp = q + ((long long)b * Sq + (q_valid ? qi : 0)) * q_row +
                      (long long)h * HD;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      qr[i] = q_valid ? qp[sub + kFLanes * i] : 0.f;
      acc[i] = 0.f;
    }
  }

  const int last_q = min(q0 + kFBQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / kFBK) * kFBK;

  float m = kNegInf, l = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kFBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kFBK * HD; e += kFThreads) {
      const int r = e / HD, d = e % HD;
      const int kj = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (kj < Skv) {
        const long long off =
            ((long long)b * Skv + kj) * kv_row + (long long)kvh * HD + d;
        kk = k[off];
        vv = v[off];
      }
      Ks[r][d] = kk;
      Vs[r][d] = vv;
    }
    __syncthreads();

    float s[kFBK];
    float m_t = kNegInf;
#pragma unroll
    for (int j = 0; j < kFBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        dot = fmaf(qr[i], Ks[j][sub + kFLanes * i], dot);
#pragma unroll
      for (int off = 1; off < kFLanes; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kj = k0 + j;
      bool ok = kj < Skv;
      if (causal) ok = ok && kj <= q_pos;
      if (window > 0) ok = ok && kj > q_pos - window;
      float x = dot * scale;
      if constexpr (kCap) x = tanhf(x / cap) * cap;
      s[j] = ok ? x : kNegInf;
      m_t = fmaxf(m_t, s[j]);
    }
    const float m_new = fmaxf(m, m_t);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kFBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kFBK; ++j)
        a = fmaf(s[j], Vs[j][sub + kFLanes * i], a);
      acc[i] = a;
    }
    m = m_new;
  }
  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = o + ((long long)b * Sq + qi) * q_row + (long long)h * HD;
#pragma unroll
    for (int i = 0; i < kDims; ++i) op[sub + kFLanes * i] = acc[i] / denom;
    if constexpr (kLse) {
      if (sub == 0) lse[((long long)b * H + h) * Sq + qi] = m + logf(denom);
    }
  }
}


// ------------------------------------------ bfloat16: the tensor cores ----
constexpr int kTcThreads = 128;          // one warpgroup

// A 64-row tile of hd bf16 per row in shared memory, stored as column
// atoms of at most 64 columns: one atom whose span is the row for hd 16,
// 32 and 64 (the 32/64/128-byte swizzle), hd / 64 atoms of 64 rows x 128
// bytes in the 128-byte swizzle for hd 128 and 256 (no swizzle spans a
// 256- or 512-byte row). 16-byte chunk c of row r sits in atom c / 8 (of
// the row's first 8 chunks for narrower atoms) at chunk c ^ (address bits
// 7..9), the layout the wgmma descriptors below name. The ring is
// 1024-byte aligned and an atom is a multiple of 1024 bytes, so the
// swizzle of an offset is that of the address.
template <int HD>
struct TcTile {
  static constexpr int kChunks = HD / 8;
  static constexpr int kAtomChunks = kChunks < 8 ? kChunks : 8;
  static constexpr int kAtomRowBytes = kAtomChunks * 16;
  static constexpr int kAtomBytes = kBK * kAtomRowBytes;
  static constexpr int kBytes = kBK * HD * 2;
  static constexpr uint64_t kLayout =
      kAtomRowBytes == 128 ? 1 : (kAtomRowBytes == 64 ? 2 : 3);
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const int a = c / kAtomChunks, cc = c % kAtomChunks;
    return a * kAtomBytes + r * kAtomRowBytes +
           ((cc ^ ((r * kAtomRowBytes >> 7) & (kAtomChunks - 1))) << 4);
  }
  // byte offset of k-step kk (16 columns, 32 bytes) in a K-major tile:
  // the atom, then 32 bytes along its row
  static __device__ __forceinline__ uint32_t kstep(int kk) {
    return (kk * 32 / kAtomRowBytes) * kAtomBytes + (kk * 32) % kAtomRowBytes;
  }
  // wgmma shared-memory descriptor: start, leading and stride byte
  // offsets (16-byte units), swizzle mode. The stride offset steps 8 rows
  // of an atom.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr,
                                                  uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)((8 * kAtomRowBytes) >> 4) << 32) | (kLayout << 62);
  }
  // K-major operand (Q, K): a k-step stays inside one atom's row, so the
  // leading offset is unused
  static __device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
    return desc(addr, 16);
  }
  // MN-major operand (V read as K x hd): 8-row groups along K (the stride
  // offset), and along N the next 64-column atom (the leading offset)
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of wgmma registers across the
// asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// D (64 x N, f32) (+)= A (64 x 16, smem) B (16 x N, smem); scale_d 0
// overwrites D
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D (64 x N, f32) += A (64 x 16, registers) B (16 x N, smem, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

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
// swizzled tile; rows at or past n_rows are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int n_rows,
                                          int tid) {
  using Tile = TcTile<HD>;
#pragma unroll
  for (int it = 0; it < kBK * Tile::kChunks / kTcThreads; ++it) {
    const int i = tid + it * kTcThreads;
    const int r = i / Tile::kChunks, c = i % Tile::kChunks;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + Tile::offset(r, c),
               src + (long long)(ok ? row0 + r : 0) * ld + c * 8, ok);
  }
}

// Accumulator fragments (m64nN f32): index i = 4 j + e of this thread
// holds row 16 warp + lane / 4 + 8 (e >> 1), column 8 j + 2 (lane % 4) +
// (e & 1). Columns 16 t .. 16 t + 15 of S, rounded to bf16 in that order,
// are exactly the A fragment of the t-th k-step of P V.
// score_mul: scale * log2(e), or with kCap scale / cap, and then
// cap_log2 = cap * log2(e) multiplies the tanh: the base-2 rescale moves
// after the cap.
template <int HD, bool kCap, bool kLse>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Skv,
                          int H, int KV, int causal, int window,
                          int q_offset, float score_mul, float cap_log2) {
  using Tile = TcTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + Tile::kBytes,
                 sV = base + 3 * Tile::kBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const long long q_ld = (long long)H * HD, kv_ld = (long long)KV * HD;
  const __nv_bfloat16* qb = q + (long long)b * Sq * q_ld + (long long)h * HD;
  const __nv_bfloat16* kb =
      k + (long long)b * Skv * kv_ld + (long long)kvh * HD;
  const __nv_bfloat16* vb =
      v + (long long)b * Skv * kv_ld + (long long)kvh * HD;

  // the kv range any row of this q tile can see (whole-tile skips)
  const int last_q = min(q0 + kBQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, last_q + q_offset + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / kBK) * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  load_tile<HD>(sQ, qb, q_ld, q0, Sq, tid);
  if (n_tiles > 0) {
    load_tile<HD>(sK, kb, kv_ld, k_begin, Skv, tid);
    load_tile<HD>(sV, vb, kv_ld, k_begin, Skv, tid);
  }
  cp_async_commit();

  const int r0 = warp * 16 + (lane >> 2);     // rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);
  const int q_pos[2] = {q0 + r0 + q_offset, q0 + r0 + 8 + q_offset};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBK;
    const uint32_t stage = (t & 1) * Tile::kBytes;
    if (t + 1 < n_tiles) {    // the next tile into the other stage
      const uint32_t next = ((t + 1) & 1) * Tile::kBytes;
      load_tile<HD>(sK + next, kb, kv_ld, k0 + kBK, Skv, tid);
      load_tile<HD>(sV + next, vb, kv_ld, k0 + kBK, Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();          // this tile (and the q tile) have landed

    // S = Q K^T on the tensor cores
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<64>(s, Tile::desc_k(sQ + Tile::kstep(kk)),
                   Tile::desc_k(sK + stage + Tile::kstep(kk)), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale to base 2 (capped first with kCap); the mask only where the
    // tile crosses a boundary
    const bool edge = k0 + kBK > Skv ||
                      (causal && k0 + kBK - 1 > q0 + q_offset) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 + q_offset - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * score_mul;
      if constexpr (kCap) x = tanhf(x) * cap_log2;
      if (edge) {
        const int kj = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const int qp = q_pos[(i >> 1) & 1];
        bool ok = kj < Skv;
        if (causal) ok = ok && kj <= qp;
        if (window > 0) ok = ok && kj > qp - window;
        x = ok ? x : kNegInf;
      }
      s[i] = x;
    }
    // online softmax: row max over the quad, rescale, probabilities
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      corr[r] = ex2(m[r] - mt[r]);
      m[r] = mt[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      ps[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P (bf16) from registers, V MN-major from shared memory
    uint32_t pa[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      pa[kt][0] = pack_bf16(s[8 * kt + 0], s[8 * kt + 1]);
      pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
      wgmma_rs<HD>(acc, pa[kt],
                   Tile::desc_mn(sV + stage + kt * 16 * Tile::kAtomRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();          // the stage may be refilled
  }

  // the quad's partial sums, then normalise and store
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  if constexpr (kLse) {       // m is in base 2: lse = (m + log2 l) ln 2
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + r0 + 8 * r;
        if (qi < Sq)
          lse[((long long)b * H + h) * Sq + qi] =
              (m[r] + log2f(fmaxf(l[r], 1e-30f))) * 0.6931471805599453f;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* op = o + ((long long)b * Sq + qi) * q_ld + (long long)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + c0) = val;
    }
  }
}

// ------------------------------------------------------------ launch ----
template <int HD, bool kCap, bool kLse>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Skv, int H, int KV,
                       int causal, int window, int q_offset, float scale,
                       float cap, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kFBQ - 1) / kFBQ);
  flash_attention_f32_kernel<HD, kCap, kLse><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, H,
      KV, causal, window, q_offset, scale, cap);
  return cudaGetLastError();
}

template <int HD, bool kCap, bool kLse>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Skv, int H, int KV,
                      int causal, int window, int q_offset, float scale,
                      float cap, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  // the q tile and two stages of K and V, plus the alignment slack: 41 KB
  // at hd 64, 81 KB at 128, 161 KB at 256, so above the 48 KB default the
  // instance is allowed its size on each device it runs on (an attribute
  // of the device's context; a refused launch never runs, and
  // cudaGetLastError reports it). Only a grant that succeeded is kept.
  constexpr int smem = 5 * TcTile<HD>::kBytes + 1024;
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !granted[dev]) {
    err = cudaFuncSetAttribute(flash_attention_tc_kernel<HD, kCap, kLse>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) granted[dev] = true;
  }
  constexpr float kLog2e = 1.4426950408889634f;
  flash_attention_tc_kernel<HD, kCap, kLse>
      <<<grid, kTcThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, KV, causal, window,
          q_offset, kCap ? scale / cap : scale * kLog2e, cap * kLog2e);
  return cudaGetLastError();
}

template <int HD, bool kCap, bool kLse>
cudaError_t launch_kind(int dtype, const void* q, const void* k,
                        const void* v, void* o, float* lse, int B, int Sq,
                        int Skv, int H, int KV, int causal, int window,
                        int q_offset, float scale, float cap,
                        cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<HD, kCap, kLse>(q, k, v, o, lse, B, Sq, Skv, H, KV,
                                      causal, window, q_offset, scale, cap,
                                      stream);
  if (dtype == 1)
    return launch_tc<HD, kCap, kLse>(q, k, v, o, lse, B, Sq, Skv, H, KV,
                                     causal, window, q_offset, scale, cap,
                                     stream);
  return cudaErrorInvalidValue;
}

template <int HD, bool kCap>
cudaError_t launch_cap(int dtype, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int Sq, int Skv, int H,
                       int KV, int causal, int window, int q_offset,
                       float scale, float cap, cudaStream_t stream) {
  if (lse != nullptr)
    return launch_kind<HD, kCap, true>(dtype, q, k, v, o, lse, B, Sq, Skv, H,
                                       KV, causal, window, q_offset, scale,
                                       cap, stream);
  return launch_kind<HD, kCap, false>(dtype, q, k, v, o, lse, B, Sq, Skv, H,
                                      KV, causal, window, q_offset, scale,
                                      cap, stream);
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int Sq, int Skv, int H, int KV,
                   int causal, int window, int q_offset, float scale,
                   float cap, cudaStream_t stream) {
  if (cap > 0.f)
    return launch_cap<HD, true>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KV,
                                causal, window, q_offset, scale, cap, stream);
  return launch_cap<HD, false>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KV,
                               causal, window, q_offset, scale, cap, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it); cap: the logit
// soft-cap, 0 for none; lse: (B, H, Sq) float32, or null (serving)
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse_out,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int hd, int causal, int window,
                                      int q_offset, float scale, float cap,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  cudaError_t err;
  switch (hd) {
    case 16:
      err = launch<16>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KV, causal,
                       window, q_offset, scale, cap, st);
      break;
    case 32:
      err = launch<32>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KV, causal,
                       window, q_offset, scale, cap, st);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KV, causal,
                       window, q_offset, scale, cap, st);
      break;
    case 128:
      err = launch<128>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KV, causal,
                        window, q_offset, scale, cap, st);
      break;
    case 256:
      err = launch<256>(dtype, q, k, v, o, lse, B, Sq, Skv, H, KV, causal,
                        window, q_offset, scale, cap, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

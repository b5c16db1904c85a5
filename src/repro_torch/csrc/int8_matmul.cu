// Int8 x int8 -> int32 matmul with a dequantizing epilogue, for Hopper
// (sm_90a), on the integer tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py
// (int8_matmul_kernel, body _kernel):
//   out[m, n] = (float(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]
// with x_q (M, K) int8 row-major, w_q the (K, N) int8 weight held K-major
// (a (K, N) view of (N, K) row-major storage: wgmma takes 8-bit operands
// only K-major, and has no transpose bit for them), sx (M,) and sw (N,)
// float32 scales, out (M, N) float32 or bfloat16. This is the projection
// of every int8 variant of the served models: the edge ladder's d4..d7
// and Falcon-Mamba's d4 (in_proj, out_proj).
//
// Expert batch. One launch computes E independent products of one shape
// (the int8 experts of a mixture-of-experts layer, repro/models/moe.py
// _expert_matmul: Granite d4's 32 experts, each over its capacity rows):
// blockIdx.y is the expert, whose operands lie one after another, x at a
// stride of M K, w of N K, sx of M, sw of N, out of M N. Within an
// expert the tile walk, the plan and the epilogue are those of one
// product; a plain 2-D product is a batch of 1.
//
// Bound. Prefill shapes are bound by operations: Falcon-Mamba d4's
// projections at 64 x 256 tokens (16,384 x 4,096 x 16,384 and 16,384 x
// 8,192 x 4,096) do ~1,800 operations per byte, far past the ridge of the
// int8 tensor cores (1,979 TOPS over 3.35 TB/s, ~590 per byte). Decode
// shapes (M = the batch, at most 64 rows) and the edge ladder's narrow
// projections are bound by bytes: the weight is read once (64 MB for
// Falcon's in_proj, 32 MB for its out_proj) for two operations per byte
// and row.
//
// Design. One kernel template, one block per BM x BN output tile, BM /
// 64 warpgroups of 128 threads, each owning 64 rows.
// K is swept in 128-byte steps through a ring of STAGES stages in shared
// memory, filled by 16-byte cp.async from every thread, STAGES - 2 steps
// ahead of the step in use (rows past M or N and chunks past K are
// zero-filled and read nothing). A tile row of 128 bytes is stored in the
// 128-byte swizzle, the layout of a bf16 row of 64 (K3's descriptor), and
// wgmma.mma_async m64nBNk32 .s32.s8.s8 consumes 32 bytes of K per
// instruction with both operands K-major in shared memory, the int32
// accumulator in registers; one group of products stays in flight while
// the next step's loads are issued. The epilogue converts each sum once
// (__int2float_rn) and scales it by sx then sw with __fmul_rn, so nvcc
// cannot reassociate or contract it, and rounds once to the output type
// (__float2bfloat16_rn for bf16, round to nearest even as Tensor.to): the
// result is bit-identical to the plain PyTorch version, whose integer
// product is exact. The integer sum is exact in any order, so any tiling
// keeps that.
//
// Instances (the wrapper's plan, kernels/int8_matmul.py plan, picks one):
//   BM 128, BN 256, 4 stages (192 KB): prefill rows (M > 64) -- Falcon
//     d4's projections at 64 x 256 tokens and every projection of the
//     edge ladder's prefill. Tiles are walked in groups of 8 tile rows, so
//     blocks that run together share their x rows and weight columns in
//     the L2.
//   BM 64, BN 64, 6 stages (96 KB, two blocks an SM): decode rows (M <=
//     64), one 64-row tile with the rows past M zero-filled, four steps
//     of the weight stream in flight in each block -- Falcon d4's and the
//     edge ladder's projections at decode.
// K is not split: at every served shape a split of K into ranges (int32
// partials reduced by the last range to arrive) was measured slower than
// these tiles alone, whose blocks already keep the card's memory busy.
//
// Binding: plain C entry point int8_matmul_launch (ctypes); out_bf16 0
// writes float32, 1 bfloat16; batch is the number of experts (1 for one
// product). K must be a multiple of 16 (the wrapper
// zero-pads K otherwise). It returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;     // K bytes per stage: 4 wgmma k32 steps
constexpr int kGroupM = 8;   // tile rows per raster group
constexpr int kMaxDevices = 64;

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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of the accumulator across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows, in
// the 128-byte swizzle (chunk c ^ (r mod 8)); stages are 1024-byte
// aligned, so the swizzle of an offset is that of the address.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * kBK + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: start address, leading byte offset 16 (unused when a
// k-step lies inside the swizzle span), stride byte offset 1024 (8 rows),
// layout 1 (128-byte swizzle); all in 16-byte units. A k32 step moves the
// start 32 bytes along the row.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, s32) += A (64 x 32, s8, smem) B (32 x N, s8, smem); both
// operands K-major
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BM, int BN, int STAGES>
struct Tiles {
  static constexpr int kThreads = BM * 2;       // a warpgroup per 64 rows
  static constexpr int kA = BM * kBK, kB = BN * kBK, kStage = kA + kB;
  static constexpr int kSmem = STAGES * kStage + 1024;   // + alignment
  // rows one pass of the block's 16-byte chunks covers (8 chunks a row)
  static constexpr int kRows = kThreads / 8;
  static constexpr int kAPasses = BM / kRows, kBPasses = BN / kRows;
  static_assert(kRows % 8 == 0 && BN % kRows == 0, "tile shape");
  static_assert(STAGES >= 3, "the ring keeps one stage in flight");
};

// Accumulator fragments (m64nBN s32): index i = 4 j + e of this thread
// holds row 16 warp + lane / 4 + 8 (e >> 1), column 8 j + 2 (lane % 4) +
// (e & 1) of its warpgroup's 64 rows.
template <int BM, int BN, int STAGES>
__global__ void __launch_bounds__(BM * 2, 1)
int8_matmul_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                   const int8_t* __restrict__ w, const float* __restrict__ sw,
                   void* __restrict__ out, int M, int N, int K,
                   int out_bf16) {
  using T = Tiles<BM, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;

  // this block's expert: its operands and output
  const long long e = blockIdx.y;
  x += e * M * K;
  w += e * N * K;
  sx += e * M;
  sw += e * N;
  out = out_bf16 ? static_cast<void*>(static_cast<__nv_bfloat16*>(out) +
                                      e * M * N)
                 : static_cast<void*>(static_cast<float*>(out) + e * M * N);

  // the output tile, walked in groups of kGroupM tile rows
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tile = blockIdx.x;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (tile / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + (tile % per_group) % group_m) * BM;
  const int n0 = ((tile % per_group) / group_m) * BN;

  const int n_steps = (K + kBK - 1) / kBK;     // 128-byte k-steps

  // the loader: chunk c of rows r0 + i * kRows of each operand tile
  const int c = tid & 7, r0 = tid >> 3;
  const uint32_t dst0 = swizzled(r0, c);
  // each pass's source row, computed once (null past M or N: such
  // chunks read nothing)
  const int8_t* a_row[T::kAPasses];
  const int8_t* b_row[T::kBPasses];
#pragma unroll
  for (int i = 0; i < T::kAPasses; ++i) {
    const int r = m0 + r0 + i * T::kRows;
    a_row[i] = r < M ? x + (long long)r * K + 16 * c : nullptr;
  }
#pragma unroll
  for (int i = 0; i < T::kBPasses; ++i) {
    const int r = n0 + r0 + i * T::kRows;
    b_row[i] = r < N ? w + (long long)r * K + 16 * c : nullptr;
  }
  auto load = [&](int slot, int ks) {
    const uint32_t sa = base + slot * T::kStage, sb = sa + T::kA;
    const int k0 = ks * kBK;
    const bool k_in = k0 + 16 * c < K;
#pragma unroll
    for (int i = 0; i < T::kAPasses; ++i) {
      const bool ok = k_in && a_row[i];
      cp_async16(sa + dst0 + i * T::kRows * kBK, ok ? a_row[i] + k0 : x, ok);
    }
#pragma unroll
    for (int i = 0; i < T::kBPasses; ++i) {
      const bool ok = k_in && b_row[i];
      cp_async16(sb + dst0 + i * T::kRows * kBK, ok ? b_row[i] + k0 : w, ok);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int wg = tid >> 7;
  const uint32_t a_wg = wg * 64 * kBK;      // this warpgroup's 64 rows

#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();      // step i has landed; step i - 2's products are
                          // done in every warpgroup, so its slot is free
    if (i + STAGES - 2 < n_steps)
      load((i + STAGES - 2) % STAGES, i + STAGES - 2);
    cp_async_commit();
    const uint32_t sa = base + (i % STAGES) * T::kStage, sb = sa + T::kA;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8<BN>(acc, desc(sa + a_wg + kk * 32), desc(sb + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();      // step i - 1's products are done
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);   // and row + 8
  const int col = n0 + 2 * (lane & 3);                      // + 8 j, + 1
  const bool pairs = (N & 1) == 0;     // (col, col + 1) is 8-byte aligned

  // dequantize: float(acc) * sx, then * sw, each rounded once; one
  // rounding to the output type
  const float s_row[2] = {row < M ? sx[row] : 0.f,
                          row + 8 < M ? sx[row + 8] : 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cc = col + 8 * j;
    if (cc >= N) continue;
    const bool two = cc + 1 < N;
    const float s0 = sw[cc], s1 = two ? sw[cc + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= M) continue;
      const float v0 = __fmul_rn(
          __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s_row[h]), s0);
      const float v1 = __fmul_rn(
          __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s_row[h]), s1);
      const long long o = (long long)r * N + cc;
      if (out_bf16) {
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + o;
        if (pairs && two) {
          *reinterpret_cast<__nv_bfloat162*>(ob) =
              __halves2bfloat162(__float2bfloat16_rn(v0),
                                 __float2bfloat16_rn(v1));
        } else {
          ob[0] = __float2bfloat16_rn(v0);
          if (two) ob[1] = __float2bfloat16_rn(v1);
        }
      } else {
        float* of = static_cast<float*>(out) + o;
        if (pairs && two) {
          *reinterpret_cast<float2*>(of) = make_float2(v0, v1);
        } else {
          of[0] = v0;
          if (two) of[1] = v1;
        }
      }
    }
  }
}

template <int BM, int BN, int STAGES>
cudaError_t launch(const void* x, const void* sx, const void* w,
                   const void* sw, void* out, int M, int N, int K,
                   int out_bf16, int batch, cudaStream_t stream) {
  using T = Tiles<BM, BN, STAGES>;
  auto kernel = int8_matmul_kernel<BM, BN, STAGES>;
  // the shared memory past 48 KB, granted once per device
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) granted[dev] = true;
  }
  const dim3 grid(((M + BM - 1) / BM) * ((N + BN - 1) / BN), batch);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw), out, M,
      N, K, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// batch products, each of x (M, K) and w (N, K) int8 row-major (w is the
// weight's K-major storage), sx (M,) and sw (N,) float32, out (M, N); the
// batch's operands one after another
extern "C" int int8_matmul_launch(const void* x, const void* sx,
                                  const void* w, const void* sw, void* out,
                                  int M, int N, int K, int bm, int bn,
                                  int out_bf16, int batch, void* stream) {
  if (M <= 0 || N <= 0 || batch <= 0) return 0;
  if (K <= 0 || K % 16 != 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bm == 128 && bn == 256)
    err = launch<128, 256, 4>(x, sx, w, sw, out, M, N, K, out_bf16, batch,
                              st);
  else if (bm == 64 && bn == 64)
    err = launch<64, 64, 6>(x, sx, w, sw, out, M, N, K, out_bf16, batch,
                            st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Int8 x int8 -> int32 matmul with a dequantizing epilogue, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py
// (int8_matmul_kernel, body _kernel):
//   out[m, n] = (float(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]
// with x_q (M, K) int8 row-major, w_q (K, N) int8 row-major, sx (M,) and
// sw (N,) float32 scales, out (M, N) float32. This is the projection of
// every int8 variant of the served ladder (d4..d7).
//
// Bound: on the path's shapes (M = batch x tokens up to 16,384, K and N
// 64..1,024) the product does 2*M*N*K operations on (M*K + K*N) bytes in
// and 4*M*N bytes out: ~32..128 operations per byte, under the ~590 per
// byte at which the int8 tensor cores would be the limit, so by the
// card's peaks the bound is bytes. This first version runs on the CUDA
// cores with __dp4a (four int8 products and an int32 add per
// instruction), so in practice it is bound by dp4a throughput; tensor-core
// mma / wgmma is the work of a later version.
//
// Design: one 256-thread block per 64 x 64 output tile. The K axis is
// swept in 32-byte steps: the block stages the A tile (64 rows x 32 k) and
// the B tile (32 k x 64 columns, transposed so that four consecutive k of
// one column pack into one 32-bit word) in shared memory, with bounds
// checks on every byte, so M, N and K need not be multiples of anything.
// Thread (ty, tx) of a 16 x 16 grid owns the outputs (ty + 16 i, tx + 16 j)
// for i, j < 4 and keeps their int32 sums in registers. The epilogue
// converts each sum once and scales it by sx then sw with __fmul_rn, so
// nvcc cannot reassociate or contract it: the result is bit-identical to
// the plain PyTorch version, whose integer product is exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;  // tile; kBK in bytes
constexpr int kWords = kBK / 4;              // packed k words per row
constexpr int kThreads = 256;

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c,
                                     int8_t d) {
  return (int)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
               ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24));
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                   const int8_t* __restrict__ w, const float* __restrict__ sw,
                   float* __restrict__ out, int M, int N, int K) {
  // +1 word of padding per row keeps the strided reads conflict-free
  __shared__ int As[kBM][kWords + 1];
  __shared__ int Bs[kBN][kWords + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile: word (r, kw) packs x[m0 + r, k0 + 4 kw .. +3]
#pragma unroll
    for (int t = 0; t < (kBM * kWords) / kThreads; ++t) {
      const int wid = tid + t * kThreads;
      const int r = wid / kWords, kw = wid % kWords;
      const int m = m0 + r, k = k0 + 4 * kw;
      int8_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b[e] = (m < M && k + e < K) ? x[(long long)m * K + k + e] : 0;
      As[r][kw] = pack4(b[0], b[1], b[2], b[3]);
    }
    // B tile, transposed: word (c, kw) packs w[k0 + 4 kw .. +3, n0 + c];
    // neighbouring threads read neighbouring columns (coalesced)
#pragma unroll
    for (int t = 0; t < (kBN * kWords) / kThreads; ++t) {
      const int wid = tid + t * kThreads;
      const int c = wid % kBN, kw = wid / kBN;
      const int n = n0 + c, k = k0 + 4 * kw;
      int8_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b[e] = (n < N && k + e < K) ? w[(long long)(k + e) * N + n] : 0;
      Bs[c][kw] = pack4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s_row = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        out[(long long)m * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), s_row), sw[n]);
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const void* x, const void* sx,
                                  const void* w, const void* sw, void* out,
                                  int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

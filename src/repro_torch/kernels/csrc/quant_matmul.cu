// Packed-weight int8 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitserial_matmul.py::quant_matmul
// (body _unpack_matmul_kernel).  Computes
//     out[m, n] = float(sum_k a[m, k] * w[k, n]) * scale[n]
// with a (M, K) int8 activations, w stored as `bits` packed bit planes
// wp (bits, K/32, N) of 32-bit words (plane b, word c, column n holds
// bit b of w[32c .. 32c+31, n]), two's complement: the MSB plane has
// coefficient -2^(bits-1).  The sum is exact in int32; the one float
// multiply at the end is the reference's, so the result is bit-identical.
//
// Design: one thread block of 128 threads owns a 32 x 64 output tile and
// walks K one packed word (32 values of k) at a time.  Per step it stages
// the activation tile (32 rows x 32 int8) in shared memory, and unpacks
// the weight words of its 64 columns into int8 values, four k to a 32-bit
// word, so that each thread's 4 x 4 outputs accumulate with __dp4a (four
// int8 products and an int32 add per instruction).  The weights never
// exist unpacked in device memory: their bytes are bits/8 of int8's.
//
// What bounds it: the work is 2*M*N*K integer operations against
// M*K + bits*K*N/8 + 4*N + 4*M*N bytes; at the main path's shapes (M = 128
// tokens, K, N <= 4864) the int8 tensor-core bound and the memory bound are
// a few microseconds.  This simple kernel uses no tensor cores (no wgmma,
// no TMA, no pipelining): it is bound by the unpack's bit operations and
// the dp4a issue rate, by few thread blocks at small N, and by one
// load-then-compute round trip per K word at large K.  An int8 wgmma fed by
// an in-register unpack, with the loads pipelined, is the later design.
#include <cuda_runtime.h>
#include <stdint.h>

#define QM_MAX_BITS 8
#define QM_BM 32
#define QM_BN 64
#define QM_THREADS 128
#define QM_GROUPS 8  // groups of 4 k in one 32-bit packed word

template <int BITS>
__global__ void __launch_bounds__(QM_THREADS)
quant_matmul_kernel(const int8_t* __restrict__ a,
                    const uint32_t* __restrict__ wp,
                    const float* __restrict__ scale,
                    float* __restrict__ out, int M, int K, int N) {
  __shared__ int32_t as[QM_BM][QM_GROUPS + 1];  // int8x4 of a, padded
  __shared__ int32_t ws[QM_GROUPS][QM_BN];      // int8x4 of w
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;       // 16 x 8 threads
  const int m0 = blockIdx.y * QM_BM, n0 = blockIdx.x * QM_BN;
  const int kw = K / 32;
  // the unpacking thread's column and half of the 8 groups
  const int un = tid % QM_BN, uhalf = tid / QM_BN;
  const int ucol = n0 + un;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int c = 0; c < kw; ++c) {
    // activation tile: 32 rows x 8 words of 4 int8
    for (int i = tid; i < QM_BM * QM_GROUPS; i += QM_THREADS) {
      const int r = i / QM_GROUPS, g = i % QM_GROUPS, m = m0 + r;
      as[r][g] = (m < M) ? reinterpret_cast<const int32_t*>(
                               a + (size_t)m * K + (size_t)c * 32)[g]
                         : 0;
    }
    // weight tile: unpack plane words into int8 values, 4 k per word
    uint32_t word[BITS];
#pragma unroll
    for (int b = 0; b < BITS; ++b)
      word[b] = (ucol < N) ? __ldg(wp + ((size_t)b * kw + c) * N + ucol) : 0u;
#pragma unroll
    for (int gg = 0; gg < QM_GROUPS / 2; ++gg) {
      const int g = uhalf * (QM_GROUPS / 2) + gg;
      uint32_t packed = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * g + i;
        int v = 0;
#pragma unroll
        for (int b = 0; b < BITS; ++b) {
          const int bit = (int)((word[b] >> k) & 1u);
          v += (b == BITS - 1) ? -(bit << b) : (bit << b);
        }
        packed |= ((uint32_t)v & 0xFFu) << (8 * i);
      }
      ws[g][un] = (int32_t)packed;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < QM_GROUPS; ++g) {
      int av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty * 4 + i][g];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[g][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = (float)acc[i][j] * scale[n];
    }
  }
}

template <int BITS>
static void launch(const int8_t* a, const uint32_t* wp, const float* scale,
                   float* out, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + QM_BN - 1) / QM_BN, (M + QM_BM - 1) / QM_BM);
  quant_matmul_kernel<BITS><<<grid, QM_THREADS, 0, stream>>>(a, wp, scale,
                                                             out, M, K, N);
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int quant_matmul_launch(const void* a, const void* wp,
                                   const void* scale, void* out, int M, int K,
                                   int N, int bits, void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32 || (M + QM_BM - 1) / QM_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int8_t* A = (const int8_t*)a;
  const uint32_t* W = (const uint32_t*)wp;
  const float* S = (const float*)scale;
  float* O = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 1: launch<1>(A, W, S, O, M, K, N, st); break;
    case 2: launch<2>(A, W, S, O, M, K, N, st); break;
    case 3: launch<3>(A, W, S, O, M, K, N, st); break;
    case 4: launch<4>(A, W, S, O, M, K, N, st); break;
    case 5: launch<5>(A, W, S, O, M, K, N, st); break;
    case 6: launch<6>(A, W, S, O, M, K, N, st); break;
    case 7: launch<7>(A, W, S, O, M, K, N, st); break;
    case 8: launch<8>(A, W, S, O, M, K, N, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

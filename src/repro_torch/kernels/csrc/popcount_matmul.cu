// PIM-faithful bit-serial GEMM for Hopper (sm_90a): AND + popcount over
// bit-plane pairs.
//
// Replaces the TPU kernel repro/kernels/bitserial_matmul.py::popcount_matmul
// (body _popcount_kernel).  Both operands are packed bit planes of 32-bit
// words: ap (Ba, M, K/32) and wp (Bw, K/32, N).  The kernel writes
//     out[m, n] = sum_{i, j} c_i * c_j * sum_w popc(ap[i, m, w] & wp[j, w, n])
// in int32, with c_i = 2^i and the MSB coefficient negative for a signed
// operand: the Compute RAM block's arithmetic (AND on the bit-line, add
// through the carry chain).  Integer adds are associative mod 2^32, so any
// order of the sums gives the reference's bits.
//
// Design: one thread block of 128 threads owns a 32 x 64 output tile and
// walks K eight words at a time.  Per step it stages the Ba x 32 x 8
// activation words and the Bw x 8 x 64 weight words in shared memory;
// each thread then forms its 4 x 4 outputs' AND/popcount terms for every
// plane pair in registers.
//
// What bounds it: it does Ba*Bw*M*N*K/32 AND/popcount/add steps on
// (Ba*M + Bw*N)*K/8 + 4*M*N bytes.  The same product as an int8 GEMM on
// the tensor cores is bound by memory at the main path's shapes; this
// kernel is bound by the popcount issue rate (16 per SM and clock), which
// is what faithful bit-serial arithmetic costs.
#include <cuda_runtime.h>
#include <stdint.h>

#define PC_MAX_PLANES 8
#define PC_BM 32
#define PC_BN 64
#define PC_KC 8
#define PC_THREADS 128

__global__ void __launch_bounds__(PC_THREADS)
popcount_matmul_kernel(const uint32_t* __restrict__ ap,
                       const uint32_t* __restrict__ wp, int* __restrict__ out,
                       int ba, int bw, int M, int KW, int N, int a_signed,
                       int w_signed) {
  __shared__ uint32_t as[PC_MAX_PLANES][PC_BM][PC_KC + 1];
  __shared__ uint32_t ws[PC_MAX_PLANES][PC_KC][PC_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 16 x 8 threads
  const int m0 = blockIdx.y * PC_BM, n0 = blockIdx.x * PC_BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < KW; c0 += PC_KC) {
    for (int i = tid; i < ba * PC_BM * PC_KC; i += PC_THREADS) {
      const int p = i / (PC_BM * PC_KC), r = (i / PC_KC) % PC_BM,
                q = i % PC_KC;
      const int m = m0 + r, c = c0 + q;
      as[p][r][q] =
          (m < M && c < KW) ? __ldg(ap + ((size_t)p * M + m) * KW + c) : 0u;
    }
    for (int i = tid; i < bw * PC_KC * PC_BN; i += PC_THREADS) {
      const int p = i / (PC_KC * PC_BN), q = (i / PC_BN) % PC_KC,
                nl = i % PC_BN;
      const int n = n0 + nl, c = c0 + q;
      ws[p][q][nl] =
          (n < N && c < KW) ? __ldg(wp + ((size_t)p * KW + c) * N + n) : 0u;
    }
    __syncthreads();
    for (int i = 0; i < ba; ++i) {
      const int ci = (a_signed && i == ba - 1) ? -(1 << i) : (1 << i);
      for (int j = 0; j < bw; ++j) {
        const int cj = (w_signed && j == bw - 1) ? -(1 << j) : (1 << j);
        int t[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) t[r][s] = 0;
#pragma unroll
        for (int q = 0; q < PC_KC; ++q) {
          uint32_t av[4], wv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = as[i][ty * 4 + r][q];
#pragma unroll
          for (int s = 0; s < 4; ++s) wv[s] = ws[j][q][tx + 16 * s];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) t[r][s] += __popc(av[r] & wv[s]);
        }
        const int cc = ci * cj;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] += cc * t[r][s];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = n0 + tx + 16 * s;
      if (n < N) out[(size_t)m * N + n] = acc[r][s];
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int popcount_matmul_launch(const void* ap, const void* wp,
                                      void* out, int ba, int bw, int M, int KW,
                                      int N, int a_signed, int w_signed,
                                      void* stream) {
  if (ba < 1 || ba > PC_MAX_PLANES || bw < 1 || bw > PC_MAX_PLANES || M < 1 ||
      N < 1 || KW < 1 || (M + PC_BM - 1) / PC_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + PC_BN - 1) / PC_BN, (M + PC_BM - 1) / PC_BM);
  popcount_matmul_kernel<<<grid, PC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ap, (const uint32_t*)wp, (int*)out, ba, bw, M, KW, N,
      a_signed, w_signed);
  return (int)cudaGetLastError();
}

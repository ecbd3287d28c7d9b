// PIM-faithful bit-serial GEMM for Hopper (sm_90a), on the int8 tensor
// cores.
//
// Replaces the TPU kernel repro/kernels/bitserial_matmul.py::popcount_matmul
// (body _popcount_kernel).  Both operands are packed bit planes of 32-bit
// words: ap (Ba, M, K/32) and wp (Bw, K/32, N); bit b of word c holds K
// index 32c + b.  The kernel writes
//     out[m, n] = sum_{i, j} c_i * c_j * sum_w popc(ap[i, m, w] & wp[j, w, n])
// in int32, with c_i = 2^i and the MSB coefficient negative for a signed
// operand: the Compute RAM block's arithmetic (AND on the bit-line, add
// through the carry chain).  The sum over plane pairs equals the integer
// product A.W of the unpacked operands, and integer adds are associative
// mod 2^32, so any order of the sums, on any unit, gives the reference's
// bits.
//
// What bounds it: the product's 2*M*N*K operations at the int8 tensor-core
// rate, or the (Ba*M + Bw*N)*K/8 + 4*M*N bytes; at the main path's shapes
// the bytes.  AND/popcount on the SIMT pipes (16 popcounts per SM and
// clock) would put a floor of ~0.46 ms under qwen2-0.5b's seven linears
// at M = 128, A8W4: above a plain int8 GEMM's time.  So this kernel
// unpacks the planes into 8-bit values and multiplies on the tensor cores.
//
// Design: a block of eight warps owns a 64 x 64 output tile (16 x 32 a
// warp) and walks its share of K four words (128 K) a stage.  Each stage
// the block reads the packed words of A's 64 rows and W's 64 columns,
// unpacks them into shared memory as K-major bytes,
//     v = sum_{i < B-1} 2^i b_i  +/-  2^(B-1) b_(B-1)
// four bytes at a time (a nibble spread to the low bit of four bytes by
// one multiply, times the plane's coefficient mod 256), s8 for a signed
// operand and u8 for an unsigned one (B <= 8, so every value fits), and
// runs mma.sync m16n8k32 with s32 accumulation on fragments loaded by
// ldmatrix.  Each A tile is unpacked once a stage and shared by the
// block's 64 columns.  The next stage's words load into registers while
// this stage multiplies; two smem buffers need one barrier a stage.  The
// accumulate wraps mod 2^32 (no .satfinite), like the reference.  Where
// the output tiles alone give fewer than two blocks per SM, K is split
// over gridDim.z and the parts meet in int32 atomicAdd on a zeroed output,
// which wraps and is order-independent, so the result stays bit-identical.
// mma.sync and not wgmma: at these shapes the MMAs are a small part of
// the kernel's time; the chain of loads, unpack and barrier of each stage
// sets it (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define PC_MAX_PLANES 8
#define PC_BM 64
#define PC_BN 64
#define PC_KC 4                      // K words (128 K) per stage
#define PC_WM 4                      // warps along M (16 rows each)
#define PC_WN 2                      // warps along N (32 columns each)
#define PC_THREADS (32 * PC_WM * PC_WN)
#define PC_ROW (PC_KC * 32 + 16)     // bytes per unpacked row, 16 pad
#define PC_MIN_SPLIT_WORDS PC_KC     // least K words per split
// one A item (row, word) and one W item (word, column) of a stage a thread
static_assert(PC_THREADS == PC_BM * PC_KC && PC_THREADS == PC_BN * PC_KC,
              "one item of each operand per thread");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// d += a (16 x 32) . b (32 x 8), s32 accumulate that wraps mod 2^32
template <bool AS, bool WS>
__device__ __forceinline__ void mma_i8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
#define PC_MMA(TA, TB)                                                       \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "    \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"     \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (AS && WS) PC_MMA("s8", "s8");
  else if constexpr (AS) PC_MMA("s8", "u8");
  else if constexpr (WS) PC_MMA("u8", "s8");
  else PC_MMA("u8", "u8");
#undef PC_MMA
}

// the 32 K-bytes of one packed (row, word) from its planes' words; byte
// 4u + i of out is element 4u + i of the word (little-endian)
__device__ __forceinline__ void unpack32(const uint32_t (&w)[PC_MAX_PLANES],
                                         int planes, bool sgn,
                                         uint32_t (&out)[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) out[u] = 0u;
#pragma unroll
  for (int p = 0; p < PC_MAX_PLANES; ++p) {
    if (p >= planes) break;
    const uint32_t c = plane_coef(p, planes, sgn);
#pragma unroll
    for (int u = 0; u < 8; ++u)  // nibble u -> low bit of 4 bytes, times c
      out[u] += spread4(w[p] >> (4 * u)) * c;
  }
}

template <bool AS, bool WS>
__global__ void __launch_bounds__(PC_THREADS)
popcount_matmul_kernel(const uint32_t* __restrict__ ap,
                       const uint32_t* __restrict__ wp, int* __restrict__ out,
                       int ba, int bw, int M, int KW, int N, int split_words) {
  __shared__ __align__(16) uint8_t As[2][PC_BM * PC_ROW];
  __shared__ __align__(16) uint8_t Bs[2][PC_BN * PC_ROW];
  constexpr int NF = PC_BN / PC_WN / 8;  // n-fragments of 8 a warp
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / PC_WN, wn = warp % PC_WN;  // the warp's 16 x 32
  const int m0 = blockIdx.y * PC_BM, n0 = blockIdx.x * PC_BN;
  const int kw0 = blockIdx.z * split_words;
  const int kw1 = min(KW, kw0 + split_words);
  const int stages = (kw1 - kw0 + PC_KC - 1) / PC_KC;

  // this thread's A item (row ra, word qa) and W item (word qw, column
  // nw) of a stage: 64 x 4 of each, one a thread
  const int ra = tid / PC_KC, qa = tid % PC_KC;
  const int qw = tid / PC_BN, nw = tid % PC_BN;
  uint32_t aw[PC_MAX_PLANES], ww[PC_MAX_PLANES];
  auto load = [&](int c0) {
    const bool aok = m0 + ra < M && c0 + qa < kw1;
    const bool wok = n0 + nw < N && c0 + qw < kw1;
#pragma unroll
    for (int p = 0; p < PC_MAX_PLANES; ++p) {
      aw[p] = (aok && p < ba)
                  ? __ldg(ap + ((size_t)p * M + m0 + ra) * KW + c0 + qa) : 0u;
      ww[p] = (wok && p < bw)
                  ? __ldg(wp + ((size_t)p * KW + c0 + qw) * N + n0 + nw) : 0u;
    }
  };

  int acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  if (stages > 0) load(kw0);
  for (int s = 0; s < stages; ++s) {
    uint8_t* as = As[s & 1];
    uint8_t* bs = Bs[s & 1];
    uint32_t v[8];
    unpack32(aw, ba, AS, v);
    uint4* da = reinterpret_cast<uint4*>(as + ra * PC_ROW + qa * 32);
    da[0] = make_uint4(v[0], v[1], v[2], v[3]);
    da[1] = make_uint4(v[4], v[5], v[6], v[7]);
    unpack32(ww, bw, WS, v);
    uint4* db = reinterpret_cast<uint4*>(bs + nw * PC_ROW + qw * 32);
    db[0] = make_uint4(v[0], v[1], v[2], v[3]);
    db[1] = make_uint4(v[4], v[5], v[6], v[7]);
    __syncthreads();
    if (s + 1 < stages) load(kw0 + (s + 1) * PC_KC);  // in flight below
#pragma unroll
    for (int ks = 0; ks < PC_KC; ++ks) {  // 32 K a step
      uint32_t a[4];
      ldsm_x4(a, as + (wm * 16 + (lane & 15)) * PC_ROW + ks * 32 +
                     (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        uint32_t b[4];  // n-fragments 2np and 2np + 1
        ldsm_x4(b, bs + (wn * 8 * NF + np * 16 + ((lane >> 4) << 3) +
                         (lane & 7)) * PC_ROW +
                        ks * 32 + ((lane >> 3) & 1) * 16);
        mma_i8<AS, WS>(acc[2 * np], a, b[0], b[1]);
        mma_i8<AS, WS>(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // element e of fragment nf: row g + 8 * (e >> 1), column 2t + (e & 1)
  const bool atomic = gridDim.z > 1;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int m = m0 + wm * 16 + g + 8 * e2;
    if (m >= M) continue;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int n = n0 + wn * 8 * NF + nf * 8 + 2 * t + e1;
        if (n >= N) continue;
        int* dst = out + (size_t)m * N + n;
        const int x = acc[nf][2 * e2 + e1];
        if (atomic)
          atomicAdd(dst, x);
        else
          *dst = x;
      }
  }
}

// Launch on `stream`; returns the first CUDA error (0 = launched).
extern "C" int popcount_matmul_launch(const void* ap, const void* wp,
                                      void* out, int ba, int bw, int M, int KW,
                                      int N, int a_signed, int w_signed,
                                      void* stream) {
  if (ba < 1 || ba > PC_MAX_PLANES || bw < 1 || bw > PC_MAX_PLANES || M < 1 ||
      N < 1 || KW < 1 || (M + PC_BM - 1) / PC_BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int sms = 0;
  cudaError_t e = (cudaError_t)device_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((N + PC_BN - 1) / PC_BN) * ((M + PC_BM - 1) / PC_BM);
  // split K until two blocks per SM, each split >= PC_MIN_SPLIT_WORDS
  int split = (2 * sms + tiles - 1) / tiles;
  split = max(1, min(split, KW / PC_MIN_SPLIT_WORDS));
  int words = (KW + split - 1) / split;
  words = (words + PC_KC - 1) / PC_KC * PC_KC;  // whole stages
  split = (KW + words - 1) / words;
  if (split > 1) {
    e = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + PC_BN - 1) / PC_BN, (M + PC_BM - 1) / PC_BM, split);
  const uint32_t* A = (const uint32_t*)ap;
  const uint32_t* W = (const uint32_t*)wp;
  int* O = (int*)out;
#define PC_LAUNCH(AS, WS)                                          \
  popcount_matmul_kernel<AS, WS><<<grid, PC_THREADS, 0, st>>>(     \
      A, W, O, ba, bw, M, KW, N, words)
  if (a_signed && w_signed) PC_LAUNCH(true, true);
  else if (a_signed) PC_LAUNCH(true, false);
  else if (w_signed) PC_LAUNCH(false, true);
  else PC_LAUNCH(false, false);
#undef PC_LAUNCH
  return (int)cudaGetLastError();
}

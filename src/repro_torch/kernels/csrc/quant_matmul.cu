// Packed-weight int8 GEMM for Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces the TPU kernel repro/kernels/bitserial_matmul.py::quant_matmul
// (body _unpack_matmul_kernel).  Computes
//     out[m, n] = float(sum_k a[m, k] * w[k, n]) * scale[n]
// with a (M, K) int8 activations, w stored as `bits` packed bit planes
// wp (bits, K/32, N) of 32-bit words (plane b, word c, column n holds
// bit b of w[32c .. 32c+31, n]), two's complement: the MSB plane has
// coefficient -2^(bits-1).  The sum is exact in int32 (integer adds in any
// order, wrapping mod 2^32 like the reference); the one float multiply at
// the end is the reference's, so the result is bit-identical.
//
// What bounds it: 2*M*N*K operations against M*K + bits*K*N/8 + 4*N +
// 4*M*N bytes.  At the main path's shapes (M = 128 or 8 tokens, K, N <=
// 4864) the bytes bound it, at 0.3-1.4 us a linear; what the time is
// made of is latency: the launch, a block's chain of stages (copies,
// unpack, barriers, wgmmas) and the cluster's reduction, with few blocks
// in flight (the output tiles alone give 2 to 76 blocks for 132 SMs).
//
// Design: the product is taken transposed, out^T (N x M) = W^T (N x K) .
// a^T (K x M), so that the packed weights are wgmma's register operand A
// and the activations its shared-memory operand B:
//   - one warpgroup owns 64 weight columns (wgmma's M) and a tile of MT
//     tokens (wgmma's N: 8 at decode, 64, or 128 at prefill) and walks its
//     share of K one packed word (32 k, one m64nMTk32 wgmma) at a time;
//   - a 32-bit plane word holds 32 consecutive k of one column, so each
//     thread builds its A fragment (rows g and g + 8 of its warp's 16, k
//     4t..4t+3 and 16+4t..16+4t+3) from the nibbles t and 4 + t of its two
//     columns' words: a nibble spreads to the low bit of four bytes by one
//     multiply, times the plane's coefficient mod 256, summed over the
//     planes (the values fit a byte, so no carry crosses bytes);
//   - stages of 4 words (128 k: one 128-byte row of a) stream through a
//     ring of 3 stages in shared memory by cp.async, 2 stages ahead:
//     the activation tile in the 128-byte swizzle the wgmma descriptor
//     names, the weight words beside it; a stage's unpack runs while the
//     previous stage's wgmmas are on the tensor cores (two fragment sets);
//   - where the tiles give fewer than two blocks an SM, K is split over a
//     thread-block cluster of up to 8 blocks (gridDim.z); the ring is
//     small enough (at most 76 KB) for three blocks an SM.  Each
//     block stages its int32 partial tile in its shared memory; after a
//     cluster barrier, block r sums its share of the tile over the
//     cluster's partials (distributed shared memory, int32, fixed order),
//     multiplies by scale[n] once, and stores rows of `out` in coalesced
//     16-byte quads.  No workspace, no atomics, one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

#define QM_MAX_BITS 8
#define QM_BN 64               // weight columns per block: wgmma's M
#define QM_STAGE_WORDS 4       // K words (128 k) per stage: a 128-byte row
#define QM_STAGES 3            // ring of stages in shared memory
#define QM_AHEAD (QM_STAGES - 1)  // stages loading ahead of the multiplied one
#define QM_THREADS 128         // one warpgroup
#define QM_MAX_SPLIT 8         // K splits of a tile: one portable cluster
#define QM_BLOCKS_PER_SM 2     // the split aims at this many blocks an SM
#define QM_PSTR (QM_BN + 4)    // int32 row stride of the staged partial tile

// 4 bytes global -> shared; zeros where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void lds128(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

#define QM_D4(j) "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])
#define QM_D32                                                              \
  QM_D4(0), QM_D4(1), QM_D4(2), QM_D4(3), QM_D4(4), QM_D4(5), QM_D4(6), \
      QM_D4(7)
#define QM_D64                                                              \
  QM_D32, QM_D4(8), QM_D4(9), QM_D4(10), QM_D4(11), QM_D4(12), QM_D4(13), \
      QM_D4(14), QM_D4(15)

// d (64 x MT, int32) += A (64 x 32 s8, registers: the warp's 16 rows in
// mma.sync's m16n8k32 A layout) . B (32 x MT s8, shared memory, K-major,
// 128-byte swizzle); d[j][e] is row 16 * warp + g + 8 * (e >> 1), column
// 8j + 2t + (e & 1).  No .satfinite: the sum wraps mod 2^32.
template <int MT>
__device__ __forceinline__ void wg_s8(int (&d)[MT / 8][4],
                                      const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wg_s8<8>(int (&d)[1][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : QM_D4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_s8<64>(int (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : QM_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wg_s8<128>(int (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : QM_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int MT, int BITS>
struct QmLayout {
  static constexpr int ABYTES = MT * 128;  // activation tile of a stage
  static constexpr int WBYTES = BITS * QM_BN * QM_STAGE_WORDS * 4;
  // the ring, and slack to align its base to 1024 B; the partial tile
  // (MT x QM_PSTR int32) reuses the ring once every stage is consumed
  static constexpr int BYTES = QM_STAGES * (ABYTES + WBYTES) + 1024;
  static_assert(MT * QM_PSTR * 4 <= QM_STAGES * (ABYTES + WBYTES),
                "the partial tile fits the ring");
};

template <int MT, int BITS>
__global__ void __launch_bounds__(QM_THREADS)
quant_matmul_kernel(const int8_t* __restrict__ a,
                    const uint32_t* __restrict__ wp,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int M, int K, int N) {
  using L = QmLayout<MT, BITS>;
  extern __shared__ __align__(16) unsigned char qm_smem[];
  const uint32_t raw = smem_addr(qm_smem);
  const uint32_t As = (raw + 1023u) & ~1023u;       // activation slots
  const uint32_t Ws = As + QM_STAGES * L::ABYTES;   // weight slots
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * QM_BN, m0 = blockIdx.y * MT;
  const int KW = K / 32, split = gridDim.z;
  // this block's words [kw0, kw1): the split parts differ by at most one
  const int kw0 = (int)((long long)KW * blockIdx.z / split);
  const int kw1 = (int)((long long)KW * (blockIdx.z + 1) / split);
  const int nst = (kw1 - kw0 + QM_STAGE_WORDS - 1) / QM_STAGE_WORDS;

  // stage s into slot s % QM_STAGES; words past kw1, tokens past M and
  // columns past N read as zeros.  Always commits one group.
  auto load_stage = [&](int s) {
    if (s < nst) {
      const int c0 = kw0 + s * QM_STAGE_WORDS;
      const int slot = s % QM_STAGES;
      // activations: MT rows x 8 chunks of 16 B; chunk c of row r at
      // r * 128 + ((c ^ (r % 8)) * 16)
      const uint32_t ad = As + slot * L::ABYTES;
#pragma unroll
      for (int i = tid; i < MT * 8; i += QM_THREADS) {
        const int r = i / 8, c = i % 8, row = m0 + r;
        const bool ok = row < M && c0 + c / 2 < kw1;
        cp_async16(ad + r * 128 + ((c ^ (r & 7)) << 4),
                   a + (ok ? (size_t)row * K + (size_t)c0 * 32 + c * 16 : 0),
                   ok);
      }
      // weights: slot word (b, n, q) = wp[b, c0 + q, n0 + n]
      const uint32_t wd = Ws + slot * L::WBYTES;
#pragma unroll
      for (int i = tid; i < BITS * QM_STAGE_WORDS * QM_BN; i += QM_THREADS) {
        const int n = i % QM_BN, q = (i / QM_BN) % QM_STAGE_WORDS;
        const int b = i / (QM_BN * QM_STAGE_WORDS);
        const bool ok = n0 + n < N && c0 + q < kw1;
        cp_async4(wd + ((b * QM_BN + n) * QM_STAGE_WORDS + q) * 4,
                  wp + (ok ? ((size_t)b * KW + c0 + q) * N + n0 + n : 0), ok);
      }
    }
    cp_async_commit();
  };

  int acc[MT / 8][4];
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int s = 0; s < QM_AHEAD; ++s) load_stage(s);

  // the thread's two weight columns (A rows) and nibble shifts
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int sh0 = 4 * t, sh1 = 16 + 4 * t;
  // one stage: wait for it, unpack its A fragments into f (last read by
  // stage s - 2's wgmmas, done) while stage s - 1's wgmmas run, wait for
  // those, start loading stage s + QM_AHEAD into their slot, and issue
  // this stage's wgmmas
  auto stage = [&](uint32_t(&f)[QM_STAGE_WORDS][4], int s) {
    cp_async_wait<QM_AHEAD - 1>();   // stage s has landed
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int slot = s % QM_STAGES;
    const uint32_t wsl = Ws + slot * L::WBYTES;
#pragma unroll
    for (int q = 0; q < QM_STAGE_WORDS; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[q][j] = 0u;
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
      const uint32_t coef = plane_coef(b, BITS, true);
      uint32_t w0[QM_STAGE_WORDS], w1[QM_STAGE_WORDS];
      lds128(w0, wsl + (b * QM_BN + r0) * QM_STAGE_WORDS * 4);
      lds128(w1, wsl + (b * QM_BN + r1) * QM_STAGE_WORDS * 4);
#pragma unroll
      for (int q = 0; q < QM_STAGE_WORDS; ++q) {
        f[q][0] += spread4(w0[q] >> sh0) * coef;  // row r0, k 4t..4t+3
        f[q][1] += spread4(w1[q] >> sh0) * coef;  // row r1, k 4t..4t+3
        f[q][2] += spread4(w0[q] >> sh1) * coef;  // row r0, k 16+4t..
        f[q][3] += spread4(w1[q] >> sh1) * coef;  // row r1, k 16+4t..
      }
    }
    wg_wait<0>();     // stage s - 1's wgmmas are done, in every warp:
    __syncthreads();  // their slot takes stage s + QM_AHEAD
    load_stage(s + QM_AHEAD);
    const int nks = min(QM_STAGE_WORDS, kw1 - (kw0 + s * QM_STAGE_WORDS));
    const uint32_t asl = As + slot * L::ABYTES;
    // the fragments are complete before the fence: no unpack instruction
    // lands between this stage's wgmmas (ptxas would serialize them)
#pragma unroll
    for (int q = 0; q < QM_STAGE_WORDS; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[q][j])::"memory");
    wg_fence();
#pragma unroll
    for (int q = 0; q < QM_STAGE_WORDS; ++q)
      if (q < nks) wg_s8<MT>(acc, f[q], wg_desc(asl + q * 32));
    wg_commit();
  };

  uint32_t f0[QM_STAGE_WORDS][4], f1[QM_STAGE_WORDS][4];
  for (int s = 0; s < nst; s += 2) {
    stage(f0, s);
    if (s + 1 < nst) stage(f1, s + 1);
  }
  wg_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(acc[j][e])::"memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // every warp is past its last read of the ring

  // the block's partial tile, part[token][column], over the ring
  int* part = reinterpret_cast<int*>(qm_smem + (As - raw));
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(8 * j + 2 * t + (e & 1)) * QM_PSTR + r0 + 8 * (e >> 1)] =
          acc[j][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster has staged its part
  // block `rank` takes quads (4 columns of one token) rank * 128 + tid +
  // k * 128 * split of the tile and sums each over the parts of blocks
  // 0, 1, ..., split - 1 (plain 16-byte loads through distributed shared
  // memory, all in flight together); a warp's 32 quads are two tokens'
  // 64 columns
  constexpr int QUADS = QM_BN / 4;
  const int rank = (int)cluster.block_rank();
  const bool vec = N % 4 == 0;  // rows of `out` are 16-byte aligned
#pragma unroll 2
  for (int i = tid + rank * QM_THREADS; i < MT * QUADS;
       i += QM_THREADS * split) {
    const int tok = i / QUADS, n = (i % QUADS) * 4;
    const int m = m0 + tok, col = n0 + n;
    if (m >= M || col >= N) continue;
    int* src = part + tok * QM_PSTR + n;
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < QM_MAX_SPLIT; ++q) {
      if (q < split) {
        const int4 v = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(src, q));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    float* dst = out + (size_t)m * N + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4((float)sum.x * scale[col], (float)sum.y * scale[col + 1],
                      (float)sum.z * scale[col + 2],
                      (float)sum.w * scale[col + 3]);
    } else {
      const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < N) dst[c] = (float)s4[c] * scale[col + c];
    }
  }
  cluster.sync();  // the parts stay until every block has read them
}

template <int MT, int BITS>
static int launch(const int8_t* a, const uint32_t* wp, const float* scale,
                  float* out, int M, int K, int N, int sms,
                  cudaStream_t stream) {
  using L = QmLayout<MT, BITS>;
  auto* kernel = quant_matmul_kernel<MT, BITS>;
  static bool set[HOPPER_MAX_DEVICES] = {};
  cudaError_t e = (cudaError_t)smem_attribute_once(kernel, set, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (N + QM_BN - 1) / QM_BN, mtiles = (M + MT - 1) / MT;
  // split K until there are QM_BLOCKS_PER_SM blocks an SM, at most
  // QM_MAX_SPLIT ways and at least one word a part
  const int tiles = ntiles * mtiles, kw = K / 32;
  int split = (QM_BLOCKS_PER_SM * sms + tiles - 1) / tiles;
  split = split < 1 ? 1 : split;
  split = split > QM_MAX_SPLIT ? QM_MAX_SPLIT : split;
  split = split > kw ? kw : split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntiles, mtiles, split);
  cfg.blockDim = dim3(QM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a, wp, scale, out, M, K, N);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int MT>
static int launch_bits(int bits, const int8_t* a, const uint32_t* wp,
                       const float* s, float* o, int M, int K, int N, int sms,
                       cudaStream_t st) {
  switch (bits) {
    case 1: return launch<MT, 1>(a, wp, s, o, M, K, N, sms, st);
    case 2: return launch<MT, 2>(a, wp, s, o, M, K, N, sms, st);
    case 3: return launch<MT, 3>(a, wp, s, o, M, K, N, sms, st);
    case 4: return launch<MT, 4>(a, wp, s, o, M, K, N, sms, st);
    case 5: return launch<MT, 5>(a, wp, s, o, M, K, N, sms, st);
    case 6: return launch<MT, 6>(a, wp, s, o, M, K, N, sms, st);
    case 7: return launch<MT, 7>(a, wp, s, o, M, K, N, sms, st);
    case 8: return launch<MT, 8>(a, wp, s, o, M, K, N, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a and out 16-byte aligned (16-byte activation copies, float4 stores
// where N % 4 == 0); wp and scale 4-byte aligned.  Launch on `stream`; returns the first
// CUDA error (0 = launched).
extern "C" int quant_matmul_launch(const void* a, const void* wp,
                                   const void* scale, void* out, int M, int K,
                                   int N, int bits, void* stream) {
  if (M < 1 || N < 1 || K < 32 || K % 32 || bits < 1 ||
      bits > QM_MAX_BITS || (uintptr_t)a % 16 || (uintptr_t)out % 16 ||
      (M + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = device_sm_count(&sms);
  if (e != 0) return e;
  const int8_t* A = (const int8_t*)a;
  const uint32_t* W = (const uint32_t*)wp;
  const float* S = (const float*)scale;
  float* O = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 8) return launch_bits<8>(bits, A, W, S, O, M, K, N, sms, st);
  if (M <= 64) return launch_bits<64>(bits, A, W, S, O, M, K, N, sms, st);
  return launch_bits<128>(bits, A, W, S, O, M, K, N, sms, st);
}

// Flash attention (online softmax, causal or full) for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).  q, k, v, out are (BH, S, hd) row-major, float32 or
// bfloat16; out has q's type.  For each query row r of each head:
//     s_j   = (q_r . k_j) * hd^-0.5          in float32, in that order
//     s_j   = -1e30 where causal and j > r   (NEG_INF of the reference)
//     out_r = sum_j softmax(s)_j v_j, the denominator clamped at 1e-30
// computed with the online softmax (running max m, sum l, accumulator).
//
// What bounds it: 4*BH*S*S*hd flops (about half of that under causal) on
// 4*BH*S*hd elements, so the tensor-core rate bounds the work at
// qwen2-0.5b's (14, 1024, 64): the bf16 rate for bfloat16, and for
// float32 three TF32 products per product at the TF32 rate (the quickest
// float32-accurate route, 2.5x the SIMT float32 rate); at the main path's
// (14, 128, 64) it is the 28 tiles of 64 rows, which leave most of the
// 132 SMs idle.
//
// Design: one warpgroup (four warps) owns a tile of 64 query rows of one
// head, 16 rows a warp, and walks the keys in tiles of 64 from key 0
// upwards.  K and V tiles stream through a ring in shared memory fed by
// cp.async, so later tiles load while this one is multiplied; Q is loaded
// once.  The scores, the online-softmax state (m, l, alpha, in float32)
// and the accumulator stay in registers, and the scores' C fragments are
// P's A fragments: no trip through shared memory.
//   bfloat16 (the main path's type): wgmma, a ring of 4 stages.  S = Q.K^T
//     is m64n64k16 with both operands in shared memory, K-major as Q and K
//     are stored, in the 128-byte swizzle the descriptors name; P.V takes
//     P from registers and V as an N-major B (transposed in the
//     descriptor).  The softmax of one key tile runs while P.V of the
//     previous tile is on the tensor cores.  P is split into bf16 hi and
//     lo (hi = bf16(p), lo = bf16(p - hi)), two wgmmas into one float32
//     accumulator: P rounded to one bf16 (or to TF32) moves outputs by
//     more than one bf16 step of the reference.  hd 32 and 96 are padded
//     to 64 and 128 in shared memory (zeros).
//   float32: mma.sync m16n8k8 in 3xTF32, a ring of 2 stages (4 would not
//     fit at hd = 128), x = hi + lo with both rounded by
//     cvt.rna (the tensor core would truncate), summing lo.hi + hi.lo +
//     hi.hi for Q.K^T and for P.V; one TF32 product is off by ~1e-3.
//     The k index of each m16n8k8 is permuted (slot t <-> 2t, t+4 <->
//     2t+1) so the scores' C fragments are P's A fragments and Q and K
//     load as float2.  TF32 wgmma would need V transposed in shared memory.
// Under causal the grid runs the heaviest query tiles first, and a tile
// stops after the key tile that holds its last row's diagonal: the
// skipped tiles are fully masked for every row of the tile, and a masked
// score contributes exp(-1e30 - m) = 0 to a row whose running max m is
// finite, which it is from the first tile on because key 0 is never
// masked.  So skipping them does not change the output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define FA_ROWS 64  // query rows per block, 16 per warp
#define FA_KEYS 64  // keys per tile
#define FA_THREADS 128
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, each rounded to TF32 to nearest (ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
// (x, y) = hi + lo as two bf16 pairs, x in the low half
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The online softmax of one key tile, shared by both kernels.  s[j][e] is
// the raw score of row wrow + g + 8 * (e >> 1) and key t0 + 8j + 2t +
// (e & 1) (the C layout of mma.sync and of wgmma); on return it holds p,
// m is the new running max, l the thread's partial sum (its keys of the
// two rows: the quad's four partials add up at the end) and alpha the
// factor the accumulator must take.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], int t0,
                                               int wrow, int S, float scale,
                                               int causal) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool masked = t0 + 8 * NT > S || (causal && t0 + 8 * NT - 1 > wrow);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale;
      if (masked) {
        const int key = t0 + 8 * j + 2 * t + (e & 1);
        const int row = wrow + g + 8 * (e >> 1);
        if (key >= S || (causal && key > row)) x = FA_NEG_INF;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = __expf(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[j][e] - mx[e >> 1]);
      s[j][e] = p;
      ps[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
}

// out row = acc / max(l, 1e-30) for the thread's two rows; acc(d, e) is
// column 8d + 2t + (e & 1) of row wrow + g + 8 * (e >> 1), for d < DT;
// columns past HD (padding) are not written
template <typename T, int HD, int DT, typename Acc>
__device__ __forceinline__ void store_rows(T* o, Acc acc, float (&l)[2],
                                           int wrow, int S) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wrow + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + (size_t)row * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT && 8 * d < HD; ++d) {
      const float x = acc(d, 2 * r) / denom, y = acc(d, 2 * r + 1) / denom;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
            __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(orow + 8 * d) = make_float2(x, y);
    }
  }
}

// Block i takes head i % bh and query tile (tiles - 1 - i / bh), so the
// grid runs every head's heaviest causal tiles first.
struct FaTile {
  int row0, ntiles;
  size_t base;
  __device__ FaTile(int bh, int S, int HD, int causal) {
    const int tiles = (S + FA_ROWS - 1) / FA_ROWS;
    row0 = (tiles - 1 - (int)(blockIdx.x / bh)) * FA_ROWS;
    base = (size_t)(blockIdx.x % bh) * S * HD;
    const int nkeys = causal ? min(S, row0 + FA_ROWS) : S;
    ntiles = (nkeys + FA_KEYS - 1) / FA_KEYS;
  }
};

// ---------------------------------------------------------------------------
// bfloat16: wgmma
// ---------------------------------------------------------------------------
// A bf16 tile of 64 rows lives in shared memory as NB blocks of 64 columns,
// each 64 rows x 128 B in the 128-byte swizzle wgmma reads: 16-byte chunk
// c of row r at r * 128 + ((c ^ (r % 8)) * 16), 8-row groups 1024 B apart,
// every block 1024-byte aligned.
#define WG_BLOCK 8192  // bytes of one 64 x 64 bf16 block

__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait<0>();
}
// after wgmma.wait_group: reads of d stay below it
__device__ __forceinline__ void wg_settle(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

#define WG_D32(d)                                                           \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]),             \
      "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]),             \
      "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]),             \
      "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),             \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),             \
      "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]),             \
      "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WG_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, float32) += A (64 x 16, smem, K-major) . B (64 x 16, smem,
// K-major)^T; d[j][e] in the C layout of online_softmax
__device__ __forceinline__ void wg_ss(float (&d)[8][4], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64, float32) += A (64 x 16, registers: the warp's 16 rows in
// mma.sync's m16n8k16 A layout) . B (16 x 64, smem, N-major: row k holds
// B[k][0..63]), the descriptor read transposed
__device__ __forceinline__ void wg_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// rows [row0, row0 + 64) of a (S, HD) bf16 matrix into a swizzled tile at
// shared address dst; rows past S are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows_sw(uint32_t dst,
                                             const __nv_bfloat16* src,
                                             int row0, int S) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += FA_THREADS) {
    const int r = i / CH, c = i % CH, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + (c >> 3) * WG_BLOCK + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               src + (size_t)(ok ? row : 0) * HD + c * 8, ok);
  }
}

#define WG_STAGES 4  // ring of K/V tiles: tile j in stage j % 4

template <int HD>
struct WgLayout {
  static constexpr int NB = (HD + 63) / 64;  // 64-column blocks
  static constexpr int TILE = NB * WG_BLOCK;
  // Q, the K and V stages, and slack to align the base to 1024 B
  static constexpr int BYTES = (1 + 2 * WG_STAGES) * TILE + 1024;
};

// P.V of one key tile: acc += (ph + pl) . V, k steps of 16 keys (2048 B
// of V rows), V's 64-column blocks b at Vt + b * WG_BLOCK
template <int NB>
__device__ __forceinline__ void wg_pv(float (&acc)[NB][8][4],
                                      const uint32_t (&ph)[4][4],
                                      const uint32_t (&pl)[4][4],
                                      uint32_t Vt) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint64_t dv = wg_desc(Vt + b * WG_BLOCK + c * 2048);
      wg_rs(acc[b], pl[c], dv);
      wg_rs(acc[b], ph[c], dv);
    }
}

// Software pipeline of one warpgroup over key tiles j = 0, 1, ...: at the
// top of step j tile j has landed, tile j + 2 starts loading, and the
// tensor cores take S_j = Q K_j^T and then P_{j-1} V_{j-1}; the softmax of
// S_j runs while P_{j-1} V_{j-1} is still in flight, and the accumulator
// takes alpha_j once that product is done.  The ring has 4 stages: step j
// reads tiles j and j - 1 and loads j + 2 into the stage of j - 2, whose
// last reader finished before the barrier that opens step j.
template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_bf16(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int bh, int S,
                     float scale, int causal) {
  using L = WgLayout<HD>;
  constexpr int NB = L::NB;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  const uint32_t Qs = (smem_addr(fa_smem) + 1023u) & ~1023u;
  const uint32_t Ks = Qs + L::TILE, Vs = Ks + WG_STAGES * L::TILE;
  const int warp = threadIdx.x / 32;
  const FaTile tl(bh, S, HD, causal);
  const int wrow = tl.row0 + 16 * warp;  // the warp's first query row
  const __nv_bfloat16* kh = k + tl.base;
  const __nv_bfloat16* vh = v + tl.base;
  auto load_tile = [&](int j) {  // K and V tile j into stage j % 4
    if (j < tl.ntiles) {
      const uint32_t st = (j % WG_STAGES) * L::TILE;
      load_rows_sw<HD>(Ks + st, kh, j * FA_KEYS, S);
      load_rows_sw<HD>(Vs + st, vh, j * FA_KEYS, S);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  if constexpr (HD % 64 != 0) {  // padding columns read as zeros
    for (uint32_t a = Qs + 16 * threadIdx.x; a < Qs + L::BYTES - 1024;
         a += 16 * FA_THREADS)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a),
                   "r"(0)
                   : "memory");
    __syncthreads();
  }
  load_rows_sw<HD>(Qs, q + tl.base, tl.row0, S);
  load_tile(0);
  load_tile(1);

  float acc[NB][8][4];  // columns 64b + 8j + 2t + (e & 1) at acc[b][j][e]
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][j][e] = 0.f;
  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t ph[4][4], pl[4][4];  // P_{j-1} as bf16 hi + lo, A fragments

  for (int j = 0; j < tl.ntiles; ++j) {
    cp_async_wait<1>();  // tile j has landed (j + 1 may be in flight)
    // cp.async and st.shared wrote through the generic proxy; wgmma reads
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_tile(j + 2);
    const uint32_t Kt = Ks + (j % WG_STAGES) * L::TILE;

    // S_j = Q K_j^T: k steps of 16 columns, 32 B apart in a swizzled row
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks >> 2) * WG_BLOCK + (ks & 3) * 32;
      wg_ss(s, wg_desc(Qs + off), wg_desc(Kt + off));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (j > 0) {
      wg_pv<NB>(acc, ph, pl, Vs + ((j - 1) % WG_STAGES) * L::TILE);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    wg_settle(s);

    float alpha[2];
    online_softmax<8>(s, m, l, alpha, j * FA_KEYS, wrow, S, scale, causal);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int b = 0; b < NB; ++b) wg_settle(acc[b]);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][i][e] *= alpha[e >> 1];
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 keys: n-tiles 2c, 2c + 1
      split_bf16(s[2 * c][0], s[2 * c][1], ph[c][0], pl[c][0]);
      split_bf16(s[2 * c][2], s[2 * c][3], ph[c][1], pl[c][1]);
      split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], ph[c][2], pl[c][2]);
      split_bf16(s[2 * c + 1][2], s[2 * c + 1][3], ph[c][3], pl[c][3]);
    }
  }
  wg_fence();
  wg_pv<NB>(acc, ph, pl, Vs + ((tl.ntiles - 1) % WG_STAGES) * L::TILE);
  wg_commit_wait();
#pragma unroll
  for (int b = 0; b < NB; ++b) wg_settle(acc[b]);
  store_rows<__nv_bfloat16, HD, NB * 8>(
      o + tl.base, [&](int d, int e) { return acc[d >> 3][d & 7][e]; }, l,
      wrow, S);
}

// ---------------------------------------------------------------------------
// float32: mma.sync, 3xTF32
// ---------------------------------------------------------------------------
template <int HD>
struct TfLayout {
  // row strides (floats), padded so the fragments' float2 (Q, K) and
  // float (V) loads hit 32 distinct banks
  static constexpr int QSTR = HD + 8, KSTR = HD + 8, VSTR = HD + 4;
  static constexpr int BYTES =
      (FA_ROWS * QSTR + 2 * FA_KEYS * (KSTR + VSTR)) * 4;
};

// rows [row0, row0 + 64) of a (S, HD) float32 matrix into smem (stride
// STR); rows past S are zero-filled
template <int HD, int STR>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  constexpr int CH = HD / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += FA_THREADS) {
    const int r = i / CH, c = i % CH, row = row0 + r;
    const bool ok = row < S;
    cp_async16(smem_addr(dst + r * STR + c * 4),
               src + (size_t)(ok ? row : 0) * HD + c * 4, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int bh, int S, float scale, int causal) {
  using L = TfLayout<HD>;
  constexpr int NT = FA_KEYS / 8;  // score n-tiles of 8 keys
  constexpr int DT = HD / 8;       // accumulator n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);
  float* Ks = Qs + FA_ROWS * L::QSTR;
  float* Vs = Ks + 2 * FA_KEYS * L::KSTR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const FaTile tl(bh, S, HD, causal);
  const int wrow = tl.row0 + 16 * warp;
  const float* kh = k + tl.base;
  const float* vh = v + tl.base;

  load_rows<HD, L::QSTR>(Qs, q + tl.base, tl.row0, S);
  load_rows<HD, L::KSTR>(Ks, kh, 0, S);
  load_rows<HD, L::VSTR>(Vs, vh, 0, S);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < tl.ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tl.ntiles) {
      load_rows<HD, L::KSTR>(Ks + (st ^ 1) * FA_KEYS * L::KSTR, kh,
                             (it + 1) * FA_KEYS, S);
      load_rows<HD, L::VSTR>(Vs + (st ^ 1) * FA_KEYS * L::VSTR, vh,
                             (it + 1) * FA_KEYS, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * FA_KEYS * L::KSTR;
    const float* Vt = Vs + st * FA_KEYS * L::VSTR;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(
          Qs + (16 * warp + g) * L::QSTR + 8 * kk + 2 * t);
      const float2 x1 = *reinterpret_cast<const float2*>(
          Qs + (16 * warp + g + 8) * L::QSTR + 8 * kk + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(x0.x, ah[0], al[0]);
      split_tf32(x1.x, ah[1], al[1]);
      split_tf32(x0.y, ah[2], al[2]);
      split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(
            Kt + (8 * j + g) * L::KSTR + 8 * kk + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(y.x, bh0, bl0);
        split_tf32(y.y, bh1, bl1);
        mma_tf32(s[j], al, bh0, bh1);
        mma_tf32(s[j], ah, bl0, bl1);
        mma_tf32(s[j], ah, bh0, bh1);
      }
    }

    float alpha[2];
    online_softmax<NT>(s, m, l, alpha, it * FA_KEYS, wrow, S, scale, causal);
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];

#pragma unroll
    for (int j = 0; j < NT; ++j) {  // 8 keys; slot t <-> 2t, t+4 <-> 2t+1
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(Vt[(8 * j + 2 * t) * L::VSTR + 8 * d + g], bh0, bl0);
        split_tf32(Vt[(8 * j + 2 * t + 1) * L::VSTR + 8 * d + g], bh1, bl1);
        mma_tf32(acc[d], pl, bh0, bh1);
        mma_tf32(acc[d], ph, bl0, bl1);
        mma_tf32(acc[d], ph, bh0, bh1);
      }
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }
  store_rows<float, HD, DT>(
      o + tl.base, [&](int d, int e) { return acc[d][e]; }, l, wrow, S);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// Launch `kernel` with `smem` bytes of dynamic shared memory; `set`
// records the devices its attribute was set on.
template <typename T, typename K>
static int launch_kernel(K* kernel, bool (&set)[HOPPER_MAX_DEVICES],
                         int smem, const void* q, const void* k,
                         const void* v, void* o, int bh, int S, float scale,
                         int causal, cudaStream_t st) {
  const int e = smem_attribute_once(kernel, set, smem);
  if (e != 0) return e;
  const unsigned blocks = (unsigned)bh * ((S + FA_ROWS - 1) / FA_ROWS);
  kernel<<<blocks, FA_THREADS, smem, st>>>((const T*)q, (const T*)k,
                                           (const T*)v, (T*)o, bh, S, scale,
                                           causal);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_hd(int dtype, const void* q, const void* k, const void* v,
                     void* o, int bh, int S, float scale, int causal,
                     cudaStream_t st) {
  static bool set_f32[HOPPER_MAX_DEVICES] = {},
              set_bf16[HOPPER_MAX_DEVICES] = {};
  if (dtype == 0)
    return launch_kernel<float>(flash_attention_f32<HD>, set_f32,
                                TfLayout<HD>::BYTES, q, k, v, o, bh, S, scale,
                                causal, st);
  return launch_kernel<__nv_bfloat16>(flash_attention_bf16<HD>, set_bf16,
                                      WgLayout<HD>::BYTES, q, k, v, o, bh, S,
                                      scale, causal, st);
}

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o 16-byte aligned.  Launch
// on `stream`; returns the first CUDA error (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int S,
                                      int hd, int dtype, int causal,
                                      float scale, void* stream) {
  if (bh < 1 || bh > 65535 || S < 1 || (dtype != 0 && dtype != 1) ||
      (long long)bh * ((S + FA_ROWS - 1) / FA_ROWS) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch_hd<32>(dtype, q, k, v, o, bh, S, scale, causal, st);
    case 64: return launch_hd<64>(dtype, q, k, v, o, bh, S, scale, causal, st);
    case 96: return launch_hd<96>(dtype, q, k, v, o, bh, S, scale, causal, st);
    case 128:
      return launch_hd<128>(dtype, q, k, v, o, bh, S, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

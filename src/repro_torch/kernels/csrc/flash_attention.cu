// Flash attention (online softmax, causal or full) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel).  q, k, v, out are (BH, S, hd) row-major, float32 or
// bfloat16; out has q's type.  For each query row r of each head:
//     s_j   = (q_r . k_j) * hd^-0.5          in float32, in that order
//     s_j   = -1e30 where causal and j > r   (NEG_INF of the reference)
//     out_r = sum_j softmax(s)_j v_j, the denominator clamped at 1e-30
// computed with the online softmax (running max m, sum l, accumulator).
//
// Design: one warp per query row, 8 rows (warps) per thread block, and
// the block walks the keys in tiles of 32, always from key 0 upwards.  A
// tile of K and V (as float32) is staged in shared memory and shared by
// the block's 8 rows; lane j scores key j of the tile against the row's
// q (in shared memory), the warp reduces the tile's max and sum with
// shuffles, and lane l keeps accumulator elements l, l+32, ... of the
// row (hd <= 128, so at most 4 registers).  Under causal the block stops
// after the tile that holds its last row's diagonal: the skipped tiles are
// fully masked for every row of the block, and a masked score contributes
// exp(-1e30 - m) = 0 to a row whose running max m is finite, which it is
// from the first tile on because key 0 is never masked.  So skipping them
// does not change the output.
//
// What bounds it: 4*BH*S*S*hd flops (about half of that under causal) on
// 4*BH*S*hd elements; at qwen2-0.5b's shapes (BH = 14, S = 1024, hd = 64)
// the float32 rate (no tensor cores) bounds the work.  This kernel runs
// its dot products on the FMA pipes, one row per warp, and issues two
// shared-memory loads per score FMA and one per accumulator FMA, so the
// shared-memory load rate bounds the kernel.  wgmma tiles of 64 rows, with
// q and the scores in registers, are the later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_WARPS 8
#define FA_TILE 32
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <typename T, int R>  // hd = 32 * R
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       float scale, int causal) {
  constexpr int HD = 32 * R;
  __shared__ float ks[FA_TILE][HD + 1];  // padded: lane j reads row j
  __shared__ float vs[FA_TILE][HD];
  __shared__ float qs[FA_WARPS][HD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * FA_WARPS;
  const int row = row0 + warp;
  const size_t base = (size_t)blockIdx.y * S * HD;

#pragma unroll
  for (int r = 0; r < R; ++r)
    qs[warp][lane + 32 * r] =
        (row < S) ? to_f32(q[base + (size_t)row * HD + lane + 32 * r]) : 0.f;

  float m = FA_NEG_INF, l = 0.f, acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  const int last_row = min(S, row0 + FA_WARPS);  // one past the block's rows
  const int nkeys = causal ? last_row : S;
  for (int t0 = 0; t0 < nkeys; t0 += FA_TILE) {
    __syncthreads();  // the previous tile is consumed; qs is written
    for (int i = threadIdx.x; i < FA_TILE * HD; i += FA_WARPS * 32) {
      const int j = i / HD, d = i % HD, key = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < S) {
        kv = to_f32(k[base + (size_t)key * HD + d]);
        vv = to_f32(v[base + (size_t)key * HD + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();

    const int key = t0 + lane;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) s = fmaf(qs[warp][d], ks[lane][d], s);
    s = s * scale;
    if (key >= S || (causal && key > row)) s = FA_NEG_INF;

    float tmax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    const float p = expf(s - m_new);
    const float alpha = expf(m - m_new);
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] *= alpha;
#pragma unroll 8
    for (int j = 0; j < FA_TILE; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(pj, vs[j][lane + 32 * r], acc[r]);
    }
    m = m_new;
  }
  if (row < S) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int r = 0; r < R; ++r)
      o[base + (size_t)row * HD + lane + 32 * r] = from_f32<T>(acc[r] / denom);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, int bh,
                  int S, int hd, float scale, int causal, cudaStream_t st) {
  const dim3 grid((S + FA_WARPS - 1) / FA_WARPS, bh);
  const T* Q = (const T*)q;
  const T* K = (const T*)k;
  const T* V = (const T*)v;
  T* O = (T*)o;
  switch (hd) {
    case 32:
      flash_attention_kernel<T, 1><<<grid, FA_WARPS * 32, 0, st>>>(
          Q, K, V, O, S, scale, causal);
      break;
    case 64:
      flash_attention_kernel<T, 2><<<grid, FA_WARPS * 32, 0, st>>>(
          Q, K, V, O, S, scale, causal);
      break;
    case 96:
      flash_attention_kernel<T, 3><<<grid, FA_WARPS * 32, 0, st>>>(
          Q, K, V, O, S, scale, causal);
      break;
    case 128:
      flash_attention_kernel<T, 4><<<grid, FA_WARPS * 32, 0, st>>>(
          Q, K, V, O, S, scale, causal);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  Launch on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int S,
                                      int hd, int dtype, int causal,
                                      float scale, void* stream) {
  if (bh < 1 || bh > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, o, bh, S, hd, scale, causal, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, bh, S, hd, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

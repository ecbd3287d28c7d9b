// One time chunk of the linear recurrence that Mamba's selective SSM and
// RecurrentGemma's RG-LRU share (models/recurrence.py):
//
//   h_t = a_t * h_{t-1} + b_t        for every lane of a (B, T, D) chunk,
//
// bit for bit as the plain version computes it: the Hillis-Steele inclusive
// scan of (a, b) under (a1, b1) o (a2, b2) = (a1 * a2, a2 * b1 + b2), one
// doubling round after another (d = 1, 2, 4, ... while d < T; step t >= d
// combines step t - d of the previous round with step t), each product and
// each sum rounded on its own (no fused multiply-add), then
//
//   out_t = pa_t * h0 + pb_t.
//
// A block holds 32 consecutive lanes of one batch row and the whole chunk
// (T <= LS_MAX_T) in shared memory. A thread is one lane (threadIdx.x, so a
// warp reads 32 consecutive floats of a time step) and one of LS_GROUPS time
// groups (threadIdx.y: steps y, y + LS_GROUPS, ...). A round reads the
// steps it combines into registers, waits at a barrier, then writes them,
// so every step reads the previous round's values. The chunk's a and b are
// read once from device memory and out is written once; the plain version
// moves the chunk through device memory some dozen times a round.
//
//   a, b   (B, T, D) float32, strides (a_bs, a_ts, 1) and (b_bs, b_ts, 1)
//   h0     (B, D) float32, strides (h_bs, 1)
//   out    (B, T, D) float32, contiguous

#include <cuda_runtime.h>

#define LS_LANES 32                          // lanes a block
#define LS_GROUPS 8                          // time groups a block
#define LS_MAX_T 256                         // longest chunk
#define LS_PER (LS_MAX_T / LS_GROUPS)        // steps a thread
#define LS_SMEM (2 * LS_MAX_T * LS_LANES * (int)sizeof(float))

__global__ void __launch_bounds__(LS_LANES * LS_GROUPS)
linear_scan_chunk(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int T, long long D, long long a_bs, long long a_ts,
                  long long b_bs, long long b_ts, long long h_bs) {
  extern __shared__ float ls_smem[];
  float* sa = ls_smem;                       // [t * LS_LANES + lane]
  float* sb = ls_smem + LS_MAX_T * LS_LANES;
  const int x = threadIdx.x, y = threadIdx.y;
  const long long col = (long long)blockIdx.x * LS_LANES + x;
  const long long row = blockIdx.y;
  const bool live = col < D;
  const float* ar = a + row * a_bs + col;
  const float* br = b + row * b_bs + col;
#pragma unroll
  for (int k = 0; k < LS_PER; ++k) {
    const int t = y + k * LS_GROUPS;
    if (t < T) {
      sa[t * LS_LANES + x] = live ? ar[t * a_ts] : 1.f;
      sb[t * LS_LANES + x] = live ? br[t * b_ts] : 0.f;
    }
  }
  __syncthreads();
  float na[LS_PER], nb[LS_PER];
  for (int d = 1; d < T; d *= 2) {
#pragma unroll
    for (int k = 0; k < LS_PER; ++k) {
      const int t = y + k * LS_GROUPS;
      if (t >= d && t < T) {
        const float a1 = sa[(t - d) * LS_LANES + x];
        const float b1 = sb[(t - d) * LS_LANES + x];
        const float a2 = sa[t * LS_LANES + x];
        const float b2 = sb[t * LS_LANES + x];
        na[k] = __fmul_rn(a1, a2);
        nb[k] = __fadd_rn(__fmul_rn(a2, b1), b2);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < LS_PER; ++k) {
      const int t = y + k * LS_GROUPS;
      if (t >= d && t < T) {
        sa[t * LS_LANES + x] = na[k];
        sb[t * LS_LANES + x] = nb[k];
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const float h = h0[row * h_bs + col];
  float* orow = out + row * (long long)T * D + col;
#pragma unroll
  for (int k = 0; k < LS_PER; ++k) {
    const int t = y + k * LS_GROUPS;
    if (t < T)
      orow[(long long)t * D] =
          __fadd_rn(__fmul_rn(sa[t * LS_LANES + x], h), sb[t * LS_LANES + x]);
  }
}

// Launches the chunk scan on `stream`; returns the CUDA error code (0 when
// the launch was taken).
extern "C" int linear_scan_launch(const void* a, const void* b,
                                  const void* h0, void* out, int B, int T,
                                  long long D, long long a_bs, long long a_ts,
                                  long long b_bs, long long b_ts,
                                  long long h_bs, void* stream) {
  if (B < 1 || T < 1 || T > LS_MAX_T || D < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      linear_scan_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, LS_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((D + LS_LANES - 1) / LS_LANES), (unsigned)B);
  const dim3 block(LS_LANES, LS_GROUPS);
  linear_scan_chunk<<<grid, block, LS_SMEM, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)out, T, D,
      a_bs, a_ts, b_bs, b_ts, h_bs);
  return (int)cudaGetLastError();
}

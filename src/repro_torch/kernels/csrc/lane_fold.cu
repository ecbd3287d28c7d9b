// Positional-popcount lane fold for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitplane_ops.py::lane_fold_pallas
// (body _lane_fold_kernel).  Input x is (m, T, W) 32-bit words: plane i
// of lane t, word column w.  Each of the 32 bit positions of a word is
// one simulated Compute RAM column, so x[:, t, w] holds 32 independent
// m-bit integers.  The kernel writes out[i, w] = plane i of
//     sum_t x[:, t, w]  mod 2^width
// for every column: the dot-product accumulator of the idot programs.
//
// What bounds it: it reads m*T*W*4 bytes and writes width*W*4 bytes, and
// does ~5*width*T word operations per column, so the work is a fraction
// of a microsecond at the main path's sizes (m = 8 planes read, width =
// 15, T = 57, W = 160: 0.30 MB).  What takes the time is latency: a
// column's lanes walked in sequence by one thread are a chain of T
// device-memory round trips (0.055 ms on an H100 for a design with one
// thread a column), and 160 columns fill only 3 blocks of such threads.
//
// Design: put every load in flight at once and make the serial chain
// log-depth in T.  A block owns LF_WORDS word columns and LF_GROUPS lane
// groups (thread = group g, column w); group g takes lanes g, g + G,
// g + 2G, ... (G = LF_GROUPS), issues the loads of LB lanes before the
// adds that consume them, and ripple-adds them into `width` accumulator
// planes in registers (s = a^b^c, c = (a&b)|(c&(a^b)), truncated to
// `width` planes).  The groups' partial sums then meet in a shared-memory
// tree: at each level the upper half of the live groups hand their planes
// to the lower half, which ripple-adds them.  Modular addition is
// associative and commutative, so this order gives the bits of the
// reference's pairwise tree.  Eight columns a block spread the main
// path's 160 words over 20 SMs; a warp (8 columns x 4 groups) reads four
// full 32-byte sectors per load.  The accumulator width is a compile-time
// bucket (8, 16 or 32 planes), so the planes are registers.
#include <cuda_runtime.h>
#include <stdint.h>

#define LANE_FOLD_MAX_WIDTH 32
#define LF_WORDS 8                          // word columns per block
#define LF_GROUPS 32                        // lane groups per block
#define LF_THREADS (LF_WORDS * LF_GROUPS)   // thread = group * LF_WORDS + col

// acc += b over planes [0, width): a ripple add mod 2^width
template <int MAXW>
__device__ __forceinline__ void ripple_add(uint32_t (&acc)[MAXW],
                                           const uint32_t (&b)[MAXW],
                                           int width) {
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i < width) {
      const uint32_t a = acc[i];
      const uint32_t axb = a ^ b[i];
      acc[i] = axb ^ c;
      c = (a & b[i]) | (c & axb);
    }
  }
}

// MAXW: accumulator planes (>= width); LB: lanes whose loads a thread
// issues before their adds
template <int MAXW, int LB>
__global__ void __launch_bounds__(LF_THREADS)
lane_fold_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int m, int lanes, int words, int width) {
  // partial sums handed down the tree; row stride padded so that the four
  // groups of a warp write 32 distinct banks
  constexpr int PSTR = MAXW * LF_WORDS + LF_WORDS;
  __shared__ uint32_t part[LF_GROUPS / 2][PSTR];
  const int col = threadIdx.x % LF_WORDS, grp = threadIdx.x / LF_WORDS;
  const int w = blockIdx.x * LF_WORDS + col;
  const bool live = w < words;
  const size_t plane_stride = (size_t)lanes * (size_t)words;

  uint32_t acc[MAXW];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) acc[i] = 0u;
  for (int t0 = grp; t0 < lanes; t0 += LB * LF_GROUPS) {
    uint32_t b[LB][MAXW];
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const int t = t0 + j * LF_GROUPS;
      const bool ok = live && t < lanes;
      const uint32_t* xt = x + (size_t)t * words + w;
#pragma unroll
      for (int i = 0; i < MAXW; ++i)
        b[j][i] = (ok && i < m) ? __ldg(xt + i * plane_stride) : 0u;
    }
#pragma unroll
    for (int j = 0; j < LB; ++j) ripple_add<MAXW>(acc, b[j], width);
  }

  // tree over the groups that hold lanes: h = half the next power of two
  int h = 1;
  while (2 * h < min(lanes, LF_GROUPS)) h *= 2;
  if (lanes == 1) h = 0;
  for (; h >= 1; h >>= 1) {
    if (grp >= h && grp < 2 * h) {
#pragma unroll
      for (int i = 0; i < MAXW; ++i)
        if (i < width) part[grp - h][i * LF_WORDS + col] = acc[i];
    }
    __syncthreads();
    if (grp < h) {
      uint32_t b[MAXW];
#pragma unroll
      for (int i = 0; i < MAXW; ++i)
        b[i] = (i < width) ? part[grp][i * LF_WORDS + col] : 0u;
      ripple_add<MAXW>(acc, b, width);
    }
    __syncthreads();
  }
  if (grp == 0 && live) {
#pragma unroll
    for (int i = 0; i < MAXW; ++i)
      if (i < width) out[(size_t)i * words + w] = acc[i];
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int lane_fold_launch(const void* x, void* out, int m, int lanes,
                                int words, int width, void* stream) {
  if (m < 1 || width < m || width > LANE_FOLD_MAX_WIDTH || lanes < 1 ||
      words < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (words + LF_WORDS - 1) / LF_WORDS;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* X = (const uint32_t*)x;
  uint32_t* O = (uint32_t*)out;
  if (width <= 8)
    lane_fold_kernel<8, 8><<<blocks, LF_THREADS, 0, st>>>(X, O, m, lanes,
                                                          words, width);
  else if (width <= 16)
    lane_fold_kernel<16, 4><<<blocks, LF_THREADS, 0, st>>>(X, O, m, lanes,
                                                           words, width);
  else
    lane_fold_kernel<32, 2><<<blocks, LF_THREADS, 0, st>>>(X, O, m, lanes,
                                                           words, width);
  return (int)cudaGetLastError();
}

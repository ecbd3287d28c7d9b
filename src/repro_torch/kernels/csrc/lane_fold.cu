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
// Design: modular addition is associative, so any order of the T adds
// gives the same bits as the reference's pairwise carry-save tree.  One
// thread owns one word column w and keeps the `width` accumulator planes
// in registers; for each lane it ripple-adds the m input planes with the
// bitwise full adder (s = a^b^c, c = (a&b)|(c&(a^b))), truncated to
// `width` planes.  Neighbouring threads read neighbouring words, so every
// load of a warp is one coalesced 128-byte transaction.
//
// What bounds it: it reads m*T*W*4 bytes and writes width*W*4 bytes and
// does ~5*width*T word operations per thread, so it is memory-bound in
// principle; at the main path's sizes (m = width = 15, T = 57, W = 160:
// 0.55 MB) it is launch-bound.  One thread per word also leaves most SMs
// idle there: W = 160 words (128 blocks of 40 columns) fill 3 blocks of
// 64 threads on 3 of 132 SMs.  Splitting the lanes of a column across
// threads and combining their partial sums with a shared-memory tree is
// the later design.
#include <cuda_runtime.h>
#include <stdint.h>

#define LANE_FOLD_MAX_WIDTH 32
#define LANE_FOLD_THREADS 64

__global__ void __launch_bounds__(LANE_FOLD_THREADS)
lane_fold_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 int m, int lanes, int words, int width) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= words) return;
  const size_t plane_stride = (size_t)lanes * (size_t)words;
  uint32_t acc[LANE_FOLD_MAX_WIDTH];
#pragma unroll
  for (int i = 0; i < LANE_FOLD_MAX_WIDTH; ++i) acc[i] = 0u;
  for (int t = 0; t < lanes; ++t) {
    const uint32_t* xt = x + (size_t)t * words + w;
    // issue all m loads of the lane before the adds that consume them,
    // so they are in flight together (loads placed inside the ripple
    // below serialize one memory latency per plane)
    uint32_t b[LANE_FOLD_MAX_WIDTH];
#pragma unroll
    for (int i = 0; i < LANE_FOLD_MAX_WIDTH; ++i)
      b[i] = (i < m) ? __ldg(xt + i * plane_stride) : 0u;
    uint32_t c = 0u;
#pragma unroll
    for (int i = 0; i < LANE_FOLD_MAX_WIDTH; ++i) {
      if (i < width) {
        const uint32_t a = acc[i];
        const uint32_t axb = a ^ b[i];
        acc[i] = axb ^ c;
        c = (a & b[i]) | (c & axb);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LANE_FOLD_MAX_WIDTH; ++i) {
    if (i < width) out[(size_t)i * words + w] = acc[i];
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int lane_fold_launch(const void* x, void* out, int m, int lanes,
                                int words, int width, void* stream) {
  if (m < 1 || width < m || width > LANE_FOLD_MAX_WIDTH || lanes < 1 ||
      words < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (words + LANE_FOLD_THREADS - 1) / LANE_FOLD_THREADS;
  lane_fold_kernel<<<blocks, LANE_FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, m, lanes, words, width);
  return (int)cudaGetLastError();
}

// Block images of one fabric launch, packed on the card.
//
// Replaces no TPU kernel.  The reference packs each launch's block images
// on the host in numpy (repro/pim/fabric.py, execute_program's
// pack_blocks) and hands the whole (blocks, rows, cols) bool image to the
// device.  On the H100 that host pack and the image's pageable copies
// were most of a fabric job's wall, while the card sat idle; this kernel
// writes the image where the engine reads it, from operands that went up
// once a call.
//
// out[s, r, c] (one byte, 0 or 1) for slot s of the launch, row r of a
// block and column c:
//   d = desc[s] = (m, k0, kw, col0, nw, used), code = rowmap[r]
//   0 where !used, code < 0 (a row no operand bit lives in) or i >= kw
//   field a: bit j of x[m, k0 + i]                 (every column)
//   field b: bit j of w[k0 + i, col0 + c] for c < nw, else 0
// with code = (i << FP_TUPLE_SHIFT) | (field b ? FP_FIELD_B : 0) | j: the
// tuple i of the idot layout, the field and the bit j of the row.  x is
// the (M, K) activation and w the (K, ntot) weights of one dtype class,
// its GEMMs side by side; both hold uint8 (classes of <= 8 bits) or
// 32-bit words.  Every byte of the image is written, zeros included, so
// the output needs no memset: a padded slot (used = 0) is all zero.
//
// What bounds it: bytes.  It writes slots * rows * cols bytes once (10.5
// MB at the fabric's launch shape, 512 blocks of 512 x 40: 3.1 us at 3.35
// TB/s) and reads the descriptor, the row map and the operand elements
// that land in the image (a few hundred KB, mostly from L1 and L2).
//
// Design: a thread packs FP_BYTES consecutive columns of one row of one
// slot (a row is ceil(cols / FP_BYTES) threads, a slot rows of those), so
// it reads the row map once and, on a row of field a, one activation
// element whose bit it repeats over its columns; on a row of field b it
// reads its FP_BYTES weight bytes.  A block of FP_THREADS threads covers
// consecutive threads' columns of one slot (blockIdx.x = slot * chunks +
// chunk): all read one descriptor (a broadcast) and, when cols is a
// multiple of FP_BYTES, each stores one 32-bit word, so a warp stores 128
// contiguous bytes; otherwise the stores go byte by byte.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FP_THREADS 256                 // threads per block
#define FP_BYTES 4                     // image bytes (columns) per thread
#define FP_DESC 6                      // int32 fields of a slot descriptor
#define FP_FIELD_B 256                 // row map code: field b (else a)
#define FP_TUPLE_SHIFT 9               // row map code: tuple i above here

template <typename T>
__global__ void __launch_bounds__(FP_THREADS)
fabric_pack_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ desc,
                   const int* __restrict__ rowmap, uint8_t* __restrict__ out,
                   int rows, int cols, int K, int ntot, int chunks) {
  const int s = blockIdx.x / chunks;
  const int chunk = blockIdx.x - s * chunks;
  const int per_row = (cols + FP_BYTES - 1) / FP_BYTES;   // threads a row
  const int t = chunk * FP_THREADS + threadIdx.x;
  if (t >= rows * per_row) return;
  const int r = t / per_row;
  const int c0 = (t - r * per_row) * FP_BYTES;
  const int* d = desc + (size_t)s * FP_DESC;
  const int m = __ldg(d), k0 = __ldg(d + 1), kw = __ldg(d + 2),
            col0 = __ldg(d + 3), nw = __ldg(d + 4), used = __ldg(d + 5);
  const int code = __ldg(rowmap + r);
  const int i = code >> FP_TUPLE_SHIFT;
  uint32_t word = 0u;                  // byte q: the bit of column c0 + q
  if (used && code >= 0 && i < kw) {
    const int k = k0 + i, bit = code & 0xFF;
    if (code & FP_FIELD_B) {
      const T* wr = w + (size_t)k * ntot + col0;
#pragma unroll
      for (int q = 0; q < FP_BYTES; ++q)
        if (c0 + q < nw)
          word |= (((uint32_t)__ldg(wr + c0 + q) >> bit) & 1u) << (8 * q);
    } else {
      word = (((uint32_t)__ldg(x + (size_t)m * K + k) >> bit) & 1u) *
             0x01010101u;
    }
  }
  uint8_t* o = out + ((size_t)s * rows + r) * cols + c0;
  if (cols % FP_BYTES == 0) {
    // every row starts 4-byte aligned: one store, little endian
    *reinterpret_cast<uint32_t*>(o) = word;
  } else {
#pragma unroll
    for (int q = 0; q < FP_BYTES; ++q)
      if (c0 + q < cols) o[q] = (uint8_t)(word >> (8 * q));
  }
}

// x (M, K) and w (K, ntot) of elem_bytes (1: uint8, 4: 32-bit words), desc
// (slots, FP_DESC) int32, rowmap (rows,) int32, out (slots, rows, cols)
// bytes; all contiguous on one device.  Launches on `stream`, no sync;
// returns cudaGetLastError() (cudaErrorInvalidValue on a bad argument).
extern "C" int fabric_pack_launch(const void* x, const void* w,
                                  const void* desc, const void* rowmap,
                                  void* out, int slots, int rows, int cols,
                                  int K, int ntot, int elem_bytes,
                                  void* stream) {
  if (slots < 1 || rows < 1 || cols < 1 || K < 1 || ntot < 1 ||
      (elem_bytes != 1 && elem_bytes != 4) ||
      (long long)rows * cols > INT_MAX - FP_THREADS * FP_BYTES)
    return (int)cudaErrorInvalidValue;
  const int threads = rows * ((cols + FP_BYTES - 1) / FP_BYTES);
  const int chunks = (threads + FP_THREADS - 1) / FP_THREADS;
  if ((long long)chunks * slots > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = chunks * slots;
  cudaStream_t st = (cudaStream_t)stream;
  const int* D = (const int*)desc;
  const int* R = (const int*)rowmap;
  uint8_t* O = (uint8_t*)out;
  if (elem_bytes == 1)
    fabric_pack_kernel<uint8_t><<<blocks, FP_THREADS, 0, st>>>(
        (const uint8_t*)x, (const uint8_t*)w, D, R, O, rows, cols, K, ntot,
        chunks);
  else
    fabric_pack_kernel<uint32_t><<<blocks, FP_THREADS, 0, st>>>(
        (const uint32_t*)x, (const uint32_t*)w, D, R, O, rows, cols, K, ntot,
        chunks);
  return (int)cudaGetLastError();
}

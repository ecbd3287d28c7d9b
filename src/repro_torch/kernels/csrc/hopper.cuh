// Building blocks shared by the port's Hopper (sm_90a) kernels: cp.async
// copies, the 128-byte-swizzle wgmma descriptor, wgmma's fence, commit and
// wait, the unpack of bit planes into bytes, the current device's SM
// count, and the shared-memory attribute.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// descriptor of a 128B-swizzled operand at shared address a: start
// address, leading byte offset 16 (unused by these layouts), stride byte
// offset 1024 (between 8-row groups), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t wg_desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Unpacking bit planes into 8-bit values, four at a time: bit i of the
// low nibble of x spreads to bit 0 of byte i (one multiply; the four
// shifted copies of the nibble do not overlap, so nothing carries) ...
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}
// ... and each byte then takes plane p's coefficient mod 256: 2^p, or -2^p
// for the top plane of a signed operand (its byte sign-extends the value).
// Summed over the planes, a byte never passes 255: no carry crosses bytes.
__device__ __forceinline__ uint32_t plane_coef(int p, int planes, bool sgn) {
  return (sgn && p == planes - 1) ? ((0xFFu << p) & 0xFFu) : (1u << p);
}

#define HOPPER_MAX_DEVICES 64

// *sms = the current device's SM count, read once per device; returns the
// first CUDA error (0 = ok)
static inline int device_sm_count(int* sms) {
  static int sms_of[HOPPER_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= HOPPER_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = sms_of[dev];
  return 0;
}

// Give `kernel` `bytes` of dynamic shared memory (above 48 KB it needs the
// attribute), once per device: `set[dev]` records, for this kernel, the
// devices it was set on.  Returns the first CUDA error (0 = ok).
template <typename K>
static inline int smem_attribute_once(K* kernel,
                                      bool (&set)[HOPPER_MAX_DEVICES],
                                      int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= HOPPER_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!set[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    set[dev] = true;
  }
  return 0;
}

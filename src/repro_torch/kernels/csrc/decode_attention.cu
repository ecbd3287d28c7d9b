// GQA / MQA decode attention over a bf16 ring-buffer KV cache.
//
// Replaces no TPU kernel.  The reference attends its decode cache in
// plain JAX (repro/models/attention.py, attn_decode -> _kv_read ->
// _repeat_kv -> _attend_cache), which XLA fuses on the TPU.  Run eagerly
// on the H100, the same steps widen the whole (B, cap, KV, hd) bf16
// cache to float32, copy it H / KV times over to one row per query head
// and permute those copies for the batched products: about 70 GB a
// decode step of h2o-danube-1.8b at 16 lanes of 2048 slots, for a step
// that needs one read of the cache's live bf16 rows.
//
// One query a lane and head against its lane's cache:
//   q    (B, H, hd) float32 or bf16, rotated, not yet scaled
//   k, v (B, cap, KV, hd) bf16, any strides whose rows are 16-byte aligned
//   pos  (B, cap) int32: each slot's position, -1 for an empty slot
//   cur  (B,) int32: each lane's current position
// Slot t of lane b is valid when pos >= 0, pos <= cur[b] and, with a
// window, pos > cur[b] - window.  Query head h reads KV head h / g, g =
// H / KV.  Scores (q * scale) . k, the softmax and the P . V sum are
// float32, the bf16 cache widened in registers; out (B, H, hd) float32.
//
// What bounds it: bytes.  It has to read the valid K and V rows once a
// KV head (16 lanes x 360 live slots x 8 heads x 80 dims x 2 B x 2 is
// 1.5 MB a layer of the chat mix: 0.44 us at 3.35 TB/s); the queries,
// the slot positions and the partials are small beside them.
//
// Design (flash-decoding): pass 1 splits each lane's cache into chunks of
// DA_CHUNK slots; a block takes one (chunk, KV head, lane).  It first reads
// the chunk's positions; a chunk with no valid slot writes the marker
// l = 0 and stops before touching K or V (exact: such slots add
// exp(-1e30 - m) = 0 in the plain path).  A live block stages its g
// queries (scaled, float32) and the chunk's valid K rows (16-byte loads,
// rows padded to an odd number of words, so consecutive rows fall in
// other banks) in shared memory, scores every (head, slot) pair, takes
// each head's max m, p = exp(s - m) and l = sum p with one warp a head,
// then stages the valid V rows in the same buffer and sums p . V, one
// thread a (head, dim).  Each cache row is read once and serves the g
// query heads of its group: nothing is widened or repeated in device
// memory.  Its partial (acc[hd], m, l) goes to the caller's scratch.
// Pass 2 merges a (lane, head)'s chunks in chunk order, skipping the
// dead ones: M = max m, out = sum exp(m - M) acc / max(sum exp(m - M) l,
// 1e-30).  No atomics, so the output is the same bits from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define DA_CHUNK 64          // cache slots a block of pass 1
#define DA_THREADS 128       // threads a block of pass 1
#define DA_MERGE_THREADS 128 // threads a block of pass 2
#define DA_MAX_HD 256        // largest head width (a multiple of 8)
#define DA_MAX_GROUP 64      // most query heads a KV head
#define DA_NEG_INF (-1e30f)
// the shared memory a block may take, less the static valid flags
#define DA_MAX_SMEM (232448 - 1024)

__device__ __forceinline__ float da_float(float x) { return x; }
__device__ __forceinline__ float da_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// the valid rows of one chunk of a (lane, KV head): 16-byte loads, row r
// to words [r * wpr, r * wpr + hd / 2) of the tile
__device__ __forceinline__ void da_stage(uint32_t* tile,
                                         const uint16_t* __restrict__ base,
                                         long long row_stride, int hd,
                                         int rows, const int* valid,
                                         int wpr) {
  const int vecs = hd / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += DA_THREADS) {
    const int r = i / vecs, e = i - r * vecs;
    if (!valid[r]) continue;
    const uint4 w = __ldg(
        reinterpret_cast<const uint4*>(base + r * row_stride) + e);
    uint32_t* t = tile + r * wpr + e * 4;
    t[0] = w.x;
    t[1] = w.y;
    t[2] = w.z;
    t[3] = w.w;
  }
}

template <typename TQ>
__global__ void __launch_bounds__(DA_THREADS)
decode_attention_chunk(const TQ* __restrict__ q,
                       const uint16_t* __restrict__ k,
                       const uint16_t* __restrict__ v,
                       const int* __restrict__ pos,
                       const int* __restrict__ cur,
                       float* __restrict__ part, int cap, int kv, int g,
                       int hd, long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       int window, float scale, int chunks) {
  extern __shared__ __align__(16) unsigned char da_smem[];
  __shared__ int valid[DA_CHUNK];
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int c0 = c * DA_CHUNK;
  const int rows = min(DA_CHUNK, cap - c0);
  const long long now = __ldg(cur + b);
  int any = 0;
  for (int r = threadIdx.x; r < DA_CHUNK; r += DA_THREADS) {
    int ok = 0;
    if (r < rows) {
      const long long p = __ldg(pos + (long long)b * cap + c0 + r);
      ok = p >= 0 && p <= now && (window <= 0 || p > now - window);
    }
    valid[r] = ok;
    any |= ok;
  }
  // partial of query head kh * g + j: part[((b * H + kh * g + j) * chunks
  // + c) * (hd + 2)], acc[hd] then m, l
  const int stride = hd + 2;
  const long long head_stride = (long long)chunks * stride;
  float* out = part + (((long long)b * kv + kh) * g * chunks + c) * stride;
  if (!__syncthreads_or(any)) {
    for (int j = threadIdx.x; j < g; j += DA_THREADS) {
      out[j * head_stride + hd] = DA_NEG_INF;
      out[j * head_stride + hd + 1] = 0.f;
    }
    return;
  }
  const int wpr = hd / 2 + 1;                 // words a tile row (odd)
  float* qs = reinterpret_cast<float*>(da_smem);          // g * hd
  uint32_t* tile = reinterpret_cast<uint32_t*>(qs + g * hd);
  float* ps = reinterpret_cast<float*>(tile + DA_CHUNK * wpr);  // g * CHUNK

  const TQ* qb = q + ((long long)b * kv + kh) * g * hd;
  for (int i = threadIdx.x; i < g * hd; i += DA_THREADS)
    qs[i] = da_float(qb[i]) * scale;
  da_stage(tile, k + b * ksb + c0 * kss + kh * ksh, kss, hd, rows, valid,
           wpr);
  __syncthreads();

  // scores: a warp takes 32 slots of one head (the query is a broadcast)
  for (int i = threadIdx.x; i < g * DA_CHUNK; i += DA_THREADS) {
    const int j = i / DA_CHUNK, r = i - j * DA_CHUNK;
    float s = DA_NEG_INF;
    if (valid[r]) {
      const float* qj = qs + j * hd;
      const uint32_t* t = tile + r * wpr;
      float a = 0.f;
      for (int w = 0; w < hd / 2; ++w) {
        const uint32_t x = t[w];
        a = fmaf(qj[2 * w], bf16_lo(x), a);
        a = fmaf(qj[2 * w + 1], bf16_hi(x), a);
      }
      s = a;
    }
    ps[i] = s;
  }
  __syncthreads();

  // the chunk's softmax: one warp a head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < g; j += DA_THREADS / 32) {
    float* pj = ps + j * DA_CHUNK;
    float m = DA_NEG_INF;
    for (int r = lane; r < DA_CHUNK; r += 32) m = fmaxf(m, pj[r]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int r = lane; r < DA_CHUNK; r += 32) {
      const float p = valid[r] ? expf(pj[r] - m) : 0.f;
      pj[r] = p;
      l += p;
    }
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      out[j * head_stride + hd] = m;
      out[j * head_stride + hd + 1] = l;
    }
  }
  __syncthreads();

  // P . V: the valid V rows in the same tile, one thread a (head, dim)
  da_stage(tile, v + b * vsb + c0 * vss + kh * vsh, vss, hd, rows, valid,
           wpr);
  __syncthreads();
  const uint16_t* th = reinterpret_cast<const uint16_t*>(tile);
  for (int i = threadIdx.x; i < g * hd; i += DA_THREADS) {
    const int j = i / hd, d = i - j * hd;
    const float* pj = ps + j * DA_CHUNK;
    float a = 0.f;
    for (int r = 0; r < rows; ++r)
      if (valid[r])
        a = fmaf(pj[r], __uint_as_float((uint32_t)th[2 * r * wpr + d] << 16),
                 a);
    out[j * head_stride + d] = a;
  }
}

// a (lane, head)'s chunks merged in chunk order; one block each
__global__ void __launch_bounds__(DA_MERGE_THREADS)
decode_attention_merge(const float* __restrict__ part,
                       float* __restrict__ out, int hd, int chunks) {
  const long long bh = blockIdx.x;
  const int stride = hd + 2;
  const float* pb = part + bh * chunks * stride;
  float big = DA_NEG_INF;
  for (int c = 0; c < chunks; ++c)
    if (pb[c * stride + hd + 1] > 0.f) big = fmaxf(big, pb[c * stride + hd]);
  for (int d = threadIdx.x; d < hd; d += DA_MERGE_THREADS) {
    float l = 0.f, a = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float* p = pb + c * stride;
      const float lc = p[hd + 1];
      if (lc > 0.f) {
        const float w = expf(p[hd] - big);
        l += w * lc;
        a += w * p[d];
      }
    }
    out[bh * hd + d] = a / fmaxf(l, 1e-30f);
  }
}

// The shared memory a block of pass 1 takes: the g scaled queries, one
// tile of DA_CHUNK padded rows, the g x DA_CHUNK scores.
static long long da_smem_bytes(int g, int hd) {
  return 4LL * g * hd + 4LL * DA_CHUNK * (hd / 2 + 1) + 4LL * g * DA_CHUNK;
}

// q (B, H, hd) (q_bf16: bf16, else float32), k and v bf16 of shape (B,
// cap, KV, hd) with element strides (ksb, kss, ksh), (vsb, vss, vsh) and a
// unit last stride, pos (B, cap) and cur (B,) int32 contiguous; part
// (B, H, ceil(cap / DA_CHUNK), hd + 2) and out (B, H, hd) float32 scratch
// and output the caller allocated.  window <= 0: none.  Launches both
// passes on `stream`, no sync; returns cudaGetLastError()
// (cudaErrorInvalidValue on an argument the kernel does not take).
extern "C" int decode_attention_launch(
    const void* q, int q_bf16, const void* k, const void* v, const void* pos,
    const void* cur, void* part, void* out, int B, int H, int KV, int cap,
    int hd, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int window, float scale, void* stream) {
  if (B < 1 || B > 65535 || KV < 1 || KV > 65535 || H < KV || H % KV != 0 ||
      H / KV > DA_MAX_GROUP || cap < 1 || hd < 8 || hd > DA_MAX_HD ||
      hd % 8 != 0 || (long long)B * H > 2147483647LL ||
      ((ksb | kss | ksh | vsb | vss | vsh) & 7) != 0 ||
      (((uintptr_t)k | (uintptr_t)v) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int g = H / KV;
  const long long smem = da_smem_bytes(g, hd);
  if (smem > DA_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int chunks = (cap + DA_CHUNK - 1) / DA_CHUNK;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(chunks, KV, B);
  const uint16_t* K = (const uint16_t*)k;
  const uint16_t* V = (const uint16_t*)v;
  const int* P = (const int*)pos;
  const int* C = (const int*)cur;
  float* W = (float*)part;
  cudaError_t err;
  if (q_bf16) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(decode_attention_chunk<__nv_bfloat16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    decode_attention_chunk<__nv_bfloat16><<<grid, DA_THREADS, smem, st>>>(
        (const __nv_bfloat16*)q, K, V, P, C, W, cap, KV, g, hd, ksb, kss, ksh,
        vsb, vss, vsh, window, scale, chunks);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(decode_attention_chunk<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    decode_attention_chunk<float><<<grid, DA_THREADS, smem, st>>>(
        (const float*)q, K, V, P, C, W, cap, KV, g, hd, ksb, kss, ksh, vsb,
        vss, vsh, window, scale, chunks);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_merge<<<B * H, DA_MERGE_THREADS, 0, st>>>(W, (float*)out,
                                                              hd, chunks);
  return (int)cudaGetLastError();
}

// Tile helpers shared by the attention kernels that stream [B, S, H, D]
// tiles through shared memory in fp32: flash_attention.cu (TPU kernels
// #3-#5) and sparse_attention.cu (TPU kernels #8-#10); fused_ln.cu (#6,
// #7) borrows the loads, stores and reductions. The 16-bit tensor-core
// helpers at the end (ldmatrix, mma.sync.m16n8k16, cp.async, the split
// of an fp32 operand into two 16-bit terms) serve fused_ln.cu and, through
// attention_tc.cuh's tiles, flash_attention_tc.cu and
// sparse_attention_tc.cu; Drop is the attention dropout's hash, shared by
// the flash sources.
//
// A block has THREADS threads. The rows of the tile it owns get LPR
// neighbouring lanes each (LPR a power of two up to 32, so that a row's
// lanes sit in one warp); row_max / row_sum reduce over them with
// shuffles. load_tile reads rows of D elements (D a multiple of 8) with
// 16-byte vector loads of 8 elements, converts them to fp32 and stores
// them in a shared tile whose rows are DP floats apart.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tile {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {  // elements between consecutive batch, sequence, head
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

// from 9 host int64s: the batch, sequence and head strides of q, k and v
inline Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  store(p, v.x);
  store(p + 1, v.y);
  store(p + 2, v.z);
  store(p + 3, v.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x += s * x.x;
  acc.y += s * x.y;
  acc.z += s * x.z;
  acc.w += s * x.w;
}

// rows x D elements from `src` (row stride `stride`) into the fp32 shared
// tile `dst` [rows][DP], times `mul`; rows at or past `valid` are zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows,
                                          int valid, int D, float mul) {
  const int per_row = D / 8;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 8;
    float x[8];
    if (r < valid) {
      load8(src + r * stride + c, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] *= mul;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * DP + c);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <int LPR>  // over a row's LPR lanes
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
template <int LPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < LPR; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// 16-bit tensor-core tiles
// ---------------------------------------------------------------------------

// ldmatrix x4: lanes 8j .. 8j + 7 give the row addresses of 8 x 8 matrix
// j; r[j] holds row lane / 4, columns 2 (lane % 4) and + 1 of matrix j
// (with .trans, of its transpose)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// one m16n8k16 product into fp32 accumulators: the bf16 form, or the
// fp16 form with the same fragment layout. With g = lane / 4, t = lane %
// 4: a[0..3] hold A (row g, cols 2t, 2t+1), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8); b[0..1] B (k 2t, 2t+1, col g), (k 2t + 8, col g); c
// rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at cols 2t, 2t + 1.
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2],
                                      const __nv_bfloat16*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2], const __half*) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x0, x1 (fp32) as two 16-bit pairs: hi = T(x), lo = T(x - hi), so that
// hi + lo keeps x to ~2^-17 (bf16) or ~2^-22 (fp16) of its size; the low
// half of each word holds x0
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo, const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo, const __half*) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 f = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// two values of T packed into one word (the low half holds x0)
__device__ __forceinline__ uint32_t pack16(float x0, float x1,
                                           const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack16(float x0, float x1,
                                           const __half*) {
  const __half2 h = __floats2half2_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes from global to shared memory, asynchronously; with !valid the
// 16 bytes are zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------------
// attention dropout
// ---------------------------------------------------------------------------

// The dropout of one (batch, head): the hash terms that do not depend on
// the score's coordinates, the threshold of the top 24 bits and the scale.
struct Drop {
  uint32_t seed_term, bh_term;
  int thresh;
  float inv_keep;
  __device__ Drop(uint32_t seed, int bh, int t, float r)
      : seed_term(seed + 0x165667B1u),
        bh_term((uint32_t)bh * 0x58F633B5u + 1u), thresh(t), inv_keep(r) {}
  // JAX flash_attention.py: _dropout_bits, _hash_u32, dropout_keep_mask;
  // i the query (row of the score), j the key (column)
  __device__ __forceinline__ bool keep(int i, int j) const {
    uint32_t x = (uint32_t)i * 0x9E3779B9u + (uint32_t)j * 0x7FEB352Du;
    x ^= seed_term;
    x ^= bh_term;
    x *= 0x85EBCA6Bu;
    x ^= x >> 16;
    x *= 0xC2B2AE35u;
    x ^= x >> 13;
    x *= 0x27D4EB2Fu;
    x ^= x >> 16;
    return (int)(x >> 8) >= thresh;
  }
  __device__ __forceinline__ float apply(float v, int i, int j) const {
    return keep(i, j) ? v * inv_keep : 0.f;
  }
};

}  // namespace attn_tile

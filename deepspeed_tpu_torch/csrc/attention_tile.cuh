// Tile helpers shared by the attention kernels that stream [B, S, H, D]
// tiles through shared memory in fp32: flash_attention.cu (TPU kernels
// #3-#5) and sparse_attention.cu (TPU kernels #8-#10).
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

}  // namespace attn_tile

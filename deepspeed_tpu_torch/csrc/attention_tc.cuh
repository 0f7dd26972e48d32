// Tile helpers of the attention kernels on Hopper's tensor cores:
// flash_attention_tc.cu (TPU kernels #3-#5) and sparse_attention_tc.cu
// (#9, #10); flash_attention_tc256.cu borrows the quad reductions. A
// block of NT = 128 threads (4 warps) owns BM = 64 rows, 16
// per warp, and streams the other axis through shared tiles of 16-bit
// rows DP elements apart, filled by cp.async (load_rows); products are
// mma.sync.m16n8k16 with fp32 accumulators and fragments read by ldmatrix
// (mma_rows for the operand whose rows are the product's n, mma_cols for
// the transposed one); an fp32 accumulator tile becomes the A fragments
// of the next product as two 16-bit terms (a_frags); a row of the
// accumulator fragment lives in the 4 lanes of a quad (quad_max,
// quad_sum); a finished 16-bit tile leaves shared memory in 16-byte
// stores (store_rows). The lower-level pieces (ldmatrix, mma16, split16,
// pack16, cp.async) are attention_tile.cuh's.

#pragma once

#include <stdint.h>

#include "attention_tile.cuh"

namespace attn_tc {

using attn_tile::cp_async16;
using attn_tile::FULL;
using attn_tile::ldsm_x4;
using attn_tile::ldsm_x4_t;
using attn_tile::mma16;
using attn_tile::split16;

constexpr int NT = 128;      // threads: 4 warps
constexpr int BM = 64;       // rows a block owns, 16 per warp

// rows x dk elements (dk = D rounded up to 16) of src (row stride
// `stride`) into dst [rows][DP] by cp.async; rows at or past `valid` and
// columns at or past D are zeros
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int rows,
                                          int valid, int D, int dk) {
  const int cpr = dk / 8;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += NT) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * 8;
    const bool ok = r < valid && c < D;
    cp_async16(dst + r * DP + c, ok ? src + r * stride + c : src, ok);
  }
}

// acc[n] += A . B over a k of 16, where B's rows (n) are the tile's rows
// n0 .. n0 + 8 NN - 1 read at columns kc .. kc + 15: the non-transposed
// operand (k in q.k^T, q in k.q^T, dO in v.dO^T)
template <int NN, int DP, typename T>
__device__ __forceinline__ void mma_rows(float (&acc)[NN][4],
                                         const uint32_t (&a)[4], const T* B,
                                         int kc) {
  const int lane = threadIdx.x & 31;
  const T* base = B + ((lane & 7) + ((lane >> 4) << 3)) * DP + kc +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < NN / 2; ++np) {
    uint32_t r[4];
    ldsm_x4(r, base + np * 16 * DP);
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma16(acc[2 * np], a, b0, B);
    mma16(acc[2 * np + 1], a, b1, B);
  }
}

// acc[n] += (hi + lo) . B, where B's k runs along the tile's rows k0 ..
// k0 + 15 and n along its columns (V in p.V, dO in dv, q in dk): the
// transposed operand; n-tiles at or past dk are skipped
template <int NN, int DP, typename T>
__device__ __forceinline__ void mma_cols(float (&acc)[NN][4],
                                         const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], const T* B,
                                         int k0, int dk) {
  const int lane = threadIdx.x & 31;
  const T* base = B + (k0 + (lane & 15)) * DP + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < NN / 2; ++dp) {
    if (dp * 16 < dk) {
      uint32_t r[4];
      ldsm_x4_t(r, base + dp * 16);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma16(acc[2 * dp], hi, b0, B);
      mma16(acc[2 * dp], lo, b0, B);
      mma16(acc[2 * dp + 1], hi, b1, B);
      mma16(acc[2 * dp + 1], lo, b1, B);
    }
  }
}

// the A fragments (hi, lo) of k-step kc (columns 16 kc .. 16 kc + 15) of
// an fp32 accumulator tile [16][8 NN]
template <int NN, typename T>
__device__ __forceinline__ void a_frags(const float (&x)[NN][4], int kc,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const T* tag) {
  split16(x[2 * kc][0], x[2 * kc][1], hi[0], lo[0], tag);
  split16(x[2 * kc][2], x[2 * kc][3], hi[1], lo[1], tag);
  split16(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[2], lo[2], tag);
  split16(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[3], lo[3], tag);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// the [BM][D] tile of T staged at `tile` (row pitch DP) to dst rows
// (row stride `stride` elements), `valid` rows, 16-byte stores
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, long long stride,
                                           const T* tile, int valid, int D) {
  const int cpr = D / 8;
  for (int idx = threadIdx.x; idx < valid * cpr; idx += NT) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * stride + c) =
        *reinterpret_cast<const uint4*>(tile + r * DP + c);
  }
}

}  // namespace attn_tc

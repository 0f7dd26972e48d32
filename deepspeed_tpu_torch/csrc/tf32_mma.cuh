// The 3xTF32 products of the fp32 attention kernels on Hopper's tensor
// cores (sm_90a): flash_attention_tf32.cu (TPU kernels #3-#5),
// sparse_attention_tf32.cu (#9, #10) and chunked_prefill.cu (#2). An
// fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), and
// each product is three mma.sync.m16n8k8 TF32 products, lo.hi + hi.lo +
// hi.hi, into a fresh tile that an fp32 add folds into the running sum
// (see mma3). The fragments follow mma.sync's layout with g = lane / 4, t
// = lane % 4: a warp's accumulator tile [16][8 n] holds rows g and g + 8
// at columns 8 n + 2t and + 1. Shared tiles are fp32 with rows DP floats
// apart. Two warps that each sum a product over half of its depth add
// their partial tiles through shared memory (add_pair).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tf32 {

// cvt.rna.tf32.f32 in two integer operations: the nearest value with 10
// mantissa bits, ties away from zero (half of the dropped 13 bits' range
// added to the magnitude's bits, then those bits cleared), exact for
// every finite x. ptxas expands the cvt instruction to four, with a
// case for inf and NaN that the split does not need (there hi is inf and
// lo NaN either way, so the products are NaN).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// one m16n8k8 TF32 product into fp32 accumulators (not volatile: the
// compiler may interleave independent products). With g = lane / 4, t =
// lane % 4: a[0..3] hold A (row g, k t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); b[0..1] B (k t, col g), (k t + 4, col g); c rows g (c[0],
// c[1]) and g + 8 (c[2], c[3]) at cols 2t, 2t + 1.
__device__ __forceinline__ void mma8(float (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A.B as 3xTF32: lo.hi + hi.lo + hi.hi into a fresh tile, which an
// fp32 add then folds into c, so the tensor cores never add to the
// running sum (their fp32 accumulation drops low bits of the larger
// addend: summed in the mma, dv missed 1e-5 at |dv| = 8.5). With SWAP the
// two small products run in the other order, hi.lo then lo.hi: for s^T =
// k.q^T that is q.k^T's order (q_lo.k_hi, then q_hi.k_lo), so the
// transposed scores are the same products summed in the same order
template <bool SWAP = false>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if (SWAP) {
    mma8(d, ah, bl);
    mma8(d, al, bh);
  } else {
    mma8(d, al, bh);
    mma8(d, ah, bl);
  }
  mma8(d, ah, bh);
  c[0] += d[0];
  c[1] += d[1];
  c[2] += d[2];
  c[3] += d[3];
}

// the A fragment (hi, lo) of the warp's 16 rows of a shared tile `a`
// (already offset to the warp's first row) at columns kc .. kc + 7
template <int DP>
__device__ __forceinline__ void a_rows(const float* a, int kc,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31;
  const float* p = a + (lane >> 2) * DP + kc + (lane & 3);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * DP], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * DP + 4], hi[3], lo[3]);
}

// acc[n] += A . B^T over columns kc .. kc + 7, where B's rows n are the
// tile's rows 8n .. 8n + 7 (the non-transposed operand: k in q.k^T, v in
// dO.v^T, q in k.q^T, dO in v.dO^T); SWAP as mma3's
template <int NN, int DP, bool SWAP = false>
__device__ __forceinline__ void mma_rows(float (&acc)[NN][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* B, int kc) {
  const int lane = threadIdx.x & 31;
  const int at = (lane >> 2) * DP + kc + (lane & 3);
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    uint32_t bh[2], bl[2];
    split_tf32(B[at + n * 8 * DP], bh[0], bl[0]);
    split_tf32(B[at + n * 8 * DP + 4], bh[1], bl[1]);
    mma3<SWAP>(acc[n], ah, al, bh, bl);
  }
}

// acc[n] += X . B over the tile's rows 8 kk .. 8 kk + 7, where X is an
// fp32 accumulator tile [16][8 NS] (p or ds) and B's k runs along the
// tile's rows, n along its columns (k in ds.k, dO in dv, q in dk). The k
// index is permuted: the fragment's columns t and t + 4 are the tile's
// rows 8 kk + 2t and 8 kk + 2t + 1, which are the columns this lane holds
// of X, so X's accumulator fragment is the A fragment as it is; output
// n-tiles at or past D are skipped
template <int NO, int NS, int DP>
__device__ __forceinline__ void mma_cols(float (&acc)[NO][4],
                                         const float (&x)[NS][4], int kk,
                                         const float* B, int D) {
  const int lane = threadIdx.x & 31;
  uint32_t ah[4], al[4];
  split_tf32(x[kk][0], ah[0], al[0]);   // (g, 2t)
  split_tf32(x[kk][2], ah[1], al[1]);   // (g + 8, 2t)
  split_tf32(x[kk][1], ah[2], al[2]);   // (g, 2t + 1)
  split_tf32(x[kk][3], ah[3], al[3]);   // (g + 8, 2t + 1)
  const int at = (8 * kk + 2 * (lane & 3)) * DP + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n * 8 < D) {
      uint32_t bh[2], bl[2];
      split_tf32(B[at + n * 8], bh[0], bl[0]);
      split_tf32(B[at + DP + n * 8], bh[1], bl[1]);
      mma3(acc[n], ah, al, bh, bl);
    }
  }
}

// the warp's accumulator tile [16][8 NO] times `mul` to dst rows (row
// stride `stride` floats) r0 + g and r0 + g + 8 of the block's tile, rows
// at or past `valid` skipped, columns at or past D too; 8-byte stores
template <int NO>
__device__ __forceinline__ void store_acc_at(float* dst, long long stride,
                                             const float (&acc)[NO][4],
                                             float mul, int r0, int valid,
                                             int D) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n * 8 < D) {
      if (r < valid)
        *reinterpret_cast<float2*>(dst + r * stride + 8 * n + c) =
            make_float2(acc[n][0] * mul, acc[n][1] * mul);
      if (r + 8 < valid)
        *reinterpret_cast<float2*>(dst + (r + 8) * stride + 8 * n + c) =
            make_float2(acc[n][2] * mul, acc[n][3] * mul);
    }
  }
}

// store_acc_at with warp w's rows at 16 w, w = threadIdx.x / 32
template <int NO>
__device__ __forceinline__ void store_acc(float* dst, long long stride,
                                          const float (&acc)[NO][4],
                                          float mul, int valid, int D) {
  store_acc_at<NO>(dst, stride, acc, mul, (threadIdx.x >> 5) * 16, valid, D);
}

// a warp's [16][8 NS] tile into shared memory at dst (its lane's first
// float; one row of 32 floats an element), or added from there
template <int NS>
__device__ __forceinline__ void put_tile(float* dst,
                                         const float (&a)[NS][4]) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(4 * n + e) * 32] = a[n][e];
}

template <int NS>
__device__ __forceinline__ void add_tile(float (&a)[NS][4],
                                         const float* src) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] += src[(4 * n + e) * 32];
}

// the pair's partial sums of its tiles through shared memory Xs
// ([warps][tiles][NS * 4][32]): each warp of the pair (w and w ^ NG)
// stores its own tiles and, after one barrier, adds the other's: own +
// other's, the same bits in both warps
template <int NS, int NG, typename... Tile>
__device__ __forceinline__ void add_pair(float* Xs, Tile&... tiles) {
  constexpr int X = NS * 4 * 32;            // floats a tile
  constexpr int N = sizeof...(Tile);
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* mine = Xs + wid * N * X + lane;
  const float* other = Xs + (wid ^ NG) * N * X + lane;
  int x = 0;                                // a tile's slot: argument order
  (put_tile<NS>(mine + X * x++, tiles), ...);
  __syncthreads();
  x = 0;
  (add_tile<NS>(tiles, other + X * x++), ...);
}

}  // namespace attn_tf32

// The 16-bit tiles of the attention kernels that run warpgroup products at
// head dims in (128, 256]: flash_attention_tc256.cu (TPU kernels #3-#5)
// and chunked_prefill.cu's chunk items (#2). A tile holds up to 256
// columns of 16-bit values in wgmma's 128-byte-swizzled layout: 64-column
// blocks of 128-byte rows, a row's 16-byte chunks permuted by its place in
// its 8-row group. The same layout is a K-major operand (desc_k: q and k
// in s = q.k^T) and an MN-major one (desc_mn: V in p.V). A warpgroup (128
// threads) owns 64 rows; s over a 64-row tile of keys is m64n64k16 from
// shared memory (scores), and the wide product acc += x B is m64n256k16
// with x, an fp32 accumulator split into two 16-bit terms, in registers
// (wide_product).

#pragma once

#include <stdint.h>

#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace wg_tile {

constexpr int DMAX = 256;          // the widest head; tiles hold 256 columns
constexpr int BN = 64;             // rows of a streamed tile
constexpr int ROWB = 128;          // bytes of a row of a 64-column block
constexpr int TILE = BN * DMAX * 2;  // one 64-row tile of 16-bit values

// byte offset of the 16-byte chunk cc (columns 8 cc .. 8 cc + 7) of row r
// in a swizzled tile of `rows` rows
__device__ __forceinline__ int swz(int r, int cc, int rows) {
  return (cc >> 3) * rows * ROWB + r * ROWB + (((cc & 7) ^ (r & 7)) << 4);
}

// rows x dk columns of src (row stride `stride` elements) into the
// swizzled tile dst by cp.async, by `nt` threads; rows at or past `valid`
// and columns at or past D are zeros, columns at or past dk untouched
template <typename T>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* src,
                                          long long stride, int rows,
                                          int valid, int D, int dk,
                                          int nt) {
  const int cpr = dk >> 3;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += nt) {
    const int r = idx / cpr;
    const int cc = idx - r * cpr;
    const bool ok = r < valid && cc * 8 < D;
    attn_tile::cp_async16(dst + swz(r, cc, rows),
                          ok ? src + r * stride + cc * 8 : src, ok);
  }
}

// `valid` rows of D columns of the swizzled tile to dst (row stride
// `stride` elements), 16-byte stores by `nt` threads
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, long long stride,
                                           const uint8_t* tile, int rows,
                                           int valid, int D, int nt) {
  const int cpr = D >> 3;
  for (int idx = threadIdx.x; idx < valid * cpr; idx += nt) {
    const int r = idx / cpr;
    const int cc = idx - r * cpr;
    *reinterpret_cast<uint4*>(dst + r * stride + cc * 8) =
        *reinterpret_cast<const uint4*>(tile + swz(r, cc, rows));
  }
}

// the accumulator pair (row r, columns 8 i + 2 t, + 1) as two T in place
template <typename T>
__device__ __forceinline__ void put_pair(uint8_t* tile, int rows, int r,
                                         int i, int t, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(tile + swz(r, i, rows) + 4 * t) =
      attn_tile::pack16(x0, x1, static_cast<const T*>(nullptr));
}

// a K-major operand: rows row0 .. row0 + 63 of a tile of `rows` rows,
// k-step kc (columns 16 kc .. 16 kc + 15)
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int rows,
                                           int row0, int kc) {
  return hopper::gmma_desc(tile + (kc >> 2) * rows * ROWB + row0 * ROWB +
                               (kc & 3) * 32,
                           16, 1024, 1);
}

// an MN-major operand: k-step kc over the tile's rows 16 kc .. 16 kc + 15,
// its 256 columns the product's n
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int rows,
                                            int kc) {
  return hopper::gmma_desc(tile + kc * 16 * ROWB, rows * ROWB, 1024, 1);
}

// s (+)= A B^T over the head dim, 64 x 64, both from K-major tiles (B a
// BN-row tile); k-steps at or past dk (zero columns) skipped
template <typename T>
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* a,
                                       int a_rows, int a_row0,
                                       const uint8_t* b, int dk) {
#pragma unroll
  for (int kc = 0; kc < DMAX / 16; ++kc)
    if (kc * 16 < dk)
      hopper::wgmma64<T>(s, desc_k(a, a_rows, a_row0, kc),
                         desc_k(b, BN, 0, kc), kc > 0);
}

// acc += x B over 64 rows of B (MN-major, 256 columns): x (fp32, the
// 64 x 64 accumulator of a scores product) split into hi = T(x) and lo =
// T(x - hi), each multiplied; waits for the products
template <typename T>
__device__ __forceinline__ void wide_product(float (&acc)[128],
                                             const float (&x)[32],
                                             const uint8_t* b) {
  uint32_t hi[4][4], lo[4][4];
  const T* tag = nullptr;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      attn_tile::split16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1],
                         hi[kc][r], lo[kc][r], tag);
  hopper::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    hopper::wgmma256_rs<T>(acc, hi[kc], desc_mn(b, BN, kc), 1);
    hopper::wgmma256_rs<T>(acc, lo[kc], desc_mn(b, BN, kc), 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_acc(acc);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    hopper::fence_regs(hi[kc]);
    hopper::fence_regs(lo[kc]);
  }
}

}  // namespace wg_tile

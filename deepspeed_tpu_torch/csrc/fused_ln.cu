// Fused LayerNorm + projection, forward and backward, for Hopper (sm_90a).
//
// The route of float32, and of bf16 and fp16 at D above TC_MAX_D (1664):
// ops/transformer/fused.py:_route sends bf16 and fp16 up to that width to
// the wgmma + TMA kernels of csrc/fused_ln_tc.cu. This file's 16-bit
// mma.sync path stays for the wider D, and chip_smoke.py times it as the
// first version on the 16-bit route's inputs.
//
// Replaces the two Pallas TPU kernels of deepspeed_tpu/ops/transformer/
// fused.py: _fwd_kernel (forward) and _bwd_kernel (backward). With x
// [n, D], gamma and beta [D], W [F, D] (torch's nn.Linear layout, read in
// place) and bias [F], T the dtype of x and W (fp32, bf16 or fp16):
//
//   mean_i = sum_k x_ik / D,  var_i = sum_k (x_ik - mean_i)^2 / D  (fp32,
//            two passes over the row)
//   rstd_i = 1.0f / sqrtf(var_i + eps)  (nvcc's default division and
//            square root are correctly rounded; rsqrtf is ~2 ulp off)
//   xhat_ik = (x_ik - mean_i) rstd_i,   ln_ik = xhat_ik gamma_k + beta_k
//   pre_ij = sum_k T(ln_ik) W_jk + bias_j     (T(): rounded to T, fp32 sums)
//   y_ij   = act(pre_ij), stored as T; act = identity or the tanh GELU
//
// and, from dy [n, F]:
//
//   g_ij    = dy_ij gelu'(pre_ij) (or dy_ij),   dyc_ij = T(g_ij)
//   dW_jk   = sum_i dyc_ij T(ln_ik),            dbias_j = sum_i g_ij
//   dln_ik  = sum_j dyc_ij W_jk
//   dgamma_k = sum_i dln_ik xhat_ik,            dbeta_k = sum_i dln_ik
//   dxhat_ik = dln_ik gamma_k
//   dx_ik   = rstd_i (dxhat_ik - m1_i - xhat_ik m2_i), m1_i = mean_k dxhat_ik,
//             m2_i = mean_k dxhat_ik xhat_ik
//
// What bounds it on an H100: operations. At the training path's shapes (n
// = 16 x 512 rows, D = 768, F = 2304 for LN1 + QKV and 3072 for LN2 + fc +
// GELU, bf16) the forward multiplies 2 n D F = 29.0 and 38.7 GFLOP, 29 and
// 39 us at the 989 TFLOP/s of dense bf16, against 16 and 20 us for its
// bytes; the backward does two such products (dW, dln), and a third under
// GELU to recompute pre, 59 and 117 us.
//
// What the design does:
// - bf16 and fp16 products run on the tensor cores through
//   mma.sync.m16n8k16 with fp32 accumulators (the two forms share one
//   fragment layout): products of 16-bit values are exact in fp32, so
//   this is the TPU kernel's T x T -> fp32 dot up to the order of the
//   sums. Fragments come from shared memory through ldmatrix, and through
//   ldmatrix.trans for the operands whose k runs along their source's
//   rows (W in dln; dyc and x in dW), which are stored as they are read.
//   fp32 products run as fp32 FMAs over the same fragment layout (TF32
//   would lose digits the fp32 path is held to). A thread block computes
//   a 128 x 128 tile with 8 warps of 64 x 32, through two shared stages
//   of 128 x BK tiles: the global loads of the next tile are in flight
//   while the tensor cores work on this one, and each tile costs one
//   barrier. No wgmma or TMA yet.
// - Forward, two launches: the rows' mean and rstd (a warp per row), then
//   the product, whose A tiles are normalised in fp32 and rounded to T on
//   their way from x into shared memory: the normalised rows never reach
//   device memory. The epilogue adds the bias in fp32, applies the GELU
//   and stores T.
// - Backward, six launches, deterministic, no atomics (the TPU kernel sums
//   dW, dbias, dgamma and dbeta over a sequential grid, which a GPU does
//   not have): (1) the rows' mean and rstd; (2) under GELU the forward's
//   product again, whose epilogue writes dyc and per-128-row partial sums
//   of g for dbias (without GELU dyc is dy itself and a column pass sums
//   it); (3) dln = dyc W into an fp32 scratch; (4) a row pass: dx, and
//   per-32-row partial sums for dgamma and dbeta; (5) dW = dyc^T T(ln),
//   each block owning a dW tile and walking a fixed quarter of the rows
//   (split by n only), ln recomputed from x and the row statistics; (6)
//   one launch that sums every set of partials in a fixed order and casts
//   to the outputs' dtypes. Each sum is taken in the same order on every
//   run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "attention_tile.cuh"

namespace {

using attn_tile::dot4;
using attn_tile::ldsm_x4;
using attn_tile::ldsm_x4_t;
using attn_tile::load8;
using attn_tile::mma16;
using attn_tile::row_sum;

constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BM = 128, BN = 128;     // the output tile of a block
constexpr int WM = 64, WN = 32;       // a warp's tile: 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int ROWS_BWD = 32;          // rows of a block in the row pass
constexpr int SPLIT_ROWS = 2048;      // dW: rows per split, at most 4 splits
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

// A shared tile holds 128 rows (m or n) x BK of k in one of two layouts:
// k-contiguous, 128 rows of BK padded to SK (80 bytes), or, for a 16-bit
// operand whose k runs along its source's rows, BK rows of 128 padded to
// SM (272 bytes), which ldmatrix.trans turns into fragments. Either way
// ldmatrix's eight 16-byte rows hit 32 distinct banks, and fp32 rows stay
// 16-byte aligned for float4 reads. Two stages of A and B take 40 KB.
template <typename T>
struct Tile {
  static constexpr int BK = 32;
  static constexpr int SK = BK + 8;
  static constexpr int SM = 128 + 8;
  static constexpr int STAGE = 128 * SK;
};
template <>
struct Tile<float> {
  static constexpr int BK = 16;
  static constexpr int SK = BK + 4;
  static constexpr int STAGE = 128 * SK;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// the dtype code of T, as the entry points and put() take it
template <typename T>
constexpr int code_of() {
  return std::is_same<T, float>::value ? 0
         : std::is_same<T, __nv_bfloat16>::value ? 1 : 2;
}

// gamma, beta and bias come in their own dtype: 0 fp32, 1 bf16, 2 fp16
__device__ __forceinline__ float param(const void* p, int code, int i) {
  if (code == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// eight neighbouring parameters from i (a multiple of 8; the vectors are
// 16-byte aligned)
__device__ __forceinline__ void param8(const void* p, int code, int i,
                                       float (&v)[8]) {
  if (code == 0) {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i);
    const float4 a = q[0], b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
  const uint4 u = *reinterpret_cast<const uint4*>(
      static_cast<const char*>(p) + 2 * (long long)i);
  if (code == 1) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __half22float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void put(void* p, int code, long long i,
                                    float v) {
  if (code == 1) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else if (code == 2) static_cast<__half*>(p)[i] = __float2half(v);
  else static_cast<float*>(p)[i] = v;
}

// two neighbouring elements (4- or 8-byte aligned), rounded to nearest even
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// eight elements into a 16-byte aligned shared row
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <typename T16>
__device__ __forceinline__ void store8(T16* p, const float (&v)[8]) {
  static_assert(sizeof(T16) == 2, "bf16 or fp16");
  uint4 u;
  T16* h = reinterpret_cast<T16*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) store2(h + 2 * k, v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// eight elements as loaded from device memory (16 or 32 bytes)
template <typename T>
struct Raw {  // bf16 or fp16: one 16-byte vector
  static_assert(sizeof(T) == 2, "16-bit types; fp32 below");
  uint4 u;
  __device__ __forceinline__ void load(const T* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<uint4*>(p) = u;
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    load8(reinterpret_cast<const T*>(&u), v);
  }
};
template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = a;
    reinterpret_cast<float4*>(p)[1] = b;
  }
  __device__ __forceinline__ void store_pairs(const Raw& next, float* p,
                                              int stride) const {
    float v[8], w[8];
    unpack(v);
    next.unpack(w);
#pragma unroll
    for (int e = 0; e < 8; ++e) store2(p + e * stride, v[e], w[e]);
  }
  __device__ __forceinline__ void unpack(float (&v)[8]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x *
         (1.f + tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float t = tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x * x * x));
  const float du = SQRT_2_OVER_PI * (1.f + 0.134145f * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
}

// xhat * gamma + beta with each operation rounded on its own, as the
// plain version's elementwise ops round (no contraction into an FMA)
__device__ __forceinline__ float normalize(float v, float mu, float rs,
                                          float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rs), g), b);
}

// mean and rstd of one row of D elements, by a whole warp (every lane
// gets both); two passes, each summed in a fixed order
template <typename T>
__device__ __forceinline__ void row_stats(const T* xr, int D, float eps,
                                          float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
  }
  mean = row_sum<32>(s) / D;
  float q = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float dv = v[e] - mean;
      q += dv * dv;
    }
  }
  rstd = 1.0f / sqrtf(row_sum<32>(q) / D + eps);
}

// What a loader applies to eight neighbouring elements of one source row
// (columns col .. col + 7) on their way into shared memory.
struct Identity {
  static constexpr bool kIdentity = true;
  __device__ __forceinline__ void operator()(int, int, float (&)[8]) const {}
};

// The LayerNorm of rows of x: (v - mean) rstd gamma + beta, with the row's
// statistics at mean[row - row0] and rstd[row - row0]
struct Normalize {
  static constexpr bool kIdentity = false;
  const float* mean;
  const float* rstd;
  int row0;
  const void* gamma;
  const void* beta;
  int gcode;
  __device__ __forceinline__ void operator()(int row, int col,
                                             float (&v)[8]) const {
    float g[8], b[8];
    param8(gamma, gcode, col, g);
    param8(beta, gcode, col, b);
    const float mu = mean[row - row0], rs = rstd[row - row0];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = normalize(v[e], mu, rs, g[e], b[e]);
  }
};

// Loads one operand's tiles: tile[r][c] = f(src[(row0 + r) * ld + k0 +
// c]) rounded to T, for 128 rows and BK columns; 0 past `rows` or `K`. K
// is a multiple of 8, so a vector of 8 is all in or all out. load()
// issues the global loads of a tile into registers, store() transforms
// them into a shared stage.
template <typename T, typename Fn>
struct DirectTile {
  static constexpr bool kTrans = false;
  static constexpr int VPR = Tile<T>::BK / 8;     // vectors per row
  static constexpr int NV = 128 * VPR / THREADS;  // vectors per thread
  const T* src;
  long long ld;
  int row0, rows, K;
  Fn f;
  Raw<T> raw[NV];

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = threadIdx.x + v * THREADS;
      const int gr = row0 + i / VPR, gk = k0 + (i % VPR) * 8;
      if (gr < rows && gk < K) raw[v].load(src + gr * ld + gk);
      else raw[v].zero();
    }
  }
  __device__ __forceinline__ void store(T* tile, int k0) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = threadIdx.x + v * THREADS;
      const int r = i / VPR, c = (i % VPR) * 8;
      T* dst = tile + r * Tile<T>::SK + c;
      if (Fn::kIdentity) {
        raw[v].store(dst);
        continue;
      }
      const int gr = row0 + r, gk = k0 + c;
      float x[8];
      raw[v].unpack(x);
      if (gr < rows && gk < K) f(gr, gk, x);
      store8(dst, x);  // zeros past the edge: raw was zeroed
    }
  }
};

// An operand whose k runs along its source's rows, fp32: tile[m][c] =
// f(src[(k0 + c) * ld + m0 + m]); 0 past `M` (a multiple of 8) or `K`
// (any). A thread loads 8 neighbouring m of two neighbouring rows k and
// stores 8 pairs into the k-contiguous layout.
template <typename T, typename Fn>
struct TransTile {
  static constexpr bool kTrans = false;
  static constexpr int PAIRS = Tile<T>::BK / 2;
  static constexpr int ITEMS = PAIRS * (128 / 8);
  static_assert(ITEMS <= THREADS, "one item per thread");
  const T* src;
  long long ld;
  int m0, M, K;
  Fn f;
  Raw<T> raw[2];

  __device__ __forceinline__ void load(int k0) {
    if (threadIdx.x >= ITEMS) return;
    const int gm = m0 + threadIdx.x / PAIRS * 8;
    const int gk = k0 + threadIdx.x % PAIRS * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (gm < M && gk + h < K) raw[h].load(src + (gk + h) * ld + gm);
      else raw[h].zero();
    }
  }
  __device__ __forceinline__ void store(T* tile, int k0) const {
    if (threadIdx.x >= ITEMS) return;
    const int mv = threadIdx.x / PAIRS, kp = threadIdx.x % PAIRS;
    T* dst = tile + mv * 8 * Tile<T>::SK + 2 * kp;
    if (Fn::kIdentity) {
      raw[0].store_pairs(raw[1], dst, Tile<T>::SK);
      return;
    }
    const int gm = m0 + mv * 8, gk = k0 + 2 * kp;
    float v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      raw[h].unpack(v[h]);
      if (gm < M && gk + h < K) f(gk + h, gm, v[h]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      store2(dst + e * Tile<T>::SK, v[0][e], v[1][e]);
  }
};

// The same operand in bf16 or fp16, kept as its source lays it out: tile[c][m] =
// f(src[(k0 + c) * ld + m0 + m]) for BK rows of 128, read by ldmatrix.trans.
template <typename T, typename Fn>
struct RowTile {
  static constexpr bool kTrans = true;
  static constexpr int VPR = 128 / 8;                     // vectors per row
  static constexpr int NV = Tile<T>::BK * VPR / THREADS;  // per thread
  const T* src;
  long long ld;
  int m0, M, K;
  Fn f;
  Raw<T> raw[NV];

  __device__ __forceinline__ void load(int k0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = threadIdx.x + v * THREADS;
      const int gk = k0 + i / VPR, gm = m0 + (i % VPR) * 8;
      if (gk < K && gm < M) raw[v].load(src + gk * ld + gm);
      else raw[v].zero();
    }
  }
  __device__ __forceinline__ void store(T* tile, int k0) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = threadIdx.x + v * THREADS;
      const int c = i / VPR, m = (i % VPR) * 8;
      T* dst = tile + c * Tile<T>::SM + m;
      if (Fn::kIdentity) {
        raw[v].store(dst);
        continue;
      }
      const int gk = k0 + c, gm = m0 + m;
      float x[8];
      raw[v].unpack(x);
      if (gk < K && gm < M) f(gk, gm, x);
      store8(dst, x);
    }
  }
};

template <typename T, typename Fn>
using KRowsTile = std::conditional_t<sizeof(T) == 2, RowTile<T, Fn>,
                                     TransTile<T, Fn>>;

// acc += A B^T over one shared stage of 16-bit T: A [128][BK] and B
// [128][BK], k-contiguous, or with TA / TB k-major [BK][128]; the warp's
// 64 x 32 tile in mma.sync's C fragment layout: acc[mt][nt][2 h + e] is
// row wm*64 + mt*16 + g + 8 h, column wn*32 + nt*8 + 2 t + e (g = lane /
// 4, t = lane % 4).
template <bool TA, bool TB, typename T16>
__device__ __forceinline__ std::enable_if_t<sizeof(T16) == 2> warp_mma(
    const T16* As, const T16* Bs, float (&acc)[MT][NT][4]) {
  constexpr int SK = Tile<T16>::SK, SM = Tile<T16>::SM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // ldmatrix x4 row addresses (lanes 8j .. 8j + 7 address matrix j): A's
  // four 8 x 8 matrices are m 0-7 and 8-15 at k and k + 8 (a0..a3); B's
  // are n 0-7 at k and k + 8, then n 8-15 (b0, b1 of two n-tiles)
  const T16* ab =
      TA ? As + ((lane >> 4) * 8 + (lane & 7)) * SM + (warp >> 2) * WM +
               ((lane >> 3) & 1) * 8
         : As + ((warp >> 2) * WM + (lane & 15)) * SK + (lane >> 4) * 8;
  const T16* bb =
      TB ? Bs + (((lane >> 3) & 1) * 8 + (lane & 7)) * SM + (warp & 3) * WN +
               (lane >> 4) * 8
         : Bs + ((warp & 3) * WN + (lane & 7) + ((lane >> 4) << 3)) * SK +
               ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < Tile<T16>::BK; kk += 16) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (TA) ldsm_x4_t(a[mt], ab + kk * SM + mt * 16);
      else ldsm_x4(a[mt], ab + mt * 16 * SK + kk);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      if (TB) ldsm_x4_t(r, bb + kk * SM + np * 16);
      else ldsm_x4(r, bb + np * 16 * SK + kk);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma16(acc[mt][nt], a[mt], b[nt], As);
  }
}

// the fp32 tile: FMAs into the same fragment layout (k-contiguous only)
template <bool TA, bool TB>
__device__ __forceinline__ void warp_mma(const float* As, const float* Bs,
                                         float (&acc)[MT][NT][4]) {
  static_assert(!TA && !TB, "fp32 tiles are k-contiguous");
  constexpr int SK = Tile<float>::SK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* ab = As + ((warp >> 2) * WM + g) * SK;
  const float* bb = Bs + ((warp & 3) * WN + 2 * t) * SK;
#pragma unroll
  for (int kk = 0; kk < Tile<float>::BK; kk += 4) {
    float4 a[MT][2], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = *reinterpret_cast<const float4*>(ab + mt * 16 * SK + kk);
      a[mt][1] =
          *reinterpret_cast<const float4*>(ab + (mt * 16 + 8) * SK + kk);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt][0] = *reinterpret_cast<const float4*>(bb + nt * 8 * SK + kk);
      b[nt][1] =
          *reinterpret_cast<const float4*>(bb + (nt * 8 + 1) * SK + kk);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[mt][nt][0] += dot4(a[mt][0], b[nt][0]);
        acc[mt][nt][1] += dot4(a[mt][0], b[nt][1]);
        acc[mt][nt][2] += dot4(a[mt][1], b[nt][0]);
        acc[mt][nt][3] += dot4(a[mt][1], b[nt][1]);
      }
  }
}

// acc += A B^T over k in [k_begin, k_end), two shared stages: a tile is
// stored, one barrier, then the next tile's loads are issued before this
// one's products. A warp that stores stage s at tile t + 2 has passed the
// barrier of tile t + 1, which every warp reached after its products on
// stage s at tile t: one barrier a tile suffices.
template <typename T, typename LA, typename LB>
__device__ __forceinline__ void mainloop(T* As, T* Bs, LA& la, LB& lb,
                                         int k_begin, int k_end,
                                         float (&acc)[MT][NT][4]) {
  constexpr int BK = Tile<T>::BK, STAGE = Tile<T>::STAGE;
  if (k_begin >= k_end) return;
  la.load(k_begin);
  lb.load(k_begin);
  int s = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, s ^= 1) {
    la.store(As + s * STAGE, k0);
    lb.store(Bs + s * STAGE, k0);
    __syncthreads();
    if (k0 + BK < k_end) {
      la.load(k0 + BK);
      lb.load(k0 + BK);
    }
    warp_mma<LA::kTrans, LB::kTrans>(As + s * STAGE, Bs + s * STAGE, acc);
  }
}

// where the thread's accumulators sit in its block's 128 x 128 tile
struct Frag {
  int r, c;  // row of acc[mt][.][0], column of acc[.][nt][0] at mt = nt = 0
  __device__ Frag() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r = (warp >> 2) * WM + (lane >> 2);
    c = (warp & 3) * WN + 2 * (lane & 3);
  }
};

// ---------------------------------------------------------------------------
// (the row statistics) mean and rstd of every row into stats[0:n] and
// stats[n:2n]; a warp per row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) ln_stats_kernel(
    const T* __restrict__ x, float* __restrict__ stats, int n, int D,
    float eps) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;
  float mu, rs;
  row_stats(x + (long long)row * D, D, eps, mu, rs);
  if ((threadIdx.x & 31) == 0) {
    stats[row] = mu;
    stats[n + row] = rs;
  }
}

// ---------------------------------------------------------------------------
// forward, and the backward's GELU prologue: grid (ceil(n / BM), ceil(F /
// BN)). MODE 0: y = pre; 1: y = gelu(pre); 2: dyc = T(dy gelu'(pre)) and
// dbias_part[blockIdx.x][:] = sum over the block's rows of dy gelu'(pre).
// ---------------------------------------------------------------------------
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    ln_gemm_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   const void* gamma, const void* beta, int gcode,
                   const T* __restrict__ w, const void* bias, int bcode,
                   const T* __restrict__ dy, T* __restrict__ out,
                   float* __restrict__ dbias_part, int n, int D, int F) {
  __shared__ __align__(16) T As[2 * Tile<T>::STAGE];
  __shared__ __align__(16) T Bs[2 * Tile<T>::STAGE];
  __shared__ float s_mean[BM], s_rstd[BM];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < BM) {
    const int row = row0 + threadIdx.x;
    s_mean[threadIdx.x] = row < n ? stats[row] : 0.f;
    s_rstd[threadIdx.x] = row < n ? stats[n + row] : 0.f;
  }
  __syncthreads();

  const Normalize norm{s_mean, s_rstd, row0, gamma, beta, gcode};
  DirectTile<T, Normalize> la{x, D, row0, n, D, norm};
  DirectTile<T, Identity> lb{w, D, col0, F, D, Identity()};
  float acc[MT][NT][4] = {};
  mainloop(As, Bs, la, lb, 0, D, acc);

  const Frag fr;
  float cs[NT][2] = {};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + fr.r + mt * 16 + 8 * h;
      if (row >= n) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + fr.c + nt * 8;
        if (col >= F) continue;
        const long long o = (long long)row * F + col;
        float y0 = acc[mt][nt][2 * h] + param(bias, bcode, col);
        float y1 = acc[mt][nt][2 * h + 1] + param(bias, bcode, col + 1);
        if (MODE == 1) {
          y0 = gelu(y0);
          y1 = gelu(y1);
        } else if (MODE == 2) {
          y0 = to_float(dy[o]) * gelu_grad(y0);
          y1 = to_float(dy[o + 1]) * gelu_grad(y1);
          cs[nt][0] += y0;
          cs[nt][1] += y1;
        }
        store2(out + o, y0, y1);
      }
    }
  if (MODE == 2) {
    // the block's column sums: over the thread's rows (above), the warp's
    // 8 row groups (lanes xor 4, 8, 16), then warp rows 0 + 1; fixed order
    __shared__ float s_red[2][BN];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = cs[nt][e];
        v += __shfl_xor_sync(attn_tile::FULL, v, 4);
        v += __shfl_xor_sync(attn_tile::FULL, v, 8);
        v += __shfl_xor_sync(attn_tile::FULL, v, 16);
        if (lane < 4) s_red[warp >> 2][fr.c + nt * 8 + e] = v;
      }
    __syncthreads();
    const int col = col0 + threadIdx.x;
    if (threadIdx.x < BN && col < F)
      dbias_part[(long long)blockIdx.x * F + col] =
          s_red[0][threadIdx.x] + s_red[1][threadIdx.x];
  }
}

// backward (2) without GELU: part[blockIdx.x][col] = sum of dy over the
// block's BM rows, in order; grid (ceil(n / BM), ceil(F / THREADS))
template <typename T>
__global__ void __launch_bounds__(THREADS) col_partial_kernel(
    const T* __restrict__ dy, float* __restrict__ part, int n, int F) {
  const int col = blockIdx.y * THREADS + threadIdx.x;
  if (col >= F) return;
  const int r0 = blockIdx.x * BM, r1 = min(n, r0 + BM);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_float(dy[(long long)r * F + col]);
  part[(long long)blockIdx.x * F + col] = s;
}

// backward (3): dln = dyc W, fp32 [n, D]; grid (ceil(n / BM), ceil(D / BN))
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    dln_kernel(const T* __restrict__ dyc, const T* __restrict__ w,
               float* __restrict__ dln, int n, int D, int F) {
  __shared__ __align__(16) T As[2 * Tile<T>::STAGE];
  __shared__ __align__(16) T Bs[2 * Tile<T>::STAGE];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  DirectTile<T, Identity> la{dyc, F, row0, n, F, Identity()};
  KRowsTile<T, Identity> lb{w, D, col0, D, F, Identity()};
  float acc[MT][NT][4] = {};
  mainloop(As, Bs, la, lb, 0, F, acc);
  const Frag fr;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + fr.r + mt * 16 + 8 * h;
      if (row >= n) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + fr.c + nt * 8;
        if (col < D)
          store2(dln + (long long)row * D + col, acc[mt][nt][2 * h],
                 acc[mt][nt][2 * h + 1]);
      }
    }
}

// backward (4): the LayerNorm's backward over ROWS_BWD rows a block: dx,
// and dg_part / db_part[blockIdx.x][:] = sums of dln xhat and dln over
// those rows, in order
template <typename T>
__global__ void __launch_bounds__(THREADS) ln_rows_bwd_kernel(
    const T* __restrict__ x, const void* gamma, int gcode,
    const float* __restrict__ stats, const float* __restrict__ dln,
    T* __restrict__ dx,
    float* __restrict__ dg_part, float* __restrict__ db_part, int n,
    int D) {
  __shared__ float s_m1[ROWS_BWD], s_m2[ROWS_BWD];
  const float* mean = stats;
  const float* rstd = stats + n;
  const int row0 = blockIdx.x * ROWS_BWD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS_BWD; r += WARPS) {
    const int row = row0 + r;
    float m1 = 0.f, m2 = 0.f;
    if (row < n) {
      const float mu = mean[row], rs = rstd[row];
      const T* xr = x + (long long)row * D;
      const float* dr = dln + (long long)row * D;
      for (int c = lane; c < D; c += 32) {
        const float xh = (to_float(xr[c]) - mu) * rs;
        const float dxh = dr[c] * param(gamma, gcode, c);
        m1 += dxh;
        m2 += dxh * xh;
      }
      m1 = row_sum<32>(m1) / D;
      m2 = row_sum<32>(m2) / D;
    }
    if (lane == 0) {
      s_m1[r] = m1;
      s_m2[r] = m2;
    }
  }
  __syncthreads();
  const int rows = min(ROWS_BWD, n - row0);
  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float gc = param(gamma, gcode, c);
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < rows; ++r) {
      const long long o = (long long)(row0 + r) * D + c;
      const float rs = rstd[row0 + r];
      const float xh = (to_float(x[o]) - mean[row0 + r]) * rs;
      const float dl = dln[o];
      const float dxh = dl * gc;
      attn_tile::store(dx + o, rs * (dxh - s_m1[r] - xh * s_m2[r]));
      dg += dl * xh;
      db += dl;
    }
    dg_part[(long long)blockIdx.x * D + c] = dg;
    db_part[(long long)blockIdx.x * D + c] = db;
  }
}

// backward (5): dw_part[z] = sum over rows [z chunk, (z + 1) chunk) of
// dyc^T T(ln), fp32 [F, D]; grid (ceil(F / BM), ceil(D / BN), splits)
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    dw_kernel(const T* __restrict__ x, const void* gamma, const void* beta,
              int gcode, const float* __restrict__ stats,
              const T* __restrict__ dyc, float* __restrict__ dw_part, int n,
              int D, int F, int chunk) {
  __shared__ __align__(16) T As[2 * Tile<T>::STAGE];
  __shared__ __align__(16) T Bs[2 * Tile<T>::STAGE];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * chunk, k_end = min(n, k_begin + chunk);
  const Normalize norm{stats, stats + n, 0, gamma, beta, gcode};
  KRowsTile<T, Identity> la{dyc, F, row0, F, k_end, Identity()};
  KRowsTile<T, Normalize> lb{x, D, col0, D, k_end, norm};
  float acc[MT][NT][4] = {};
  mainloop(As, Bs, la, lb, k_begin, k_end, acc);
  const Frag fr;
  float* out = dw_part + (long long)blockIdx.z * F * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + fr.r + mt * 16 + 8 * h;
      if (row >= F) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = col0 + fr.c + nt * 8;
        if (col < D)
          store2(out + (long long)row * D + col, acc[mt][nt][2 * h],
                 acc[mt][nt][2 * h + 1]);
      }
    }
}

// backward (6): out[i] = sum over t of part[t][i], in a fixed order, cast
// to the output's dtype; one job per blockIdx.y
struct ReduceJob {
  const float* part;
  long long count;
  int terms;
  int code;
  void* out;
};
struct ReduceJobs {
  ReduceJob job[4];
};

__global__ void __launch_bounds__(THREADS) reduce_kernel(ReduceJobs jobs) {
  // constant indices: a dynamic one would copy the parameters to local
  // memory in every thread
  ReduceJob j;
  switch (blockIdx.y) {
    case 0: j = jobs.job[0]; break;
    case 1: j = jobs.job[1]; break;
    case 2: j = jobs.job[2]; break;
    default: j = jobs.job[3];
  }
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= j.count) return;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int t = 0;
  for (; t + 4 <= j.terms; t += 4)
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] += j.part[(t + u) * j.count + i];
  for (; t < j.terms; ++t) a[0] += j.part[t * j.count + i];
  put(j.out, j.code, i, (a[0] + a[1]) + (a[2] + a[3]));
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

struct BwdLayout {  // the backward's scratch, in one workspace
  int p1, p2, splits, chunk;
  size_t stats, dbias, dln, dg, db, dw, dyc, bytes;
  BwdLayout(int n, int D, int F, int gelu, size_t esize) {
    p1 = cdiv(n, BM);
    p2 = cdiv(n, ROWS_BWD);
    splits = std::min(4, std::max(1, n / SPLIT_ROWS));
    chunk = cdiv(cdiv(n, splits), 32) * 32;
    size_t o = 0;
    stats = o; o += align256((size_t)2 * n * 4);
    dbias = o; o += align256((size_t)p1 * F * 4);
    dln = o; o += align256((size_t)n * D * 4);
    dg = o; o += align256((size_t)p2 * D * 4);
    db = o; o += align256((size_t)p2 * D * 4);
    dw = o; o += align256((size_t)splits * F * D * 4);
    dyc = o; o += gelu ? align256((size_t)n * F * esize) : 0;
    bytes = o;
  }
};

template <typename T>
int fwd(const void* xv, const void* gamma, const void* beta, int gcode,
        const void* w, const void* bias, int bcode, void* y, float* stats,
        int n, int D, int F, float eps, int gelu, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  ln_stats_kernel<T><<<cdiv(n, WARPS), THREADS, 0, s>>>(x, stats, n, D, eps);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  auto k = gelu ? ln_gemm_kernel<T, 1> : ln_gemm_kernel<T, 0>;
  k<<<dim3(cdiv(n, BM), cdiv(F, BN)), THREADS, 0, s>>>(
      x, stats, gamma, beta, gcode, static_cast<const T*>(w), bias, bcode,
      nullptr, static_cast<T*>(y), nullptr, n, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* xv, const void* gamma, const void* beta, int gcode,
        const void* wv, const void* bias, int bcode, const void* dyv,
        void* dxv, void* dwv, void* dbias, void* dgamma, void* dbeta,
        void* work, int n, int D, int F, float eps, int gelu,
        cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* dy = static_cast<const T*>(dyv);
  const BwdLayout L(n, D, F, gelu, sizeof(T));
  char* ws = static_cast<char*>(work);
  float* stats = reinterpret_cast<float*>(ws + L.stats);
  float* dbias_part = reinterpret_cast<float*>(ws + L.dbias);
  float* dln = reinterpret_cast<float*>(ws + L.dln);
  float* dg_part = reinterpret_cast<float*>(ws + L.dg);
  float* db_part = reinterpret_cast<float*>(ws + L.db);
  float* dw_part = reinterpret_cast<float*>(ws + L.dw);
  const T* dyc = gelu ? reinterpret_cast<const T*>(ws + L.dyc) : dy;
  int rc;

  ln_stats_kernel<T><<<cdiv(n, WARPS), THREADS, 0, s>>>(x, stats, n, D,
                                                         eps);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (gelu)
    ln_gemm_kernel<T, 2><<<dim3(cdiv(n, BM), cdiv(F, BN)), THREADS, 0, s>>>(
        x, stats, gamma, beta, gcode, w, bias, bcode, dy,
        reinterpret_cast<T*>(ws + L.dyc), dbias_part, n, D, F);
  else
    col_partial_kernel<T><<<dim3(L.p1, cdiv(F, THREADS)), THREADS, 0, s>>>(
        dy, dbias_part, n, F);
  if ((rc = (int)cudaGetLastError())) return rc;
  dln_kernel<T><<<dim3(cdiv(n, BM), cdiv(D, BN)), THREADS, 0, s>>>(
      dyc, w, dln, n, D, F);
  if ((rc = (int)cudaGetLastError())) return rc;
  ln_rows_bwd_kernel<T><<<L.p2, THREADS, 0, s>>>(
      x, gamma, gcode, stats, dln, static_cast<T*>(dxv), dg_part, db_part,
      n, D);
  if ((rc = (int)cudaGetLastError())) return rc;
  dw_kernel<T><<<dim3(cdiv(F, BM), cdiv(D, BN), L.splits), THREADS, 0, s>>>(
      x, gamma, beta, gcode, stats, dyc, dw_part, n, D, F, L.chunk);
  if ((rc = (int)cudaGetLastError())) return rc;
  ReduceJobs jobs;
  jobs.job[0] = ReduceJob{dw_part, (long long)F * D, L.splits, code_of<T>(),
                          dwv};
  jobs.job[1] = ReduceJob{dbias_part, F, L.p1, bcode, dbias};
  jobs.job[2] = ReduceJob{dg_part, D, L.p2, gcode, dgamma};
  jobs.job[3] = ReduceJob{db_part, D, L.p2, gcode, dbeta};
  reduce_kernel<<<dim3(cdiv((long long)F * D, THREADS), 4), THREADS, 0,
                  s>>>(jobs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, W, y, dy, dx, dW): 0 = float32, 1 = bfloat16, 2 = float16.
// gcode (gamma,
// beta, dgamma, dbeta) and bcode (bias, dbias): 0 = float32, 1 = bfloat16,
// 2 = float16. x [n, D], W [F, D], y and dy [n, F]: contiguous and 16-byte
// aligned; D and F multiples of 8; stats: 2 n floats of scratch. Every
// call returns cudaGetLastError() after its launches (0 = launched).
int fused_ln_fwd(const void* x, const void* gamma, const void* beta,
                 int gcode, const void* w, const void* bias, int bcode,
                 void* y, float* stats, int n, int D, int F, float eps,
                 int gelu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, gamma, beta, gcode, w, bias, bcode, y,
                              stats, n, D, F, eps, gelu, s);
  if (dtype == 2)
    return fwd<__half>(x, gamma, beta, gcode, w, bias, bcode, y, stats, n,
                       D, F, eps, gelu, s);
  return fwd<float>(x, gamma, beta, gcode, w, bias, bcode, y, stats, n, D,
                    F, eps, gelu, s);
}

// bytes of the workspace fused_ln_bwd needs
long long fused_ln_bwd_workspace(int n, int D, int F, int gelu, int dtype) {
  return (long long)BwdLayout(n, D, F, gelu, dtype == 0 ? 4 : 2).bytes;
}

// dx [n, D] and dW [F, D] in dtype; dbias [F] in bcode; dgamma, dbeta [D]
// in gcode; work: fused_ln_bwd_workspace(...) bytes, 256-byte aligned.
int fused_ln_bwd(const void* x, const void* gamma, const void* beta,
                 int gcode, const void* w, const void* bias, int bcode,
                 const void* dy, void* dx, void* dw, void* dbias,
                 void* dgamma, void* dbeta, void* work, int n, int D, int F,
                 float eps, int gelu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, gamma, beta, gcode, w, bias, bcode, dy, dx,
                              dw, dbias, dgamma, dbeta, work, n, D, F, eps,
                              gelu, s);
  if (dtype == 2)
    return bwd<__half>(x, gamma, beta, gcode, w, bias, bcode, dy, dx, dw,
                       dbias, dgamma, dbeta, work, n, D, F, eps, gelu, s);
  return bwd<float>(x, gamma, beta, gcode, w, bias, bcode, dy, dx, dw,
                    dbias, dgamma, dbeta, work, n, D, F, eps, gelu, s);
}

const char* fused_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

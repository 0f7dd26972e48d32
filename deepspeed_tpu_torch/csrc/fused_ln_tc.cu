// Fused LayerNorm + projection on Hopper's warpgroup tensor cores (wgmma)
// and tensor memory accelerator (TMA), bf16 and fp16, for sm_90a.
//
// Replaces, for 16-bit x and W with D up to TC_MAX_D, the two Pallas TPU
// kernels of deepspeed_tpu/ops/transformer/fused.py: _fwd_kernel (the
// forward, pallas_call at :140) and _bwd_kernel (the backward, :165). The
// function and its rounding points are those of csrc/fused_ln.cu, whose
// header writes them out; that file keeps fp32 and the 16-bit D above
// TC_MAX_D. With x [n, D], W [F, D] (nn.Linear's layout), T = bf16 or
// fp16:
//
//   y = act(T(LayerNorm(x)) W^T + bias)        (fp32 statistics and sums)
//   dyc = T(dy act'(pre)),  dW = dyc^T T(ln),  dln = dyc W,  dbias = sum g
//   dx, dgamma, dbeta from dln, as fused_ln.cu computes them.
//
// What bounds it on an H100: operations. At the training path's shapes (n
// = 8192, D = 768, F = 2304 and 3072 + GELU) the forward multiplies 29.0
// and 38.7 GFLOP (29 and 39 us at 989 TFLOP/s) against 16 and 20 us of
// bytes; the backward runs two such products, three under GELU.
//
// What the design does:
// - Every product is wgmma.mma_async m64n128k16 with fp32 accumulators,
//   both operands read from shared memory through matrix descriptors; a
//   product of 16-bit values is exact in fp32, so only the order of the
//   sums differs from the plain version. A producer thread streams tiles
//   in by TMA (cp.async.bulk.tensor, 128- or 64-byte swizzle) into a ring
//   of stages under full / empty mbarriers; consumer warpgroups issue the
//   wgmmas on a stage, keep one group in flight, and release the stage
//   when its products are done.
// - Forward, one launch: a block owns a panel of 64 rows of x, brought in
//   by TMA straight into wgmma's 128-byte-swizzled K-major layout, and
//   normalises it once, in place: fp32 two-pass statistics, the
//   normalisation rounded op by op, rounded to T. The panel stays
//   resident while the block walks its share of W's column tiles, so x is
//   normalised once per block, not once per column tile, and never
//   reaches device memory. Up to D = 1280 two consumer warpgroups take
//   alternate 128-column tiles, each through its own ring of W's 128 x 64
//   tiles (16 KB a stage) fed by its own producer warp; above, one
//   warpgroup, 32 deep (8 KB). The epilogue adds the bias in fp32,
//   applies the GELU and stores T. The panel (128 D bytes), two stages and
//   the barriers must fit the 232,448 bytes a block may use: 128 D +
//   16,520 <= 232,448, so D <= 1664 (TC_MAX_D, a multiple of 64): every
//   GPT-2 width, 768 to 1600, takes this file.
// - Backward, five launches under GELU and six without, deterministic,
//   no atomics: (1) under GELU the forward's kernel again, which also
//   writes T(ln) [n, D] and the rows' statistics into the workspace (its
//   panel, normalised once per call), dyc, and each warp's column sums of
//   g over its 16 rows; without GELU a rows kernel writes T(ln) and the
//   statistics and a column pass sums dy in 16-row blocks; (2) dln = dyc
//   W, dyc K-major and W MN-major (the transpose bit of wgmma), into an
//   fp32 scratch; (3) a row pass: dx and per-32-row partial sums of dgamma
//   and dbeta; (4) dW = dyc^T T(ln), both operands MN-major, each block
//   owning a 128 x 128 dW tile, summing all n rows in order and storing T
//   straight from its accumulators (at the path's shapes 108 and 144
//   tiles already fill the SMs, so dW is not split over n: no fp32
//   partials); (5) one launch that sums the dbias, dgamma and dbeta
//   partials in a fixed order.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // at run time (cudaGetDriverEntryPoint), no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "attention_tile.cuh"
#include "wgmma.cuh"

namespace {

using attn_tile::load8;
using attn_tile::row_sum;
using hopper::consumer_sync;
using hopper::fence_acc;
using hopper::fence_proxy_async;
using hopper::gmma_desc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::wgmma128;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int WG = 128;                // threads of a warpgroup
constexpr int BN = 128;                // wgmma n: a tile's columns
constexpr int PANEL_K = 64;            // 16-bit values in a 128-byte row
constexpr int GEMM_K = 64;             // backward stage depth
constexpr int GEMM_HALF = 64 * GEMM_K * 2;            // one 64 x 64 box
constexpr int GEMM_STAGE = 4 * GEMM_HALF;             // A and B: 32 KB
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 3 * WG;   // two consumer warpgroups + producer
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;     // 227 KB of dynamic shared memory
constexpr int TC_MAX_D = 1664;
constexpr int PANEL_ROWS = 64;         // rows of x a forward block owns
constexpr int DBIAS_ROWS = 16;         // rows of a dbias partial sum
constexpr int ROWS_BWD = 32;           // rows of a block in the row pass
constexpr int THREADS = 256;           // the plain passes' blocks
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

// ---------------------------------------------------------------------------
// element helpers (as fused_ln.cu's)
// ---------------------------------------------------------------------------

// gamma, beta and bias come in their own dtype: 0 fp32, 1 bf16, 2 fp16
__device__ __forceinline__ float param(const void* p, int code, int i) {
  if (code == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// eight neighbouring parameters from i (a multiple of 8, 16-byte aligned)
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
  if (code == 1) load8(static_cast<const __nv_bfloat16*>(p) + i, v);
  else load8(static_cast<const __half*>(p) + i, v);
}

__device__ __forceinline__ void put(void* p, int code, long long i,
                                    float v) {
  if (code == 1) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else if (code == 2) static_cast<__half*>(p)[i] = __float2half(v);
  else static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// eight values rounded to T as one 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  T* h = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) store2(h + 2 * k, v[2 * k], v[2 * k + 1]);
  return u;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x *
         (1.f + tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float t = tanhf(SQRT_2_OVER_PI * (x + 0.044715f * x * x * x));
  const float du = SQRT_2_OVER_PI * (1.f + 0.134145f * x * x);
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * du;
}

// xhat * gamma + beta, each operation rounded on its own
__device__ __forceinline__ float normalize(float v, float mu, float rs,
                                          float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rs), g), b);
}

// mean and rstd of one row, by a whole warp: fused_ln.cu's two passes in
// its order, so both files normalise a row to the same bits
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

// T(ln) of the values v of columns c .. c + 7 of a row (c < D, a
// multiple of 8)
template <typename T>
__device__ __forceinline__ uint4 ln8(float (&v)[8], int c, float mu,
                                     float rs, const void* gamma,
                                     const void* beta, int gcode) {
  float g[8], b[8];
  param8(gamma, gcode, c, g);
  param8(beta, gcode, c, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = normalize(v[e], mu, rs, g[e], b[e]);
  return pack8<T>(v);
}

// two or eight 16-bit values held in registers, as fp32
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  else
    return __half22float2(*reinterpret_cast<__half2*>(&w));
}
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = unpack2<T>(w[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// The accumulators of row 16 warp + lane / 4 + 8 h and columns 32 g ..
// 32 g + 31, rearranged across the four lanes of a quad (a 4 x 4
// transpose of column pairs, lanes xor 2 then xor 1) so that lane t holds
// the eight neighbouring columns 32 g + 8 t .. + 7 in v; every lane of the
// warp takes part.
__device__ __forceinline__ void quad_columns(const float (&d)[64], int g,
                                             int h, int t, float (&v)[8]) {
  float2 m[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    m[u] = make_float2(d[4 * (4 * g + u) + 2 * h],
                       d[4 * (4 * g + u) + 2 * h + 1]);
#pragma unroll
  for (int bit = 2; bit >= 1; bit >>= 1) {
    const bool up = t & bit;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u & bit) continue;
      const float2 send = up ? m[u] : m[u + bit];
      const float2 recv =
          make_float2(__shfl_xor_sync(attn_tile::FULL, send.x, bit),
                      __shfl_xor_sync(attn_tile::FULL, send.y, bit));
      if (up) m[u] = recv;
      else m[u + bit] = recv;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    v[2 * u] = m[u].x;
    v[2 * u + 1] = m[u].y;
  }
}

// the element (r, c) of the 128-byte-swizzled K-major panel: 64-column
// blocks of `rows` rows of 128 bytes, whose 16-byte chunks are permuted
// by the row's place in its 8-row group (the TMA's and wgmma's pattern)
__device__ __forceinline__ int panel_offset(int r, int c, int rows) {
  return (c / PANEL_K) * rows * 128 + r * 128 +
         ((((c % PANEL_K) >> 3) ^ (r & 7)) << 4);
}

// ---------------------------------------------------------------------------
// forward, and the backward's GELU prologue. grid (ceil(n / 64), nsplit):
// a block owns a panel of 64 rows of x and the 128-column tiles j =
// blockIdx.y, + nsplit, ...; of those, consumer warpgroup w takes every
// NWG-th from the w-th, through its own ring of W's 128 x RK tiles (RK =
// 64: 128-byte swizzle; 32: 64-byte) fed by its own producer warp. MODE
// 0: y = pre; 1: y = gelu(pre); 2: dyc = T(dy gelu'(pre)), and
// dbias_part[4 blockIdx.x + warp][:] = the column sums of dy gelu'(pre)
// over that warp's 16 rows.
// ---------------------------------------------------------------------------
template <typename T, int NWG, int RK, int MODE>
__global__ void __launch_bounds__(WG*(NWG + 1), 1)
    ln_gemm_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const void* gamma, const void* beta, int gcode,
                      const void* bias, int bcode, const T* __restrict__ dy,
                      T* __restrict__ out, float* __restrict__ dbias_part,
                      T* __restrict__ lnT, float* __restrict__ stats, int n,
                      int D, int F, float eps, int stages) {
  constexpr int CONSUMERS = WG * NWG;
  constexpr int STAGE = BN * RK * 2;               // W's 128 x RK tile
  extern __shared__ __align__(1024) uint8_t smem[];
  const int d_pad = (D + PANEL_K - 1) / PANEL_K * PANEL_K;
  uint8_t* panel = smem;
  uint8_t* rings = panel + (size_t)d_pad * PANEL_ROWS * 2;
  uint64_t* fulls =
      reinterpret_cast<uint64_t*>(rings + NWG * stages * STAGE);
  uint64_t* empties = fulls + NWG * MAX_STAGES;
  uint64_t* panel_full = empties + NWG * MAX_STAGES;

  const int row0 = blockIdx.x * PANEL_ROWS;
  const int tiles = (F + BN - 1) / BN;
  const int ksteps = d_pad / RK;
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();   // the swizzle needs 1 KB rows
    for (int w = 0; w < NWG; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(&fulls[w * MAX_STAGES + s], 1);
        mbar_init(&empties[w * MAX_STAGES + s], WG);
      }
    mbar_init(panel_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producers: lane 0 of warp p feeds warpgroup p's ring; the first
    // also loads the panel's rows of x (64-column boxes land in the
    // panel's swizzled layout; past n or D they are zeros)
    const int p = (threadIdx.x - CONSUMERS) >> 5;
    if (p >= NWG || (threadIdx.x & 31)) return;
    if (p == 0) {
      mbar_expect_tx(panel_full, (uint32_t)(d_pad * PANEL_ROWS * 2));
      for (int kb = 0; kb < d_pad / PANEL_K; ++kb)
        tma_load(panel + kb * PANEL_ROWS * 128, &map_x, panel_full,
                 kb * PANEL_K, row0);
    }
    uint8_t* ring = rings + p * stages * STAGE;
    uint64_t* full = fulls + p * MAX_STAGES;
    uint64_t* empty = empties + p * MAX_STAGES;
    int it = 0;
    for (int u = blockIdx.y + p * gridDim.y; u < tiles;
         u += NWG * gridDim.y)
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % stages;
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE);
        tma_load(ring + s * STAGE, &map_w, &full[s], ks * RK, u * BN);
      }
    return;
  }

  // the consumers: normalise the panel once, in place, a warp per row,
  // each lane's eight-value chunks held in registers; the sums are
  // row_stats' (same lanes, same order), so the panel holds ln_rows_kernel's
  // bits. Rows past n and columns past D stay zero.
  constexpr int MAXV = (TC_MAX_D + 255) / 256;
  mbar_wait(panel_full, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < PANEL_ROWS && row0 + r < n; r += CONSUMERS / 32) {
    uint4 raw[MAXV];
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < MAXV; ++t) {
      const int c = (lane + 32 * t) * 8;
      if (c >= D) continue;
      raw[t] = *reinterpret_cast<const uint4*>(
          panel + panel_offset(r, c, PANEL_ROWS));
      float v[8];
      unpack8<T>(raw[t], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[e];
    }
    const float mu = row_sum<32>(s) / D;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < MAXV; ++t) {
      if ((lane + 32 * t) * 8 >= D) continue;
      float v[8];
      unpack8<T>(raw[t], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dv = v[e] - mu;
        sq += dv * dv;
      }
    }
    const float rs = 1.0f / sqrtf(row_sum<32>(sq) / D + eps);
    // MODE 2: the backward's T(ln) and row statistics too (ln_rows_kernel's
    // bits), from the blocks of the first column split
    const bool keep = MODE == 2 && blockIdx.y == 0;
    const long long row = row0 + r;
#pragma unroll
    for (int t = 0; t < MAXV; ++t) {
      const int c = (lane + 32 * t) * 8;
      if (c >= D) continue;
      float v[8];
      unpack8<T>(raw[t], v);
      const uint4 u = ln8<T>(v, c, mu, rs, gamma, beta, gcode);
      *reinterpret_cast<uint4*>(panel + panel_offset(r, c, PANEL_ROWS)) = u;
      if (keep) *reinterpret_cast<uint4*>(lnT + row * D + c) = u;
    }
    if (keep && lane == 0) {
      stats[row] = mu;
      stats[n + row] = rs;
    }
  }
  fence_proxy_async();   // the panel's writes, before wgmma reads them
  consumer_sync(CONSUMERS);

  const int wg = threadIdx.x / WG;
  const int q = (threadIdx.x % WG) >> 5;
  const int rbase = row0 + q * 16 + (lane >> 2);
  const uint8_t* ring = rings + wg * stages * STAGE;
  uint64_t* full = fulls + wg * MAX_STAGES;
  uint64_t* empty = empties + wg * MAX_STAGES;
  int it = 0;
  for (int u = blockIdx.y + wg * gridDim.y; u < tiles;
       u += NWG * gridDim.y) {
    const int col0 = u * BN;
    const int t = lane & 3;
    // MODE 2: the tile's dy, eight neighbouring columns a vector as the
    // epilogue holds them, loaded before the products hide its latency
    uint4 dyr[4][2];
    if (MODE == 2) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + 8 * h, col = col0 + 32 * g + 8 * t;
          dyr[g][h] = row < n && col < F
                          ? *reinterpret_cast<const uint4*>(
                                dy + (long long)row * F + col)
                          : make_uint4(0, 0, 0, 0);
        }
    }
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    int prev = -1;
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      const int k = ks * RK;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < RK / 16; ++kk) {
        const int kc = k + kk * 16;
        const uint64_t da = gmma_desc(
            panel + (kc / PANEL_K) * PANEL_ROWS * 128 + (kc % PANEL_K) * 2,
            16, 1024, 1);
        const uint64_t db =
            gmma_desc(ring + s * STAGE + kk * 32, 16, 16 * RK,
                      RK == 64 ? 1 : 2);
        wgmma128<T, 0, 0>(d, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(d);
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(&empty[prev]);

    // the epilogue, four groups of 32 columns: the quad's transpose gives
    // each lane eight neighbouring columns of its two rows; bias in fp32,
    // the activation, 16-byte T stores. MODE 2: the warp's column sums of
    // g over its 16 rows (a thread's two rows, then the 8 row groups,
    // lanes xor 4, 8, 16), one partial row per warp.
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int col = col0 + 32 * g + 8 * t;
      const bool cok = col < F;
      float bv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (cok) param8(bias, bcode, col, bv);
      float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[8];
        quad_columns(d, g, h, t, v);
        const int row = rbase + 8 * h;
        if (!cok || row >= n) continue;
        float dyv[8];
        if (MODE == 2) unpack8<T>(dyr[g][h], dyv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] += bv[e];
          if (MODE == 1) v[e] = gelu(v[e]);
          if (MODE == 2) {
            v[e] = dyv[e] * gelu_grad(v[e]);
            cs[e] += v[e];
          }
        }
        *reinterpret_cast<uint4*>(out + (long long)row * F + col) =
            pack8<T>(v);
      }
      if (MODE == 2) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int m = 4; m < 32; m <<= 1)
            cs[e] += __shfl_xor_sync(attn_tile::FULL, cs[e], m);
        if (lane < 4 && cok && row0 + 16 * q < n) {
          float* part = dbias_part + (long long)(4 * blockIdx.x + q) * F +
                        col;
          reinterpret_cast<float4*>(part)[0] =
              make_float4(cs[0], cs[1], cs[2], cs[3]);
          reinterpret_cast<float4*>(part)[1] =
              make_float4(cs[4], cs[5], cs[6], cs[7]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the backward's products, a 128 x 128 output tile a block over the whole
// depth K, 64 deep a stage. KIND 0, dln = dyc W: rows of dyc (A, K-major:
// one 128 x 64 box), W (B, MN-major: two 64 x 64 boxes), out32 = dln
// [M = n, N = D]. KIND 1, dW = dyc^T T(ln): dyc (A, MN-major) and T(ln)
// (B, MN-major), two 64 x 64 boxes each, out16 = dW [M = F, N = D].
// ---------------------------------------------------------------------------
template <typename T, int KIND>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    float* __restrict__ out32, T* __restrict__ out16, int M,
                    int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + GEMM_STAGES *
                                               GEMM_STAGE);
  uint64_t* empty = full + GEMM_STAGES;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * BN;
  const int ksteps = (K + GEMM_K - 1) / GEMM_K;
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    if (threadIdx.x != 2 * WG) return;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int s = ks % GEMM_STAGES;
      const int k = ks * GEMM_K;
      uint8_t* st = smem + s * GEMM_STAGE;
      mbar_wait(&empty[s], ((ks / GEMM_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], GEMM_STAGE);
      if (KIND == 0) {
        tma_load(st, &map_a, &full[s], k, m0);
      } else {
        tma_load(st, &map_a, &full[s], m0, k);
        tma_load(st + GEMM_HALF, &map_a, &full[s], m0 + 64, k);
      }
      tma_load(st + 2 * GEMM_HALF, &map_b, &full[s], n0, k);
      tma_load(st + 3 * GEMM_HALF, &map_b, &full[s], n0 + 64, k);
    }
    return;
  }

  const int wg = threadIdx.x / WG, tw = threadIdx.x % WG;
  const int q = tw >> 5, lane = tw & 31;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  int prev = -1;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % GEMM_STAGES;
    const uint8_t* st = smem + s * GEMM_STAGE;
    mbar_wait(&full[s], (ks / GEMM_STAGES) & 1);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GEMM_K / 16; ++kk) {
      // A: the warpgroup's 64 rows; K-major advances 32 bytes along a
      // swizzled row, MN-major two 8-deep groups of 128-byte rows
      const uint64_t da =
          KIND == 0
              ? gmma_desc(st + wg * GEMM_HALF + kk * 32, 16, 1024, 1)
              : gmma_desc(st + wg * GEMM_HALF + kk * 2048, GEMM_HALF, 1024,
                          1);
      const uint64_t db =
          gmma_desc(st + 2 * GEMM_HALF + kk * 2048, GEMM_HALF, 1024, 1);
      wgmma128<T, KIND, 1>(d, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(d);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(d);

  const int rbase = m0 + wg * 64 + q * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + 8 * h;
      if (row >= M) continue;
      const long long o = (long long)row * N + col;
      if (KIND == 1)
        store2(out16 + o, d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
      else
        store2(out32 + o, d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the plain passes of the backward
// ---------------------------------------------------------------------------

// without GELU: each row's mean and rstd into stats[0:n] and stats[n:2n],
// and T(ln) into lnT [n, D]; a warp per row
template <typename T>
__global__ void __launch_bounds__(THREADS) ln_rows_kernel(
    const T* __restrict__ x, const void* gamma, const void* beta, int gcode,
    float* __restrict__ stats, T* __restrict__ lnT, int n, int D,
    float eps) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + (long long)row * D;
  float mu, rs;
  row_stats(xr, D, eps, mu, rs);
  for (int c = lane * 8; c < D; c += 256) {
    float v[8];
    load8(xr + c, v);
    *reinterpret_cast<uint4*>(lnT + (long long)row * D + c) =
        ln8<T>(v, c, mu, rs, gamma, beta, gcode);
  }
  if (lane == 0) {
    stats[row] = mu;
    stats[n + row] = rs;
  }
}

// without GELU: part[blockIdx.x][c, c + 1] = sums of dy over the
// block's `rows` rows, in order; a thread a pair of columns
template <typename T>
__global__ void __launch_bounds__(THREADS) col_partial_kernel(
    const T* __restrict__ dy, float* __restrict__ part, int n, int F,
    int rows) {
  const int c = 2 * (blockIdx.y * THREADS + threadIdx.x);
  if (c >= F) return;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  float2 s = make_float2(0.f, 0.f);
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const float2 v = unpack2<T>(
        *reinterpret_cast<const uint32_t*>(dy + (long long)r * F + c));
    s.x += v.x;
    s.y += v.y;
  }
  *reinterpret_cast<float2*>(part + (long long)blockIdx.x * F + c) = s;
}

// the row pass, over ROWS_BWD rows a block: dx, and
// dg_part / db_part[blockIdx.x][:] = sums of dln xhat and dln over those
// rows, in order. A warp per row for the row means (eight columns a
// lane), then a thread a pair of columns down the rows.
template <typename T>
__global__ void __launch_bounds__(THREADS) ln_rows_bwd_kernel(
    const T* __restrict__ x, const void* gamma, int gcode,
    const float* __restrict__ stats, const float* __restrict__ dln,
    T* __restrict__ dx, float* __restrict__ dg_part,
    float* __restrict__ db_part, int n, int D) {
  __shared__ float s_m1[ROWS_BWD], s_m2[ROWS_BWD];
  const float* mean = stats;
  const float* rstd = stats + n;
  const int row0 = blockIdx.x * ROWS_BWD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS_BWD; r += THREADS / 32) {
    const int row = row0 + r;
    float m1 = 0.f, m2 = 0.f;
    if (row < n) {
      const float mu = mean[row], rs = rstd[row];
      const T* xr = x + (long long)row * D;
      const float* dr = dln + (long long)row * D;
      for (int c = lane * 8; c < D; c += 256) {
        float xv[8], g[8];
        load8(xr + c, xv);
        param8(gamma, gcode, c, g);
        const float4 a = *reinterpret_cast<const float4*>(dr + c);
        const float4 b = *reinterpret_cast<const float4*>(dr + c + 4);
        const float dl[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (xv[e] - mu) * rs;
          const float dxh = dl[e] * g[e];
          m1 += dxh;
          m2 += dxh * xh;
        }
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
  for (int c = 2 * threadIdx.x; c < D; c += 2 * THREADS) {
    const float g0 = param(gamma, gcode, c), g1 = param(gamma, gcode, c + 1);
    float2 dg = make_float2(0.f, 0.f), db = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const long long o = (long long)(row0 + r) * D + c;
      const float mu = mean[row0 + r], rs = rstd[row0 + r];
      const float2 xv = unpack2<T>(*reinterpret_cast<const uint32_t*>(x + o));
      const float2 dl = *reinterpret_cast<const float2*>(dln + o);
      const float xh0 = (xv.x - mu) * rs, xh1 = (xv.y - mu) * rs;
      store2(dx + o, rs * (dl.x * g0 - s_m1[r] - xh0 * s_m2[r]),
             rs * (dl.y * g1 - s_m1[r] - xh1 * s_m2[r]));
      dg.x += dl.x * xh0;
      dg.y += dl.y * xh1;
      db.x += dl.x;
      db.y += dl.y;
    }
    *reinterpret_cast<float2*>(dg_part + (long long)blockIdx.x * D + c) = dg;
    *reinterpret_cast<float2*>(db_part + (long long)blockIdx.x * D + c) = db;
  }
}

// the sums of dbias, dgamma and dbeta: out[i] = sum over t of
// part[t][i], cast to the output's dtype; one job per blockIdx.y (a block
// past its job's count is idle). A block sums 32 outputs: warp w takes
// the terms t = w, w + 8, ... in order, then the eight warps' sums are
// added in warp order.
struct ReduceJob {
  const float* part;
  long long count;
  int terms;
  int code;
  void* out;
};
struct ReduceJobs {
  ReduceJob job[3];
};

__global__ void __launch_bounds__(THREADS) reduce_kernel(ReduceJobs jobs) {
  __shared__ float s_sum[THREADS / 32][32];
  ReduceJob j;
  switch (blockIdx.y) {   // constant indices keep the jobs in registers
    case 0: j = jobs.job[0]; break;
    case 1: j = jobs.job[1]; break;
    default: j = jobs.job[2];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * 32 + lane;
  if ((long long)blockIdx.x * 32 >= j.count) return;   // the whole block
  float a = 0.f;
  if (i < j.count)
#pragma unroll 4
    for (int t = warp; t < j.terms; t += THREADS / 32)
      a += j.part[t * j.count + i];
  s_sum[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && i < j.count) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += s_sum[w][lane];
    put(j.out, j.code, i, total);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(1, sms);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// a tensor map of a row-major [outer, inner] 16-bit matrix read in boxes
// of [box_outer, box_inner] (box_inner x 2 bytes = the swizzle's span)
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                     int box_inner, int box_outer) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map,
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_inner * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Fn>
cudaError_t set_smem(Fn fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// the forward's variant: two consumer warpgroups, each with a ring of
// 16 KB stages (W's 128 x 64 tiles), while the panel leaves two stages a
// ring (D <= 1280); above, one warpgroup, 8 KB stages 32 deep (D <=
// TC_MAX_D)
inline bool wide(int D) { return D <= 1280; }

// the forward kernel (MODE 0/1) or the backward's GELU prologue (MODE 2)
template <typename T, int NWG, int RK, int MODE>
cudaError_t ln_gemm(const void* x, const void* gamma, const void* beta,
                    int gcode, const void* w, const void* bias, int bcode,
                    const void* dy, void* out, float* dbias_part, void* lnT,
                    float* stats, int n, int D, int F, float eps,
                    cudaStream_t s) {
  constexpr int STAGE = BN * RK * 2;
  const int d_pad = (D + PANEL_K - 1) / PANEL_K * PANEL_K;
  const size_t panel = (size_t)d_pad * PANEL_ROWS * 2;
  const size_t bars = (2 * NWG * MAX_STAGES + 1) * 8;
  const int stages = std::min<long long>(
      MAX_STAGES, ((long long)SMEM_LIMIT - (long long)panel -
                   (long long)bars) / (NWG * STAGE));
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = panel + (size_t)NWG * stages * STAGE + bars;
  CUtensorMap map_x, map_w;
  cudaError_t err;
  if ((err = make_map<T>(&map_x, x, D, n, PANEL_K, PANEL_ROWS)) !=
          cudaSuccess ||
      (err = make_map<T>(&map_w, w, D, F, RK, BN)) != cudaSuccess)
    return err;
  auto fn = ln_gemm_tc_kernel<T, NWG, RK, MODE>;
  if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
  const int panels = cdiv(n, PANEL_ROWS), tiles = cdiv(F, BN * NWG);
  const int nsplit = std::max(1, std::min(tiles, sm_count() / panels));
  fn<<<dim3(panels, nsplit), WG * (NWG + 1), smem, s>>>(
      map_x, map_w, gamma, beta, gcode, bias, bcode,
      static_cast<const T*>(dy), static_cast<T*>(out), dbias_part,
      static_cast<T*>(lnT), stats, n, D, F, eps, stages);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t ln_gemm_d(const void* x, const void* gamma, const void* beta,
                      int gcode, const void* w, const void* bias, int bcode,
                      const void* dy, void* out, float* dbias_part,
                      void* lnT, float* stats, int n, int D, int F, float eps,
                      cudaStream_t s) {
  return wide(D)
             ? ln_gemm<T, 2, 64, MODE>(x, gamma, beta, gcode, w, bias, bcode,
                                       dy, out, dbias_part, lnT, stats, n,
                                       D, F, eps, s)
             : ln_gemm<T, 1, 32, MODE>(x, gamma, beta, gcode, w, bias, bcode,
                                       dy, out, dbias_part, lnT, stats, n,
                                       D, F, eps, s);
}

template <typename T, int KIND>
cudaError_t bwd_gemm(const CUtensorMap& a, const CUtensorMap& b,
                     float* out32, T* out16, int M, int N, int K,
                     cudaStream_t s) {
  constexpr size_t smem = GEMM_STAGES * GEMM_STAGE + 2 * GEMM_STAGES * 8;
  auto fn = bwd_gemm_kernel<T, KIND>;
  cudaError_t err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<dim3(cdiv(M, 128), cdiv(N, BN)), GEMM_THREADS, smem, s>>>(
      a, b, out32, out16, M, N, K);
  return cudaGetLastError();
}

struct BwdLayout {  // the backward's scratch, in one workspace
  int p1, p2;
  size_t stats, lnT, dbias, dln, dg, db, dyc, bytes;
  BwdLayout(int n, int D, int F, int gelu) {
    p1 = cdiv(n, DBIAS_ROWS);
    p2 = cdiv(n, ROWS_BWD);
    size_t o = 0;
    stats = o; o += align256((size_t)2 * n * 4);
    lnT = o; o += align256((size_t)n * D * 2);
    dbias = o; o += align256((size_t)p1 * F * 4);
    dln = o; o += align256((size_t)n * D * 4);
    dg = o; o += align256((size_t)p2 * D * 4);
    db = o; o += align256((size_t)p2 * D * 4);
    dyc = o; o += gelu ? align256((size_t)n * F * 2) : 0;
    bytes = o;
  }
};

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, int gcode,
        const void* w, const void* bias, int bcode, void* y, int n, int D,
        int F, float eps, int gelu, cudaStream_t s) {
  return (int)(gelu ? ln_gemm_d<T, 1>(x, gamma, beta, gcode, w, bias, bcode,
                                      nullptr, y, nullptr, nullptr, nullptr,
                                      n, D, F, eps, s)
                    : ln_gemm_d<T, 0>(x, gamma, beta, gcode, w, bias, bcode,
                                      nullptr, y, nullptr, nullptr, nullptr,
                                      n, D, F, eps, s));
}

template <typename T>
int bwd(const void* xv, const void* gamma, const void* beta, int gcode,
        const void* w, const void* bias, int bcode, const void* dyv,
        void* dxv, void* dwv, void* dbias, void* dgamma, void* dbeta,
        void* work, int n, int D, int F, float eps, int gelu,
        cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  const BwdLayout L(n, D, F, gelu);
  char* ws = static_cast<char*>(work);
  float* stats = reinterpret_cast<float*>(ws + L.stats);
  T* lnT = reinterpret_cast<T*>(ws + L.lnT);
  float* dbias_part = reinterpret_cast<float*>(ws + L.dbias);
  float* dln = reinterpret_cast<float*>(ws + L.dln);
  float* dg_part = reinterpret_cast<float*>(ws + L.dg);
  float* db_part = reinterpret_cast<float*>(ws + L.db);
  T* dyc = gelu ? reinterpret_cast<T*>(ws + L.dyc) : const_cast<T*>(dy);
  cudaError_t err;

  if (gelu)   // the GELU prologue writes T(ln) and the statistics too
    err = ln_gemm_d<T, 2>(x, gamma, beta, gcode, w, bias, bcode, dy, dyc,
                          dbias_part, lnT, stats, n, D, F, eps, s);
  else {
    ln_rows_kernel<T><<<cdiv(n, THREADS / 32), THREADS, 0, s>>>(
        x, gamma, beta, gcode, stats, lnT, n, D, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    col_partial_kernel<T>
        <<<dim3(L.p1, cdiv(F, 2 * THREADS)), THREADS, 0, s>>>(
            dy, dbias_part, n, F, DBIAS_ROWS);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;

  CUtensorMap dyc_k, w_mn, dyc_mn, ln_mn;
  if ((err = make_map<T>(&dyc_k, dyc, F, n, GEMM_K, 128)) != cudaSuccess ||
      (err = make_map<T>(&w_mn, w, D, F, 64, GEMM_K)) != cudaSuccess ||
      (err = make_map<T>(&dyc_mn, dyc, F, n, 64, GEMM_K)) != cudaSuccess ||
      (err = make_map<T>(&ln_mn, lnT, D, n, 64, GEMM_K)) != cudaSuccess)
    return (int)err;
  if ((err = bwd_gemm<T, 0>(dyc_k, w_mn, dln, nullptr, n, D, F, s)) !=
      cudaSuccess)
    return (int)err;
  ln_rows_bwd_kernel<T><<<L.p2, THREADS, 0, s>>>(
      x, gamma, gcode, stats, dln, static_cast<T*>(dxv), dg_part, db_part, n,
      D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = bwd_gemm<T, 1>(dyc_mn, ln_mn, nullptr, static_cast<T*>(dwv), F,
                            D, n, s)) != cudaSuccess)
    return (int)err;
  ReduceJobs jobs;
  jobs.job[0] = ReduceJob{dbias_part, F, L.p1, bcode, dbias};
  jobs.job[1] = ReduceJob{dg_part, D, L.p2, gcode, dgamma};
  jobs.job[2] = ReduceJob{db_part, D, L.p2, gcode, dbeta};
  reduce_kernel<<<dim3(cdiv(std::max(F, D), 32), 3), THREADS, 0, s>>>(jobs);
  return (int)cudaGetLastError();
}

bool takes(int n, int D, int F, int dtype) {
  return (dtype == 1 || dtype == 2) && n >= 1 && D >= 8 && D % 8 == 0 &&
         D <= TC_MAX_D && F >= 8 && F % 8 == 0;
}

}  // namespace

extern "C" {

// The arguments of fused_ln.cu's entry points, for dtype 1 (bfloat16) or
// 2 (float16) and D a multiple of 8 up to TC_MAX_D (anything else returns
// cudaErrorInvalidValue); the forward computes its own row statistics,
// so `stats` is not used. Every call returns cudaGetLastError() after its
// launches (0 = launched).
int fused_ln_tc_fwd(const void* x, const void* gamma, const void* beta,
                    int gcode, const void* w, const void* bias, int bcode,
                    void* y, float* stats, int n, int D, int F, float eps,
                    int gelu, int dtype, void* stream) {
  (void)stats;
  if (!takes(n, D, F, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(x, gamma, beta, gcode, w, bias, bcode, y, n, D,
                              F, eps, gelu, s);
  return fwd<__half>(x, gamma, beta, gcode, w, bias, bcode, y, n, D, F, eps,
                     gelu, s);
}

long long fused_ln_tc_bwd_workspace(int n, int D, int F, int gelu,
                                    int dtype) {
  (void)dtype;
  return (long long)BwdLayout(n, D, F, gelu).bytes;
}

int fused_ln_tc_bwd(const void* x, const void* gamma, const void* beta,
                    int gcode, const void* w, const void* bias, int bcode,
                    const void* dy, void* dx, void* dw, void* dbias,
                    void* dgamma, void* dbeta, void* work, int n, int D,
                    int F, float eps, int gelu, int dtype, void* stream) {
  if (!takes(n, D, F, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, gamma, beta, gcode, w, bias, bcode, dy, dx,
                              dw, dbias, dgamma, dbeta, work, n, D, F, eps,
                              gelu, s);
  return bwd<__half>(x, gamma, beta, gcode, w, bias, bcode, dy, dx, dw,
                     dbias, dgamma, dbeta, work, n, D, F, eps, gelu, s);
}

const char* fused_ln_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

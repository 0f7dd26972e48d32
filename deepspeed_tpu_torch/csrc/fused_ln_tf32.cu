// Fused LayerNorm + projection in fp32 on Hopper's warpgroup tensor cores
// (wgmma) as 3xTF32, fed by the tensor memory accelerator (TMA), for
// sm_90a.
//
// Replaces, for float32 x and W, the two Pallas TPU kernels of
// deepspeed_tpu/ops/transformer/fused.py: _fwd_kernel (the forward, :68,
// pallas_call at :140) and _bwd_kernel (the backward, :81, pallas_call at
// :165). The function and its rounding points are csrc/fused_ln.cu's,
// whose header writes them out, with T = fp32 (T() is the identity). With
// x [n, D], W [F, D] (nn.Linear's layout):
//
//   mean, rstd = 1.0f / sqrtf(var + eps)    (fp32, two passes over a row)
//   ln = (x - mean) rstd gamma + beta,  y = act(ln W^T + bias)
//   g = dy act'(pre) (or dy),  dW = g^T ln,  dln = g W,  dbias = sum_i g
//   dx, dgamma, dbeta from dln, as fused_ln.cu computes them.
//
// What bounds it on an H100: operations. Each fp32 product runs as three
// TF32 products (below), so the card's rate for it is 495 / 3 = 165
// TFLOP/s. At the training path's shapes (n = 8192, D = 768, F = 2304,
// and F = 3072 + GELU) the forward multiplies 2 n D F = 29.0 and 38.7
// GFLOP: 176 and 234 us at that rate, against 21 and 40 us for its bytes
// at 3.35 TB/s; the backward runs two such products, three under GELU
// (352 and 703 us).
//
// What the design does:
// - 3xTF32, as csrc/tf32_mma.cuh's mma.sync kernels do it: an fp32
//   operand x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna in
//   two integer operations), and each product is lo.hi + hi.lo + hi.hi
//   (lo.lo, below 2^-22 of it, is dropped). The tensor cores sum those
//   products over FOLD k-steps (one 32-deep stage) into a fresh set of
//   accumulators, which an fp32 add folds into the running sum: the
//   tensor cores' fp32 accumulation drops low bits of the larger addend,
//   which over dW's 8192 rows would cost digits the fp32 path is held to.
// - Every product is wgmma.mma_async m64n128k8 tf32 with A from registers.
//   TF32 wgmma reads a shared operand K-major only (there is no transpose
//   bit), so B's hi and lo are laid out K-major in the workspace, once per
//   call, by a prologue: W's [F, D] for the forward and the GELU
//   recompute, W^T's [D, F] for dln = g W (whose k runs along W's rows),
//   ln^T's [D, n] for dW = g^T ln (whose k runs along both operands'
//   rows; ln^T rather than g^T because D < F: 2 n D 4 bytes written and
//   read, ~50 MB and ~30 us at the path's shapes, against the backward's
//   bound of 1.05 ms). A is streamed raw and its wgmma fragments are
//   built in registers, so its stored layout does not matter: x
//   normalised on the way (the normalised rows never reach device memory
//   in the forward, as in the TPU kernel), g as stored for dln, g^T from
//   g's boxes for dW.
// - A block computes a 128 x 128 output tile with two warpgroups of 64
//   rows each (256 threads, so up to 255 registers a thread: a producer
//   warp would round the block up to 384 threads and cap them at 168).
//   Its thread 0 streams raw A, B hi and B lo (16 KB each, 32 deep,
//   128-byte swizzle; a box past an edge fills with zeros) by TMA into a
//   ring of four 48 KB stages under full / empty mbarriers, refilling a
//   stage as soon as both warpgroups have released it. A warpgroup issues
//   a stage's 12 wgmmas, builds the next stage's A fragments while they
//   run, waits for them, folds and releases the stage. The 64 + 64
//   accumulators and 2 x 32 fragment registers a thread holds are why a
//   tile is 128 columns, not 256.
// - Forward, two launches: the prologue (W's hi and lo, the rows'
//   statistics), then the product, whose epilogue adds the bias in fp32,
//   applies the GELU and stores fp32.
// - Backward, six launches, deterministic, no atomics: (1) the prologue:
//   W^T's hi and lo (and W's under GELU), the rows' statistics and ln^T's
//   hi and lo; (2) under GELU the forward's product again, whose epilogue
//   writes g and each warp's column sums of g over its 16 rows (without
//   GELU a column pass sums dy in 16-row blocks); (3) dln = g W into an
//   fp32 scratch; (4) fused_ln_tc.cu's row pass in fp32: dx, and
//   per-32-row partial sums of dgamma and dbeta; (5) dW = g^T ln, whose
//   128 x 128 tiles are split over the rows into up to MAX_SPLIT chunks of
//   at least MIN_CHUNK rows where that fills the SMs' waves better (108
//   and 144 tiles at the path's sites: 1.09 waves of 132 SMs for the
//   second), each chunk's fp32 partial in the workspace; (6)
//   fused_ln_tc.cu's reduce kernel: dbias, dgamma, dbeta and dW's chunks,
//   each summed in one fixed order.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // at run time (cudaGetDriverEntryPoint), no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attention_tile.cuh"
#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace {

using attn_tf32::split_tf32;
using attn_tile::load8;
using attn_tile::row_sum;
using hopper::fence_acc;
using hopper::fence_regs;
using hopper::gmma_desc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::tma_load;
using hopper::wgmma128_tf32_rs;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int WG = 128;                 // threads of a warpgroup
constexpr int BM = 128;                 // a block's rows
constexpr int BN = 128;                 // a block's columns
// where the second warpgroup's 64 x 128 tile (wgmma m 64, n 128) sits in
// the block's: 64 rows below the first's
constexpr int WG_ROWS = 64;
constexpr int WG_COLS = 0;
constexpr int BK = 32;                  // a stage's depth: 128 bytes of fp32
constexpr int KSTEP = 8;                // a tf32 wgmma's depth
constexpr int KSTEPS = BK / KSTEP;      // k-steps a stage
constexpr int FOLD = 4;                 // k-steps summed before a fold
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK * 4;     // raw A's box: 16 KB
constexpr int B_TILE = BN * BK * 4;     // B hi's or B lo's box: 16 KB
constexpr int STAGE_BYTES = A_TILE + 2 * B_TILE;
static_assert(BM == 64 + WG_ROWS && BN == 128 + WG_COLS,
              "two warpgroups of 64 x 128 cover the block's tile");
constexpr int GEMM_THREADS = 2 * WG;   // two warpgroups
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int MAX_SPLIT = 8;            // dW's chunks over the rows
constexpr int MIN_CHUNK = 1024;         // rows of a dW chunk, at least
constexpr int PART_ROWS = 16;           // rows of a dbias partial sum
constexpr int ROWS_BWD = 32;            // rows of a block in the row pass
constexpr int PRE_ROWS = 32;            // rows of a prologue row block
constexpr int THREADS = 256;            // the plain passes' blocks
constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;

// A's source: x normalised (K-major), g as stored (K-major), g^T (g's
// [k][m] boxes)
enum { A_NORM = 0, A_ROWS = 1, A_COLS = 2 };
// the epilogue: pre, gelu(pre), g = dy gelu'(pre) with dbias partials, the
// sum as it is
enum { OUT_PRE = 0, OUT_GELU = 1, OUT_DYC = 2, OUT_PLAIN = 3 };

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

__device__ __forceinline__ void put(void* p, int code, long long i,
                                    float v) {
  if (code == 1) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else if (code == 2) static_cast<__half*>(p)[i] = __float2half(v);
  else static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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
// its order
__device__ __forceinline__ void row_stats(const float* xr, int D, float eps,
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

// ---------------------------------------------------------------------------
// the prologue: blocks [0, wblocks) take 32 x 32 tiles of W [F, D] (its hi
// and lo as stored and gamma, beta and bias as fp32 into vec [2 D + F],
// PLAIN_W; W's hi and lo transposed, TRANS_W); the rest take 32 rows of x
// each: their mean and rstd into stats[0:n] and stats[n:2n] and, LN_T,
// the hi and lo of their ln^T [D, n_pad] columns (zeros past n)
// ---------------------------------------------------------------------------
template <bool PLAIN_W, bool TRANS_W, bool LN_T>
__global__ void __launch_bounds__(THREADS) ln_prologue_tf32_kernel(
    const float* __restrict__ w, float* __restrict__ w_hi,
    float* __restrict__ w_lo, float* __restrict__ wt_hi,
    float* __restrict__ wt_lo, const float* __restrict__ x,
    const void* gamma, const void* beta, int gcode, const void* bias,
    int bcode, float* __restrict__ vec, float* __restrict__ stats,
    float* __restrict__ lt_hi, float* __restrict__ lt_lo, int n, int n_pad,
    int D, int F, float eps, int wblocks) {
  __shared__ float sh[32][33], sl[32][33];
  __shared__ float s_mu[PRE_ROWS], s_rs[PRE_ROWS];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  if ((int)blockIdx.x < wblocks) {
    const int dt = (D + 31) / 32;
    const int c0 = (blockIdx.x % dt) * 32, f0 = (blockIdx.x / dt) * 32;
    if (PLAIN_W && f0 == 0 && ty == 0 && c0 + tx < D) {
      vec[c0 + tx] = param(gamma, gcode, c0 + tx);
      vec[D + c0 + tx] = param(beta, gcode, c0 + tx);
    }
    if (PLAIN_W && c0 == 0 && ty == 1 && f0 + tx < F)
      vec[2 * D + f0 + tx] = param(bias, bcode, f0 + tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + ty + 8 * j, c = c0 + tx;
      uint32_t h = 0, l = 0;
      if (f < F && c < D) {
        const long long o = (long long)f * D + c;
        split_tf32(w[o], h, l);
        if (PLAIN_W) {
          w_hi[o] = __uint_as_float(h);
          w_lo[o] = __uint_as_float(l);
        }
      }
      if (TRANS_W) {
        sh[ty + 8 * j][tx] = __uint_as_float(h);
        sl[ty + 8 * j][tx] = __uint_as_float(l);
      }
    }
    if (TRANS_W) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + ty + 8 * j, f = f0 + tx;
        if (c < D && f < F) {
          wt_hi[(long long)c * F + f] = sh[tx][ty + 8 * j];
          wt_lo[(long long)c * F + f] = sl[tx][ty + 8 * j];
        }
      }
    }
    return;
  }
  const int i0 = (blockIdx.x - wblocks) * PRE_ROWS;
  for (int r = ty; r < PRE_ROWS; r += THREADS / 32) {
    const int row = i0 + r;
    float mu = 0.f, rs = 0.f;
    if (row < n) row_stats(x + (long long)row * D, D, eps, mu, rs);
    if (tx == 0) {
      s_mu[r] = mu;
      s_rs[r] = rs;
      if (row < n) {
        stats[row] = mu;
        stats[n + row] = rs;
      }
    }
  }
  if (!LN_T) return;
  __syncthreads();
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + tx;
    const float g = c < D ? param(gamma, gcode, c) : 0.f;
    const float b = c < D ? param(beta, gcode, c) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 8 * j, row = i0 + r;
      uint32_t h = 0, l = 0;
      if (row < n && c < D)
        split_tf32(normalize(x[(long long)row * D + c], s_mu[r], s_rs[r], g,
                             b),
                   h, l);
      sh[tx][r] = __uint_as_float(h);
      sl[tx][r] = __uint_as_float(l);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = ty + 8 * j;
      if (c0 + cc < D && i0 + tx < n_pad) {
        const long long o = (long long)(c0 + cc) * n_pad + i0 + tx;
        lt_hi[o] = sh[cc][tx];
        lt_lo[o] = sl[cc][tx];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the products: out [M, N] (+ blockIdx.z M N) = A B^T over the depth slice
// [z chunk, min(K, (z + 1) chunk)), A's rows m and B's rows n each K
// deep; B's hi and lo K-major [N, K] in the workspace, A raw (ASRC).
// ---------------------------------------------------------------------------
struct GemmArgs {
  const float* stats;       // A_NORM: mean [M], then rstd [M]
  const float* gamma;       // A_NORM: [K], fp32 (the prologue's copies)
  const float* beta;
  const float* bias;        // OUT_PRE, OUT_GELU, OUT_DYC: [N], fp32
  const float* dy;          // OUT_DYC: [M, N]
  float* out;
  float* part;              // OUT_DYC: [BM / 16 gridDim.y][N], 16-row sums
  int M, N, K, chunk;       // chunk: a multiple of BK
};

// the byte offset of A's element (row r of the block, k of the stage) in
// its stage: A_NORM and A_ROWS, one [BM][32] box (128-byte swizzle: the
// 16-byte chunk index xor the row's place in its 8-row group); A_COLS,
// BM / 32 boxes [32 k][32 m] of g
template <int ASRC>
__device__ __forceinline__ int a_offset(int r, int k) {
  if (ASRC == A_COLS)
    return (r >> 5) * 4096 + k * 128 + ((((r & 31) >> 2) ^ (k & 7)) << 4) +
           (r & 3) * 4;
  return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4;
}

// the A fragments of one stage (at `st`, depth k0 .. k0 + BK - 1), split:
// a[kk][e] is (row r0 + 8 (e & 1), k 8 kk + t + 4 (e >> 1)) of the
// block's tile, t = lane % 4; A_NORM normalises x on the way (0 past K)
template <int ASRC>
__device__ __forceinline__ void a_frags(const uint8_t* st, int r0, int k0,
                                        const GemmArgs& p,
                                        const float (&mu)[2],
                                        const float (&rs)[2],
                                        uint32_t (&ah)[KSTEPS][4],
                                        uint32_t (&al)[KSTEPS][4]) {
  const int t = threadIdx.x & 3;
  float gm[KSTEPS][2], bt[KSTEPS][2];
  if (ASRC == A_NORM) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + KSTEP * kk + t + 4 * e;
        gm[kk][e] = col < p.K ? __ldg(p.gamma + col) : 0.f;
        bt[kk][e] = col < p.K ? __ldg(p.beta + col) : 0.f;
      }
  }
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = KSTEP * kk + t + 4 * (e >> 1);
      float v = *reinterpret_cast<const float*>(
          st + a_offset<ASRC>(r0 + 8 * (e & 1), kc));
      if (ASRC == A_NORM)
        v = k0 + kc < p.K ? normalize(v, mu[e & 1], rs[e & 1],
                                      gm[kk][e >> 1], bt[kk][e >> 1])
                          : 0.f;
      split_tf32(v, ah[kk][e], al[kk][e]);
    }
}

// one stage's boxes by TMA, for the k-step ks at depth k: raw A, then B
// hi and B lo
template <int ASRC>
__device__ __forceinline__ void load_stage(uint8_t* smem,
                                           const CUtensorMap* ma,
                                           const CUtensorMap* mh,
                                           const CUtensorMap* ml,
                                           uint64_t* full, int ks, int k,
                                           int m0, int n0) {
  const int s = ks % STAGES;
  uint8_t* st = smem + s * STAGE_BYTES;
  mbar_expect_tx(&full[s], STAGE_BYTES);
  if (ASRC == A_COLS) {
#pragma unroll
    for (int b = 0; b < BM / 32; ++b)
      tma_load(st + b * 4096, ma, &full[s], m0 + 32 * b, k);
  } else {
    tma_load(st, ma, &full[s], k, m0);
  }
  tma_load(st + A_TILE, mh, &full[s], k, n0);
  tma_load(st + A_TILE + B_TILE, ml, &full[s], k, n0);
}

template <int ASRC, int OUT>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    ln_mm_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_bh,
                     const __grid_constant__ CUtensorMap map_bl,
                     const GemmArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  // the column tile runs fastest: the blocks in flight share their rows
  // of A
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.chunk;
  const int ksteps = (min(p.K, kbeg + p.chunk) - kbeg + BK - 1) / BK;
  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();   // the swizzle needs 1 KB rows
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0 fills the ring, then refills each stage once both warpgroups
  // have released it
  if (threadIdx.x == 0)
    for (int ks = 0; ks < min(STAGES, ksteps); ++ks)
      load_stage<ASRC>(smem, &map_a, &map_bh, &map_bl, full, ks,
                       kbeg + ks * BK, m0, n0);

  // warpgroup wg owns the 64 x 128 tile at row WG_ROWS wg and column
  // WG_COLS wg of the block's; a thread the rows r0 and r0 + 8 of its
  // warp's 16 in wgmma's layouts
  const int wg = threadIdx.x / WG, q = (threadIdx.x % WG) >> 5;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = wg * WG_ROWS + q * 16 + (lane >> 2);
  float mu[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  if (ASRC == A_NORM) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      if (row < p.M) {
        mu[h] = __ldg(p.stats + row);
        rs[h] = __ldg(p.stats + p.M + row);
      }
    }
  }
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  // the first stage's A fragments; each later stage's are built while the
  // stage before it is in the tensor cores
  uint32_t ah[KSTEPS][4], al[KSTEPS][4];
  if (ksteps > 0) {
    mbar_wait(&full[0], 0);
    a_frags<ASRC>(smem, r0, kbeg, p, mu, rs, ah, al);
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % STAGES;
    const uint8_t* bh = smem + s * STAGE_BYTES + A_TILE + wg * WG_COLS * 128;
    const uint8_t* bl = bh + B_TILE;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = ks * KSTEPS + kk;   // the k-step
      fence_regs(ah[kk]);
      fence_regs(al[kk]);
      fence_acc(part);
      if (kk == 0 || c % FOLD == 0) wgmma_fence();
      // K-major, 128-byte swizzle: a k-step is 32 bytes along the rows
      const uint64_t dh = gmma_desc(bh + kk * 32, 16, 1024, 1);
      const uint64_t dl = gmma_desc(bl + kk * 32, 16, 1024, 1);
      wgmma128_tf32_rs(part, al[kk], dh, c % FOLD != 0);
      wgmma128_tf32_rs(part, ah[kk], dl, 1);
      wgmma128_tf32_rs(part, ah[kk], dh, 1);
      if (kk + 1 < KSTEPS && (c + 1) % FOLD == 0) {   // a fold inside
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
    }
    wgmma_commit();
    uint32_t nh[KSTEPS][4], nl[KSTEPS][4];
    if (ks + 1 < ksteps) {
      const int s1 = (ks + 1) % STAGES;
      mbar_wait(&full[s1], ((ks + 1) / STAGES) & 1);
      a_frags<ASRC>(smem + s1 * STAGE_BYTES, r0, kbeg + (ks + 1) * BK, p, mu,
                    rs, nh, nl);
    }
    wgmma_wait<0>();
    fence_acc(part);
    if (((ks + 1) * KSTEPS) % FOLD == 0 || ks + 1 == ksteps) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && ks + STAGES < ksteps) {
      mbar_wait(&empty[s], (ks / STAGES) & 1);
      load_stage<ASRC>(smem, &map_a, &map_bh, &map_bl, full, ks + STAGES,
                       kbeg + (ks + STAGES) * BK, m0, n0);
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[kk][e] = nh[kk][e];
        al[kk][e] = nl[kk][e];
      }
  }

  // the epilogue: d[4 i + 2 h + e] is row r0 + 8 h, column 8 i + 2 t + e.
  // Its loads (bias, dy) are issued first, all together, from addresses
  // kept inside the tensors (a load under the edge's branch would wait
  // for the one before it)
  float* out = p.out + (long long)blockIdx.z * p.M * p.N;
  const int c0 = n0 + wg * WG_COLS + 2 * t;
  float2 bv[16], dv[16][2];
  if (OUT != OUT_PLAIN) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      bv[i] = __ldg(reinterpret_cast<const float2*>(
          p.bias + min(c0 + 8 * i, p.N - 2)));
  }
  if (OUT == OUT_DYC) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dv[i][h] = __ldg(reinterpret_cast<const float2*>(
            p.dy + (long long)min(m0 + r0 + 8 * h, p.M - 1) * p.N +
            min(c0 + 8 * i, p.N - 2)));
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = c0 + 8 * i;
    const bool cok = col < p.N;
    float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      if (!cok || row >= p.M) continue;
      float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (OUT != OUT_PLAIN) {
        v0 += bv[i].x;
        v1 += bv[i].y;
      }
      if (OUT == OUT_GELU) {
        v0 = gelu(v0);
        v1 = gelu(v1);
      }
      if (OUT == OUT_DYC) {
        v0 = dv[i][h].x * gelu_grad(v0);
        v1 = dv[i][h].y * gelu_grad(v1);
        cs0 += v0;
        cs1 += v1;
      }
      store2(out + (long long)row * p.N + col, v0, v1);
    }
    if (OUT == OUT_DYC) {
      // the warp's column sums over its 16 rows: the thread's two rows,
      // then the 8 row groups (lanes xor 4, 8, 16)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        cs0 += __shfl_xor_sync(attn_tile::FULL, cs0, m);
        cs1 += __shfl_xor_sync(attn_tile::FULL, cs1, m);
      }
      if (lane < 4 && cok)
        store2(p.part + ((long long)blockIdx.y * (BM / PART_ROWS) +
                         (r0 >> 4)) * p.N + col,
               cs0, cs1);
    }
  }
}

// ---------------------------------------------------------------------------
// the plain passes of the backward: fused_ln_tc.cu's, in fp32
// ---------------------------------------------------------------------------

// without GELU: part[blockIdx.x][c, c + 1] = sums of dy over the block's
// PART_ROWS rows, in order; a thread a pair of columns
__global__ void __launch_bounds__(THREADS) col_partial_kernel(
    const float* __restrict__ dy, float* __restrict__ part, int n, int F) {
  const int c = 2 * (blockIdx.y * THREADS + threadIdx.x);
  if (c >= F) return;
  const int r0 = blockIdx.x * PART_ROWS, r1 = min(n, r0 + PART_ROWS);
  float2 s = make_float2(0.f, 0.f);
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const float2 v =
        *reinterpret_cast<const float2*>(dy + (long long)r * F + c);
    s.x += v.x;
    s.y += v.y;
  }
  *reinterpret_cast<float2*>(part + (long long)blockIdx.x * F + c) = s;
}

// the row pass, over ROWS_BWD rows a block: dx, and
// dg_part / db_part[blockIdx.x][:] = sums of dln xhat and dln over those
// rows, in order. A warp per row for the row means (eight columns a
// lane), then a thread a pair of columns down the rows.
__global__ void __launch_bounds__(THREADS) ln_rows_bwd_kernel(
    const float* __restrict__ x, const void* gamma, int gcode,
    const float* __restrict__ stats, const float* __restrict__ dln,
    float* __restrict__ dx, float* __restrict__ dg_part,
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
      const float* xr = x + (long long)row * D;
      const float* dr = dln + (long long)row * D;
      for (int c = lane * 8; c < D; c += 256) {
        float xv[8], dl[8];
        load8(xr + c, xv);
        load8(dr + c, dl);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (xv[e] - mu) * rs;
          const float dxh = dl[e] * param(gamma, gcode, c + e);
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
      const float2 xv = *reinterpret_cast<const float2*>(x + o);
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

// the sums of dbias, dgamma, dbeta and dW's chunks: out[i] = sum over t of
// part[t][i], cast to the output's dtype; one job per blockIdx.y (a block
// past its job's count is idle). A block of jobs 0-2 sums 32 outputs:
// warp w takes the terms t = w, w + 8, ... in order, then the eight warps'
// sums are added in warp order. Job 3 (dW's at most MAX_SPLIT chunks, fp32)
// gives a thread four neighbouring outputs, each summed over the chunks
// in order: the same sums in the same order (a warp's one term each),
// read as 16-byte vectors.
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
  __shared__ float s_sum[THREADS / 32][32];
  ReduceJob j;
  switch (blockIdx.y) {   // constant indices keep the jobs in registers
    case 0: j = jobs.job[0]; break;
    case 1: j = jobs.job[1]; break;
    case 2: j = jobs.job[2]; break;
    default: j = jobs.job[3];
  }
  if (blockIdx.y == 3) {
    static_assert(MAX_SPLIT <= THREADS / 32, "a warp's one term each");
    const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
    if (i >= j.count) return;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < j.terms; ++t) {
      const float4 v =
          *reinterpret_cast<const float4*>(j.part + t * j.count + i);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    *reinterpret_cast<float4*>(static_cast<float*>(j.out) + i) = a;
    return;
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

// a tensor map of a row-major [outer, inner] fp32 matrix read in boxes of
// [box_outer, 32] (32 floats: the 128-byte swizzle's span); past the
// edges the boxes fill with zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, long long inner,
                     long long outer, int box_outer) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// one product: a, bh and bl as the kernel's TMA loads read them (A_COLS:
// boxes of 32 x 32, else BM x 32; B: BN x 32)
template <int ASRC, int OUT>
cudaError_t gemm(const void* a, long long a_inner, long long a_outer,
                 const float* bh, const float* bl, const GemmArgs& p,
                 int splits, cudaStream_t s) {
  CUtensorMap ma, mh, ml;
  cudaError_t err;
  if ((err = make_map(&ma, a, a_inner, a_outer,
                      ASRC == A_COLS ? 32 : BM)) != cudaSuccess ||
      (err = make_map(&mh, bh, p.K, p.N, BN)) != cudaSuccess ||
      (err = make_map(&ml, bl, p.K, p.N, BN)) != cudaSuccess)
    return err;
  auto fn = ln_mm_tf32_kernel<ASRC, OUT>;
  if ((err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM)) !=
      cudaSuccess)
    return err;
  fn<<<dim3(cdiv(p.N, BN), cdiv(p.M, BM), splits), GEMM_THREADS, GEMM_SMEM,
       s>>>(ma, mh, ml, p);
  return cudaGetLastError();
}

// dW's chunks over its n rows: the count s <= MAX_SPLIT (chunks of at
// least MIN_CHUNK rows) whose waves of s x tiles blocks over the SMs, per
// chunk, are fewest, the fewest chunks among equals; chunks are multiples
// of BK rows
void dw_split(int n, int D, int F, int& splits, int& chunk) {
  const long long tiles = (long long)cdiv(F, BM) * cdiv(D, BN);
  const long long sms = sm_count();
  splits = 1;
  long long best_w = cdiv(tiles, sms), best_s = 1;   // waves / chunks
  for (int s = 2; s <= MAX_SPLIT && (long long)s * MIN_CHUNK <= n; ++s) {
    const long long w = cdiv(tiles * s, sms);
    if (w * best_s < best_w * s) {
      best_w = w;
      best_s = s;
      splits = s;
    }
  }
  chunk = cdiv(cdiv(n, splits), BK) * BK;
  splits = cdiv(n, chunk);
}

struct BwdLayout {  // the backward's scratch, in one workspace
  int n_pad, p1, p2, splits, chunk;
  size_t stats, w_hi, w_lo, vec, wt_hi, wt_lo, lt_hi, lt_lo, dyc, dbias, dln,
      dg, db, dw, bytes;
  BwdLayout(int n, int D, int F, int gelu) {
    n_pad = cdiv(n, PRE_ROWS) * PRE_ROWS;
    p1 = (BM / PART_ROWS) * cdiv(n, BM);
    p2 = cdiv(n, ROWS_BWD);
    dw_split(n, D, F, splits, chunk);
    const size_t fd = (size_t)F * D * 4, nd = (size_t)n_pad * D * 4;
    size_t o = 0;
    stats = o; o += align256((size_t)2 * n * 4);
    w_hi = o; o += gelu ? align256(fd) : 0;
    w_lo = o; o += gelu ? align256(fd) : 0;
    vec = o; o += gelu ? align256((size_t)(2 * D + F) * 4) : 0;
    wt_hi = o; o += align256(fd);
    wt_lo = o; o += align256(fd);
    lt_hi = o; o += align256(nd);
    lt_lo = o; o += align256(nd);
    dyc = o; o += gelu ? align256((size_t)n * F * 4) : 0;
    dbias = o; o += align256((size_t)p1 * F * 4);
    dln = o; o += align256((size_t)n * D * 4);
    dg = o; o += align256((size_t)p2 * D * 4);
    db = o; o += align256((size_t)p2 * D * 4);
    dw = o; o += splits > 1 ? align256((size_t)splits * fd) : 0;
    bytes = o;
  }
};

// the forward; `scratch`: W's hi [F, D] and lo [F, D], gamma, beta [D]
// and bias [F] as fp32, then the rows' mean and rstd (2 F D + 2 D + F + 2
// n floats)
int fwd(const float* x, const void* gamma, const void* beta, int gcode,
        const float* w, const void* bias, int bcode, float* y,
        float* scratch, int n, int D, int F, float eps, int gelu,
        cudaStream_t s) {
  float* w_hi = scratch;
  float* w_lo = w_hi + (size_t)F * D;
  float* vec = w_lo + (size_t)F * D;
  float* stats = vec + 2 * D + F;
  const int wblocks = cdiv(D, 32) * cdiv(F, 32);
  ln_prologue_tf32_kernel<true, false, false>
      <<<wblocks + cdiv(n, PRE_ROWS), THREADS, 0, s>>>(
          w, w_hi, w_lo, nullptr, nullptr, x, gamma, beta, gcode, bias,
          bcode, vec, stats, nullptr, nullptr, n, 0, D, F, eps, wblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GemmArgs p{stats, vec, vec + D, vec + 2 * D, nullptr, y, nullptr, n,
                   F, D, cdiv(D, BK) * BK};
  err = gelu ? gemm<A_NORM, OUT_GELU>(x, D, n, w_hi, w_lo, p, 1, s)
             : gemm<A_NORM, OUT_PRE>(x, D, n, w_hi, w_lo, p, 1, s);
  return (int)err;
}

int bwd(const float* x, const void* gamma, const void* beta, int gcode,
        const float* w, const void* bias, int bcode, const float* dy,
        float* dx, float* dw, void* dbias, void* dgamma, void* dbeta,
        void* work, int n, int D, int F, float eps, int gelu,
        cudaStream_t s) {
  const BwdLayout L(n, D, F, gelu);
  char* ws = static_cast<char*>(work);
  auto at = [&](size_t off) { return reinterpret_cast<float*>(ws + off); };
  float* stats = at(L.stats);
  const float* dyc = gelu ? at(L.dyc) : dy;
  cudaError_t err;

  // (1) the prologue
  const int wblocks = cdiv(D, 32) * cdiv(F, 32);
  const int blocks = wblocks + L.n_pad / PRE_ROWS;
  if (gelu)
    ln_prologue_tf32_kernel<true, true, true><<<blocks, THREADS, 0, s>>>(
        w, at(L.w_hi), at(L.w_lo), at(L.wt_hi), at(L.wt_lo), x, gamma, beta,
        gcode, bias, bcode, at(L.vec), stats, at(L.lt_hi), at(L.lt_lo), n,
        L.n_pad, D, F, eps, wblocks);
  else
    ln_prologue_tf32_kernel<false, true, true><<<blocks, THREADS, 0, s>>>(
        w, nullptr, nullptr, at(L.wt_hi), at(L.wt_lo), x, gamma, beta,
        gcode, bias, bcode, nullptr, stats, at(L.lt_hi), at(L.lt_lo), n,
        L.n_pad, D, F, eps, wblocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // (2) g and dbias's partials
  if (gelu) {
    const float* vec = at(L.vec);
    const GemmArgs p{stats, vec, vec + D, vec + 2 * D, dy, at(L.dyc),
                     at(L.dbias), n, F, D, cdiv(D, BK) * BK};
    err = gemm<A_NORM, OUT_DYC>(x, D, n, at(L.w_hi), at(L.w_lo), p, 1, s);
  } else {
    col_partial_kernel<<<dim3(L.p1, cdiv(F, 2 * THREADS)), THREADS, 0, s>>>(
        dy, at(L.dbias), n, F);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;

  // (3) dln = g W: A = g [n, F], B = W^T [D, F]
  const GemmArgs pl{nullptr, nullptr, nullptr, nullptr, nullptr, at(L.dln),
                    nullptr, n, D, F, cdiv(F, BK) * BK};
  if ((err = gemm<A_ROWS, OUT_PLAIN>(dyc, F, n, at(L.wt_hi), at(L.wt_lo), pl,
                                     1, s)) != cudaSuccess)
    return (int)err;

  // (4) the row pass
  ln_rows_bwd_kernel<<<L.p2, THREADS, 0, s>>>(x, gamma, gcode, stats,
                                               at(L.dln), dx, at(L.dg),
                                               at(L.db), n, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // (5) dW = g^T ln: A = g^T from g [n, F]'s boxes, B = ln^T [D, n_pad]
  const GemmArgs pw{nullptr, nullptr, nullptr, nullptr, nullptr,
                    L.splits > 1 ? at(L.dw) : dw, nullptr, F, D, L.n_pad,
                    L.chunk};
  if ((err = gemm<A_COLS, OUT_PLAIN>(dyc, F, n, at(L.lt_hi), at(L.lt_lo), pw,
                                     L.splits, s)) != cudaSuccess)
    return (int)err;

  // (6) the fixed-order sums
  ReduceJobs jobs;
  jobs.job[0] = ReduceJob{at(L.dbias), F, L.p1, bcode, dbias};
  jobs.job[1] = ReduceJob{at(L.dg), D, L.p2, gcode, dgamma};
  jobs.job[2] = ReduceJob{at(L.db), D, L.p2, gcode, dbeta};
  const long long fd = (long long)F * D;
  jobs.job[3] = ReduceJob{at(L.dw), L.splits > 1 ? fd : 0, L.splits, 0, dw};
  const int blocks_r = std::max(cdiv(L.splits > 1 ? fd : 0, 4 * THREADS),
                                cdiv(std::max(F, D), 32));
  reduce_kernel<<<dim3(blocks_r, 4), THREADS, 0, s>>>(jobs);
  return (int)cudaGetLastError();
}

// the products' grid holds the row blocks in its second dimension
bool takes(int n, int D, int F, int dtype) {
  return dtype == 0 && n >= 1 && (long long)n <= 65535LL * BM && D >= 8 &&
         D % 8 == 0 && F >= 8 && F % 8 == 0 && cdiv(F, BM) <= 65535;
}

}  // namespace

extern "C" {

// The arguments of fused_ln.cu's entry points, for dtype 0 (float32) only
// (anything else returns cudaErrorInvalidValue); `stats` is the forward's
// scratch of 2 F D + 2 D + F + 2 n floats (W's hi and lo, gamma, beta and
// bias as fp32, then the rows' statistics), 16-byte aligned. Every call returns cudaGetLastError()
// after its launches (0 = launched).
int fused_ln_tf32_fwd(const void* x, const void* gamma, const void* beta,
                      int gcode, const void* w, const void* bias, int bcode,
                      void* y, float* stats, int n, int D, int F, float eps,
                      int gelu, int dtype, void* stream) {
  if (!takes(n, D, F, dtype)) return (int)cudaErrorInvalidValue;
  return fwd(static_cast<const float*>(x), gamma, beta, gcode,
             static_cast<const float*>(w), bias, bcode,
             static_cast<float*>(y), stats, n, D, F, eps, gelu,
             static_cast<cudaStream_t>(stream));
}

long long fused_ln_tf32_bwd_workspace(int n, int D, int F, int gelu,
                                      int dtype) {
  (void)dtype;
  return (long long)BwdLayout(n, D, F, gelu).bytes;
}

int fused_ln_tf32_bwd(const void* x, const void* gamma, const void* beta,
                      int gcode, const void* w, const void* bias, int bcode,
                      const void* dy, void* dx, void* dw, void* dbias,
                      void* dgamma, void* dbeta, void* work, int n, int D,
                      int F, float eps, int gelu, int dtype, void* stream) {
  if (!takes(n, D, F, dtype)) return (int)cudaErrorInvalidValue;
  return bwd(static_cast<const float*>(x), gamma, beta, gcode,
             static_cast<const float*>(w), bias, bcode,
             static_cast<const float*>(dy), static_cast<float*>(dx),
             static_cast<float*>(dw), dbias, dgamma, dbeta, work, n, D, F,
             eps, gelu, static_cast<cudaStream_t>(stream));
}

const char* fused_ln_tf32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

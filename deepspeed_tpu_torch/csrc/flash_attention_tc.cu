// Flash attention forward, dq and dk/dv on Hopper's tensor cores (sm_90a),
// for bf16 and fp16 with head_dim a multiple of 8 up to 128.
//
// Replaces, for those types, the three Pallas TPU kernels of deepspeed_tpu/
// ops/transformer/flash_attention.py: _fwd_kernel (forward), _bwd_dq_kernel
// (dq) and _bwd_dkv_kernel (dk and dv). Each computes exactly the function
// that
// flash_attention.cu's header states (bottom-right causal j <= i + Sk -
// Sq; the key mask multiplying p; lse of the undropped mass; a row whose
// keys are all masked gives o = 0 and lse = m + log(1e-30); the dropout
// keep-mask Drop::keep(i, j) regenerated in registers, never stored),
// through the same C interface: q, k, v read through their [B, S, H, D]
// strides; o, dO, dk, dv contiguous [B, S, H, D]; lse and delta fp32
// [B * H, Sq]. fp32 takes flash_attention_tf32.cu; head dims above 128
// take flash_attention_tc256.cu's forward and dk/dv and flash_attention.cu's
// FMA dq.
//
// What bounds it on an H100: at the training shape (B*H = 192, S = 512,
// D = 64, bf16, causal) the forward must move q, k, v and o, 4 x 12.6 MB,
// 15 us at 3.35 TB/s, against 6.4 GFLOP of products, 6.5 us at the 989
// TFLOP/s of dense bf16; dk/dv moves q, k, v, dO, dk, dv (23 us) against
// 12.9 GFLOP (13 us); dq moves q, k, v, dO, dq (19 us) against 9.7 GFLOP
// (10 us). Bytes bound all three; the FMA kernels ran at 40-53x that
// bound, held by the fp32 FMA rate.
//
// What the design does:
// - products on the tensor cores: mma.sync.m16n8k16 with fp32
//   accumulators, fragments from shared memory through ldmatrix (and
//   ldmatrix.trans where the product's k runs along the tile's rows: V in
//   p.V, dO in dv, q in dk). Products of 16-bit inputs are exact in fp32,
//   so s = q.k and dp = dO.v are the TPU kernel's fp32 dots up to the
//   order of the sums; the softmax scale multiplies s in fp32 (q is not
//   rounded to 16 bits after scaling);
// - p and ds are fp32 and are not rounded once to 16 bits: each is split
//   into hi = T(x) and lo = T(x - hi) and multiplied twice (split16), which
//   keeps ~2^-17 of its size (one bf16 rounding, 2^-9, would reach the
//   bf16 tolerance over millions of elements) for 1.5x the tensor work of
//   a single term, still under the bytes bound at this shape;
// - a block of 4 warps owns 64 rows (queries in the forward and dq, keys
//   in dk/dv), 16 per warp; the other axis streams through two shared stages
//   filled with cp.async (16-byte copies, ragged rows and the zero
//   columns of a head dim padded to 16 zero-filled), so one tile's loads
//   are in flight while the tensor cores work on the previous one. Rows
//   are 16 bytes longer than the tile, so ldmatrix's 8 rows fall in 8
//   distinct bank groups;
// - the forward keeps its q fragments in registers for the whole walk;
//   the online softmax runs on the accumulator fragment (a row lives in
//   the 4 lanes of a quad: max by two shuffles; the row sum stays a
//   per-lane partial until the end), and p goes from the accumulator
//   fragment straight into the A fragments of p.V in registers, with no
//   trip through shared memory;
// - dq is the forward turned to the backward: lse and delta are known, so
//   there is no online softmax; s = q.k^T and dp = dO.v^T share the walk,
//   ds = p (D dp - delta) is formed on the accumulator fragments and goes
//   straight into the A fragments of dq += ds.k (k read with ldmatrix.trans,
//   as V in p.V). q and dO stay in registers at D <= 64 and are re-read
//   from their resident shared tiles at D = 128, where holding both spills.
//   It stays a kernel of its own beside dk/dv: a fused backward would sum
//   dq across key blocks with atomics;
// - dk/dv computes the transposed tile: s^T = k.q^T and dp^T = v.dO^T, so
//   that p^T and ds^T are A fragments of dv += p^T.dO and dk += ds^T.q in
//   registers. Its rows are keys and its columns queries: the dropout
//   hash is keep(i = column, j = row);
// - the causal mask is evaluated only on tiles that cross the diagonal or
//   the ragged end; tiles above the diagonal are never loaded. Forward
//   and dq blocks start with the last query tiles (the longest walks),
//   dk/dv blocks with the first key tiles;
// - no atomics: every output element is summed by one thread in a fixed
//   order, so the backward stays deterministic; o, dq, dk and dv leave
//   through shared memory in 16-byte stores;
// - at D <= 64 the register budget is held to 4 resident forward blocks
//   and 3 dq and dk/dv blocks per SM (128 and 168 registers; dk/dv spills
//   a few bytes), which tools/probe_flash_tc.py measured faster than the
//   compiler's own budget for the forward and dk/dv; at D = 128 the same
//   bounds would spill hundreds of bytes, so they are not set there.

#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

using attn_tc::a_frags;
using attn_tc::BM;
using attn_tc::load_rows;
using attn_tc::mma_cols;
using attn_tc::mma_rows;
using attn_tc::NT;
using attn_tc::quad_max;
using attn_tc::quad_sum;
using attn_tc::store_rows;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using attn_tile::Drop;
using attn_tile::ldsm_x4;
using attn_tile::pack16;
using attn_tile::Strides;
using attn_tile::strides_of;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// forward: grid (B * H, ceil(Sq / BM)); the block's query tile is counted
// from the end, so the longest causal walks start first
// ---------------------------------------------------------------------------
template <typename T, int DMAX, bool DROP>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 4 : 1) flash_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ lse, Strides st, int H, int Sq, int Sk, int D,
    float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int BN = 64;            // keys per streamed tile
  constexpr int DP = DMAX + 8;      // row pitch (elements)
  constexpr int KC = DMAX / 16;     // k-steps over the head dim
  constexpr int NO = DMAX / 8;      // output n-tiles
  constexpr int NS = BN / 8;        // score n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BM][DP]; then the o tile
  T* Ks = Qs + BM * DP;                     // [2][BN][DP]
  T* Vs = Ks + 2 * BN * DP;                 // [2][BN][DP]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BN * DP);  // [2][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int offset = Sk - Sq;
  const int nq = min(BM, Sq - q0);
  const int dk = (D + 15) & ~15;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * Sk : nullptr;
  const Drop drop(seed, bh, thresh, inv_keep);
  // keys past the reach of the tile's last query are visible to no query
  const int k_end = causal ? min(Sk, q0 + nq + offset) : Sk;
  const int ntiles = (k_end + BN - 1) / BN;
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int i0 = q0 + warp * 16 + g;  // this lane's rows: i0 and i0 + 8

  auto load_kv = [&](int it) {
    const int k0 = it * BN, s = it & 1;
    const int valid = min(BN, Sk - k0);
    load_rows<T, DP>(Ks + s * BN * DP, kb + k0 * st.ks, st.ks, BN, valid,
                     D, dk);
    load_rows<T, DP>(Vs + s * BN * DP, vb + k0 * st.vs, st.vs, BN, valid,
                     D, dk);
    if (mb && threadIdx.x < BN)
      Ms[s * BN + threadIdx.x] =
          threadIdx.x < valid ? mb[k0 + threadIdx.x] : 0.f;
  };
  load_rows<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM,
                   nq, D, dk);
  load_kv(0);
  cp_async_commit();

  uint32_t qf[KC][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * BN;
    const T* Kt = Ks + (it & 1) * BN * DP;
    const T* Vt = Vs + (it & 1) * BN * DP;
    const float* Mt = Ms + (it & 1) * BN;
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        if (kc * 16 < dk)
          ldsm_x4(qf[kc], Qs + (warp * 16 + (lane & 15)) * DP + kc * 16 +
                              (lane >> 4) * 8);
    }

    // s = q.k^T (fp32 sums), then scaled in fp32, base-2 units
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      if (kc * 16 < dk) mma_rows<NS, DP>(s, qf[kc], Kt, kc * 16);
    const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + offset);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl;
        if (edge) {
          const int j = k0 + 8 * n + 2 * t + (e & 1);
          const int i = e < 2 ? i0 : i0 + 8;
          if (j >= Sk || (causal && j > i + offset)) x = -INFINITY;
        }
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = mn0 == -INFINITY ? 1.f
                     : m0 == -INFINITY ? 0.f : exp2f(m0 - mn0);
    const float a1 = mn1 == -INFINITY ? 1.f
                     : m1 == -INFINITY ? 0.f : exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        if (mb) p *= Mt[8 * n + 2 * t + (e & 1)];
        if (e < 2) sum0 += p;   // the normaliser keeps the undropped mass
        else sum1 += p;
        if (DROP)
          p = drop.apply(p, e < 2 ? i0 : i0 + 8, k0 + 8 * n + 2 * t + (e & 1));
        s[n][e] = p;
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= a0; acc[n][1] *= a0;
      acc[n][2] *= a1; acc[n][3] *= a1;
    }
    // o += p.v, p split into two 16-bit terms
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      uint32_t hi[4], lo[4];
      a_frags(s, kc, hi, lo, Qs);
      mma_cols<NO, DP>(acc, hi, lo, Vt, kc * 16, dk);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // o = acc / max(l, 1e-30) through the q tile's shared memory
  const float ls0 = fmaxf(quad_sum(l0), 1e-30f);
  const float ls1 = fmaxf(quad_sum(l1), 1e-30f);
  T* Os = Qs;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t;
    if (c < dk) {
      *reinterpret_cast<uint32_t*>(Os + r0 * DP + c) =
          pack16(acc[n][0] / ls0, acc[n][1] / ls0, Os);
      *reinterpret_cast<uint32_t*>(Os + (r0 + 8) * DP + c) =
          pack16(acc[n][2] / ls1, acc[n][3] / ls1, Os);
    }
  }
  if (t == 0) {
    if (i0 < Sq) lse[(long long)bh * Sq + i0] = m0 * LN2 + logf(ls0);
    if (i0 + 8 < Sq) lse[(long long)bh * Sq + i0 + 8] = m1 * LN2 + logf(ls1);
  }
  __syncthreads();
  store_rows<T, DP>(out + (((long long)b * Sq + q0) * H + h) * D,
                    (long long)H * D, Os, nq, D);
}

// ---------------------------------------------------------------------------
// dq: grid (B * H, ceil(Sq / BM)); the block owns 64 queries (counted from
// the end, so the longest causal walks start first) and walks key tiles up
// to the last key its last query can see. At DMAX <= 64 each warp keeps
// the A fragments of its q and dO rows in registers for the whole walk; at
// DMAX = 128 that would spill, so they are read from the resident tiles in
// shared memory at every key tile.
// ---------------------------------------------------------------------------
template <typename T, int DMAX, bool DROP>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 3 : 1) flash_bwd_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq_out, Strides st, int H, int Sq, int Sk, int D,
    float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int BN = 64;            // keys per streamed tile
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BN / 8;
  constexpr bool FRAG_REG = DMAX <= 64;   // q and dO fragments in registers
  constexpr int KF = FRAG_REG ? KC : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BM][DP]; then the dq tile
  T* Os = Qs + BM * DP;                     // [BM][DP] dO
  T* Ks = Os + BM * DP;                     // [2][BN][DP]
  T* Vs = Ks + 2 * BN * DP;                 // [2][BN][DP]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BN * DP);  // [2][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int offset = Sk - Sq;
  const int nq = min(BM, Sq - q0);
  const int dk = (D + 15) & ~15;
  const long long orow = (long long)H * D;  // dO / dq row stride
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * Sk : nullptr;
  const Drop drop(seed, bh, thresh, inv_keep);
  const int k_end = causal ? min(Sk, q0 + nq + offset) : Sk;
  const int ntiles = (k_end + BN - 1) / BN;
  const float sl = scale * LOG2E;
  const int i0 = q0 + warp * 16 + g;  // this lane's rows: i0 and i0 + 8
  // lse (base 2) and delta of the lane's rows; rows past Sq read zeros
  // (their q and dO are zero-filled, so their ds is 0; they are not stored)
  const long long at = (long long)bh * Sq;
  const float ls0 = i0 < Sq ? lse[at + i0] * LOG2E : 0.f;
  const float ls1 = i0 + 8 < Sq ? lse[at + i0 + 8] * LOG2E : 0.f;
  const float de0 = i0 < Sq ? delta[at + i0] : 0.f;
  const float de1 = i0 + 8 < Sq ? delta[at + i0 + 8] : 0.f;

  auto load_kv = [&](int it) {
    const int k0 = it * BN, s = it & 1;
    const int valid = min(BN, Sk - k0);
    load_rows<T, DP>(Ks + s * BN * DP, kb + k0 * st.ks, st.ks, BN, valid,
                     D, dk);
    load_rows<T, DP>(Vs + s * BN * DP, vb + k0 * st.vs, st.vs, BN, valid,
                     D, dk);
    if (mb && threadIdx.x < BN)
      Ms[s * BN + threadIdx.x] =
          threadIdx.x < valid ? mb[k0 + threadIdx.x] : 0.f;
  };
  load_rows<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM,
                   nq, D, dk);
  load_rows<T, DP>(Os, dout + ((long long)b * Sq + q0) * orow +
                           (long long)h * D,
                   orow, BM, nq, D, dk);
  load_kv(0);
  cp_async_commit();

  // the warp's A fragments of q and dO: row (warp * 16 + lane % 16),
  // columns 16 kc + 8 (lane / 16)
  const T* Qw = Qs + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  const T* Ow = Os + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  uint32_t qf[KF][4], of[KF][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * BN;
    const T* Kt = Ks + (it & 1) * BN * DP;
    const T* Vt = Vs + (it & 1) * BN * DP;
    const float* Mt = Ms + (it & 1) * BN;
    if constexpr (FRAG_REG) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < KF; ++kc)
          if (kc * 16 < dk) {
            ldsm_x4(qf[kc], Qw + kc * 16);
            ldsm_x4(of[kc], Ow + kc * 16);
          }
      }
    }

    // s = q.k^T and dp = dO.v^T (fp32 sums of exact 16-bit products)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc * 16 < dk) {
        if constexpr (FRAG_REG) {
          mma_rows<NS, DP>(s, qf[kc], Kt, kc * 16);
          mma_rows<NS, DP>(dp, of[kc], Vt, kc * 16);
        } else {
          uint32_t a[4];
          ldsm_x4(a, Qw + kc * 16);
          mma_rows<NS, DP>(s, a, Kt, kc * 16);
          ldsm_x4(a, Ow + kc * 16);
          mma_rows<NS, DP>(dp, a, Vt, kc * 16);
        }
      }
    }
    // p = exp(s - lse) mask_j; ds = p (D dp - delta), in place of dp
    const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + offset);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const int j = k0 + c;
        const int i = e < 2 ? i0 : i0 + 8;
        const bool vis = !edge || (j < Sk && (!causal || j <= i + offset));
        float p = vis ? exp2f(s[n][e] * sl - (e < 2 ? ls0 : ls1)) : 0.f;
        if (mb) p *= Mt[c];
        float d = dp[n][e];
        if (DROP) d = drop.apply(d, i, j);
        dp[n][e] = p * (d - (e < 2 ? de0 : de1));
      }
    // dq += ds.k, ds split into two 16-bit terms, k read transposed
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      uint32_t hi[4], lo[4];
      a_frags(dp, kc, hi, lo, Qs);
      mma_cols<NO, DP>(acc, hi, lo, Kt, kc * 16, dk);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // dq = scale * acc through the q tile's shared memory
  T* Ds = Qs;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t;
    if (c < dk) {
      *reinterpret_cast<uint32_t*>(Ds + r0 * DP + c) =
          pack16(acc[n][0] * scale, acc[n][1] * scale, Ds);
      *reinterpret_cast<uint32_t*>(Ds + (r0 + 8) * DP + c) =
          pack16(acc[n][2] * scale, acc[n][3] * scale, Ds);
    }
  }
  __syncthreads();
  store_rows<T, DP>(dq_out + ((long long)b * Sq + q0) * orow +
                        (long long)h * D,
                    orow, Ds, nq, D);
}

// ---------------------------------------------------------------------------
// dk and dv: grid (B * H, ceil(Sk / BM)); the block owns 64 keys and walks
// query tiles from the first query that can see its first key
// ---------------------------------------------------------------------------
template <typename T, int DMAX, bool DROP>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 3 : 1) flash_bwd_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk_out, T* __restrict__ dv_out, Strides st, int H,
    int Sq, int Sk, int D, float scale, int causal, uint32_t seed,
    int thresh, float inv_keep) {
  constexpr int BQ = DMAX <= 64 ? 64 : 32;  // queries per streamed tile
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [BM][DP]
  T* Vs = Ks + BM * DP;                     // [BM][DP]
  T* Qs = Vs + BM * DP;                     // [2][BQ][DP]; then the dk tile
  T* Os = Qs + 2 * BQ * DP;                 // [2][BQ][DP] dO; then dv
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * DP);  // [2][BQ] lse'
  float* Es = Ls + 2 * BQ;                  // [2][BQ] delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BM;
  const int offset = Sk - Sq;
  const int nk = min(BM, Sk - k0);
  const int dk = (D + 15) & ~15;
  const long long orow = (long long)H * D;  // dO / dk / dv row stride
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + (long long)b * Sq * orow + (long long)h * D;
  const Drop drop(seed, bh, thresh, inv_keep);
  const float sl = scale * LOG2E;
  const int j0 = k0 + warp * 16 + g;  // this lane's keys: j0 and j0 + 8
  const float km0 = (mask && j0 < Sk) ? mask[(long long)b * Sk + j0] : 1.f;
  const float km1 =
      (mask && j0 + 8 < Sk) ? mask[(long long)b * Sk + j0 + 8] : 1.f;
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int it0 = q_first / BQ;
  const int ntiles = (Sq + BQ - 1) / BQ;

  auto load_q = [&](int it) {
    const int q0 = it * BQ, s = (it - it0) & 1;
    const int valid = min(BQ, Sq - q0);
    load_rows<T, DP>(Qs + s * BQ * DP, qb + q0 * st.qs, st.qs, BQ, valid, D,
                     dk);
    load_rows<T, DP>(Os + s * BQ * DP, ob + q0 * orow, orow, BQ, valid, D,
                     dk);
    if (threadIdx.x < BQ) {
      const bool ok = (int)threadIdx.x < valid;
      const long long at = (long long)bh * Sq + q0 + threadIdx.x;
      Ls[s * BQ + threadIdx.x] = ok ? lse[at] * LOG2E : 0.f;
      Es[s * BQ + threadIdx.x] = ok ? delta[at] : 0.f;
    }
  };
  load_rows<T, DP>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BM,
                   nk, D, dk);
  load_rows<T, DP>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BM,
                   nk, D, dk);
  load_q(it0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const T* Kw = Ks + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  const T* Vw = Vs + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;

  for (int it = it0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = it * BQ, s_ = (it - it0) & 1;
    const T* Qt = Qs + s_ * BQ * DP;
    const T* Ot = Os + s_ * BQ * DP;
    const float* Lt = Ls + s_ * BQ;
    const float* Et = Es + s_ * BQ;

    // s^T = k.q^T and dp^T = v.dO^T: rows keys, columns queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc * 16 < dk) {
        uint32_t a[4];
        ldsm_x4(a, Kw + kc * 16);
        mma_rows<NS, DP>(s, a, Qt, kc * 16);
        ldsm_x4(a, Vw + kc * 16);
        mma_rows<NS, DP>(dp, a, Ot, kc * 16);
      }
    }
    // p^T = exp(s - lse_i) mask_j; ds^T = p^T (D dp^T - delta_i); p^T
    // becomes D p^T for dv. The row is the key j, the column the query i.
    const bool edge =
        q0 + BQ > Sq || (causal && q0 + offset < k0 + BM - 1);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const int i = q0 + c;
        const int j = e < 2 ? j0 : j0 + 8;
        const bool vis = !edge || (i < Sq && (!causal || j <= i + offset));
        float p = vis ? exp2f(s[n][e] * sl - Lt[c]) * (e < 2 ? km0 : km1)
                      : 0.f;
        float d = dp[n][e];
        if (DROP) {
          const bool kp = drop.keep(i, j);   // (query, key): swapped
          d = kp ? d * drop.inv_keep : 0.f;
          dp[n][e] = p * (d - Et[c]);
          p = kp ? p * drop.inv_keep : 0.f;
        } else {
          dp[n][e] = p * (d - Et[c]);
        }
        s[n][e] = p;
      }
    // dv += (D p^T).dO and dk += ds^T.q, each A split into two terms
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      uint32_t hi[4], lo[4];
      a_frags(s, kc, hi, lo, Ks);
      mma_cols<NO, DP>(dva, hi, lo, Ot, kc * 16, dk);
      a_frags(dp, kc, hi, lo, Ks);
      mma_cols<NO, DP>(dka, hi, lo, Qt, kc * 16, dk);
    }
    __syncthreads();
  }

  // dk (times the softmax scale) and dv through the streamed tiles'
  // shared memory
  T* dks = Qs;
  T* dvs = Os;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t;
    if (c < dk) {
      *reinterpret_cast<uint32_t*>(dks + r0 * DP + c) =
          pack16(dka[n][0] * scale, dka[n][1] * scale, dks);
      *reinterpret_cast<uint32_t*>(dks + (r0 + 8) * DP + c) =
          pack16(dka[n][2] * scale, dka[n][3] * scale, dks);
      *reinterpret_cast<uint32_t*>(dvs + r0 * DP + c) =
          pack16(dva[n][0], dva[n][1], dvs);
      *reinterpret_cast<uint32_t*>(dvs + (r0 + 8) * DP + c) =
          pack16(dva[n][2], dva[n][3], dvs);
    }
  }
  __syncthreads();
  const long long off = ((long long)b * Sk + k0) * orow + (long long)h * D;
  store_rows<T, DP>(dk_out + off, orow, dks, nk, D);
  store_rows<T, DP>(dv_out + off, orow, dvs, nk, D);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { FWD = 0, DQ = 1, DKV = 2 };

struct Args {
  const void *q, *k, *v, *dout;
  const float *mask, *lse_in, *delta;
  void *out, *dq, *dk, *dv;
  float* lse;
  Strides st;
  int B, H, Sq, Sk, D;
  float scale;
  int causal;
  uint32_t seed;   // dropout: the host's seed, threshold and 1 / (1 - rate)
  int thresh;
  float inv_keep;
};

template <typename T, int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(T) * (size_t)(BM + 4 * 64) * (DMAX + 8) + sizeof(float) * 2 * 64;
}
template <typename T, int DMAX>
constexpr size_t dq_smem() {
  return sizeof(T) * (size_t)(2 * BM + 4 * 64) * (DMAX + 8) +
         sizeof(float) * 2 * 64;
}
template <typename T, int DMAX>
constexpr size_t dkv_smem() {
  constexpr int BQ = DMAX <= 64 ? 64 : 32;
  return sizeof(T) * (size_t)(2 * BM + 4 * BQ) * (DMAX + 8) +
         sizeof(float) * 4 * BQ;
}

template <typename Fn>
cudaError_t set_smem(Fn fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int DMAX, bool DROP>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (w == FWD) {
    constexpr size_t smem = fwd_smem<T, DMAX>();
    auto fn = flash_fwd_tc_kernel<T, DMAX, DROP>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sq + BM - 1) / BM);
    fn<<<grid, NT, smem, stream>>>(q, k, v, a.mask, static_cast<T*>(a.out),
                                   a.lse, a.st, a.H, a.Sq, a.Sk, a.D,
                                   a.scale, a.causal, a.seed, a.thresh,
                                   a.inv_keep);
  } else if (w == DQ) {
    constexpr size_t smem = dq_smem<T, DMAX>();
    auto fn = flash_bwd_dq_tc_kernel<T, DMAX, DROP>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sq + BM - 1) / BM);
    fn<<<grid, NT, smem, stream>>>(q, k, v, dout, a.mask, a.lse_in, a.delta,
                                   static_cast<T*>(a.dq), a.st, a.H, a.Sq,
                                   a.Sk, a.D, a.scale, a.causal, a.seed,
                                   a.thresh, a.inv_keep);
  } else {
    constexpr size_t smem = dkv_smem<T, DMAX>();
    auto fn = flash_bwd_dkv_tc_kernel<T, DMAX, DROP>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sk + BM - 1) / BM);
    fn<<<grid, NT, smem, stream>>>(
        q, k, v, dout, a.mask, a.lse_in, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.st, a.H, a.Sq, a.Sk, a.D, a.scale,
        a.causal, a.seed, a.thresh, a.inv_keep);
  }
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dispatch_d(Which w, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, DROP>(w, a, stream);
  return launch<T, 128, DROP>(w, a, stream);
}

template <typename T>
cudaError_t dispatch_drop(Which w, const Args& a, cudaStream_t stream) {
  // rate 0 (threshold 0, scale 1) is the variant without the hash
  return a.thresh > 0 || a.inv_keep != 1.f
             ? dispatch_d<T, true>(w, a, stream)
             : dispatch_d<T, false>(w, a, stream);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (a.D < 8 || a.D > 128 || a.D % 8 != 0 || a.B < 1 || a.H < 1 ||
      a.Sq < 1 || a.Sk < 1 || (a.causal && a.Sq > a.Sk) || a.thresh < 0 ||
      a.thresh > (1 << 24) || (a.Sq + BM - 1) / BM > 65535 ||
      (a.Sk + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) err = dispatch_drop<__nv_bfloat16>(w, a, st);
  else if (dtype == 2) err = dispatch_drop<__half>(w, a, st);
  else err = cudaErrorInvalidValue;   // fp32 runs the FMA kernels
  return (int)err;
}

}  // namespace

extern "C" {

// The arguments of flash_attention.cu's flash_attention_fwd,
// flash_attention_bwd_dq and flash_attention_bwd_dkv, with dtype 1
// (bfloat16) or 2 (float16) and D a multiple of 8 in [8, 128]. Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention_tc_fwd(const void* q, const void* k, const void* v,
                           const float* mask, void* out, float* lse,
                           const long long* strides, int B, int H, int Sq,
                           int Sk, int D, float scale, int causal,
                           uint32_t seed, int thresh, float inv_keep,
                           int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.out = out; a.lse = lse;
  a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(FWD, a, dtype, stream);
}

int flash_attention_tc_bwd_dq(const void* q, const void* k, const void* v,
                              const void* dout, const float* mask,
                              const float* lse, const float* delta, void* dq,
                              const long long* strides, int B, int H, int Sq,
                              int Sk, int D, float scale, int causal,
                              uint32_t seed, int thresh, float inv_keep,
                              int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.lse_in = lse;
  a.delta = delta; a.dq = dq; a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(DQ, a, dtype, stream);
}

int flash_attention_tc_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const float* mask,
                               const float* lse, const float* delta, void* dk,
                               void* dv, const long long* strides, int B,
                               int H, int Sq, int Sk, int D, float scale,
                               int causal, uint32_t seed, int thresh,
                               float inv_keep, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.lse_in = lse;
  a.delta = delta; a.dk = dk; a.dv = dv; a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(DKV, a, dtype, stream);
}

const char* flash_attention_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

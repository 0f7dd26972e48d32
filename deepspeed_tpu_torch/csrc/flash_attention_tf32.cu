// Flash attention forward, dq and dk/dv for float32 on Hopper's tensor
// cores (sm_90a), as 3xTF32: head_dim a multiple of 8 up to 256.
//
// Replaces, for fp32, the Pallas TPU kernels _fwd_kernel (o and lse),
// _bwd_dq_kernel (dq) and _bwd_dkv_kernel (dk and dv) of deepspeed_tpu/
// ops/transformer/flash_attention.py. Each computes exactly the function
// that flash_attention.cu's header states (bottom-right causal j <= i +
// Sk - Sq; the row max over the visible keys, masked ones included; the
// key mask multiplying p; l and lse keeping the undropped mass; a row
// whose keys are all masked gives o = 0 and contributes nothing; the
// dropout keep-mask Drop::keep(i, j) regenerated in registers, never
// stored), through the same C interface: q, k, v read through their [B,
// S, H, D] strides; out, dO, dq, dk, dv contiguous [B, S, H, D]; lse and
// delta fp32 [B * H, Sq].
//
// What bounds it on an H100: at the training shape (B*H = 192, S = 512,
// D = 64, fp32, causal) the forward must move q, k, v and o (50 MB, 15 us
// at 3.35 TB/s) and do 6.4 GFLOP of fp32-accurate products; dq moves q,
// k, v, dO and dq (63 MB, 19 us) and does 9.7 GFLOP; dk/dv moves six [B,
// S, H, D] tensors (23 us) and does 12.9 GFLOP. As three TF32 products
// each, at 495 TFLOP/s of TF32, that is 39, 59 and 78 us: operations
// bound all three. flash_attention.cu's FMA kernels do the same products
// as fp32 FMAs fed by one 16-byte shared-memory load per four FMAs, so
// shared memory bounds them (0.63, 0.86 and 1.21 ms). dq and dk/dv take
// 0.31 and 0.45 ms (5.4x and 5.7x their bounds), held by mma.sync
// throughput and the splits and adds around it; with one TF32 product
// they took 0.19 and 0.27, with none 0.08 and 0.10
// (tools/probe_flash_tf32.py).
//
// What the design does:
// - products on the tensor cores: mma.sync.m16n8k8 with tf32 operands and
//   fp32 accumulators. Every fp32 operand x is split into hi = tf32(x)
//   (cvt.rna: round to nearest, ties away from zero) and lo = tf32(x -
//   hi), and each product is three mmas, lo.hi + hi.lo + hi.hi (the
//   small terms first): that keeps each operand to ~2^-22 of its size,
//   where one TF32 rounding (2^-11) would miss the fp32 path's 1e-5. The
//   three mmas of one k-step (8 products) sum into a fresh tile that an
//   fp32 add folds into the running sum: the tensor cores' accumulation
//   drops low bits of its larger addend, which over a whole walk missed
//   1e-5 at the training shape; rounded adds keep an FMA loop's error. The
//   products are s = q.k^T and o += p.v in the forward, s = q.k^T and dp =
//   dO.v^T, then dq = ds.k in dq, and s^T = k.q^T, dp^T = v.dO^T, dv =
//   p^T.dO and dk = ds^T.q in dk/dv. The forward computes s exactly as dq
//   does (q unscaled, the same splits and k-steps, scale applied after),
//   so the lse it saves and the p the backward recomputes come from the
//   same fp32 scores;
// - B operands are split where they are loaded into fragments (32-bit
//   shared loads, rows DMAX + 4 floats apart, so the 8 x 4 lanes of a
//   fragment hit 32 distinct banks in both orientations); p and ds are
//   split in registers. The rounding is cvt.rna's, done in two integer
//   operations (ptxas expands cvt.rna.tf32.f32 to four; the instruction
//   measured 0.41 / 0.56 ms for dq / dk/dv against 0.32 / 0.44 at the
//   training shape, tools/probe_flash_tf32.py). Splitting each streamed
//   tile once into hi and lo tiles in shared memory (the probe's
//   presplit variant) measured 0.40 / 0.54: its 87 KB a block fit two
//   blocks an SM, not three;
// - the first products' accumulator fragment (rows g, g + 8, columns
//   2t, 2t + 1 of each 8-column tile) becomes the A fragment of the
//   second products with no shuffle: the k index of m16n8k8 is permuted
//   so that its columns t and t + 4 are keys (or queries) 2t and 2t + 1
//   of the tile, and the B operand's rows are read in the same order;
// - the forward's online softmax runs on those fragments: a lane holds
//   rows g and g + 8, their running max reduces over the quad's 4 lanes
//   by shuffles, each lane sums its own share of l (the quad's shares
//   are added once, at the end), and each key tile rescales the o
//   accumulator by alpha before its p.v is folded in;
// - a block of 4 warps owns 64 rows (queries in the forward and dq, keys
//   in dk/dv), 16 per warp, and streams the other axis in tiles of 32
//   rows through two shared stages filled by cp.async (16 bytes = 4
//   floats), so one tile's loads are in flight while the tensor cores
//   work on the previous one. At D <= 64 a dq or dk/dv block takes 70 KB
//   and three fit an SM (at most 168 registers a thread, no spills);
//   tiles of 64 rows (two blocks, 104 KB) measured 0.36 / 0.54 ms and
//   tiles of 16 (four blocks) 0.33 / 0.46. The forward keeps q alone
//   resident: 52 KB a block at D <= 64, four blocks an SM. At D = 128 one
//   backward block an SM, two forward blocks;
// - the causal mask and the ragged end are evaluated only on tiles that
//   cross them; tiles above the diagonal are never loaded. Forward and dq
//   blocks start with the last query tiles (the longest walks), dk/dv
//   blocks with the first key tiles;
// - the forward at D in (128, 256] is this file's kernel at DMAX = 256,
//   not a file of its own: the 32-key walk, the splits and the softmax
//   are the same, and only the o accumulator widens. At [4, 512, 8, 256]
//   causal it must move q, k, v and o (67 MB, 20 us) and do 4.3 GFLOP of
//   fp32-accurate products, 26 us at 165 TFLOP/s (3xTF32): operations
//   bound it. One warp owning a 16-row group's 256 columns holds 128
//   accumulator registers a thread, and a block of 4 warps (200 KB: q
//   and two stages of 32-key K and V at rows of 260 floats) is one block
//   an SM: 0.3437-0.3515 ms there (219-223 registers). FWD256_SPLIT = 2
//   puts two warps on each 16-row group, each owning 128 columns of o;
//   each sums s over its half of the head dim and the pair adds the two
//   partial sums through 16 KB of shared memory (FWD256_SHARE_S; a + b
//   and b + a are the same bits, so both run the same softmax): 216 KB,
//   165-168 registers, 0.1921-0.1965 ms. Each warp computing all of s
//   itself took 0.2402-0.2457, and 16-key tiles 0.2342-0.2345 (shared)
//   and 0.3640-0.3681 (one warp); tools/probe_flash_tf32_d256.py, H100,
//   device time, two chip calls;
// - dq and dk/dv at D in (128, 256] are kernels of their own
//   (flash_bwd_dq_tf32_d256_kernel, flash_bwd_dkv_tf32_d256_kernel): at
//   [4, 512, 8, 256] causal dq must move q, k, v, dO and dq (84 MB, 25 us)
//   and do 6.45 GFLOP of fp32-accurate products, 39 us at 165 TFLOP/s;
//   dk/dv moves six such tensors (30 us) and does 8.6 GFLOP, 52 us:
//   operations bound both. One warp owning a 16-row group's 256 columns
//   would hold 128 accumulator registers for dq and 256 for dk and dv,
//   and the D <= 128 layout (64 resident rows of two tensors, two stages
//   of two 32-row tiles) needs 266,496 bytes of shared memory against
//   a block's 232,448. So two warps share each 16-row group, each owning
//   128 columns of dq (of dk and of dv), as the forward's pair does: each
//   sums s and dp (s^T and dp^T) over its half of the head dim and the
//   pair adds the partial tiles through shared memory (add_pair: own +
//   other's, the same bits in both). A block keeps 64 rows resident
//   (eight warps) and streams 16-row tiles in two stages: 216 KB, one
//   block an SM, 169 registers for dq and 236-237 for dk/dv, no spills.
//   s is summed as the forward sums it (the same halves, k-steps and
//   splits), so the p that dq recomputes comes from the forward's
//   scores; s^T = k.q^T runs mma3's two small products swapped
//   (mma3<true>: q_lo.k_hi, then q_hi.k_lo), and the probe's check on
//   one warp found all 65,536 of its s^T bit-equal to s, where mma3's
//   default order (the D <= 128 dk/dv's) misses 40. Measured (H100 80GB
//   HBM3, 700 W, device time, two rounds, dropout 0 and 0.1;
//   tools/probe_flash_tf32_d256.py): dq 0.2708-0.2785 ms and dk/dv
//   0.3736-0.3833 (kept); dk/dv with one warp of a pair owning dv and
//   summing s^T, the other dk and dp^T, p^T handed over (the probe's
//   OWNERS_DKV patch, 255 registers) 0.4556-0.5113; 32 resident rows and
//   32-row tiles (four warps an SM) dq 0.3791-0.4005, dk/dv 0.5762-0.6175
//   (halves) and 0.9849-1.0016 (owners). The FMA kernels took
//   0.8904-0.9028 and 1.2477-1.2542 on the same inputs;
// - no atomics: every output element is summed by one thread in a fixed
//   order, so the outputs are bit-equal over two launches.

#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "tf32_mma.cuh"

namespace {

using attn_tf32::a_rows;
using attn_tf32::add_pair;
using attn_tf32::mma_cols;
using attn_tf32::mma_rows;
using attn_tf32::store_acc;
using attn_tf32::store_acc_at;
using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using attn_tile::Drop;
using attn_tile::row_max;
using attn_tile::row_sum;
using attn_tile::Strides;
using attn_tile::strides_of;

constexpr int NT = 128;      // threads: 4 warps
constexpr int BM = 64;       // rows a block owns, 16 per warp
constexpr int BS = 32;       // rows of a streamed tile
constexpr int BLOCKS64 = 3;  // dq, dk/dv blocks an SM at D <= 64 (70 KB)
constexpr int FWD64 = 4;     // forward blocks an SM at D <= 64 (52 KB)
// the forward at D in (128, 256] (tools/probe_flash_tf32_d256.py's
// picks): FWD256_SPLIT warps over each 16-row group, each owning 256 /
// FWD256_SPLIT columns of o; with FWD256_SHARE_S, each of two such warps
// sums s over its half of the head dim and the pair adds the two partial
// sums through shared memory, else each computes all of s itself
constexpr int FWD256_SPLIT = 2;
constexpr bool FWD256_SHARE_S = true;
// dq and dk/dv at D in (128, 256] (the probe's picks): BWD256_ROWS rows a
// block owns (queries in dq, keys in dk/dv), two warps on each 16-row
// group, BWD256_TILE rows a streamed tile
constexpr int BWD256_ROWS = 64;
constexpr int BWD256_TILE = 16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows x D floats of src (row stride `stride`) into dst [rows][DP] by
// cp.async, 16 bytes at a time, by NTH threads; rows at or past `valid`
// are zeros
template <int DP, int NTH = NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int rows,
                                          int valid, int D) {
  const int cpr = D / 4;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += NTH) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * DP + c, ok ? src + r * stride + c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// forward: grid (B * H, ceil(Sq / BM)); the block owns 64 queries (counted
// from the end, so the longest causal walks start first) and walks key
// tiles up to the last key its last query can see, with an online softmax.
// SPLIT warps share each 16-row group: each runs the group's softmax
// itself and owns DMAX / SPLIT columns of o (SPLIT > 1 only at DMAX =
// 256, where D > 128 keeps every warp's columns in range); with SHARE two
// warps each sum s over their half of the head dim and add the other's
// partial sum (own + other's in both: the same bits), else each computes
// all of s.
// ---------------------------------------------------------------------------
template <int DMAX, int SPLIT, bool DROP>
__global__ void __launch_bounds__(NT* SPLIT, DMAX <= 64 ? FWD64
                                             : DMAX <= 128 ? 2 : 1)
    flash_fwd_tf32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ mask,
        float* __restrict__ out, float* __restrict__ lse, Strides st, int H,
        int Sq, int Sk, int D, float scale, int causal, uint32_t seed,
        int thresh, float inv_keep) {
  constexpr int BN = BS;                     // keys per streamed tile
  constexpr int DP = DMAX + 4;               // row pitch (floats)
  constexpr int NO = DMAX / 8 / SPLIT;       // a warp's output n-tiles
  constexpr int NS = BN / 8;                 // score n-tiles
  constexpr int NTH = NT * SPLIT;            // threads
  constexpr bool SHARE = SPLIT == 2 && FWD256_SHARE_S;
  constexpr int KS = SHARE ? DMAX / 2 : DMAX;  // head-dim columns s sums
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BM][DP]
  float* Ks = Qs + BM * DP;         // [2][BN][DP]
  float* Vs = Ks + 2 * BN * DP;     // [2][BN][DP]
  float* Ms = Vs + 2 * BN * DP;     // [2][BN]
  float* Xs = Ms + 2 * BN;          // SHARE: [NTH / 32][NS * 4][32] s

  const int warp = (threadIdx.x >> 5) % 4, lane = threadIdx.x & 31;
  const int c0 = (threadIdx.x >> 7) * (DMAX / SPLIT);  // first column of o
  const int kq = SHARE ? c0 : 0;    // first head-dim column s sums
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int offset = Sk - Sq;
  const int nq = min(BM, Sq - q0);
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
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
    load_rows<DP, NTH>(Ks + s * BN * DP, kb + k0 * st.ks, st.ks, BN, valid,
                       D);
    load_rows<DP, NTH>(Vs + s * BN * DP, vb + k0 * st.vs, st.vs, BN, valid,
                       D);
    if (mb && threadIdx.x < BN)
      Ms[s * BN + threadIdx.x] =
          threadIdx.x < valid ? mb[k0 + threadIdx.x] : 0.f;
  };
  load_rows<DP, NTH>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM,
                     nq, D);
  load_kv(0);
  cp_async_commit();

  const float* Qw = Qs + warp * 16 * DP;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (base 2) of rows i0, i0 + 8, and this lane's share of l
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * BN;
    const float* Kt = Ks + (it & 1) * BN * DP;
    const float* Vt = Vs + (it & 1) * BN * DP + c0;   // the warp's columns
    const float* Mt = Ms + (it & 1) * BN;

    // s = q.k^T, as the dq kernel computes it; then scaled, base 2
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      const int kc = kq + kk;
      if (kc < D) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Qw, kc, ah, al);
        mma_rows<NS, DP>(s, ah, al, Kt, kc);
      }
    }
    if constexpr (SHARE) add_pair<NS, 4>(Xs, s);  // warps w and w ^ 4
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
    // a tile that shows a row no key leaves it as it was (alpha 1); the
    // first tile that does starts it (alpha 0 on the empty o)
    const float mn0 = fmaxf(m0, row_max<4>(mx0));
    const float mn1 = fmaxf(m1, row_max<4>(mx1));
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
        const int c = 8 * n + 2 * t + (e & 1);
        const float x = s[n][e];
        float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        if (mb) p *= Mt[c];
        if (e < 2) sum0 += p;   // the normaliser keeps the undropped mass
        else sum1 += p;
        if (DROP) p = drop.apply(p, e < 2 ? i0 : i0 + 8, k0 + c);
        s[n][e] = p;
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= a0; acc[n][1] *= a0;
      acc[n][2] *= a1; acc[n][3] *= a1;
    }
    // o += p.v over the warp's columns
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      mma_cols<NO, NS, DP>(acc, s, kk, Vt, D - c0);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30))
  const float ls0 = fmaxf(row_sum<4>(l0), 1e-30f);
  const float ls1 = fmaxf(row_sum<4>(l1), 1e-30f);
  const long long orow = (long long)H * D;
  float* ob = out + ((long long)b * Sq + q0) * orow + (long long)h * D + c0;
  const int r = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (c0 + n * 8 < D) {
      if (r < nq)
        *reinterpret_cast<float2*>(ob + r * orow + 8 * n + 2 * t) =
            make_float2(acc[n][0] / ls0, acc[n][1] / ls0);
      if (r + 8 < nq)
        *reinterpret_cast<float2*>(ob + (r + 8) * orow + 8 * n + 2 * t) =
            make_float2(acc[n][2] / ls1, acc[n][3] / ls1);
    }
  }
  if (t == 0 && c0 == 0) {
    if (i0 < Sq) lse[(long long)bh * Sq + i0] = m0 * LN2 + logf(ls0);
    if (i0 + 8 < Sq) lse[(long long)bh * Sq + i0 + 8] = m1 * LN2 + logf(ls1);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (B * H, ceil(Sq / BM)); the block owns 64 queries (counted from
// the end, so the longest causal walks start first) and walks key tiles
// up to the last key its last query can see
// ---------------------------------------------------------------------------
template <int DMAX, bool DROP>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? BLOCKS64 : 1)
    flash_bwd_dq_tf32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ mask, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dq_out,
        Strides st, int H, int Sq, int Sk, int D, float scale, int causal,
        uint32_t seed, int thresh, float inv_keep) {
  constexpr int BN = BS;                     // keys per streamed tile
  constexpr int DP = DMAX + 4;               // row pitch (floats)
  constexpr int NO = DMAX / 8;               // output n-tiles
  constexpr int NS = BN / 8;                 // score n-tiles
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BM][DP]
  float* Os = Qs + BM * DP;         // [BM][DP] dO
  float* Ks = Os + BM * DP;         // [2][BN][DP]
  float* Vs = Ks + 2 * BN * DP;     // [2][BN][DP]
  float* Ms = Vs + 2 * BN * DP;     // [2][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int offset = Sk - Sq;
  const int nq = min(BM, Sq - q0);
  const long long orow = (long long)H * D;  // dO / dq row stride
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
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
    load_rows<DP>(Ks + s * BN * DP, kb + k0 * st.ks, st.ks, BN, valid, D);
    load_rows<DP>(Vs + s * BN * DP, vb + k0 * st.vs, st.vs, BN, valid, D);
    if (mb && threadIdx.x < BN)
      Ms[s * BN + threadIdx.x] =
          threadIdx.x < valid ? mb[k0 + threadIdx.x] : 0.f;
  };
  load_rows<DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM, nq,
                D);
  load_rows<DP>(Os, dout + ((long long)b * Sq + q0) * orow + (long long)h * D,
                orow, BM, nq, D);
  load_kv(0);
  cp_async_commit();

  const float* Qw = Qs + warp * 16 * DP;
  const float* Ow = Os + warp * 16 * DP;
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
    const float* Kt = Ks + (it & 1) * BN * DP;
    const float* Vt = Vs + (it & 1) * BN * DP;
    const float* Mt = Ms + (it & 1) * BN;

    // s = q.k^T and dp = dO.v^T
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DMAX; kc += 8) {
      if (kc < D) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Qw, kc, ah, al);
        mma_rows<NS, DP>(s, ah, al, Kt, kc);
        a_rows<DP>(Ow, kc, ah, al);
        mma_rows<NS, DP>(dp, ah, al, Vt, kc);
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
    // dq += ds.k
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      mma_cols<NO, NS, DP>(acc, dp, kk, Kt, D);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  store_acc<NO>(dq_out + ((long long)b * Sq + q0) * orow + (long long)h * D,
                orow, acc, scale, nq, D);
}

// ---------------------------------------------------------------------------
// dk and dv: grid (B * H, ceil(Sk / BM)); the block owns 64 keys and walks
// query tiles from the first query that can see its first key
// ---------------------------------------------------------------------------
template <int DMAX, bool DROP>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? BLOCKS64 : 1)
    flash_bwd_dkv_tf32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ mask, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dk_out,
        float* __restrict__ dv_out, Strides st, int H, int Sq, int Sk, int D,
        float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int BQ = BS;                     // queries per streamed tile
  constexpr int DP = DMAX + 4;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BQ / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [BM][DP]
  float* Vs = Ks + BM * DP;         // [BM][DP]
  float* Qs = Vs + BM * DP;         // [2][BQ][DP]
  float* Os = Qs + 2 * BQ * DP;     // [2][BQ][DP] dO
  float* Ls = Os + 2 * BQ * DP;     // [2][BQ] lse (base 2)
  float* Es = Ls + 2 * BQ;          // [2][BQ] delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BM;
  const int offset = Sk - Sq;
  const int nk = min(BM, Sk - k0);
  const long long orow = (long long)H * D;  // dO / dk / dv row stride
  const float* qb = q + b * st.qb + h * st.qh;
  const float* ob = dout + (long long)b * Sq * orow + (long long)h * D;
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
    load_rows<DP>(Qs + s * BQ * DP, qb + q0 * st.qs, st.qs, BQ, valid, D);
    load_rows<DP>(Os + s * BQ * DP, ob + q0 * orow, orow, BQ, valid, D);
    if (threadIdx.x < BQ) {
      const bool ok = (int)threadIdx.x < valid;
      const long long at = (long long)bh * Sq + q0 + threadIdx.x;
      Ls[s * BQ + threadIdx.x] = ok ? lse[at] * LOG2E : 0.f;
      Es[s * BQ + threadIdx.x] = ok ? delta[at] : 0.f;
    }
  };
  load_rows<DP>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BM, nk,
                D);
  load_rows<DP>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BM, nk,
                D);
  load_q(it0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float* Kw = Ks + warp * 16 * DP;
  const float* Vw = Vs + warp * 16 * DP;

  for (int it = it0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = it * BQ, s_ = (it - it0) & 1;
    const float* Qt = Qs + s_ * BQ * DP;
    const float* Ot = Os + s_ * BQ * DP;
    const float* Lt = Ls + s_ * BQ;
    const float* Et = Es + s_ * BQ;

    // s^T = k.q^T and dp^T = v.dO^T: rows keys, columns queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DMAX; kc += 8) {
      if (kc < D) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Kw, kc, ah, al);
        mma_rows<NS, DP>(s, ah, al, Qt, kc);
        a_rows<DP>(Vw, kc, ah, al);
        mma_rows<NS, DP>(dp, ah, al, Ot, kc);
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
    // dv += (D p^T).dO and dk += ds^T.q
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      mma_cols<NO, NS, DP>(dva, s, kk, Ot, D);
      mma_cols<NO, NS, DP>(dka, dp, kk, Qt, D);
    }
    __syncthreads();
  }

  const long long off = ((long long)b * Sk + k0) * orow + (long long)h * D;
  store_acc<NO>(dk_out + off, orow, dka, scale, nk, D);
  store_acc<NO>(dv_out + off, orow, dva, 1.f, nk, D);
}

// ---------------------------------------------------------------------------
// dq and dk/dv at D in (128, 256]: two warps on each 16-row group (warps w
// and w ^ NG of a block of NG groups), each owning 128 columns of the
// output, so that an accumulator fits a thread. Scores are summed as the
// forward sums them: each warp of a pair over its half of the head dim,
// the halves added as own + other's (the same bits in both warps).
// ---------------------------------------------------------------------------

// dq: grid (B * H, ceil(Sq / BWD256_ROWS)); queries counted from the end,
// key tiles up to the last key the block's last query can see. Each warp
// of a pair sums s = q.k^T and dp = dO.v^T over its half, the pair adds
// them, and each forms p and ds for the tile and folds ds.k into its
// columns of dq.
template <bool DROP>
__global__ void __launch_bounds__(BWD256_ROWS * 4, 1)
    flash_bwd_dq_tf32_d256_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ mask, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dq_out,
        Strides st, int H, int Sq, int Sk, int D, float scale, int causal,
        uint32_t seed, int thresh, float inv_keep) {
  constexpr int DP = 256 + 4;                // row pitch (floats)
  constexpr int BQ = BWD256_ROWS;            // queries a block owns
  constexpr int BN = BWD256_TILE;            // keys per streamed tile
  constexpr int NTH = BQ * 4;                // threads: 2 warps a group
  constexpr int NG = BQ / 16;                // 16-row groups
  constexpr int NO = 16;                     // a warp's output n-tiles
  constexpr int NS = BN / 8;                 // score n-tiles
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][DP]
  float* Os = Qs + BQ * DP;         // [BQ][DP] dO
  float* Ks = Os + BQ * DP;         // [2][BN][DP]
  float* Vs = Ks + 2 * BN * DP;     // [2][BN][DP]
  float* Ms = Vs + 2 * BN * DP;     // [2][BN]
  float* Xs = Ms + 2 * BN;          // partial s and dp (add_pair)

  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp = wid % NG;        // the warp's 16-row group
  const int c0 = wid / NG * 128;    // the first column of its half
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int offset = Sk - Sq;
  const int nq = min(BQ, Sq - q0);
  const long long orow = (long long)H * D;  // dO / dq row stride
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * Sk : nullptr;
  const Drop drop(seed, bh, thresh, inv_keep);
  const int k_end = causal ? min(Sk, q0 + nq + offset) : Sk;
  const int ntiles = (k_end + BN - 1) / BN;
  const float sl = scale * LOG2E;
  const int i0 = q0 + warp * 16 + g;  // this lane's rows: i0 and i0 + 8
  const long long at = (long long)bh * Sq;
  const float ls0 = i0 < Sq ? lse[at + i0] * LOG2E : 0.f;
  const float ls1 = i0 + 8 < Sq ? lse[at + i0 + 8] * LOG2E : 0.f;
  const float de0 = i0 < Sq ? delta[at + i0] : 0.f;
  const float de1 = i0 + 8 < Sq ? delta[at + i0 + 8] : 0.f;

  auto load_kv = [&](int it) {
    const int k0 = it * BN, s = it & 1;
    const int valid = min(BN, Sk - k0);
    load_rows<DP, NTH>(Ks + s * BN * DP, kb + k0 * st.ks, st.ks, BN, valid,
                       D);
    load_rows<DP, NTH>(Vs + s * BN * DP, vb + k0 * st.vs, st.vs, BN, valid,
                       D);
    if (mb && threadIdx.x < BN)
      Ms[s * BN + threadIdx.x] =
          threadIdx.x < valid ? mb[k0 + threadIdx.x] : 0.f;
  };
  load_rows<DP, NTH>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BQ,
                     nq, D);
  load_rows<DP, NTH>(
      Os, dout + ((long long)b * Sq + q0) * orow + (long long)h * D, orow,
      BQ, nq, D);
  load_kv(0);
  cp_async_commit();

  const float* Qw = Qs + warp * 16 * DP;
  const float* Ow = Os + warp * 16 * DP;
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
    const float* Kt = Ks + (it & 1) * BN * DP;
    const float* Vt = Vs + (it & 1) * BN * DP;
    const float* Mt = Ms + (it & 1) * BN;

    // s = q.k^T and dp = dO.v^T over the warp's half, then the pair's sum
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 128; kk += 8) {
      const int kc = c0 + kk;
      if (kc < D) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Qw, kc, ah, al);
        mma_rows<NS, DP>(s, ah, al, Kt, kc);
        a_rows<DP>(Ow, kc, ah, al);
        mma_rows<NS, DP>(dp, ah, al, Vt, kc);
      }
    }
    add_pair<NS, NG>(Xs, s, dp);
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
    // dq[:, half] += ds.k[:, half]
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
      mma_cols<NO, NS, DP>(acc, dp, kk, Kt + c0, D - c0);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  store_acc_at<NO>(
      dq_out + ((long long)b * Sq + q0) * orow + (long long)h * D + c0, orow,
      acc, scale, warp * 16, nq, D - c0);
}

// dk and dv: grid (B * H, ceil(Sk / BWD256_ROWS)); query tiles from the
// first query that can see the block's first key. Each warp of a pair
// sums s^T = k.q^T (in s's product order: the forward's bits) and dp^T =
// v.dO^T over its half, the pair adds them, and each folds (D p^T).dO and
// ds^T.q into its halves of dv and dk.
template <bool DROP>
__global__ void __launch_bounds__(BWD256_ROWS * 4, 1)
    flash_bwd_dkv_tf32_d256_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ mask, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dk_out,
        float* __restrict__ dv_out, Strides st, int H, int Sq, int Sk, int D,
        float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int DP = 256 + 4;
  constexpr int BK = BWD256_ROWS;            // keys a block owns
  constexpr int BQ = BWD256_TILE;            // queries per streamed tile
  constexpr int NTH = BK * 4;
  constexpr int NG = BK / 16;
  constexpr int NO = 16;                     // a warp's output n-tiles
  constexpr int NS = BQ / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [BK][DP]
  float* Vs = Ks + BK * DP;         // [BK][DP]
  float* Qs = Vs + BK * DP;         // [2][BQ][DP]
  float* Os = Qs + 2 * BQ * DP;     // [2][BQ][DP] dO
  float* Ls = Os + 2 * BQ * DP;     // [2][BQ] lse (base 2)
  float* Es = Ls + 2 * BQ;          // [2][BQ] delta
  float* Xs = Es + 2 * BQ;          // partial s^T and dp^T (add_pair)

  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp = wid % NG;
  const int c0 = wid / NG * 128;    // the first column of its half
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BK;
  const int offset = Sk - Sq;
  const int nk = min(BK, Sk - k0);
  const long long orow = (long long)H * D;  // dO / dk / dv row stride
  const float* qb = q + b * st.qb + h * st.qh;
  const float* ob = dout + (long long)b * Sq * orow + (long long)h * D;
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
    load_rows<DP, NTH>(Qs + s * BQ * DP, qb + q0 * st.qs, st.qs, BQ, valid,
                       D);
    load_rows<DP, NTH>(Os + s * BQ * DP, ob + q0 * orow, orow, BQ, valid,
                       D);
    if (threadIdx.x < BQ) {
      const bool ok = (int)threadIdx.x < valid;
      const long long at = (long long)bh * Sq + q0 + threadIdx.x;
      Ls[s * BQ + threadIdx.x] = ok ? lse[at] * LOG2E : 0.f;
      Es[s * BQ + threadIdx.x] = ok ? delta[at] : 0.f;
    }
  };
  load_rows<DP, NTH>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BK,
                     nk, D);
  load_rows<DP, NTH>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BK,
                     nk, D);
  load_q(it0);
  cp_async_commit();

  float dva[NO][4], dka[NO][4];     // the warp's columns of dv and dk
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;
  const float* Kw = Ks + warp * 16 * DP;
  const float* Vw = Vs + warp * 16 * DP;

  for (int it = it0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = it * BQ, s_ = (it - it0) & 1;
    const float* Qt = Qs + s_ * BQ * DP;
    const float* Ot = Os + s_ * BQ * DP;
    const float* Lt = Ls + s_ * BQ;
    const float* Et = Es + s_ * BQ;
    const bool edge =
        q0 + BQ > Sq || (causal && q0 + offset < k0 + BK - 1);

    // s^T = k.q^T and dp^T = v.dO^T: rows keys, columns queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 128; kk += 8) {
      const int kc = c0 + kk;
      if (kc < D) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Kw, kc, ah, al);
        mma_rows<NS, DP, true>(s, ah, al, Qt, kc);
        a_rows<DP>(Vw, kc, ah, al);
        mma_rows<NS, DP>(dp, ah, al, Ot, kc);
      }
    }
    add_pair<NS, NG>(Xs, s, dp);
    // p^T = exp(s - lse_i) mask_j; ds^T = p^T (D dp^T - delta_i); p^T
    // becomes D p^T for dv. The row is the key j, the column the query i.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const int i = q0 + c;
        const int j = e < 2 ? j0 : j0 + 8;
        const bool vis = !edge || (i < Sq && (!causal || j <= i + offset));
        const float p =
            vis ? exp2f(s[n][e] * sl - Lt[c]) * (e < 2 ? km0 : km1) : 0.f;
        const bool kp = !DROP || drop.keep(i, j);   // (query, key): swapped
        const float d = DROP ? (kp ? dp[n][e] * drop.inv_keep : 0.f)
                             : dp[n][e];
        dp[n][e] = p * (d - Et[c]);
        s[n][e] = DROP ? (kp ? p * drop.inv_keep : 0.f) : p;
      }
    // dv += (D p^T).dO and dk += ds^T.q over the warp's columns
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      mma_cols<NO, NS, DP>(dva, s, kk, Ot + c0, D - c0);
      mma_cols<NO, NS, DP>(dka, dp, kk, Qt + c0, D - c0);
    }
    __syncthreads();
  }

  const long long off = ((long long)b * Sk + k0) * orow + (long long)h * D;
  store_acc_at<NO>(dv_out + off + c0, orow, dva, 1.f, warp * 16, nk, D - c0);
  store_acc_at<NO>(dk_out + off + c0, orow, dka, scale, warp * 16, nk,
                   D - c0);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { FWD = 0, DQ = 1, DKV = 2 };

struct Args {
  const float *q, *k, *v, *dout;
  const float *mask, *lse, *delta;
  float *out, *lse_out, *dq, *dk, *dv;
  Strides st;
  int B, H, Sq, Sk, D;
  float scale;
  int causal;
  uint32_t seed;   // dropout: the host's seed, threshold and 1 / (1 - rate)
  int thresh;
  float inv_keep;
};

// shared bytes: the resident rows (the forward: q; dq: q, dO; dk/dv: k,
// v), two stages of two streamed tiles, the streamed tile's per-row floats
// (the forward and dq: the key mask; dk/dv: lse and delta), the forward's
// shared partial scores at DMAX = 256, and at DMAX = 256 dq's and dk/dv's
// pair exchange (add_pair's two tiles a warp)
template <int DMAX>
constexpr size_t smem_bytes(Which w) {
  const bool wide = DMAX > 128 && w != FWD;
  const int rows = wide ? BWD256_ROWS : BM;
  const int tile = wide ? BWD256_TILE : BS;
  size_t floats = (size_t)((w == FWD ? 1 : 2) * rows + 4 * tile) *
                      (DMAX + 4) +
                  (w == DKV ? 4 : 2) * tile;
  if (w == FWD && DMAX > 128 && FWD256_SPLIT == 2 && FWD256_SHARE_S)
    floats += NT * FWD256_SPLIT * BS / 2;
  if (wide) floats += 4 * rows * tile;
  return sizeof(float) * floats;
}

template <int DMAX, bool DROP>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>(w);
  cudaError_t err;
  if (w == FWD) {
    constexpr int SPLIT = DMAX > 128 ? FWD256_SPLIT : 1;
    auto fn = flash_fwd_tf32_kernel<DMAX, SPLIT, DROP>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sq + BM - 1) / BM);
    fn<<<grid, NT * SPLIT, smem, stream>>>(a.q, a.k, a.v, a.mask, a.out, a.lse_out,
                                   a.st, a.H, a.Sq, a.Sk, a.D, a.scale,
                                   a.causal, a.seed, a.thresh, a.inv_keep);
  } else if constexpr (DMAX > 128) {
    constexpr int R = BWD256_ROWS;
    if (w == DQ) {
      auto fn = flash_bwd_dq_tf32_d256_kernel<DROP>;
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(a.B * a.H, (a.Sq + R - 1) / R);
      fn<<<grid, R * 4, smem, stream>>>(a.q, a.k, a.v, a.dout, a.mask, a.lse,
                                        a.delta, a.dq, a.st, a.H, a.Sq, a.Sk,
                                        a.D, a.scale, a.causal, a.seed,
                                        a.thresh, a.inv_keep);
    } else {
      auto fn = flash_bwd_dkv_tf32_d256_kernel<DROP>;
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(a.B * a.H, (a.Sk + R - 1) / R);
      fn<<<grid, R * 4, smem, stream>>>(a.q, a.k, a.v, a.dout, a.mask, a.lse,
                                        a.delta, a.dk, a.dv, a.st, a.H, a.Sq,
                                        a.Sk, a.D, a.scale, a.causal, a.seed,
                                        a.thresh, a.inv_keep);
    }
  } else if (w == DQ) {
    auto fn = flash_bwd_dq_tf32_kernel<DMAX, DROP>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sq + BM - 1) / BM);
    fn<<<grid, NT, smem, stream>>>(a.q, a.k, a.v, a.dout, a.mask, a.lse,
                                   a.delta, a.dq, a.st, a.H, a.Sq, a.Sk, a.D,
                                   a.scale, a.causal, a.seed, a.thresh,
                                   a.inv_keep);
  } else {
    auto fn = flash_bwd_dkv_tf32_kernel<DMAX, DROP>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sk + BM - 1) / BM);
    fn<<<grid, NT, smem, stream>>>(a.q, a.k, a.v, a.dout, a.mask, a.lse,
                                   a.delta, a.dk, a.dv, a.st, a.H, a.Sq,
                                   a.Sk, a.D, a.scale, a.causal, a.seed,
                                   a.thresh, a.inv_keep);
  }
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t dispatch_d(Which w, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<64, DROP>(w, a, stream);
  if (a.D <= 128) return launch<128, DROP>(w, a, stream);
  return launch<256, DROP>(w, a, stream);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  constexpr int ROWS = BWD256_ROWS < BM ? BWD256_ROWS : BM;  // fewest
  if (dtype != 0 || a.D < 8 || a.D > 256 || a.D % 8 != 0 || a.B < 1 ||
      a.H < 1 || a.Sq < 1 || a.Sk < 1 || (a.causal && a.Sq > a.Sk) ||
      a.thresh < 0 || a.thresh > (1 << 24) ||
      (a.Sq + ROWS - 1) / ROWS > 65535 || (a.Sk + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rate 0 (threshold 0, scale 1) is the variant without the hash
  return (int)(a.thresh > 0 || a.inv_keep != 1.f
                   ? dispatch_d<true>(w, a, st)
                   : dispatch_d<false>(w, a, st));
}

}  // namespace

extern "C" {

// The arguments of flash_attention.cu's flash_attention_fwd,
// flash_attention_bwd_dq and flash_attention_bwd_dkv, with dtype 0
// (float32) and D a multiple of 8 in [8, 256]. Returns cudaGetLastError()
// after the launch (0 = launched).
int flash_attention_tf32_fwd(const void* q, const void* k, const void* v,
                             const float* mask, void* out, float* lse,
                             const long long* strides, int B, int H, int Sq,
                             int Sk, int D, float scale, int causal,
                             uint32_t seed, int thresh, float inv_keep,
                             int dtype, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v); a.mask = mask;
  a.out = static_cast<float*>(out); a.lse_out = lse;
  a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(FWD, a, dtype, stream);
}

int flash_attention_tf32_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* mask,
                                const float* lse, const float* delta,
                                void* dq, const long long* strides, int B,
                                int H, int Sq, int Sk, int D, float scale,
                                int causal, uint32_t seed, int thresh,
                                float inv_keep, int dtype, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout); a.mask = mask; a.lse = lse;
  a.delta = delta; a.dq = static_cast<float*>(dq);
  a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(DQ, a, dtype, stream);
}

int flash_attention_tf32_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* mask,
                                 const float* lse, const float* delta,
                                 void* dk, void* dv, const long long* strides,
                                 int B, int H, int Sq, int Sk, int D,
                                 float scale, int causal, uint32_t seed,
                                 int thresh, float inv_keep, int dtype,
                                 void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout); a.mask = mask; a.lse = lse;
  a.delta = delta; a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv); a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(DKV, a, dtype, stream);
}

const char* flash_attention_tf32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Block-sparse attention forward, dq and dk/dv on Hopper's tensor cores
// (sm_90a), for bf16 and fp16 with head_dim a multiple of 8 up to 128 and
// a layout block that is a multiple of 64.
//
// Replaces, for those inputs, three Pallas TPU kernels of deepspeed_tpu/
// ops/sparse_attention/sparse_attention.py: _sparse_kernel (the forward:
// o and a natural-log lse), _sparse_bwd_dq_kernel (dq) and
// _sparse_bwd_dkv_kernel (dk and dv). Each computes exactly the function
// that sparse_attention.cu's header states (masked pairs selected out; the
// forward's row with no visible key gives o = 0 and lse = -1e30; the
// backward's lse clamped at -5e29, p = exp(s - lse) on visible pairs only,
// ds = p (dp - delta), dq = scale sum ds k, dk = sum ds (scale q), dv =
// sum p dO). fp32 stays on sparse_attention.cu's FMA kernels; other
// multiples of 16 take sparse_attention_tc16.cu's 16-row kernels.
//
// What bounds it on an H100: at the long-sequence training shape (B*H =
// 12, S = 16384, D = 64, bf16, BigBird block 256, causal) the forward must
// move q, k, v and o (101 MB, 30 us at 3.35 TB/s) against 41 GFLOP over
// the visible pairs (42 us at 989 TFLOP/s); dq must move q, k, v, dO and
// dq (126 MB, 38 us) against 61.6 GFLOP (62 us); dk/dv 151 MB (45 us)
// against 82 GFLOP (83 us): operations bound all three. The FMA kernels
// ran at 76x (forward), 73x and 151x that bound.
//
// What the design does:
// - the tiles of flash_attention_tc.cu (attention_tc.cuh): mma.sync.
//   m16n8k16 with fp32 sums, fragments through ldmatrix (.trans for the
//   operand whose k runs along the tile's rows), a block of 4 warps owning
//   64 rows (queries for the forward and dq, keys for dk/dv) while the
//   other axis streams through two cp.async stages; p and ds split into
//   two 16-bit terms (split16); dk/dv on the transposed tile (s^T =
//   k.q^T), so that p^T and ds^T are A fragments in registers. The
//   softmax scale multiplies s and dk in fp32 (a scaled q is never rounded
//   to 16 bits); s and lse are carried in base 2, the lse converted once
//   as it is loaded (backward) or written (forward: m ln 2 + ln l);
// - the forward is the flash forward's online softmax on the accumulator
//   fragment (a row in the 4 lanes of a quad; a fully masked tile leaves
//   the row's state unchanged, -inf-safe), walking the same list as dq;
// - the walk is a list the host builds (ops/sparse_attention/
//   sparse_attention.py, SparsePlan.work): for each (head, 64-row tile)
//   the first rows of the 64-row tiles of the other axis it visits, in
//   layout order, with the tiles above the causal diagonal left out, so
//   they are never loaded. The next tile's address comes from the list:
//   the entry after next is read while the current tile's products run.
//   The causal mask is evaluated only on a tile that crosses the
//   diagonal, the key mask (a select, not a product) wherever there is
//   one;
// - the split of long walks: a work item is (head, 64-row tile, a run of
//   consecutive list entries). A walk longer than the plan's cap is cut
//   into pieces no longer than the cap, so the global column of a BigBird
//   layout (every query block attends it: 256 query tiles per key tile at
//   S = 16384), or a bidirectional layout's global row, no longer runs its
//   whole walk in one block while the others idle. Items are ordered
//   longest first and a thread block takes one item of one batch row. A
//   piece writes its fp32 partials to scratch ([B][slots][outputs][64][D];
//   the forward's unnormalised o, then its rows' base-2 max m and sum l,
//   [B][slots][64][2]); a second kernel reads each split tile's pieces in
//   piece order and writes the output, rounded once: the backward sums
//   them, the forward combines them (M = max m_p, o = sum 2^(m_p - M) o_p
//   / sum 2^(m_p - M) l_p, lse = M ln 2 + ln L). Unsplit tiles write their
//   output straight from their accumulators. No atomics: every output
//   element is summed in a fixed order, so each kernel is deterministic;
// - q, k and v are read through their [B, S, H, D] strides (views of the
//   fused QKV projection); o, dO, dq, dk and dv are contiguous [B, S, H,
//   D]; lse and delta fp32 [B * H, S].

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
using attn_tile::ldsm_x4;
using attn_tile::pack16;
using attn_tile::store4;
using attn_tile::Strides;
using attn_tile::strides_of;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;    // the forward's lse of an empty row
constexpr float LSE_FLOOR = -5e29f;  // the backward's clamp of an empty row
constexpr int ITEM = 5;    // ints per work item: head, first row of the
                           // owned tile, offset and count in the tile list,
                           // scratch slot of a piece (-1: not split)
constexpr int SPLIT = 4;   // ints per split tile: head, first row, first
                           // slot, pieces

// the fp32 accumulator tile [BM][D] of this thread's fragments (rows r0
// and r0 + 8, columns 8 n + 2 t and + 1) into a piece's scratch slot
template <int NO>
__device__ __forceinline__ void store_part(float* dst, const float (&acc)[NO][4],
                                           int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t;
    if (c < D) {
      *reinterpret_cast<float2*>(dst + r0 * D + c) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(dst + (r0 + 8) * D + c) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: grid (items * B); the block owns 64 queries and walks its item's
// key tiles with the flash forward's online softmax. q's A fragments stay
// in registers at DMAX <= 64 and are read from the resident tile at DMAX =
// 128, as in dq. A piece of a split walk leaves its unnormalised o and its
// rows' (m, l) in scratch; an unsplit tile writes o and lse.
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 4 : 1) sparse_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const int* __restrict__ items,
    const int* __restrict__ tiles, T* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, Strides st, int B,
    int H, int S, int D, int n_slots, float scale, int causal) {
  constexpr int BN = 64;            // keys per streamed tile
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BN / 8;
  constexpr bool FRAG_REG = DMAX <= 64;
  constexpr int KF = FRAG_REG ? KC : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BM][DP]; then the o tile
  T* Ks = Qs + BM * DP;                     // [2][BN][DP]
  T* Vs = Ks + 2 * BN * DP;                 // [2][BN][DP]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BN * DP);  // [2][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], q0 = wi[1], cnt = wi[3], slot = wi[4];
  const int* walk = tiles + wi[2];
  const int bh = b * H + h;
  const int dk = (D + 15) & ~15;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int i0 = q0 + warp * 16 + g;  // this lane's rows: i0 and i0 + 8

  auto load_kv = [&](int n, int k0) {
    const int s = n & 1;
    load_rows<T, DP>(Ks + s * BN * DP, kb + k0 * st.ks, st.ks, BN, BN, D,
                     dk);
    load_rows<T, DP>(Vs + s * BN * DP, vb + k0 * st.vs, st.vs, BN, BN, D,
                     dk);
    if (mb && threadIdx.x < BN) Ms[s * BN + threadIdx.x] = mb[k0 + threadIdx.x];
  };
  load_rows<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM,
                   BM, D, dk);
  int k_cur = cnt > 0 ? walk[0] : 0;
  int k_nxt = cnt > 1 ? walk[1] : 0;
  if (cnt > 0) load_kv(0, k_cur);
  cp_async_commit();

  const T* Qw = Qs + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  uint32_t qf[KF][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < cnt; ++n) {
    if (n + 1 < cnt) load_kv(n + 1, k_nxt);
    cp_async_commit();
    // the list entry after next, read while this tile's products run
    const int k_after = n + 2 < cnt ? walk[n + 2] : 0;
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = k_cur;
    const T* Kt = Ks + (n & 1) * BN * DP;
    const T* Vt = Vs + (n & 1) * BN * DP;
    const float* Mt = Ms + (n & 1) * BN;
    if constexpr (FRAG_REG) {
      if (n == 0) {
#pragma unroll
        for (int kc = 0; kc < KF; ++kc)
          if (kc * 16 < dk) ldsm_x4(qf[kc], Qw + kc * 16);
      }
    }

    // s = q.k^T (fp32 sums of exact 16-bit products), scaled in fp32
    float s[NS][4];
#pragma unroll
    for (int c = 0; c < NS; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (kc * 16 < dk) {
        if constexpr (FRAG_REG) {
          mma_rows<NS, DP>(s, qf[kc], Kt, kc * 16);
        } else {
          uint32_t a[4];
          ldsm_x4(a, Qw + kc * 16);
          mma_rows<NS, DP>(s, a, Kt, kc * 16);
        }
      }
    }
    // masked pairs leave the max and the sum (a select); only the
    // diagonal tile (k0 == q0) crosses the causal edge
    const bool cedge = causal && k0 + BN - 1 > q0;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        const int i = e < 2 ? i0 : i0 + 8;
        const bool vis = (!cedge || k0 + col <= i) && (!mb || Mt[col] > 0.f);
        const float x = vis ? s[c][e] * sl : -INFINITY;
        s[c][e] = x;
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
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[c][e];
        const float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += p;
        else sum1 += p;
        s[c][e] = p;
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= a0; acc[c][1] *= a0;
      acc[c][2] *= a1; acc[c][3] *= a1;
    }
    // o += p.v, p split into two 16-bit terms
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      uint32_t hi[4], lo[4];
      a_frags(s, kc, hi, lo, Qs);
      mma_cols<NO, DP>(acc, hi, lo, Vt, kc * 16, dk);
    }
    __syncthreads();  // this stage is consumed before it is refilled
    k_cur = k_nxt;
    k_nxt = k_after;
  }
  cp_async_wait<0>();  // an empty walk never waited for the q tile
  __syncthreads();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = warp * 16 + g;

  if (slot >= 0) {     // a piece of a split walk: fp32 partials
    const long long at = (long long)b * n_slots + slot;
    store_part<NO>(part + at * BM * D, acc, D);
    if (t == 0) {
      float* ml = part + (long long)B * n_slots * BM * D + at * BM * 2;
      ml[2 * r0] = m0;
      ml[2 * r0 + 1] = l0;
      ml[2 * (r0 + 8)] = m1;
      ml[2 * (r0 + 8) + 1] = l1;
    }
    return;
  }
  // o = acc / l through the q tile's shared memory; a row that saw no key
  // writes o = 0 and lse = -1e30
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* Os = Qs;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = 8 * c + 2 * t;
    if (col < dk) {
      *reinterpret_cast<uint32_t*>(Os + r0 * DP + col) =
          pack16(acc[c][0] * inv0, acc[c][1] * inv0, Os);
      *reinterpret_cast<uint32_t*>(Os + (r0 + 8) * DP + col) =
          pack16(acc[c][2] * inv1, acc[c][3] * inv1, Os);
    }
  }
  if (t == 0) {
    const long long at = (long long)bh * S;
    lse[at + i0] = l0 > 0.f ? m0 * LN2 + logf(l0) : NEG_INF;
    lse[at + i0 + 8] = l1 > 0.f ? m1 * LN2 + logf(l1) : NEG_INF;
  }
  __syncthreads();
  store_rows<T, DP>(out + (((long long)b * S + q0) * H + h) * D,
                    (long long)H * D, Os, BM, D);
}

// ---------------------------------------------------------------------------
// dq: grid (items * B); the block owns 64 queries and walks its item's key
// tiles. At DMAX <= 64 each warp keeps the A fragments of its q and dO rows
// in registers for the whole walk; at DMAX = 128 they are read from the
// resident tiles at every key tile (holding both would spill).
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 3 : 1) sparse_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const int* __restrict__ items, const int* __restrict__ tiles,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq_out, float* __restrict__ part, Strides st, int B,
    int H, int S, int D, int n_slots, float scale, int causal) {
  constexpr int BN = 64;            // keys per streamed tile
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BN / 8;
  constexpr bool FRAG_REG = DMAX <= 64;
  constexpr int KF = FRAG_REG ? KC : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BM][DP]; then the dq tile
  T* Os = Qs + BM * DP;                     // [BM][DP] dO
  T* Ks = Os + BM * DP;                     // [2][BN][DP]
  T* Vs = Ks + 2 * BN * DP;                 // [2][BN][DP]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BN * DP);  // [2][BN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], q0 = wi[1], cnt = wi[3], slot = wi[4];
  const int* walk = tiles + wi[2];
  const int bh = b * H + h;
  const int dk = (D + 15) & ~15;
  const long long orow = (long long)H * D;  // dO / dq row stride
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const float sl = scale * LOG2E;
  const int i0 = q0 + warp * 16 + g;  // this lane's rows: i0 and i0 + 8
  const long long at = (long long)bh * S;
  const float ls0 = fmaxf(lse[at + i0], LSE_FLOOR) * LOG2E;
  const float ls1 = fmaxf(lse[at + i0 + 8], LSE_FLOOR) * LOG2E;
  const float de0 = delta[at + i0];
  const float de1 = delta[at + i0 + 8];

  auto load_kv = [&](int n, int k0) {
    const int s = n & 1;
    load_rows<T, DP>(Ks + s * BN * DP, kb + k0 * st.ks, st.ks, BN, BN, D,
                     dk);
    load_rows<T, DP>(Vs + s * BN * DP, vb + k0 * st.vs, st.vs, BN, BN, D,
                     dk);
    if (mb && threadIdx.x < BN) Ms[s * BN + threadIdx.x] = mb[k0 + threadIdx.x];
  };
  load_rows<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM,
                   BM, D, dk);
  load_rows<T, DP>(Os, dout + ((long long)b * S + q0) * orow +
                           (long long)h * D,
                   orow, BM, BM, D, dk);
  int k_cur = cnt > 0 ? walk[0] : 0;
  int k_nxt = cnt > 1 ? walk[1] : 0;
  if (cnt > 0) load_kv(0, k_cur);
  cp_async_commit();

  const T* Qw = Qs + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  const T* Ow = Os + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  uint32_t qf[KF][4], of[KF][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int n = 0; n < cnt; ++n) {
    if (n + 1 < cnt) load_kv(n + 1, k_nxt);
    cp_async_commit();
    // the list entry after next, read while this tile's products run
    const int k_after = n + 2 < cnt ? walk[n + 2] : 0;
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = k_cur;
    const T* Kt = Ks + (n & 1) * BN * DP;
    const T* Vt = Vs + (n & 1) * BN * DP;
    const float* Mt = Ms + (n & 1) * BN;
    if constexpr (FRAG_REG) {
      if (n == 0) {
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
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
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
    // p = exp(s - lse) on visible pairs; ds = p (dp - delta), in place of
    // dp. Only the diagonal tile (k0 == q0) crosses the causal edge.
    const bool cedge = causal && k0 + BN - 1 > q0;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        const int i = e < 2 ? i0 : i0 + 8;
        const bool vis = (!cedge || k0 + col <= i) && (!mb || Mt[col] > 0.f);
        const float p = vis ? exp2f(s[c][e] * sl - (e < 2 ? ls0 : ls1)) : 0.f;
        dp[c][e] = p * (dp[c][e] - (e < 2 ? de0 : de1));
      }
    // dq += ds.k, ds split into two 16-bit terms, k read transposed
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      uint32_t hi[4], lo[4];
      a_frags(dp, kc, hi, lo, Qs);
      mma_cols<NO, DP>(acc, hi, lo, Kt, kc * 16, dk);
    }
    __syncthreads();  // this stage is consumed before it is refilled
    k_cur = k_nxt;
    k_nxt = k_after;
  }
  cp_async_wait<0>();  // an empty walk never waited for the q and dO tiles
  __syncthreads();

  if (slot >= 0) {     // a piece of a split walk: fp32 partial sums
    store_part<NO>(part + ((long long)b * n_slots + slot) * BM * D, acc, D);
    return;
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
  store_rows<T, DP>(dq_out + ((long long)b * S + q0) * orow +
                        (long long)h * D,
                    orow, Ds, BM, D);
}

// ---------------------------------------------------------------------------
// dk and dv: grid (items * B); the block owns 64 keys and walks its item's
// query tiles, BQ rows at a time (a 64-row list tile is 64 / BQ steps)
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 3 : 1) sparse_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const int* __restrict__ items, const int* __restrict__ tiles,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ part,
    Strides st, int B, int H, int S, int D, int n_slots, float scale,
    int causal) {
  constexpr int BQ = DMAX <= 64 ? 64 : 32;  // queries per streamed step
  constexpr int SUB = BM / BQ;              // steps per list tile
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
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], k0 = wi[1], slot = wi[4];
  const int steps = wi[3] * SUB;
  const int* walk = tiles + wi[2];
  const int bh = b * H + h;
  const int dk = (D + 15) & ~15;
  const long long orow = (long long)H * D;  // dO / dk / dv row stride
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + (long long)b * S * orow + (long long)h * D;
  const float sl = scale * LOG2E;
  const int j0 = k0 + warp * 16 + g;  // this lane's keys: j0 and j0 + 8
  const bool kept0 = !mask || mask[(long long)b * S + j0] > 0.f;
  const bool kept1 = !mask || mask[(long long)b * S + j0 + 8] > 0.f;

  auto row_of = [&](int it) { return walk[it / SUB] + (it % SUB) * BQ; };
  auto load_q = [&](int it, int q0) {
    const int s = it & 1;
    load_rows<T, DP>(Qs + s * BQ * DP, qb + q0 * st.qs, st.qs, BQ, BQ, D,
                     dk);
    load_rows<T, DP>(Os + s * BQ * DP, ob + q0 * orow, orow, BQ, BQ, D, dk);
    if (threadIdx.x < BQ) {
      const long long at = (long long)bh * S + q0 + threadIdx.x;
      Ls[s * BQ + threadIdx.x] = fmaxf(lse[at], LSE_FLOOR) * LOG2E;
      Es[s * BQ + threadIdx.x] = delta[at];
    }
  };
  load_rows<T, DP>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BM,
                   BM, D, dk);
  load_rows<T, DP>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BM,
                   BM, D, dk);
  int q_cur = steps > 0 ? row_of(0) : 0;
  int q_nxt = steps > 1 ? row_of(1) : 0;
  if (steps > 0) load_q(0, q_cur);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const T* Kw = Ks + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  const T* Vw = Vs + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) load_q(it + 1, q_nxt);
    cp_async_commit();
    // the list entry after next, read while this tile's products run
    const int q_after = it + 2 < steps ? row_of(it + 2) : 0;
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = q_cur, s_ = it & 1;
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
    // p^T = exp(s - lse_i) on visible pairs; ds^T = p^T (dp^T - delta_i).
    // The row is the key j, the column the query i; only a step whose
    // first query is before the tile's last key crosses the diagonal.
    const bool cedge = causal && q0 < k0 + BM - 1;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const int j = e < 2 ? j0 : j0 + 8;
        const bool vis = (e < 2 ? kept0 : kept1) && (!cedge || j <= q0 + c);
        const float p = vis ? exp2f(s[n][e] * sl - Lt[c]) : 0.f;
        dp[n][e] = p * (dp[n][e] - Et[c]);
        s[n][e] = p;
      }
    // dv += p^T.dO and dk += ds^T.q, each A split into two terms
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
      uint32_t hi[4], lo[4];
      a_frags(s, kc, hi, lo, Ks);
      mma_cols<NO, DP>(dva, hi, lo, Ot, kc * 16, dk);
      a_frags(dp, kc, hi, lo, Ks);
      mma_cols<NO, DP>(dka, hi, lo, Qt, kc * 16, dk);
    }
    __syncthreads();
    q_cur = q_nxt;
    q_nxt = q_after;
  }
  cp_async_wait<0>();  // an empty walk never waited for the k and v tiles
  __syncthreads();

  if (slot >= 0) {     // a piece of a split walk: fp32 partial sums
    float* dst = part + ((long long)b * n_slots + slot) * 2 * BM * D;
    store_part<NO>(dst, dka, D);
    store_part<NO>(dst + BM * D, dva, D);
    return;
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
  const long long off = ((long long)b * S + k0) * orow + (long long)h * D;
  store_rows<T, DP>(dk_out + off, orow, dks, BM, D);
  store_rows<T, DP>(dv_out + off, orow, dvs, BM, D);
}

// ---------------------------------------------------------------------------
// the second pass: grid (split tiles * B). Each split tile's pieces are
// summed in piece order (fp32), the first output times scale0, rounded
// once to T. `out1` is null for dq (one output), dv for dk/dv.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) sparse_reduce_kernel(
    const float* __restrict__ part, const int* __restrict__ splits,
    T* __restrict__ out0, T* __restrict__ out1, int B, int H, int S, int D,
    int n_slots, float scale0) {
  const int nout = out1 ? 2 : 1;
  const int tile = blockIdx.x / B;
  const int b = blockIdx.x - tile * B;
  const int* sp = splits + SPLIT * tile;
  const int h = sp[0], row0 = sp[1], first = sp[2], pieces = sp[3];
  const long long orow = (long long)H * D;
  const int per_row = D / 4;
  for (int o = 0; o < nout; ++o) {
    T* dst = (o == 0 ? out0 : out1) + ((long long)b * S + row0) * orow +
             (long long)h * D;
    const float mul = o == 0 ? scale0 : 1.f;
    const float* src =
        part + (((long long)b * n_slots + first) * nout + o) * BM * D;
    const long long piece = (long long)nout * BM * D;  // slot to slot
    for (int idx = threadIdx.x; idx < BM * per_row; idx += NT) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < pieces; ++p) {
        const float4 x =
            *reinterpret_cast<const float4*>(src + p * piece + r * D + c);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      store4(dst + r * orow + c, make_float4(acc.x * mul, acc.y * mul,
                                             acc.z * mul, acc.w * mul));
    }
  }
}

// ---------------------------------------------------------------------------
// the forward's second pass: grid (split tiles * B). Each row's pieces are
// combined in piece order: M = max m_p, L = sum 2^(m_p - M) l_p, o = sum
// 2^(m_p - M) o_p / L rounded once to T, lse = M ln 2 + ln L (o = 0 and
// lse = -1e30 where no piece saw a key).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) sparse_fwd_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ splits,
    T* __restrict__ out, float* __restrict__ lse, int B, int H, int S, int D,
    int n_slots) {
  __shared__ float Mx[BM], Li[BM];
  const int tile = blockIdx.x / B;
  const int b = blockIdx.x - tile * B;
  const int* sp = splits + SPLIT * tile;
  const int h = sp[0], row0 = sp[1], first = sp[2], pieces = sp[3];
  const long long slot0 = (long long)b * n_slots + first;
  const float* po = part + slot0 * BM * D;
  const float* ml = part + (long long)B * n_slots * BM * D + slot0 * BM * 2;
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    float mx = -INFINITY;
    for (int p = 0; p < pieces; ++p) mx = fmaxf(mx, ml[(p * BM + r) * 2]);
    float l = 0.f;
    for (int p = 0; p < pieces; ++p) {
      const float m = ml[(p * BM + r) * 2];
      if (m != -INFINITY) l += exp2f(m - mx) * ml[(p * BM + r) * 2 + 1];
    }
    Mx[r] = mx;
    Li[r] = l;
    lse[((long long)b * H + h) * S + row0 + r] =
        l > 0.f ? mx * LN2 + logf(l) : NEG_INF;
  }
  __syncthreads();
  const long long orow = (long long)H * D;
  T* dst = out + ((long long)b * S + row0) * orow + (long long)h * D;
  const int per_row = D / 4;
  for (int idx = threadIdx.x; idx < BM * per_row; idx += NT) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 4;
    const float mx = Mx[r];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < pieces; ++p) {
      const float m = ml[(p * BM + r) * 2];
      const float w = m == -INFINITY ? 0.f : exp2f(m - mx);
      const float4 x =
          *reinterpret_cast<const float4*>(po + (long long)p * BM * D +
                                           r * D + c);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    const float inv = Li[r] > 0.f ? 1.f / Li[r] : 0.f;
    store4(dst + r * orow + c, make_float4(acc.x * inv, acc.y * inv,
                                           acc.z * inv, acc.w * inv));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { FWD = 0, DQ = 1, DKV = 2 };

struct Args {
  const void *q, *k, *v, *dout;
  const float *mask, *lse, *delta;
  void* out;
  float* lse_out;
  const int *items, *tiles, *splits;
  int n_items, n_split, n_slots;
  void *dq, *dk, *dv;
  float* part;
  Strides st;
  int B, H, S, D, block;
  float scale;
  int causal;
};

template <typename T, int DMAX>
constexpr size_t fwd_smem() {
  return sizeof(T) * (size_t)(BM + 4 * 64) * (DMAX + 8) +
         sizeof(float) * 2 * 64;
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

template <typename T, int DMAX>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const unsigned grid = (unsigned)a.n_items * (unsigned)a.B;
  cudaError_t err;
  if (w == FWD) {
    constexpr size_t smem = fwd_smem<T, DMAX>();
    auto fn = sparse_fwd_tc_kernel<T, DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        q, k, v, a.mask, a.items, a.tiles, static_cast<T*>(a.out),
        a.lse_out, a.part, a.st, a.B, a.H, a.S, a.D, a.n_slots, a.scale,
        a.causal);
    if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 0)
      return err;
    sparse_fwd_combine_kernel<T><<<(unsigned)a.n_split * (unsigned)a.B, NT,
                                   0, stream>>>(
        a.part, a.splits, static_cast<T*>(a.out), a.lse_out, a.B, a.H, a.S,
        a.D, a.n_slots);
    return cudaGetLastError();
  }
  if (w == DQ) {
    constexpr size_t smem = dq_smem<T, DMAX>();
    auto fn = sparse_dq_tc_kernel<T, DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        q, k, v, dout, a.mask, a.items, a.tiles, a.lse, a.delta,
        static_cast<T*>(a.dq), a.part, a.st, a.B, a.H, a.S, a.D, a.n_slots,
        a.scale, a.causal);
  } else {
    constexpr size_t smem = dkv_smem<T, DMAX>();
    auto fn = sparse_dkv_tc_kernel<T, DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        q, k, v, dout, a.mask, a.items, a.tiles, a.lse, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.part, a.st, a.B,
        a.H, a.S, a.D, a.n_slots, a.scale, a.causal);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 0)
    return err;
  T* out0 = static_cast<T*>(w == DQ ? a.dq : a.dk);
  T* out1 = w == DQ ? nullptr : static_cast<T*>(a.dv);
  sparse_reduce_kernel<T><<<(unsigned)a.n_split * (unsigned)a.B, NT, 0,
                            stream>>>(a.part, a.splits, out0, out1, a.B, a.H,
                                      a.S, a.D, a.n_slots, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which w, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(w, a, stream);
  return launch<T, 128>(w, a, stream);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (a.D < 8 || a.D > 128 || a.D % 8 != 0 || a.B < 1 || a.H < 1 ||
      a.block < BM || a.block % BM != 0 || a.S < a.block ||
      a.S % a.block != 0 || a.n_items < 1 || a.n_split < 0 ||
      a.n_slots < 0 || (long long)a.n_items * a.B > 0x7fffffffLL ||
      (long long)a.n_split * a.B > 0x7fffffffLL ||
      (a.n_split > 0 && (!a.part || !a.splits || a.n_slots < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) err = dispatch_d<__nv_bfloat16>(w, a, st);
  else if (dtype == 2) err = dispatch_d<__half>(w, a, st);
  else err = cudaErrorInvalidValue;   // fp32 runs the FMA kernels
  return (int)err;
}

}  // namespace

extern "C" {

// The arguments of sparse_attention.cu's sparse_attention_fwd with the
// layout's index lists replaced by the dq kernel's work list (the forward
// walks the same tiles), and scratch for split walks: part fp32, B *
// n_slots * 64 * (D + 2) floats (the pieces' o, then their rows' m and l;
// null when n_split is 0). Returns cudaGetLastError() after the launches
// (0 = launched).
int sparse_attention_tc_fwd(const void* q, const void* k, const void* v,
                            const float* mask, const int* items,
                            const int* tiles, int n_items, void* out,
                            float* lse, const long long* strides, int B,
                            int H, int S, int D, int block, float scale,
                            int causal, float* part, const int* splits,
                            int n_split, int n_slots, int dtype,
                            void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.items = items;
  a.tiles = tiles; a.n_items = n_items; a.out = out; a.lse_out = lse;
  a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(FWD, a, dtype, stream);
}

// The arguments of sparse_attention.cu's sparse_attention_bwd_dq and
// sparse_attention_bwd_dkv, with the layout's index lists replaced by a
// work list and its split (SparsePlan.work): items int32 [n_items][5],
// tiles int32 (the first row of each streamed 64-row tile, by item);
// part fp32 [B][n_slots][outputs][64][D] (null when n_split is 0), splits
// int32 [n_split][4]. dtype 1 (bfloat16) or 2 (float16), D a multiple of
// 8 in [8, 128], block a multiple of 64. Returns cudaGetLastError() after
// the launches (0 = launched).
int sparse_attention_tc_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* mask,
                               const int* items, const int* tiles,
                               int n_items, const float* lse,
                               const float* delta, void* dq,
                               const long long* strides, int B, int H, int S,
                               int D, int block, float scale, int causal,
                               float* part, const int* splits, int n_split,
                               int n_slots, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.items = items;
  a.tiles = tiles; a.n_items = n_items; a.lse = lse; a.delta = delta;
  a.dq = dq; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(DQ, a, dtype, stream);
}

int sparse_attention_tc_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* mask,
                                const int* items, const int* tiles,
                                int n_items, const float* lse,
                                const float* delta, void* dk, void* dv,
                                const long long* strides, int B, int H,
                                int S, int D, int block, float scale,
                                int causal, float* part, const int* splits,
                                int n_split, int n_slots, int dtype,
                                void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.items = items;
  a.tiles = tiles; a.n_items = n_items; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(DKV, a, dtype, stream);
}

const char* sparse_attention_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Block-sparse attention forward, dq and dk/dv on Hopper's tensor cores
// (sm_90a) over 16-row blocks, for bf16 and fp16 with head_dim a multiple
// of 8 up to 128 and a layout block that is a multiple of 16 and not of 64
// (16, 32, 48, ...; the reference's default block is 16).
//
// Replaces, for those inputs, three Pallas TPU kernels of deepspeed_tpu/
// ops/sparse_attention/sparse_attention.py: _sparse_kernel (the forward: o
// and a natural-log lse), _sparse_bwd_dq_kernel (dq) and
// _sparse_bwd_dkv_kernel (dk and dv). Each computes exactly the function
// that sparse_attention.cu's header states: masked pairs (outside the
// layout, above the causal diagonal, a dropped key) selected out; the
// forward's row with no visible key gives o = 0 and lse = -1e30; the
// backward's lse clamped at -5e29, p = exp(s - lse) on visible pairs only,
// ds = p (dO.v - delta), dq = scale sum_j ds k_j, dk = sum_i ds (scale
// q_i), dv = sum_i p dO_i. Blocks that are multiples of 64 take
// sparse_attention_tc.cu's 64-row kernels; fp32 stays on
// sparse_attention.cu's FMA kernels.
//
// What bounds it on an H100: at the sparse BERT shape (bf16 [8, 512, 16,
// 64], the reference documentation's fixed layout at block 16 with a
// pattern per head, non-causal, a key mask: 0.344 of the pairs) the
// forward must move q, k, v, o and lse (33.8 MB: 0.0101 ms at 3.35 TB/s)
// against 1.9 GFLOP (0.0019 ms at 989 TFLOP/s); dq q, k, v, dO, lse, delta
// and dq (42.5 MB: 0.0127 ms) against 2.8 GFLOP (0.0029 ms); dk/dv 50.9 MB
// (0.0152 ms) against 3.8 GFLOP: bytes bound all three. The FMA first
// versions ran at 35x, 37x and 43x that bound.
//
// What the design does:
// - a 64-row tile of the 64-row kernels straddles up to four layout rows
//   whose lists differ at these blocks, so the unit of work is a 16-row
//   block, one warp's: a work item (ops/sparse_attention/
//   sparse_attention.py, build_work16) is up to four 16-row blocks of
//   one head, not necessarily contiguous (queries for the forward and dq,
//   keys for dk/dv; the forward walks dq's list), packed by equal lists,
//   and one walk over the other axis' 16-row blocks: the union of the four
//   lists, ascending, each entry with the bits of the warps that list it.
//   Blocks wholly above the causal diagonal are left out of a warp's list
//   (its bit is 0, and the entry leaves the walk where no warp lists it);
// - a block of 4 warps takes one item of one batch row, reads its walk
//   into shared memory once (so no step waits on a global read for the
//   addresses it gathers) and streams it 4 entries a step (64 rows, each
//   16-row block gathered from its own address by cp.async, two stages,
//   the key mask or the lse and delta at the gathered rows by 4-byte
//   cp.async too; dk/dv at D = 128 2 entries, 32 rows, a step). With
//   equal lists the 4 warps read each gathered tile once from device
//   memory. A warp skips the products of the entries it does not list
//   (its s, dp and ds columns, its k-steps of p.v and ds.k);
// - the tiles of attention_tc.cuh, as in sparse_attention_tc.cu:
//   mma.sync.m16n8k16 with fp32 sums, ldmatrix (.trans where k runs
//   along rows), p and ds split into two 16-bit terms (split16), s and
//   lse in base 2 with the lse converted once as it is loaded (backward)
//   or written (forward: m ln 2 + ln l); dk/dv on the transposed tile
//   (s^T = k.q^T). The forward is the flash forward's online softmax on
//   each warp's accumulator fragment, -inf-safe (a row that has seen no
//   visible key keeps m = -inf and p = 0). The key mask is read at each
//   gathered row's real position; the causal mask is evaluated only on a
//   diagonal 16-row block (the entry's first row equals the warp's);
// - a walk longer than the plan's cap (in 64-row steps) is cut into
//   pieces of whole steps: a piece writes its warps' fp32 partials to
//   scratch ([B][slots][outputs][64][D], warp w's rows at 16 w; the
//   forward's unnormalised o, then its rows' base-2 m and l,
//   [B][slots][64][2]), and a second kernel reads each split item's pieces
//   in piece order and writes each warp's rows to its own block, rounded
//   once: the backward sums them, the forward combines them (M = max m_p,
//   o = sum 2^(m_p - M) o_p / sum 2^(m_p - M) l_p, lse = M ln 2 + ln L).
//   No atomics: every output element is summed in a fixed order, so each
//   kernel is deterministic;
// - q, k and v are read through their [B, S, H, D] strides; o, dO, dq, dk
//   and dv are contiguous [B, S, H, D]; lse and delta fp32 [B * H, S].

#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

using attn_tc::a_frags;
using attn_tc::BM;
using attn_tc::mma_cols;
using attn_tc::NT;
using attn_tc::quad_max;
using attn_tc::quad_sum;
using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using attn_tile::ldsm_x4;
using attn_tile::mma16;
using attn_tile::pack16;
using attn_tile::store4;
using attn_tile::Strides;
using attn_tile::strides_of;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;    // the forward's lse of an empty row
constexpr float LSE_FLOOR = -5e29f;  // the backward's clamp of an empty row
constexpr int SUB = 16;    // rows of a block one warp owns or one entry holds
constexpr int WARPS = 4;
constexpr int ITEM = 8;    // ints per work item: head, the 4 warps' first
                           // rows (-1: none), offset and count of its walk,
                           // scratch slot of a piece (-1: not split)
constexpr int ENTRY = 2;   // ints per walk entry: first row, warp bits
constexpr int SPLIT = 7;   // ints per split item: head, 4 rows, first slot,
                           // pieces

// 4 bytes from global to shared memory, asynchronously; with !valid the
// word is zero and nothing is read
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// the item's walk (cnt entries) into shared memory, then (-1, 0) entries
// up to `padded`: read once, so that no step waits on a global read for
// the addresses of the blocks it gathers
__device__ __forceinline__ void load_walk(int* dst, const int* walk, int cnt,
                                          int padded) {
  for (int i = threadIdx.x; i < padded; i += NT) {
    const bool ok = i < cnt;
    dst[ENTRY * i] = ok ? walk[ENTRY * i] : -1;
    dst[ENTRY * i + 1] = ok ? walk[ENTRY * i + 1] : 0;
  }
}

// nb 16-row blocks into dst [nb * 16][DP] by cp.async: block e from src +
// row_e * stride, row_e = rows[e * rstride] for e < valid (and >= 0);
// other blocks, and columns at or past D, are zeros
template <typename T, int DP>
__device__ __forceinline__ void load_blocks(T* dst, const T* src,
                                            long long stride,
                                            const int* rows, int rstride,
                                            int nb, int valid, int D,
                                            int dk) {
  const int cpr = dk / 8;
  for (int idx = threadIdx.x; idx < nb * SUB * cpr; idx += NT) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * 8;
    const int e = r / SUB;
    const int row = e < valid ? rows[e * rstride] : -1;
    const bool ok = row >= 0 && c < D;
    cp_async16(dst + r * DP + c,
               ok ? src + (long long)(row + r % SUB) * stride + c : src, ok);
  }
}

// acc[n] += A . B as attention_tc.cuh's mma_rows, over the 16-column
// groups (entries) whose bit in `live` is set; the others are left as
// they are
template <int NN, int DP, typename T>
__device__ __forceinline__ void mma_rows_live(float (&acc)[NN][4],
                                              const uint32_t (&a)[4],
                                              const T* B, int kc,
                                              unsigned live) {
  const int lane = threadIdx.x & 31;
  const T* base = B + ((lane & 7) + ((lane >> 4) << 3)) * DP + kc +
                  ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < NN / 2; ++np) {
    if ((live >> np) & 1u) {
      uint32_t r[4];
      ldsm_x4(r, base + np * 16 * DP);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma16(acc[2 * np], a, b0, B);
      mma16(acc[2 * np + 1], a, b1, B);
    }
  }
}

// the fp32 accumulator tile of this warp's fragments (rows 16 warp + g
// and + 8, columns 8 n + 2 t and + 1) into a piece's scratch slot [64][D]
template <int NO>
__device__ __forceinline__ void store_part(float* dst,
                                           const float (&acc)[NO][4], int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * SUB + (lane >> 2), t = lane & 3;
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

// the finished [64][D] tile staged at `tile` (row pitch DP) to dst: warp
// w's 16 rows to rows rows[w] .. + 15 (row stride `stride` elements;
// none where rows[w] < 0), 16-byte stores
template <typename T, int DP>
__device__ __forceinline__ void store_blocks(T* dst, long long stride,
                                             const T* tile, const int* rows,
                                             int D) {
  const int cpr = D / 8;
  for (int idx = threadIdx.x; idx < BM * cpr; idx += NT) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * 8;
    const int row = rows[r / SUB];
    if (row >= 0)
      *reinterpret_cast<uint4*>(dst + (long long)(row + r % SUB) * stride +
                                c) =
          *reinterpret_cast<const uint4*>(tile + r * DP + c);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (items * B); warp w owns the 16 queries at items[1 + w] and the
// block streams the item's walk (read into shared memory once), 4 gathered
// key blocks a step. The A fragments of the warp's q and dO rows are read
// from the resident tiles at every step: kept in registers they would
// hold the kernel to 3 blocks an SM at DMAX <= 64, and 4 ran faster
// (tools/probe_sparse_tc16.py, PERF.md).
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 4 : 1) sparse_dq_tc16_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const int* __restrict__ items, const int* __restrict__ tiles,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq_out, float* __restrict__ part, Strides st, int B,
    int H, int S, int D, int n_slots, float scale, int causal) {
  constexpr int BN = 64;            // keys per step
  constexpr int EPS = BN / SUB;     // walk entries per step
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BM][DP]; then the dq tile
  T* Os = Qs + BM * DP;                     // [BM][DP] dO
  T* Ks = Os + BM * DP;                     // [2][BN][DP]
  T* Vs = Ks + 2 * BN * DP;                 // [2][BN][DP]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BN * DP);  // [2][BN]
  int* Wk = reinterpret_cast<int*>(Ms + 2 * BN);  // the walk [][row, bits]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], rw = wi[1 + warp], cnt = wi[6], slot = wi[7];
  const int steps = (cnt + EPS - 1) / EPS;
  const int bh = b * H + h;
  const int dk = (D + 15) & ~15;
  const long long orow = (long long)H * D;  // dO / dq row stride
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const float sl = scale * LOG2E;
  const int i0 = rw + g;              // this lane's rows: i0 and i0 + 8
  const long long at = (long long)bh * S;
  const float ls0 = rw >= 0 ? fmaxf(lse[at + i0], LSE_FLOOR) * LOG2E : 0.f;
  const float ls1 = rw >= 0 ? fmaxf(lse[at + i0 + 8], LSE_FLOOR) * LOG2E
                            : 0.f;
  const float de0 = rw >= 0 ? delta[at + i0] : 0.f;
  const float de1 = rw >= 0 ? delta[at + i0 + 8] : 0.f;

  // step n's entries into stage n & 1: the K and V blocks and the key
  // mask at their rows, all by cp.async
  auto load_kv = [&](int n) {
    const int s = n & 1;
    const int* ent = Wk + ENTRY * EPS * n;
    load_blocks<T, DP>(Ks + s * BN * DP, kb, st.ks, ent, ENTRY, EPS, EPS, D,
                       dk);
    load_blocks<T, DP>(Vs + s * BN * DP, vb, st.vs, ent, ENTRY, EPS, EPS, D,
                       dk);
    if (mb && threadIdx.x < BN) {
      const int row = ent[ENTRY * (threadIdx.x / SUB)];
      cp_async4(Ms + s * BN + threadIdx.x,
                row >= 0 ? mb + row + threadIdx.x % SUB : mb, row >= 0);
    }
  };
  load_blocks<T, DP>(Qs, q + b * st.qb + h * st.qh, st.qs, wi + 1, 1, WARPS,
                     WARPS, D, dk);
  load_blocks<T, DP>(Os, dout + (long long)b * S * orow + (long long)h * D,
                     orow, wi + 1, 1, WARPS, WARPS, D, dk);
  load_walk(Wk, tiles + ENTRY * wi[5], cnt, steps * EPS);
  __syncthreads();
  if (steps > 0) load_kv(0);
  cp_async_commit();

  const T* Qw = Qs + (warp * SUB + (lane & 15)) * DP + (lane >> 4) * 8;
  const T* Ow = Os + (warp * SUB + (lane & 15)) * DP + (lane >> 4) * 8;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int n = 0; n < steps; ++n) {
    if (n + 1 < steps) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + (n & 1) * BN * DP;
    const T* Vt = Vs + (n & 1) * BN * DP;
    const float* Mt = Ms + (n & 1) * BN;
    const int* Wt = Wk + ENTRY * EPS * n;
    constexpr unsigned FULL_LIVE = (1u << EPS) - 1;
    unsigned live = 0;  // the step's entries this warp lists
#pragma unroll
    for (int e = 0; e < EPS; ++e)
      live |= ((unsigned)(Wt[ENTRY * e + 1] >> warp) & 1u) << e;

    // the step's products over the entries in lv, in two unrolled copies:
    // one where the warp lists all of them (lv a constant, so no branch
    // separates the products), one for the rest
#pragma unroll
    for (int variant = 0; variant < 2; ++variant) {
      if (variant == 0 ? live != FULL_LIVE : live == FULL_LIVE || !live)
        continue;
      const unsigned lv = variant == 0 ? FULL_LIVE : live;
      // s = q.k^T and dp = dO.v^T over the listed entries
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc * 16 < dk) {
          uint32_t a[4];
          ldsm_x4(a, Qw + kc * 16);
          mma_rows_live<NS, DP>(s, a, Kt, kc * 16, lv);
          ldsm_x4(a, Ow + kc * 16);
          mma_rows_live<NS, DP>(dp, a, Vt, kc * 16, lv);
        }
      }
      // p = exp(s - lse) on visible pairs, ds = p (dp - delta) in place of
      // dp; only the entry whose block is the warp's own crosses the
      // causal edge
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int e = c >> 1;
        const int k0 = Wt[ENTRY * e];
        const bool listed = (lv >> e) & 1u;
        const bool cedge = causal && k0 == rw;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int col = 8 * c + 2 * t + (x & 1);
          const int i = x < 2 ? i0 : i0 + 8;
          const bool vis = listed && (!cedge || k0 + col % SUB <= i) &&
                           (!mb || Mt[col] > 0.f);
          const float p =
              vis ? exp2f(s[c][x] * sl - (x < 2 ? ls0 : ls1)) : 0.f;
          dp[c][x] = p * (dp[c][x] - (x < 2 ? de0 : de1));
        }
      }
      // dq += ds.k over the listed entries, ds split into two 16-bit terms
#pragma unroll
      for (int kc = 0; kc < NS / 2; ++kc) {
        if ((lv >> kc) & 1u) {
          uint32_t hi[4], lo[4];
          a_frags(dp, kc, hi, lo, Qs);
          mma_cols<NO, DP>(acc, hi, lo, Kt, kc * 16, dk);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // an empty walk never waited for the q and dO tiles
  __syncthreads();

  if (slot >= 0) {     // a piece of a split walk: fp32 partial sums
    store_part<NO>(part + ((long long)b * n_slots + slot) * BM * D, acc, D);
    return;
  }
  // dq = scale * acc through the q tile's shared memory
  T* Ds = Qs;
  const int r0 = warp * SUB + g;
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
  store_blocks<T, DP>(dq_out + (long long)b * S * orow + (long long)h * D,
                      orow, Ds, wi + 1, D);
}

// ---------------------------------------------------------------------------
// dk and dv: grid (items * B); warp w owns the 16 keys at items[1 + w] and
// the block streams the item's walk (read into shared memory once), BQ /
// 16 gathered query blocks a step with their dO, lse and delta
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 3 : 1) sparse_dkv_tc16_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const int* __restrict__ items, const int* __restrict__ tiles,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ part,
    Strides st, int B, int H, int S, int D, int n_slots, float scale,
    int causal) {
  constexpr int BQ = DMAX <= 64 ? 64 : 32;  // queries per step
  constexpr int EPS = BQ / SUB;             // walk entries per step
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [BM][DP]
  T* Vs = Ks + BM * DP;                     // [BM][DP]
  T* Qs = Vs + BM * DP;                     // [2][BQ][DP]; then the dk tile
  T* Os = Qs + 2 * BQ * DP;                 // [2][BQ][DP] dO; then dv
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * DP);  // [2][BQ] lse
  float* Es = Ls + 2 * BQ;                  // [2][BQ] delta
  int* Wk = reinterpret_cast<int*>(Es + 2 * BQ);  // the walk [][row, bits]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], rw = wi[1 + warp], cnt = wi[6], slot = wi[7];
  const int steps = (cnt + EPS - 1) / EPS;
  const int bh = b * H + h;
  const int dk = (D + 15) & ~15;
  const long long orow = (long long)H * D;  // dO / dk / dv row stride
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + (long long)b * S * orow + (long long)h * D;
  const float* lb = lse + (long long)bh * S;
  const float* eb = delta + (long long)bh * S;
  const float sl = scale * LOG2E;
  const int j0 = rw + g;              // this lane's keys: j0 and j0 + 8
  const bool kept0 = rw >= 0 && (!mask || mask[(long long)b * S + j0] > 0.f);
  const bool kept1 =
      rw >= 0 && (!mask || mask[(long long)b * S + j0 + 8] > 0.f);

  // step n's entries into stage n & 1: the q and dO blocks and the lse
  // and delta at their rows, all by cp.async
  auto load_q = [&](int n) {
    const int s = n & 1;
    const int* ent = Wk + ENTRY * EPS * n;
    load_blocks<T, DP>(Qs + s * BQ * DP, qb, st.qs, ent, ENTRY, EPS, EPS, D,
                       dk);
    load_blocks<T, DP>(Os + s * BQ * DP, ob, orow, ent, ENTRY, EPS, EPS, D,
                       dk);
    if (threadIdx.x < BQ) {
      const int row = ent[ENTRY * (threadIdx.x / SUB)];
      const int i = row + threadIdx.x % SUB;
      cp_async4(Ls + s * BQ + threadIdx.x, row >= 0 ? lb + i : lb, row >= 0);
      cp_async4(Es + s * BQ + threadIdx.x, row >= 0 ? eb + i : eb, row >= 0);
    }
  };
  load_blocks<T, DP>(Ks, k + b * st.kb + h * st.kh, st.ks, wi + 1, 1, WARPS,
                     WARPS, D, dk);
  load_blocks<T, DP>(Vs, v + b * st.vb + h * st.vh, st.vs, wi + 1, 1, WARPS,
                     WARPS, D, dk);
  load_walk(Wk, tiles + ENTRY * wi[5], cnt, steps * EPS);
  __syncthreads();
  if (steps > 0) load_q(0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const T* Kw = Ks + (warp * SUB + (lane & 15)) * DP + (lane >> 4) * 8;
  const T* Vw = Vs + (warp * SUB + (lane & 15)) * DP + (lane >> 4) * 8;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s_ = it & 1;
    const T* Qt = Qs + s_ * BQ * DP;
    const T* Ot = Os + s_ * BQ * DP;
    const float* Lt = Ls + s_ * BQ;
    const float* Et = Es + s_ * BQ;
    const int* Wt = Wk + ENTRY * EPS * it;
    constexpr unsigned FULL_LIVE = (1u << EPS) - 1;
    unsigned live = 0;  // the step's entries this warp lists
#pragma unroll
    for (int e = 0; e < EPS; ++e)
      live |= ((unsigned)(Wt[ENTRY * e + 1] >> warp) & 1u) << e;

    // the step's products over the entries in lv, in two unrolled copies:
    // one where the warp lists all of them (lv a constant, so no branch
    // separates the products), one for the rest
#pragma unroll
    for (int variant = 0; variant < 2; ++variant) {
      if (variant == 0 ? live != FULL_LIVE : live == FULL_LIVE || !live)
        continue;
      const unsigned lv = variant == 0 ? FULL_LIVE : live;
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
          mma_rows_live<NS, DP>(s, a, Qt, kc * 16, lv);
          ldsm_x4(a, Vw + kc * 16);
          mma_rows_live<NS, DP>(dp, a, Ot, kc * 16, lv);
        }
      }
      // p^T = exp(s - lse_i) on visible pairs; ds^T = p^T (dp^T - delta_i).
      // The row is the key j, the column the query i; only the entry whose
      // block is the warp's own crosses the causal edge.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int e = n >> 1;
        const int q0 = Wt[ENTRY * e];
        const bool listed = (lv >> e) & 1u;
        const bool cedge = causal && q0 == rw;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int c = 8 * n + 2 * t + (x & 1);
          const int j = x < 2 ? j0 : j0 + 8;
          const bool vis = listed && (x < 2 ? kept0 : kept1) &&
                           (!cedge || j <= q0 + c % SUB);
          const float p =
              vis ? exp2f(s[n][x] * sl - fmaxf(Lt[c], LSE_FLOOR) * LOG2E)
                  : 0.f;
          dp[n][x] = p * (dp[n][x] - Et[c]);
          s[n][x] = p;
        }
      }
      // dv += p^T.dO and dk += ds^T.q over the listed entries, each A split
      // into two terms
#pragma unroll
      for (int kc = 0; kc < NS / 2; ++kc) {
        if ((lv >> kc) & 1u) {
          uint32_t hi[4], lo[4];
          a_frags(s, kc, hi, lo, Ks);
          mma_cols<NO, DP>(dva, hi, lo, Ot, kc * 16, dk);
          a_frags(dp, kc, hi, lo, Ks);
          mma_cols<NO, DP>(dka, hi, lo, Qt, kc * 16, dk);
        }
      }
    }
    __syncthreads();
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
  const int r0 = warp * SUB + g;
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
  const long long off = (long long)b * S * orow + (long long)h * D;
  store_blocks<T, DP>(dk_out + off, orow, dks, wi + 1, D);
  store_blocks<T, DP>(dv_out + off, orow, dvs, wi + 1, D);
}

// ---------------------------------------------------------------------------
// the second pass: grid (split items * B). Each split item's pieces are
// summed in piece order (fp32), the first output times scale0, rounded
// once to T, warp w's rows written to rows sp[1 + w] ... `out1` is null
// for dq (one output), dv for dk/dv.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) sparse_reduce16_kernel(
    const float* __restrict__ part, const int* __restrict__ splits,
    T* __restrict__ out0, T* __restrict__ out1, int B, int H, int S, int D,
    int n_slots, float scale0) {
  const int nout = out1 ? 2 : 1;
  const int tile = blockIdx.x / B;
  const int b = blockIdx.x - tile * B;
  const int* sp = splits + SPLIT * tile;
  const int h = sp[0], first = sp[5], pieces = sp[6];
  const long long orow = (long long)H * D;
  const int per_row = D / 4;
  for (int o = 0; o < nout; ++o) {
    T* dst = (o == 0 ? out0 : out1) + (long long)b * S * orow +
             (long long)h * D;
    const float mul = o == 0 ? scale0 : 1.f;
    const float* src =
        part + (((long long)b * n_slots + first) * nout + o) * BM * D;
    const long long piece = (long long)nout * BM * D;  // slot to slot
    for (int idx = threadIdx.x; idx < BM * per_row; idx += NT) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) * 4;
      const int row = sp[1 + r / SUB];
      if (row < 0) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < pieces; ++p) {
        const float4 x =
            *reinterpret_cast<const float4*>(src + p * piece + r * D + c);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      store4(dst + (long long)(row + r % SUB) * orow + c,
             make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul));
    }
  }
}

// ---------------------------------------------------------------------------
// forward: grid (items * B), over dq's work list; warp w owns the 16 queries
// at items[1 + w] and the block streams the item's walk (read into shared
// memory once), 4 gathered key and value blocks a step, each warp running
// the online softmax of sparse_attention_tc.cu's forward over the entries
// its bit lists (a step it lists none of leaves its state as it was). The
// A fragments of the warp's q rows are read from the resident tile at
// every step: kept in registers they spilled at 4 blocks an SM, and the
// forward ran slower (tools/probe_sparse_tc16.py, PERF.md); 3 blocks an SM
// ran slower still. A piece of a split walk leaves its warps'
// unnormalised o and their rows' base-2 (m, l) in scratch; an unsplit
// item writes o and lse.
// ---------------------------------------------------------------------------
template <typename T, int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? 4 : 1) sparse_fwd_tc16_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const int* __restrict__ items,
    const int* __restrict__ tiles, T* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, Strides st, int B,
    int H, int S, int D, int n_slots, float scale, int causal) {
  constexpr int BN = 64;            // keys per step
  constexpr int EPS = BN / SUB;     // walk entries per step
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BM][DP]; then the o tile
  T* Ks = Qs + BM * DP;                     // [2][BN][DP]
  T* Vs = Ks + 2 * BN * DP;                 // [2][BN][DP]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BN * DP);  // [2][BN]
  int* Wk = reinterpret_cast<int*>(Ms + 2 * BN);  // the walk [][row, bits]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], rw = wi[1 + warp], cnt = wi[6], slot = wi[7];
  const int steps = (cnt + EPS - 1) / EPS;
  const int dk = (D + 15) & ~15;
  const long long orow = (long long)H * D;  // o row stride
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const float sl = scale * LOG2E;     // s in base-2 units: exp2(s' - m')
  const int i0 = rw + g;              // this lane's rows: i0 and i0 + 8

  // step n's entries into stage n & 1: the K and V blocks and the key
  // mask at their rows, all by cp.async
  auto load_kv = [&](int n) {
    const int s = n & 1;
    const int* ent = Wk + ENTRY * EPS * n;
    load_blocks<T, DP>(Ks + s * BN * DP, kb, st.ks, ent, ENTRY, EPS, EPS, D,
                       dk);
    load_blocks<T, DP>(Vs + s * BN * DP, vb, st.vs, ent, ENTRY, EPS, EPS, D,
                       dk);
    if (mb && threadIdx.x < BN) {
      const int row = ent[ENTRY * (threadIdx.x / SUB)];
      cp_async4(Ms + s * BN + threadIdx.x,
                row >= 0 ? mb + row + threadIdx.x % SUB : mb, row >= 0);
    }
  };
  load_blocks<T, DP>(Qs, q + b * st.qb + h * st.qh, st.qs, wi + 1, 1, WARPS,
                     WARPS, D, dk);
  load_walk(Wk, tiles + ENTRY * wi[5], cnt, steps * EPS);
  __syncthreads();
  if (steps > 0) load_kv(0);
  cp_async_commit();

  const T* Qw = Qs + (warp * SUB + (lane & 15)) * DP + (lane >> 4) * 8;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < steps; ++n) {
    if (n + 1 < steps) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + (n & 1) * BN * DP;
    const T* Vt = Vs + (n & 1) * BN * DP;
    const float* Mt = Ms + (n & 1) * BN;
    const int* Wt = Wk + ENTRY * EPS * n;
    constexpr unsigned FULL_LIVE = (1u << EPS) - 1;
    unsigned live = 0;  // the step's entries this warp lists
#pragma unroll
    for (int e = 0; e < EPS; ++e)
      live |= ((unsigned)(Wt[ENTRY * e + 1] >> warp) & 1u) << e;

    // the step's products over the entries in lv, in two unrolled copies:
    // one where the warp lists all of them (lv a constant, so no branch
    // separates the products), one for the rest
#pragma unroll
    for (int variant = 0; variant < 2; ++variant) {
      if (variant == 0 ? live != FULL_LIVE : live == FULL_LIVE || !live)
        continue;
      const unsigned lv = variant == 0 ? FULL_LIVE : live;
      // s = q.k^T over the listed entries (fp32 sums of exact 16-bit
      // products)
      float s[NS][4];
#pragma unroll
      for (int c = 0; c < NS; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc * 16 < dk) {
          uint32_t a[4];
          ldsm_x4(a, Qw + kc * 16);
          mma_rows_live<NS, DP>(s, a, Kt, kc * 16, lv);
        }
      }
      // masked pairs (an entry the warp does not list, a dropped key, above
      // the diagonal) leave the max and the sum: a select, scaled in fp32
      // into base 2; only the entry whose block is the warp's own crosses
      // the causal edge
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int e = c >> 1;
        const int k0 = Wt[ENTRY * e];
        const bool listed = (lv >> e) & 1u;
        const bool cedge = causal && k0 == rw;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int col = 8 * c + 2 * t + (x & 1);
          const int i = x < 2 ? i0 : i0 + 8;
          const bool vis = listed && (!cedge || k0 + col % SUB <= i) &&
                           (!mb || Mt[col] > 0.f);
          const float y = vis ? s[c][x] * sl : -INFINITY;
          s[c][x] = y;
          if (x < 2) mx0 = fmaxf(mx0, y);
          else mx1 = fmaxf(mx1, y);
        }
      }
      // the online softmax, -inf-safe: a row that has seen no visible key
      // keeps m = -inf, l = 0 and p = 0
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
        for (int x = 0; x < 4; ++x) {
          const float y = s[c][x];
          const float p =
              y == -INFINITY ? 0.f : exp2f(y - (x < 2 ? mn0 : mn1));
          if (x < 2) sum0 += p;
          else sum1 += p;
          s[c][x] = p;
        }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        acc[c][0] *= a0; acc[c][1] *= a0;
        acc[c][2] *= a1; acc[c][3] *= a1;
      }
      // o += p.v over the listed entries, p split into two 16-bit terms
#pragma unroll
      for (int kc = 0; kc < NS / 2; ++kc) {
        if ((lv >> kc) & 1u) {
          uint32_t hi[4], lo[4];
          a_frags(s, kc, hi, lo, Qs);
          mma_cols<NO, DP>(acc, hi, lo, Vt, kc * 16, dk);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // an empty walk never waited for the q tile
  __syncthreads();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int r0 = warp * SUB + g;

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
  if (t == 0 && rw >= 0) {
    const long long at = ((long long)b * H + h) * S;
    lse[at + i0] = l0 > 0.f ? m0 * LN2 + logf(l0) : NEG_INF;
    lse[at + i0 + 8] = l1 > 0.f ? m1 * LN2 + logf(l1) : NEG_INF;
  }
  __syncthreads();
  store_blocks<T, DP>(out + (long long)b * S * orow + (long long)h * D, orow,
                      Os, wi + 1, D);
}

// ---------------------------------------------------------------------------
// the forward's second pass: grid (split items * B). Each row's pieces are
// combined in piece order: M = max m_p, L = sum 2^(m_p - M) l_p, o = sum
// 2^(m_p - M) o_p / L rounded once to T, lse = M ln 2 + ln L (o = 0 and
// lse = -1e30 where no piece saw a key); warp w's rows written to rows
// sp[1 + w] ...
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT) sparse_fwd_combine16_kernel(
    const float* __restrict__ part, const int* __restrict__ splits,
    T* __restrict__ out, float* __restrict__ lse, int B, int H, int S, int D,
    int n_slots) {
  __shared__ float Mx[BM], Li[BM];
  const int tile = blockIdx.x / B;
  const int b = blockIdx.x - tile * B;
  const int* sp = splits + SPLIT * tile;
  const int h = sp[0], first = sp[5], pieces = sp[6];
  const long long slot0 = (long long)b * n_slots + first;
  const float* po = part + slot0 * BM * D;
  const float* ml = part + (long long)B * n_slots * BM * D + slot0 * BM * 2;
  if (threadIdx.x < BM) {
    const int r = threadIdx.x;
    const int row = sp[1 + r / SUB];
    float mx = -INFINITY;
    for (int p = 0; p < pieces; ++p) mx = fmaxf(mx, ml[(p * BM + r) * 2]);
    float l = 0.f;
    for (int p = 0; p < pieces; ++p) {
      const float m = ml[(p * BM + r) * 2];
      if (m != -INFINITY) l += exp2f(m - mx) * ml[(p * BM + r) * 2 + 1];
    }
    Mx[r] = mx;
    Li[r] = l;
    if (row >= 0)
      lse[((long long)b * H + h) * S + row + r % SUB] =
          l > 0.f ? mx * LN2 + logf(l) : NEG_INF;
  }
  __syncthreads();
  const long long orow = (long long)H * D;
  T* dst = out + (long long)b * S * orow + (long long)h * D;
  const int per_row = D / 4;
  for (int idx = threadIdx.x; idx < BM * per_row; idx += NT) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * 4;
    const int row = sp[1 + r / SUB];
    if (row < 0) continue;
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
    store4(dst + (long long)(row + r % SUB) * orow + c,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
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
  int n_items, walk_max, n_split, n_slots;
  void *dq, *dk, *dv;
  float* part;
  Strides st;
  int B, H, S, D, block;
  float scale;
  int causal;
};

// the tiles, then the walk of up to walk_max entries (a multiple of 4)
template <typename T, int DMAX>
size_t fwd_smem(int walk_max) {
  return sizeof(T) * (size_t)(BM + 4 * 64) * (DMAX + 8) +
         sizeof(float) * 2 * 64 + sizeof(int) * ENTRY * (size_t)walk_max;
}
template <typename T, int DMAX>
size_t dq_smem(int walk_max) {
  return sizeof(T) * (size_t)(2 * BM + 4 * 64) * (DMAX + 8) +
         sizeof(float) * 2 * 64 + sizeof(int) * ENTRY * (size_t)walk_max;
}
template <typename T, int DMAX>
size_t dkv_smem(int walk_max) {
  constexpr int BQ = DMAX <= 64 ? 64 : 32;
  return sizeof(T) * (size_t)(2 * BM + 4 * BQ) * (DMAX + 8) +
         sizeof(float) * 4 * BQ + sizeof(int) * ENTRY * (size_t)walk_max;
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
    const size_t smem = fwd_smem<T, DMAX>(a.walk_max);
    auto fn = sparse_fwd_tc16_kernel<T, DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        q, k, v, a.mask, a.items, a.tiles, static_cast<T*>(a.out),
        a.lse_out, a.part, a.st, a.B, a.H, a.S, a.D, a.n_slots, a.scale,
        a.causal);
    if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 0)
      return err;
    sparse_fwd_combine16_kernel<T><<<(unsigned)a.n_split * (unsigned)a.B,
                                     NT, 0, stream>>>(
        a.part, a.splits, static_cast<T*>(a.out), a.lse_out, a.B, a.H, a.S,
        a.D, a.n_slots);
    return cudaGetLastError();
  }
  if (w == DQ) {
    const size_t smem = dq_smem<T, DMAX>(a.walk_max);
    auto fn = sparse_dq_tc16_kernel<T, DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        q, k, v, dout, a.mask, a.items, a.tiles, a.lse, a.delta,
        static_cast<T*>(a.dq), a.part, a.st, a.B, a.H, a.S, a.D, a.n_slots,
        a.scale, a.causal);
  } else {
    const size_t smem = dkv_smem<T, DMAX>(a.walk_max);
    auto fn = sparse_dkv_tc16_kernel<T, DMAX>;
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
  sparse_reduce16_kernel<T><<<(unsigned)a.n_split * (unsigned)a.B, NT, 0,
                              stream>>>(a.part, a.splits, out0, out1, a.B,
                                        a.H, a.S, a.D, a.n_slots, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which w, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64>(w, a, stream);
  return launch<T, 128>(w, a, stream);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (a.D < 8 || a.D > 128 || a.D % 8 != 0 || a.B < 1 || a.H < 1 ||
      a.block < SUB || a.block % SUB != 0 || a.block % BM == 0 ||
      a.S < a.block || a.S % a.block != 0 || a.n_items < 1 ||
      a.walk_max < 0 || a.walk_max % WARPS != 0 ||
      a.n_split < 0 || a.n_slots < 0 ||
      (long long)a.n_items * a.B > 0x7fffffffLL ||
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

// The arguments of sparse_attention_tc.cu's sparse_attention_tc_fwd with
// its 64-row work list replaced by dq's 16-row one (SparsePlan.work16; the
// forward walks the same blocks) and walk_max beside n_items, as below;
// part fp32, B * n_slots * 64 * (D + 2) floats (the pieces' o, then their
// rows' m and l; null when n_split is 0), splits int32 [n_split][7].
// Returns cudaGetLastError() after the launches (0 = launched).
int sparse_attention_tc16_fwd(const void* q, const void* k, const void* v,
                              const float* mask, const int* items,
                              const int* tiles, int n_items, int walk_max,
                              void* out, float* lse,
                              const long long* strides, int B, int H, int S,
                              int D, int block, float scale, int causal,
                              float* part, const int* splits, int n_split,
                              int n_slots, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.items = items;
  a.tiles = tiles; a.n_items = n_items; a.walk_max = walk_max;
  a.out = out; a.lse_out = lse; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(FWD, a, dtype, stream);
}

// The arguments of sparse_attention_tc.cu's sparse_attention_tc_bwd_dq
// and sparse_attention_tc_bwd_dkv, with its 64-row work list replaced by
// the 16-row one (SparsePlan.work16): items int32 [n_items][8], tiles
// int32 [entries][2], walk_max the longest walk's entries rounded up to a
// multiple of 4 (the shared memory a block keeps it in); part fp32
// [B][n_slots][outputs][64][D] (null when n_split is 0), splits int32
// [n_split][7]. dtype 1 (bfloat16) or 2 (float16), D a multiple of 8 in
// [8, 128], block a multiple of 16 and not of 64. Returns
// cudaGetLastError() after the launches (0 = launched).
int sparse_attention_tc16_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* mask,
                                 const int* items, const int* tiles,
                                 int n_items, int walk_max, const float* lse,
                                 const float* delta, void* dq,
                                 const long long* strides, int B, int H,
                                 int S, int D, int block, float scale,
                                 int causal, float* part, const int* splits,
                                 int n_split, int n_slots, int dtype,
                                 void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.items = items;
  a.tiles = tiles; a.n_items = n_items; a.walk_max = walk_max;
  a.lse = lse; a.delta = delta;
  a.dq = dq; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(DQ, a, dtype, stream);
}

int sparse_attention_tc16_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* mask, const int* items,
                                  const int* tiles, int n_items,
                                  int walk_max, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  const long long* strides, int B, int H,
                                  int S, int D, int block, float scale,
                                  int causal, float* part, const int* splits,
                                  int n_split, int n_slots, int dtype,
                                  void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.items = items;
  a.tiles = tiles; a.n_items = n_items; a.walk_max = walk_max;
  a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(DKV, a, dtype, stream);
}

const char* sparse_attention_tc16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Block-sparse attention forward, dq and dk/dv for float32 on Hopper's
// tensor cores (sm_90a), as 3xTF32: head_dim a multiple of 8 up to 128 and
// any layout block that is a multiple of 16.
//
// Replaces, for fp32, the three Pallas TPU kernels of deepspeed_tpu/ops/
// sparse_attention/sparse_attention.py: _sparse_kernel (the forward: o and
// a natural-log lse per row), _sparse_bwd_dq_kernel (dq) and
// _sparse_bwd_dkv_kernel (dk and dv). Each computes exactly the function
// that sparse_attention.cu's header states: masked pairs (outside the
// layout, above the causal diagonal, a dropped key) selected out; o =
// sum_j p_ij v_j / l_i and lse = m_i + log l_i over the visible pairs, o
// = 0 and lse = -1e30 for a row with no visible key; in the backward lse
// clamped at -5e29, so such a row gives 0; p = exp(s - lse) on visible
// pairs only, ds = p (dO.v - delta), dq = scale sum_j ds k_j, dk = sum_i
// ds (scale q_i), dv = sum_i p dO_i. sparse_attention.cu's FMA forward, dq
// and dk/dv are the first versions of these and run on no path.
//
// What bounds it on an H100: at the long-sequence training shape (B*H =
// 12, S = 16384, D = 64, fp32, BigBird block 256, causal: 5.8% of the
// causal square) the forward must move q, k, v, o and lse (202 MB, 0.060
// ms at 3.35 TB/s) and do 41.1 GFLOP of fp32-accurate products, 0.25 ms at
// the 165 TFLOP/s of three TF32 products each (495 / 3); dq must move q,
// k, v, dO, lse, delta and dq (253 MB, 0.076 ms) and do 61.6 GFLOP (0.37
// ms); dk/dv moves 304 MB (0.091 ms) and does 82.2 GFLOP (0.50 ms):
// operations bound all three. sparse_attention.cu's FMA kernels multiply
// at the FMA rate, fed by shared-memory loads, and walk each key block's
// whole transposed list in one thread block, so a global column's walk is
// their critical path.
//
// What the design does:
// - the products of flash_attention_tf32.cu (tf32_mma.cuh): every fp32
//   operand split into hi = tf32(x) and lo = tf32(x - hi) by two integer
//   operations, each product lo.hi + hi.lo + hi.hi on mma.sync.m16n8k8,
//   each k-step's three products into a fresh tile that an fp32 add folds
//   into the running sum (summed inside the mma, the tensor cores'
//   accumulation missed 1e-5); s = q.k^T, then o += p.v in the forward;
//   s = q.k^T and dp = dO.v^T, then dq += ds.k in dq; s^T = k.q^T and
//   dp^T = v.dO^T, then dv += p^T.dO and dk += ds^T.q in dk/dv, q unscaled
//   and the scale applied in the exponent and at the end. The forward's s
//   is dq's, bit for bit (the same splits, the same k-steps), so the lse
//   it saves and the p the backward recomputes come from the same fp32
//   scores. The accumulator fragment of the first products is the A
//   fragment of the second with no shuffle (mma_cols);
// - the walk of sparse_attention_tc16.cu: a work item (ops/
//   sparse_attention/sparse_attention.py, build_work16) is up to four
//   16-row blocks of one head (queries for the forward and dq, keys for
//   dk/dv), one per warp, packed by equal lists, and one walk over the
//   other axis' 16-row blocks, each entry with the bits of the warps that
//   list it; the forward walks dq's list. 16 rows divide every block the
//   kernels take, so one kernel covers the reference's default block 16
//   (sparse BERT) and BigBird's 256 (the long-sequence path). A block of
//   4 warps reads its item's walk into shared memory once and streams it
//   a few entries (16 rows each) a step, each 16-row block gathered from
//   its own address by cp.async into two stages (with the key mask, or
//   the lse and delta, at the gathered rows); a warp skips the products
//   of the entries it does not list. fp32 tiles take twice the shared
//   memory of 16-bit ones. dq and dk/dv keep two 64-row tiles resident
//   and stream one entry a step: 52 KB at D <= 64, four blocks an SM at
//   128 registers a thread and no spills. At the long-sequence shape that
//   measured dq / dk/dv 1.85 / 2.51 ms, against 1.87 / 2.79 at 2 entries
//   a step (70 KB, three blocks an SM) and 2.46 / 3.50 at 4 (two blocks,
//   spills) (tools/probe_sparse_tf32.py). The forward keeps q alone
//   resident and streams FEPS entries a step (2: 52 KB at D <= 64, four
//   blocks an SM; 1: 35 KB; 4: 87 KB, two). At D = 128 one backward block
//   an SM, two forward blocks;
// - the forward's online softmax runs on the accumulator fragments in
//   base 2 (s scaled by scale * log2 e in fp32), -inf-safe: a row that has
//   seen no visible key keeps m = -inf, l = 0 and p = 0, and a step that
//   shows it none leaves it as it was; a lane holds rows g and g + 8,
//   their max reduces over the quad's 4 lanes by shuffles, each lane sums
//   its own share of l (the quad's shares added once, at the end);
// - the causal mask is evaluated only on the entry whose block is the
//   warp's own (the lists hold no block wholly above the diagonal); the
//   key mask is read at each gathered row's real position;
// - a walk longer than the plan's cap (in 64-row steps) is cut into
//   pieces: a piece writes its warps' fp32 partials to scratch (dq, dk/dv:
//   [B][slots][outputs][64][D], warp w's rows at 16 w, summed by a second
//   kernel in piece order; the forward: the unnormalised o, then each
//   row's base-2 (m, l), combined by a second kernel in piece order). No
//   atomics: every output element is summed in a fixed order, so two
//   launches are bit-equal;
// - q, k and v are read through their [B, S, H, D] strides; o, dO, dq, dk
//   and dv are contiguous [B, S, H, D]; lse and delta fp32 [B * H, S].

#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "tf32_mma.cuh"

namespace {

using attn_tf32::a_rows;
using attn_tf32::mma3;
using attn_tf32::mma_cols;
using attn_tf32::split_tf32;
using attn_tf32::store_acc;
using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using attn_tile::row_max;
using attn_tile::row_sum;
using attn_tile::Strides;
using attn_tile::strides_of;

constexpr int NT = 128;      // threads: 4 warps
constexpr int WARPS = 4;
constexpr int SUB = 16;      // rows of a block one warp owns or one entry
                             // holds
constexpr int BM = WARPS * SUB;  // rows an item owns
constexpr int EPS = 1;       // walk entries a step of dq, dk/dv streams
constexpr int BS = EPS * SUB;    // rows of a streamed tile
constexpr int BLOCKS64 = 4;  // dq, dk/dv blocks an SM at D <= 64 (52 KB)
constexpr int FEPS = 2;      // walk entries a step of the forward streams
constexpr int FWD64 = 4;     // forward blocks an SM at D <= 64 (52 KB)
constexpr int FWD128 = 2;    // forward blocks an SM at D = 128 (100 KB)
static_assert(WARPS % FEPS == 0, "a walk padded to whole forward steps "
              "must fit walk_max, a multiple of 4 entries");
constexpr int ITEM = 8;      // ints per work item: head, the 4 warps' first
                             // rows (-1: none), offset and count of its
                             // walk, scratch slot of a piece (-1: not split)
constexpr int ENTRY = 2;     // ints per walk entry: first row, warp bits
constexpr int SPLIT = 7;     // ints per split item: head, 4 rows, first
                             // slot, pieces
constexpr unsigned FULL_LIVE = (1u << EPS) - 1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LSE_FLOOR = -5e29f;  // the clamp of an empty row's lse
constexpr float NEG_INF = -1e30f;    // the forward's lse of an empty row

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

// nb 16-row blocks of D floats into dst [nb * 16][DP] by cp.async, 16
// bytes at a time: block e from src + row_e * stride, row_e = rows[e *
// rstride]; a block whose row is negative is zeros
template <int DP>
__device__ __forceinline__ void load_blocks(float* dst, const float* src,
                                            long long stride,
                                            const int* rows, int rstride,
                                            int nb, int D) {
  const int cpr = D / 4;
  for (int idx = threadIdx.x; idx < nb * SUB * cpr; idx += NT) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * 4;
    const int row = rows[(r / SUB) * rstride];
    const bool ok = row >= 0;
    cp_async16(dst + r * DP + c,
               ok ? src + (long long)(row + r % SUB) * stride + c : src, ok);
  }
}

// acc[n] += A . B^T as tf32_mma.cuh's mma_rows, over the 16-row entries
// of the streamed tile (n-tiles 2e, 2e + 1) whose bit in `live` is set;
// the others are left as they are
template <int NN, int DP>
__device__ __forceinline__ void mma_rows_live(float (&acc)[NN][4],
                                              const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4],
                                              const float* B, int kc,
                                              unsigned live) {
  const int lane = threadIdx.x & 31;
  const int at = (lane >> 2) * DP + kc + (lane & 3);
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    if ((live >> (n >> 1)) & 1u) {
      uint32_t bh[2], bl[2];
      split_tf32(B[at + n * 8 * DP], bh[0], bl[0]);
      split_tf32(B[at + n * 8 * DP + 4], bh[1], bl[1]);
      mma3(acc[n], ah, al, bh, bl);
    }
  }
}

// the warp's accumulator tile [16][8 NO] times `mul` to rows g and g + 8
// of dst (the warp's first row; row stride `stride` floats); 8-byte
// stores
template <int NO>
__device__ __forceinline__ void store_rows(float* dst, long long stride,
                                           const float (&acc)[NO][4],
                                           float mul, int D) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n * 8 < D) {
      *reinterpret_cast<float2*>(dst + r * stride + 8 * n + c) =
          make_float2(acc[n][0] * mul, acc[n][1] * mul);
      *reinterpret_cast<float2*>(dst + (r + 8) * stride + 8 * n + c) =
          make_float2(acc[n][2] * mul, acc[n][3] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: grid (items * B), over dq's work list; warp w owns the 16
// queries at items[1 + w] and the block streams the item's walk, FEPS
// gathered key and value blocks a step, each warp running an online
// softmax over the entries its bit lists (a step it lists none of leaves
// its state as it was). A piece of a split walk leaves its warps'
// unnormalised o and their rows' base-2 (m, l) in scratch; an unsplit
// item writes o and lse.
// ---------------------------------------------------------------------------
template <int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? FWD64 : FWD128)
    sparse_fwd_tf32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ mask,
        const int* __restrict__ items, const int* __restrict__ tiles,
        float* __restrict__ out, float* __restrict__ lse,
        float* __restrict__ part, Strides st, int B, int H, int S, int D,
        int n_slots, float scale, int causal) {
  constexpr int FS = FEPS * SUB;    // keys a step
  constexpr int DP = DMAX + 4;      // row pitch (floats)
  constexpr int NO = DMAX / 8;      // output n-tiles
  constexpr int NS = FS / 8;        // score n-tiles
  constexpr unsigned ALL_LIVE = (1u << FEPS) - 1;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BM][DP]
  float* Ks = Qs + BM * DP;         // [2][FS][DP]
  float* Vs = Ks + 2 * FS * DP;     // [2][FS][DP]
  float* Ms = Vs + 2 * FS * DP;     // [2][FS] key mask
  int* Wk = reinterpret_cast<int*>(Ms + 2 * FS);  // the walk [][row, bits]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], rw = wi[1 + warp], cnt = wi[6], slot = wi[7];
  const int steps = (cnt + FEPS - 1) / FEPS;
  const long long orow = (long long)H * D;  // o row stride
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int i0 = rw + g;            // this lane's rows: i0 and i0 + 8

  // step n's entries into stage n & 1: the K and V blocks and the key
  // mask at their rows, all by cp.async
  auto load_kv = [&](int n) {
    const int s = n & 1;
    const int* ent = Wk + ENTRY * FEPS * n;
    load_blocks<DP>(Ks + s * FS * DP, kb, st.ks, ent, ENTRY, FEPS, D);
    load_blocks<DP>(Vs + s * FS * DP, vb, st.vs, ent, ENTRY, FEPS, D);
    if (mb && threadIdx.x < FS) {
      const int row = ent[ENTRY * (threadIdx.x / SUB)];
      cp_async4(Ms + s * FS + threadIdx.x,
                row >= 0 ? mb + row + threadIdx.x % SUB : mb, row >= 0);
    }
  };
  load_blocks<DP>(Qs, q + b * st.qb + h * st.qh, st.qs, wi + 1, 1, WARPS, D);
  load_walk(Wk, tiles + ENTRY * wi[5], cnt, steps * FEPS);
  __syncthreads();
  if (steps > 0) load_kv(0);
  cp_async_commit();

  const float* Qw = Qs + warp * SUB * DP;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (base 2) of rows i0, i0 + 8, and this lane's share of l
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < steps; ++n) {
    if (n + 1 < steps) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + (n & 1) * FS * DP;
    const float* Vt = Vs + (n & 1) * FS * DP;
    const float* Mt = Ms + (n & 1) * FS;
    const int* Wt = Wk + ENTRY * FEPS * n;
    unsigned live = 0;  // the step's entries this warp lists
#pragma unroll
    for (int e = 0; e < FEPS; ++e)
      live |= ((unsigned)(Wt[ENTRY * e + 1] >> warp) & 1u) << e;

    // the step's products over the entries in lv, in two unrolled copies:
    // one where the warp lists all of them (lv a constant, so no branch
    // separates the products), one for the rest
#pragma unroll
    for (int variant = 0; variant < 2; ++variant) {
      if (variant == 0 ? live != ALL_LIVE : live == ALL_LIVE || !live)
        continue;
      const unsigned lv = variant == 0 ? ALL_LIVE : live;
      // s = q.k^T over the listed entries, as the dq kernel computes it
      float s[NS][4];
#pragma unroll
      for (int c = 0; c < NS; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DMAX; kc += 8) {
        if (kc < D) {
          uint32_t ah[4], al[4];
          a_rows<DP>(Qw, kc, ah, al);
          mma_rows_live<NS, DP>(s, ah, al, Kt, kc, lv);
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
      // the online softmax, -inf-safe: a step that shows a row no key
      // leaves it as it was (alpha 1); the first step that does starts it
      // (alpha 0 on the empty o)
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
      // o += p.v over the listed entries' k-steps, p split in registers
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
        if ((lv >> (kk >> 1)) & 1u) mma_cols<NO, NS, DP>(acc, s, kk, Vt, D);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // an empty walk never waited for the q tile
  __syncthreads();
  l0 = row_sum<4>(l0);
  l1 = row_sum<4>(l1);

  if (slot >= 0) {     // a piece of a split walk: fp32 partials
    const long long at = (long long)b * n_slots + slot;
    store_acc<NO>(part + at * BM * D, D, acc, 1.f, BM, D);
    if (t == 0) {
      float* ml = part + (long long)B * n_slots * BM * D + at * BM * 2;
      const int r0 = warp * SUB + g;
      ml[2 * r0] = m0;
      ml[2 * r0 + 1] = l0;
      ml[2 * (r0 + 8)] = m1;
      ml[2 * (r0 + 8) + 1] = l1;
    }
    return;
  }
  if (rw < 0) return;
  // o = acc / l, lse = m ln 2 + ln l; a row that saw no key writes o = 0
  // and lse = -1e30
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    acc[c][0] = l0 > 0.f ? acc[c][0] / l0 : 0.f;
    acc[c][1] = l0 > 0.f ? acc[c][1] / l0 : 0.f;
    acc[c][2] = l1 > 0.f ? acc[c][2] / l1 : 0.f;
    acc[c][3] = l1 > 0.f ? acc[c][3] / l1 : 0.f;
  }
  store_rows<NO>(out + ((long long)b * S + rw) * orow + (long long)h * D,
                 orow, acc, 1.f, D);
  if (t == 0) {
    const long long at = ((long long)b * H + h) * S;
    lse[at + i0] = l0 > 0.f ? m0 * LN2 + logf(l0) : NEG_INF;
    lse[at + i0 + 8] = l1 > 0.f ? m1 * LN2 + logf(l1) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// the forward's second pass: grid (split items * B). Each row's pieces are
// combined in piece order: M = max m_p, L = sum 2^(m_p - M) l_p, o = sum
// 2^(m_p - M) o_p / L, lse = M ln 2 + ln L (o = 0 and lse = -1e30 where no
// piece saw a key); warp w's rows written to rows sp[1 + w] ...
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) sparse_fwd_combine_tf32_kernel(
    const float* __restrict__ part, const int* __restrict__ splits,
    float* __restrict__ out, float* __restrict__ lse, int B, int H, int S,
    int D, int n_slots) {
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
  float* dst = out + (long long)b * S * orow + (long long)h * D;
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
    const float l = Li[r];
    *reinterpret_cast<float4*>(dst + (long long)(row + r % SUB) * orow + c) =
        l > 0.f ? make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (items * B); warp w owns the 16 queries at items[1 + w] and the
// block streams the item's walk, one gathered key block a step
// ---------------------------------------------------------------------------
template <int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? BLOCKS64 : 1)
    sparse_dq_tf32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ mask, const int* __restrict__ items,
        const int* __restrict__ tiles, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dq_out,
        float* __restrict__ part, Strides st, int B, int H, int S, int D,
        int n_slots, float scale, int causal) {
  constexpr int DP = DMAX + 4;      // row pitch (floats)
  constexpr int NO = DMAX / 8;      // output n-tiles
  constexpr int NS = BS / 8;        // score n-tiles
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BM][DP]
  float* Os = Qs + BM * DP;         // [BM][DP] dO
  float* Ks = Os + BM * DP;         // [2][BS][DP]
  float* Vs = Ks + 2 * BS * DP;     // [2][BS][DP]
  float* Ms = Vs + 2 * BS * DP;     // [2][BS] key mask
  int* Wk = reinterpret_cast<int*>(Ms + 2 * BS);  // the walk [][row, bits]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], rw = wi[1 + warp], cnt = wi[6], slot = wi[7];
  const int steps = (cnt + EPS - 1) / EPS;
  const int bh = b * H + h;
  const long long orow = (long long)H * D;  // dO / dq row stride
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const float sl = scale * LOG2E;   // s in base-2 units
  const int i0 = rw + g;            // this lane's rows: i0 and i0 + 8
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
    load_blocks<DP>(Ks + s * BS * DP, kb, st.ks, ent, ENTRY, EPS, D);
    load_blocks<DP>(Vs + s * BS * DP, vb, st.vs, ent, ENTRY, EPS, D);
    if (mb && threadIdx.x < BS) {
      const int row = ent[ENTRY * (threadIdx.x / SUB)];
      cp_async4(Ms + s * BS + threadIdx.x,
                row >= 0 ? mb + row + threadIdx.x % SUB : mb, row >= 0);
    }
  };
  load_blocks<DP>(Qs, q + b * st.qb + h * st.qh, st.qs, wi + 1, 1, WARPS, D);
  load_blocks<DP>(Os, dout + (long long)b * S * orow + (long long)h * D, orow,
                  wi + 1, 1, WARPS, D);
  load_walk(Wk, tiles + ENTRY * wi[5], cnt, steps * EPS);
  __syncthreads();
  if (steps > 0) load_kv(0);
  cp_async_commit();

  const float* Qw = Qs + warp * SUB * DP;
  const float* Ow = Os + warp * SUB * DP;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int n = 0; n < steps; ++n) {
    if (n + 1 < steps) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + (n & 1) * BS * DP;
    const float* Vt = Vs + (n & 1) * BS * DP;
    const float* Mt = Ms + (n & 1) * BS;
    const int* Wt = Wk + ENTRY * EPS * n;
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
      for (int kc = 0; kc < DMAX; kc += 8) {
        if (kc < D) {
          uint32_t ah[4], al[4];
          a_rows<DP>(Qw, kc, ah, al);
          mma_rows_live<NS, DP>(s, ah, al, Kt, kc, lv);
          a_rows<DP>(Ow, kc, ah, al);
          mma_rows_live<NS, DP>(dp, ah, al, Vt, kc, lv);
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
      // dq += ds.k over the listed entries' k-steps
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
        if ((lv >> (kk >> 1)) & 1u) mma_cols<NO, NS, DP>(acc, dp, kk, Kt, D);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();  // an empty walk never waited for the q and dO tiles
  __syncthreads();

  if (slot >= 0) {     // a piece of a split walk: fp32 partial sums
    store_acc<NO>(part + ((long long)b * n_slots + slot) * BM * D, D, acc,
                  1.f, BM, D);
  } else if (rw >= 0) {
    store_rows<NO>(dq_out + ((long long)b * S + rw) * orow + (long long)h * D,
                   orow, acc, scale, D);
  }
}

// ---------------------------------------------------------------------------
// dk and dv: grid (items * B); warp w owns the 16 keys at items[1 + w] and
// the block streams the item's walk, one gathered query block a step with
// their dO, lse and delta
// ---------------------------------------------------------------------------
template <int DMAX>
__global__ void __launch_bounds__(NT, DMAX <= 64 ? BLOCKS64 : 1)
    sparse_dkv_tf32_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ mask, const int* __restrict__ items,
        const int* __restrict__ tiles, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dk_out,
        float* __restrict__ dv_out, float* __restrict__ part, Strides st,
        int B, int H, int S, int D, int n_slots, float scale, int causal) {
  constexpr int DP = DMAX + 4;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BS / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [BM][DP]
  float* Vs = Ks + BM * DP;         // [BM][DP]
  float* Qs = Vs + BM * DP;         // [2][BS][DP]
  float* Os = Qs + 2 * BS * DP;     // [2][BS][DP] dO
  float* Ls = Os + 2 * BS * DP;     // [2][BS] lse
  float* Es = Ls + 2 * BS;          // [2][BS] delta
  int* Wk = reinterpret_cast<int*>(Es + 2 * BS);  // the walk [][row, bits]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / B;
  const int b = blockIdx.x - item * B;
  const int* wi = items + ITEM * item;
  const int h = wi[0], rw = wi[1 + warp], cnt = wi[6], slot = wi[7];
  const int steps = (cnt + EPS - 1) / EPS;
  const int bh = b * H + h;
  const long long orow = (long long)H * D;  // dO / dk / dv row stride
  const float* qb = q + b * st.qb + h * st.qh;
  const float* ob = dout + (long long)b * S * orow + (long long)h * D;
  const float* lb = lse + (long long)bh * S;
  const float* eb = delta + (long long)bh * S;
  const float sl = scale * LOG2E;
  const int j0 = rw + g;            // this lane's keys: j0 and j0 + 8
  const bool kept0 = rw >= 0 && (!mask || mask[(long long)b * S + j0] > 0.f);
  const bool kept1 =
      rw >= 0 && (!mask || mask[(long long)b * S + j0 + 8] > 0.f);

  // step n's entries into stage n & 1: the q and dO blocks and the lse
  // and delta at their rows, all by cp.async
  auto load_q = [&](int n) {
    const int s = n & 1;
    const int* ent = Wk + ENTRY * EPS * n;
    load_blocks<DP>(Qs + s * BS * DP, qb, st.qs, ent, ENTRY, EPS, D);
    load_blocks<DP>(Os + s * BS * DP, ob, orow, ent, ENTRY, EPS, D);
    if (threadIdx.x < BS) {
      const int row = ent[ENTRY * (threadIdx.x / SUB)];
      const int i = row + threadIdx.x % SUB;
      cp_async4(Ls + s * BS + threadIdx.x, row >= 0 ? lb + i : lb, row >= 0);
      cp_async4(Es + s * BS + threadIdx.x, row >= 0 ? eb + i : eb, row >= 0);
    }
  };
  load_blocks<DP>(Ks, k + b * st.kb + h * st.kh, st.ks, wi + 1, 1, WARPS, D);
  load_blocks<DP>(Vs, v + b * st.vb + h * st.vh, st.vs, wi + 1, 1, WARPS, D);
  load_walk(Wk, tiles + ENTRY * wi[5], cnt, steps * EPS);
  __syncthreads();
  if (steps > 0) load_q(0);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float* Kw = Ks + warp * SUB * DP;
  const float* Vw = Vs + warp * SUB * DP;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s_ = it & 1;
    const float* Qt = Qs + s_ * BS * DP;
    const float* Ot = Os + s_ * BS * DP;
    const float* Lt = Ls + s_ * BS;
    const float* Et = Es + s_ * BS;
    const int* Wt = Wk + ENTRY * EPS * it;
    unsigned live = 0;  // the step's entries this warp lists
#pragma unroll
    for (int e = 0; e < EPS; ++e)
      live |= ((unsigned)(Wt[ENTRY * e + 1] >> warp) & 1u) << e;

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
      for (int kc = 0; kc < DMAX; kc += 8) {
        if (kc < D) {
          uint32_t ah[4], al[4];
          a_rows<DP>(Kw, kc, ah, al);
          mma_rows_live<NS, DP>(s, ah, al, Qt, kc, lv);
          a_rows<DP>(Vw, kc, ah, al);
          mma_rows_live<NS, DP>(dp, ah, al, Ot, kc, lv);
        }
      }
      // p^T = exp(s - lse_i) on visible pairs; ds^T = p^T (dp^T -
      // delta_i). The row is the key j, the column the query i; only the
      // entry whose block is the warp's own crosses the causal edge.
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
      // dv += p^T.dO and dk += ds^T.q over the listed entries' k-steps
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        if ((lv >> (kk >> 1)) & 1u) {
          mma_cols<NO, NS, DP>(dva, s, kk, Ot, D);
          mma_cols<NO, NS, DP>(dka, dp, kk, Qt, D);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // an empty walk never waited for the k and v tiles
  __syncthreads();

  if (slot >= 0) {     // a piece of a split walk: fp32 partial sums
    float* dst = part + ((long long)b * n_slots + slot) * 2 * BM * D;
    store_acc<NO>(dst, D, dka, 1.f, BM, D);
    store_acc<NO>(dst + BM * D, D, dva, 1.f, BM, D);
  } else if (rw >= 0) {
    const long long off = ((long long)b * S + rw) * orow + (long long)h * D;
    store_rows<NO>(dk_out + off, orow, dka, scale, D);
    store_rows<NO>(dv_out + off, orow, dva, 1.f, D);
  }
}

// ---------------------------------------------------------------------------
// the second pass: grid (split items * B). Each split item's pieces are
// summed in piece order, the first output times scale0, warp w's rows
// written to rows sp[1 + w] ... `out1` is null for dq (one output), dv
// for dk/dv.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) sparse_reduce_tf32_kernel(
    const float* __restrict__ part, const int* __restrict__ splits,
    float* __restrict__ out0, float* __restrict__ out1, int B, int H, int S,
    int D, int n_slots, float scale0) {
  const int nout = out1 ? 2 : 1;
  const int tile = blockIdx.x / B;
  const int b = blockIdx.x - tile * B;
  const int* sp = splits + SPLIT * tile;
  const int h = sp[0], first = sp[5], pieces = sp[6];
  const long long orow = (long long)H * D;
  const int per_row = D / 4;
  for (int o = 0; o < nout; ++o) {
    float* dst = (o == 0 ? out0 : out1) + (long long)b * S * orow +
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
      *reinterpret_cast<float4*>(dst + (long long)(row + r % SUB) * orow +
                                 c) =
          make_float4(acc.x * mul, acc.y * mul, acc.z * mul, acc.w * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { FWD = 0, DQ = 1, DKV = 2 };

struct Args {
  const float *q, *k, *v, *dout;
  const float *mask, *lse, *delta;
  const int *items, *tiles, *splits;
  int n_items, walk_max, n_split, n_slots;
  float *out, *lse_out, *dq, *dk, *dv;
  float* part;
  Strides st;
  int B, H, S, D, block;
  float scale;
  int causal;
};

// shared bytes: the resident 64-row tiles (the forward: q; dq: q, dO;
// dk/dv: k, v), two stages of two streamed tiles (the forward: k and v of
// FEPS entries; dq, dk/dv: of one), the streamed rows' floats (the
// forward and dq: the key mask; dk/dv: lse and delta), then the walk of
// up to walk_max entries
template <int DMAX>
size_t smem_bytes(Which w, int walk_max) {
  const size_t rows = w == FWD ? FEPS * SUB : BS;
  return sizeof(float) * ((size_t)((w == FWD ? 1 : 2) * BM + 4 * rows) *
                              (DMAX + 4) +
                          (w == DKV ? 4 : 2) * rows) +
         sizeof(int) * ENTRY * (size_t)walk_max;
}

template <typename Fn>
cudaError_t set_smem(Fn fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DMAX>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)a.n_items * (unsigned)a.B;
  const size_t smem = smem_bytes<DMAX>(w, a.walk_max);
  cudaError_t err;
  if (w == FWD) {
    auto fn = sparse_fwd_tf32_kernel<DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        a.q, a.k, a.v, a.mask, a.items, a.tiles, a.out, a.lse_out, a.part,
        a.st, a.B, a.H, a.S, a.D, a.n_slots, a.scale, a.causal);
    if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 0)
      return err;
    sparse_fwd_combine_tf32_kernel<<<(unsigned)a.n_split * (unsigned)a.B,
                                     NT, 0, stream>>>(
        a.part, a.splits, a.out, a.lse_out, a.B, a.H, a.S, a.D, a.n_slots);
    return cudaGetLastError();
  }
  if (w == DQ) {
    auto fn = sparse_dq_tf32_kernel<DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.mask, a.items, a.tiles, a.lse, a.delta,
        a.dq, a.part, a.st, a.B, a.H, a.S, a.D, a.n_slots, a.scale,
        a.causal);
  } else {
    auto fn = sparse_dkv_tf32_kernel<DMAX>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<grid, NT, smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.mask, a.items, a.tiles, a.lse, a.delta,
        a.dk, a.dv, a.part, a.st, a.B, a.H, a.S, a.D, a.n_slots, a.scale,
        a.causal);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || a.n_split == 0)
    return err;
  sparse_reduce_tf32_kernel<<<(unsigned)a.n_split * (unsigned)a.B, NT, 0,
                              stream>>>(
      a.part, a.splits, w == DQ ? a.dq : a.dk, w == DQ ? nullptr : a.dv,
      a.B, a.H, a.S, a.D, a.n_slots, a.scale);
  return cudaGetLastError();
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (dtype != 0 || a.D < 8 || a.D > 128 || a.D % 8 != 0 || a.B < 1 ||
      a.H < 1 || a.block < SUB || a.block % SUB != 0 || a.S < a.block ||
      a.S % a.block != 0 || a.n_items < 1 || a.walk_max < 0 ||
      a.walk_max % WARPS != 0 || a.n_split < 0 || a.n_slots < 0 ||
      (long long)a.n_items * a.B > 0x7fffffffLL ||
      (long long)a.n_split * a.B > 0x7fffffffLL ||
      (a.n_split > 0 && (!a.part || !a.splits || a.n_slots < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(a.D <= 64 ? launch<64>(w, a, st) : launch<128>(w, a, st));
}

}  // namespace

extern "C" {

// The arguments of sparse_attention_tc16.cu's sparse_attention_tc16_fwd
// (the 16-row work list of SparsePlan.work16 that dq walks: items int32
// [n_items][8], tiles int32 [entries][2], walk_max the longest walk's
// entries rounded up to a multiple of 4; part fp32, B * n_slots * 64 * (D
// + 2) floats, the pieces' o, then their rows' m and l, null when n_split
// is 0; splits int32 [n_split][7]), with dtype 0 (float32), D a multiple
// of 8 in [8, 128] and block any multiple of 16. out is contiguous [B, S,
// H, D], lse fp32 [B * H, S]. Returns cudaGetLastError() after the
// launches (0 = launched).
int sparse_attention_tf32_fwd(const void* q, const void* k, const void* v,
                              const float* mask, const int* items,
                              const int* tiles, int n_items, int walk_max,
                              void* out, float* lse,
                              const long long* strides, int B, int H, int S,
                              int D, int block, float scale, int causal,
                              float* part, const int* splits, int n_split,
                              int n_slots, int dtype, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v); a.mask = mask;
  a.items = items; a.tiles = tiles; a.n_items = n_items;
  a.walk_max = walk_max; a.out = static_cast<float*>(out); a.lse_out = lse;
  a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(FWD, a, dtype, stream);
}

// The arguments of sparse_attention_tc16.cu's sparse_attention_tc16_bwd_dq
// and sparse_attention_tc16_bwd_dkv (the 16-row work list of
// SparsePlan.work16: items int32 [n_items][8], tiles int32 [entries][2],
// walk_max the longest walk's entries rounded up to a multiple of 4; part
// fp32 [B][n_slots][outputs][64][D], null when n_split is 0; splits int32
// [n_split][7]), with dtype 0 (float32), D a multiple of 8 in [8, 128]
// and block any multiple of 16. Returns cudaGetLastError() after the
// launches (0 = launched).
int sparse_attention_tf32_bwd_dq(const void* q, const void* k, const void* v,
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
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout); a.mask = mask;
  a.items = items; a.tiles = tiles; a.n_items = n_items;
  a.walk_max = walk_max; a.lse = lse; a.delta = delta;
  a.dq = static_cast<float*>(dq); a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(DQ, a, dtype, stream);
}

int sparse_attention_tf32_bwd_dkv(const void* q, const void* k,
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
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout); a.mask = mask;
  a.items = items; a.tiles = tiles; a.n_items = n_items;
  a.walk_max = walk_max; a.lse = lse; a.delta = delta;
  a.dk = static_cast<float*>(dk); a.dv = static_cast<float*>(dv);
  a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal; a.part = part; a.splits = splits; a.n_split = n_split;
  a.n_slots = n_slots;
  return run(DKV, a, dtype, stream);
}

const char* sparse_attention_tf32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

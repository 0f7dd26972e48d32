// Ragged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/transformer/
// chunked_prefill.py:chunked_prefill_attention_kernel. It computes the
// same function: each token t of a flat ragged batch q [T, H, D] (decode
// tokens, prompt chunks and pad tokens of one serving step) attends over
// the K/V pools [N, BS, H, D] through its own table row [T, WB]; key j is
// visible to token t iff j <= pos[t]; the softmax runs online in fp32 and
// the output [T, H, D] is written in q's dtype as acc / max(l, 1e-30).
// The pools are in q's dtype, or int8 with fp32 scales [N, BS, H]
// dequantized in fp32 as each key is read.
//
// What bounds it on an H100: device-memory bytes, as for the paged decode
// kernel (~4 flops per K/V element read). What the step must read is each
// distinct K/V block that some token can see, once. The TPU grid
// (T, H, WB) streams each block once per token; a prompt chunk of c tokens
// would read its prefix c times.
//
// Two routes run here, picked by ops/transformer/chunked_prefill.py
// (_route), over every head dim the paged decode kernel takes (a
// multiple of 8 up to 256); the first kernel is on neither:
//
// 1. bf16 q over bf16 or int8 pools: runs of one sequence
//    (chunked_prefill_tc_fwd). The host finds the step's runs
//    once (chunked_runs; the serving engine once per mixed step, shared by
//    the layers): consecutive tokens with one table row at consecutive
//    (or, for pad tokens, equal) positions. It hands the kernels a compact
//    list, longest walk first:
//    - a run of two or more tokens is cut into items of up to 64 tokens
//      (chunked_tc_kernel). A block of 4 warps owns an item's queries, 16
//      rows a warp, for one head, and streams the keys 0 .. the item's last
//      position in 64-key tiles through two cp.async stages, each K/V row
//      gathered through the table row: the flash forward's tile of
//      attention_tc.cuh (mma.sync.m16n8k16 with fp32 sums, the scale
//      applied to s in fp32 in base 2, the online softmax on the
//      accumulator fragment, p split into two 16-bit terms for p.V). Each
//      query row's own position bounds what it sees; the mask is evaluated
//      only on tiles past the item's first position, and the walk stops
//      after its last. K/V rows past the last visible key are zero-filled
//      (cp.async with src-size 0), never read: 0 x NaN in p.V would be NaN
//      on the tensor cores, and a table's tail points at the scratch
//      block. An int8 pool's codes are exact in bf16 (|code| <= 128): they
//      are copied as they are and widened in shared memory, and their fp32
//      scales multiply in fp32, k_scale into s and v_scale into p before
//      its split (a key past the last visible one has scale 0);
//    - a run of one token (a decode row) is the one-query walk of
//      paged_walk.cuh (walk_keys, NQ = 1) with its keys split over the
//      `splits` blocks of a thread-block cluster and combined through
//      distributed shared memory (finish_cluster): kernel #1's design
//      (chunked_decode_kernel). The host picks `splits` by kernel #1's
//      rule, measured on the H100 (paged_attention.py:
//      paged_decode_splits).
//    At most two launches a call: the decode items' kernel on a second
//    stream forked from the caller's and joined back to it, beside the
//    chunk items' kernel, so the two overlap. Every output element is
//    summed by one thread in a fixed order, with no atomics; pad tokens
//    write only their own rows.
//    At head dims in (128, 256] the chunk items run chunked_tc256_kernel
//    (below), the decode items the same walk at TPKP = 32.
// 2. fp32 q over fp32 or int8 pools: the same run list, fork and join
//    (chunked_prefill_tf32_fwd). Decode
//    items run chunked_decode_kernel<float, P>, kernel #1's fp32 walk.
//    Chunk items run chunked_tf32_kernel: chunked_tc_kernel's structure
//    (an item's 64 query rows, 16 a row group, one head a block; 64-key
//    tiles gathered through the table row by cp.async into two stages
//    with the table entries staged once; keys past the last visible one
//    and their scales zero-filled; the mask only on edge tiles; the
//    online softmax in base 2 on the fragments; o = acc / max(l, 1e-30)
//    stored from the fragments, pad rows their own) with fp32 tiles DMAX
//    + 4 floats apart, 8 warps (two on each row group, each on half of
//    every tile's keys with its own online softmax; the halves' (m, l, o)
//    combined at the end, half 0's first) and the products of
//    tf32_mma.cuh: each fp32 operand of s = q.k^T and
//    o = p.v split into hi = tf32(x) and lo = tf32(x - hi), each product
//    lo.hi + hi.lo + hi.hi on mma.sync.m16n8k8 into a fresh tile that an
//    fp32 add folds into the running sum (the tensor cores' fp32
//    accumulation drops low bits of the larger addend). An int8 pool's
//    codes (|code| <= 128) are exact in TF32, so their lo part is 0: the
//    codes stay int8 in shared memory (rows DMAX + 8 bytes apart), become
//    B fragments as they are read, and each product is two, lo.c then
//    hi.c (s = q.c, times k_scale in fp32; o += p.c with v_scale in p
//    before its split). q's hi/lo fragments are split from shared memory
//    at every tile. Shared memory: the q tile and two K/V stages, 87 KB
//    at DMAX = 64, 169 KB at 128; int8 36 / 70 KB. At the T = 256 mixed
//    step (60 blocks on 132 SMs, so one an SM) tools/probe_chunked_tf32.py
//    timed the chunk items at 0.042 ms with one warp a row group and
//    0.028 with two, 0.014 without the products: the products' dependent
//    chains, not bytes, set the time. 32-key tiles, a third stage, q's
//    fragments in registers and 32-row items measured within -1% .. +7%.
//    What bounds it: bytes. At the T = 256 mixed step (8 decode rows to
//    position 1,000, 200- and 40-token chunks, H = 12, D = 64) the call
//    must read 31 MB (0.0093 ms at 3.35 TB/s) and do 82 MFLOP, 0.0005 ms
//    at the 165 TFLOP/s of three TF32 products each. What the design does
//    about the first kernel's four faults (below): it walks runs, not
//    tokens (a block per item and head, no idle blocks); a chunk item's
//    prefix is read once per 64 tokens, not once per 8; the products run
//    on the tensor cores; and a decode row's keys are split over a
//    cluster, so the 1,000-key row no longer sets the time alone. At head
//    dims in (128, 256] the chunk items run chunked_tf32w_kernel (below).
//
// Head dims in (128, 256]. At D = 256 the bound is still bytes: the T =
// 256 mixed step must read 62 MB in bf16 (0.0185 ms), 124 MB in fp32,
// nearly all of it the decode rows' keys. chunked_tc_kernel does not
// widen: 16 rows a warp with the o accumulator in registers is 128 fp32
// registers a thread at D = 256 before s, p or an address
// (flash_attention_tc256.cu says the same of its own kernels), and
// chunked_tf32_kernel's q tile and two 64-key fp32 stages would need 330
// KB. So:
// - bf16 (chunked_tc256_kernel): a 64-token chunk item is one wgmma M of
//   64 rows, so one warpgroup owns it, as flash_attention_tc256.cu's
//   forward owns 64 queries: s = q.k^T on m64n64k16 from shared memory,
//   o += p.v on m64n256k16 with p split into two bf16 terms in registers
//   and V read MN-major, the fp32 o accumulator in 128 registers a
//   thread. q and the K/V rows go by cp.async into wgmma_tile.cuh's
//   128-byte-swizzled tiles (gathering a row through the table changes
//   only its source address; TMA takes boxes, not gathers). The q tile
//   and two 64-key K/V stages are 160 KB; int8 pools stage their codes
//   in two stages and widen them into one bf16 stage. The online softmax
//   is chunked_tc_kernel's, on the s accumulator;
// - fp32 (chunked_tf32w_kernel): flash_attention_tf32.cu's D = 256
//   forward: two warps on each 16 query rows, each summing s over half of
//   the head dim (3xTF32) and owning those 128 columns of o; the pair adds
//   its partial s through shared memory (add_pair: own + other's, the
//   same bits in both), so both run one online softmax. 32-key tiles in
//   two stages: 212 KB with the q tile;
// - decode items: the walk of route 1 at TPKP = 32 (kernel #1's D = 256
//   instantiation), 16 keys a tile; chunked_decode_splits counts keys
//   and blocks in units of D = 64, so the pick follows the 4x work a key.
// At the T = 256 mixed step, D = 256 (chip_smoke.py, H100 80GB HBM3 at
// 700 W, device time) the run kernels take 0.066 ms in bf16 and 0.112 in fp32,
// against the first kernel's 0.255 and 0.260 on the same inputs: the
// chunk items alone 0.038 and 0.082, the decode items at 8 splits 0.035
// and 0.048. A wgmma chunk item walks its tiles in series on one
// warpgroup, so a block is latency-bound on its ~4 tiles.
// Each keeps the arithmetic of its D <= 128 kernel, so one model of each
// holds both widths against the JAX kernel in the CPU tests.
//
// The first design (chunked_prefill_attention_fwd, chunked_prefill_kernel
// below), on no route since the run kernels took head dims above 128, is
// kept as their first version on the same inputs: consecutive tokens of one
// prompt chunk share their table row and sit at consecutive positions. A
// thread block takes such a run of up to MAX_S = 8 tokens together (the
// shared walk of paged_walk.cuh, the paged decode kernel's), so each K/V
// row is read once per 8 chunk tokens instead of once per token; a decode
// token is a run of one. The grid is (H, T); the block of token t first
// decides whether t leads a run: t continues t - 1 when pos[t] ==
// pos[t-1] + 1 and their table rows are equal, and a run is cut at every
// position that is a multiple of MAX_S, so each token can find its run's
// leader without a scan. Blocks of the other tokens of a run return at
// once. Every (t, h) output element is written by one thread, summed in a
// fixed order, with no atomics. Pad tokens (an all-scratch row at
// position 0) are runs of one that read scratch block 0 and write only
// their own rows. No tensor cores, and the key walk of a long decode row
// is not split across blocks.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_tc.cuh"
#include "paged_walk.cuh"
#include "tf32_mma.cuh"
#include "wgmma.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace paged;

// grid: (H, T); block: THREADS.
template <typename T, typename P, int TPKP>
__global__ void __launch_bounds__(THREADS) chunked_prefill_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ pos, T* __restrict__ out, int NT, int H, int D,
    int BS, int WB, float scale) {
  const int h = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  __shared__ int s_pos[MAX_S + 1];  // s_pos[i + 1] = pos[t + i]
  __shared__ int s_diff[MAX_S];     // rows of t + i and t + i - 1 differ
  __shared__ int s_ns;              // run length led by t (0: not a leader)

  if (tid <= MAX_S) {
    const int u = t - 1 + tid;
    s_pos[tid] = (u >= 0 && u < NT) ? pos[u] : -MAX_S;
  }
  if (tid < MAX_S) s_diff[tid] = 0;
  __syncthreads();
  // Compare the table rows of each consecutive-position pair.
  for (int idx = tid; idx < MAX_S * WB; idx += THREADS) {
    const int i = idx / WB;
    const int j = idx - i * WB;
    const int u = t + i;
    if (u >= 1 && u < NT && s_pos[i + 1] == s_pos[i] + 1 &&
        table[(long)u * WB + j] != table[(long)(u - 1) * WB + j])
      s_diff[i] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    // token t + i continues token t + i - 1
    auto cont = [&](int i) {
      const int u = t + i;
      return u >= 1 && u < NT && s_pos[i + 1] == s_pos[i] + 1 &&
             !s_diff[i];
    };
    int ns = 0;
    if (!cont(0) || s_pos[1] % MAX_S == 0) {
      ns = 1;
      while (ns < MAX_S && cont(ns) && s_pos[ns + 1] % MAX_S != 0) ++ns;
    }
    s_ns = ns;
  }
  __syncthreads();
  const int ns = s_ns;
  if (ns == 0) return;  // t belongs to an earlier token's run

  const long first = (long)t * H * D + (long)h * D;
  attend_run<T, P, TPKP>(q + first, out + first, k_pool, v_pool, k_scale,
                         v_scale, table + (long)t * WB, WB, s_pos[1], ns, H,
                         D, BS, h, scale);
}

// 4 and 8 bytes from global to shared memory, asynchronously; with
// !valid they are zeros and nothing is read
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 8 : 0));
}

// The chunk kernel's shared memory (bytes) for pools of P: the q tile and
// the K/V tiles in bf16 (two stages; one for int8, whose two stages hold
// the codes as read, with their scales, and are widened to bf16 tile by
// tile: |code| <= 128 is exact in bf16).
template <typename P, int DMAX>
constexpr size_t chunk_smem() {
  constexpr int BN = 64, DP = DMAX + 8;
  constexpr bool INT8 = sizeof(P) == 1;
  return sizeof(__nv_bfloat16) * (size_t)(attn_tc::BM + 2 * (INT8 ? 1 : 2) *
                                          BN) * DP +
         (INT8 ? (size_t)2 * 2 * BN * (DMAX + sizeof(float)) : 0);
}

// ---------------------------------------------------------------------------
// route 1, runs of two or more tokens: grid (items * H); block
// attn_tc::NT. items int32 [n][4]: first token, tokens (<= 64), keys (the
// item's last position + 1), 0. Pools of bf16, or of int8 codes whose
// fp32 scales multiply s (k_scale) and p before its split (v_scale).
// ---------------------------------------------------------------------------
template <typename P, int DMAX>
__global__ void __launch_bounds__(attn_tc::NT, DMAX <= 64 ? 4 : 1)
    chunked_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const P* __restrict__ k_pool,
                      const P* __restrict__ v_pool,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ table,
                      const int* __restrict__ pos,
                      const int* __restrict__ items,
                      __nv_bfloat16* __restrict__ out, int H, int D, int BS,
                      int WB, float scale) {
  using T = __nv_bfloat16;
  using attn_tc::a_frags;
  using attn_tc::BM;
  using attn_tc::mma_cols;
  using attn_tc::mma_rows;
  using attn_tc::NT;
  using attn_tc::quad_max;
  using attn_tc::quad_sum;
  using attn_tile::cp_async16;
  using attn_tile::cp_async_commit;
  using attn_tile::cp_async_wait;
  using attn_tile::ldsm_x4;
  using attn_tile::pack16;
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int BN = 64;            // keys per streamed tile
  constexpr int DP = DMAX + 8;
  constexpr int KC = DMAX / 16;
  constexpr int NO = DMAX / 8;
  constexpr int NS = BN / 8;
  constexpr int KV = INT8 ? 1 : 2;  // bf16 K/V stages
  constexpr bool FRAG_REG = DMAX <= 64;  // q's fragments in registers
  constexpr int KF = FRAG_REG ? KC : 1;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BM][DP]; then the o tile
  T* Ks = Qs + BM * DP;                     // [KV][BN][DP]
  T* Vs = Ks + KV * BN * DP;                // [KV][BN][DP]
  // int8: the codes as read [2][BN][DMAX] and their scales [2][BN]
  int8_t* Kc = reinterpret_cast<int8_t*>(Vs + KV * BN * DP);
  int8_t* Vc = Kc + 2 * BN * DMAX;
  float* Ksc = reinterpret_cast<float*>(Vc + 2 * BN * DMAX);
  float* Vsc = Ksc + 2 * BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / H;
  const int h = blockIdx.x - item * H;
  const int* it = items + 4 * item;
  const int t0 = it[0], ntok = it[1], n_keys = it[2];
  const long long row = (long long)H * D;   // token stride of q, pools, out
  const int* bt = table + (long long)t0 * WB;
  const int dk = (D + 15) & ~15;
  const int cpr = dk / 8;
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int r0 = warp * 16 + g;     // this lane's rows: r0 and r0 + 8
  // each row sees keys up to its own position (rows past the item, zero
  // queries that are never stored, none on an edge tile)
  const int pos0 = r0 < ntok ? pos[t0 + r0] : -1;
  const int pos1 = r0 + 8 < ntok ? pos[t0 + r0 + 8] : -1;
  const int pmin = pos[t0];         // positions never fall along an item
  const int ntiles = (n_keys + BN - 1) / BN;
  // the item's table entries, staged once (the first TBL of them), so
  // that a tile's row addresses wait on no device-memory read
  constexpr int TBL = 256;
  __shared__ int bts[TBL];
  const int nblk = (n_keys + BS - 1) / BS;
  for (int i = threadIdx.x; i < min(nblk, TBL); i += NT) bts[i] = bt[i];
  __syncthreads();
  auto block_of = [&](int i) { return i < TBL ? bts[i] : bt[i]; };

  // keys k0 .. k0 + 63 gathered through the table row; keys past the
  // last visible one (their scales too), and the head dim's zero padding,
  // zero-filled
  auto load_kv = [&](int n) {
    const int k0 = n * BN, s = n & 1;
    for (int idx = threadIdx.x; idx < BN * cpr; idx += NT) {
      const int r = idx / cpr;
      const int c = (idx - r * cpr) * 8;
      const int kp = k0 + r;
      const bool ok = kp < n_keys && c < D;
      const long long off =
          ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * row + h * D + c
             : 0;
      if constexpr (INT8) {
        cp_async8(Kc + (s * BN + r) * DMAX + c, k_pool + off, ok);
        cp_async8(Vc + (s * BN + r) * DMAX + c, v_pool + off, ok);
      } else {
        cp_async16(Ks + (s * BN + r) * DP + c, k_pool + off, ok);
        cp_async16(Vs + (s * BN + r) * DP + c, v_pool + off, ok);
      }
    }
    if constexpr (INT8) {
      if (threadIdx.x < BN) {
        const int kp = k0 + threadIdx.x;
        const bool ok = kp < n_keys;
        const long long at =
            ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * H + h : 0;
        cp_async4(Ksc + s * BN + threadIdx.x, k_scale + at, ok);
        cp_async4(Vsc + s * BN + threadIdx.x, v_scale + at, ok);
      }
    }
  };
  attn_tc::load_rows<T, DP>(Qs, q + t0 * row + h * D, row, BM, ntok, D, dk);
  load_kv(0);
  cp_async_commit();

  const T* Qw = Qs + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;
  uint32_t qf[KF][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    if (n + 1 < ntiles) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = n * BN;
    const T* Kt = Ks + (INT8 ? 0 : (n & 1) * BN * DP);
    const T* Vt = Vs + (INT8 ? 0 : (n & 1) * BN * DP);
    const float* Kst = Ksc + (n & 1) * BN;
    const float* Vst = Vsc + (n & 1) * BN;
    if constexpr (INT8) {   // widen this stage's codes to the bf16 tiles
      const int8_t* kc = Kc + (n & 1) * BN * DMAX;
      const int8_t* vc = Vc + (n & 1) * BN * DMAX;
      for (int idx = threadIdx.x; idx < BN * cpr; idx += NT) {
        const int r = idx / cpr;
        const int c = (idx - r * cpr) * 8;
        const int8_t* src[2] = {kc + r * DMAX + c, vc + r * DMAX + c};
        T* dst[2] = {Ks + r * DP + c, Vs + r * DP + c};
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = pack16((float)src[o][2 * e], (float)src[o][2 * e + 1],
                          Ks);
          *reinterpret_cast<uint4*>(dst[o]) = make_uint4(w[0], w[1], w[2],
                                                         w[3]);
        }
      }
      __syncthreads();
    }
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
    // only tiles past the item's first position cross a row's diagonal
    const bool edge = k0 + BN - 1 > pmin;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        const bool vis = !edge || k0 + col <= (e < 2 ? pos0 : pos1);
        float x = s[c][e] * sl;
        if constexpr (INT8) x *= Kst[col];
        x = vis ? x : -INFINITY;
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
        float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += p;
        else sum1 += p;
        if constexpr (INT8) p *= Vst[8 * c + 2 * t + (e & 1)];
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
  }

  // o = acc / max(l, 1e-30) through the q tile's shared memory
  const float ls0 = fmaxf(quad_sum(l0), 1e-30f);
  const float ls1 = fmaxf(quad_sum(l1), 1e-30f);
  T* Os = Qs;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = 8 * c + 2 * t;
    if (col < dk) {
      *reinterpret_cast<uint32_t*>(Os + r0 * DP + col) =
          pack16(acc[c][0] / ls0, acc[c][1] / ls0, Os);
      *reinterpret_cast<uint32_t*>(Os + (r0 + 8) * DP + col) =
          pack16(acc[c][2] / ls1, acc[c][3] / ls1, Os);
    }
  }
  __syncthreads();
  attn_tc::store_rows<T, DP>(out + t0 * row + h * D, row, Os, ntok, D);
}

// The 3xTF32 chunk kernel's keys per streamed tile, threads (8 warps,
// two on each 16 query rows, each on half of every tile's keys) and K/V
// stages (three fp32 stages at DMAX = 128 would need 231 KiB, past the
// 227 KiB a block may have). tools/probe_chunked_tf32.py times the other
// settings as patches of this source.
constexpr int TF32_BN = 64;
constexpr int TF32_NT = 256;
constexpr int TF32_STAGES = 2;

// The 3xTF32 chunk kernel's shared memory (bytes): the fp32 q tile and
// the K/V stages, fp32 rows DMAX + 4 floats apart, or int8 codes rows
// DMAX + 8 bytes apart with their fp32 scales.
template <typename P, int DMAX>
constexpr size_t chunk_tf32_smem() {
  constexpr int BN = TF32_BN, DP = DMAX + 4, DPB = DMAX + 8;
  constexpr int NSTG = TF32_STAGES;
  constexpr bool INT8 = sizeof(P) == 1;
  return sizeof(float) * (size_t)attn_tc::BM * DP +
         (INT8 ? (size_t)NSTG * 2 * BN * DPB + sizeof(float) * NSTG * 2 * BN
               : sizeof(float) * (size_t)NSTG * 2 * BN * DP);
}

// An int8 code as a TF32 operand: exact (|code| <= 128 has at most 8
// significant bits), so it has no lo part.
__device__ __forceinline__ uint32_t code_tf32(int8_t c) {
  return __float_as_uint((float)c);
}

// c += A.C for exact operands C: lo.c then hi.c into a fresh tile that an
// fp32 add folds into c (tf32_mma.cuh's mma3 without the product of C's
// lo part, which is 0)
__device__ __forceinline__ void mma2(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&b)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  attn_tf32::mma8(d, al, b);
  attn_tf32::mma8(d, ah, b);
  c[0] += d[0];
  c[1] += d[1];
  c[2] += d[2];
  c[3] += d[3];
}

// tf32_mma.cuh's mma_rows over int8 codes (rows DPB bytes apart): acc[n]
// += A . C^T over columns kc .. kc + 7, C's rows n the tile's rows 8n ..
// 8n + 7
template <int NN, int DPB>
__device__ __forceinline__ void mma_rows_codes(float (&acc)[NN][4],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               const int8_t* C, int kc) {
  const int lane = threadIdx.x & 31;
  const int at = (lane >> 2) * DPB + kc + (lane & 3);
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const uint32_t b[2] = {code_tf32(C[at + n * 8 * DPB]),
                           code_tf32(C[at + n * 8 * DPB + 4])};
    mma2(acc[n], ah, al, b);
  }
}

// tf32_mma.cuh's mma_cols over int8 codes: acc[n] += X . C over the
// tile's rows 8 kk .. 8 kk + 7 (the same permuted k index), X an fp32
// accumulator tile split in registers; n-tiles at or past D skipped
template <int NO, int NS, int DPB>
__device__ __forceinline__ void mma_cols_codes(float (&acc)[NO][4],
                                               const float (&x)[NS][4],
                                               int kk, const int8_t* C,
                                               int D) {
  using attn_tf32::split_tf32;
  const int lane = threadIdx.x & 31;
  uint32_t ah[4], al[4];
  split_tf32(x[kk][0], ah[0], al[0]);   // (g, 2t)
  split_tf32(x[kk][2], ah[1], al[1]);   // (g + 8, 2t)
  split_tf32(x[kk][1], ah[2], al[2]);   // (g, 2t + 1)
  split_tf32(x[kk][3], ah[3], al[3]);   // (g + 8, 2t + 1)
  const int at = (8 * kk + 2 * (lane & 3)) * DPB + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (n * 8 < D) {
      const uint32_t b[2] = {code_tf32(C[at + n * 8]),
                             code_tf32(C[at + DPB + n * 8])};
      mma2(acc[n], ah, al, b);
    }
  }
}

// ---------------------------------------------------------------------------
// route 2, runs of two or more tokens in fp32: grid (items * H); block
// TF32_NT. items as chunked_tc_kernel's. Pools of fp32, or of int8 codes
// whose fp32 scales multiply s (k_scale) and p before its split
// (v_scale). Every product 3xTF32 (two over exact codes). Two warps own
// each 16 query rows: warp w takes rows 16 (w % 4) .. + 15 and key half w
// / 4 of every tile, runs its own online softmax over those keys, and the
// two halves' (m, l, o) are combined at the end, half 0's first.
// ---------------------------------------------------------------------------
template <typename P, int DMAX>
__global__ void __launch_bounds__(TF32_NT, 1)
    chunked_tf32_kernel(const float* __restrict__ q,
                        const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ pos,
                        const int* __restrict__ items,
                        float* __restrict__ out, int H, int D, int BS,
                        int WB, float scale) {
  using attn_tc::BM;
  using attn_tc::quad_max;
  using attn_tc::quad_sum;
  using attn_tf32::a_rows;
  using attn_tile::cp_async16;
  using attn_tile::cp_async_commit;
  using attn_tile::cp_async_wait;
  constexpr int NT = TF32_NT;
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int BN = TF32_BN;       // keys per streamed tile
  constexpr int KH = BN / 2;        // keys of a tile one warp takes
  constexpr int DP = DMAX + 4;      // fp32 row pitch (floats)
  constexpr int DPB = DMAX + 8;     // int8 row pitch (bytes)
  constexpr int KS = DMAX / 8;      // k-steps of q.k^T
  constexpr int NO = DMAX / 8;      // output n-tiles
  constexpr int NS = KH / 8;        // score n-tiles
  constexpr int NSTG = TF32_STAGES;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BM][DP]; then half
                                                    // 1's unnormalised o
  float* Ks = Qs + BM * DP;                         // fp32: [NSTG][BN][DP]
  float* Vs = Ks + NSTG * BN * DP;                  // fp32: [NSTG][BN][DP]
  // int8: the codes [NSTG][BN][DPB] and their scales [NSTG][BN]
  int8_t* Kc = reinterpret_cast<int8_t*>(Qs + BM * DP);
  int8_t* Vc = Kc + NSTG * BN * DPB;
  float* Ksc = reinterpret_cast<float*>(Vc + NSTG * BN * DPB);
  float* Vsc = Ksc + NSTG * BN;
  __shared__ float half_m[BM], half_l[BM];          // half 1's m and l

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, kh = warp >> 2;  // row group, key half
  const int item = blockIdx.x / H;
  const int h = blockIdx.x - item * H;
  const int* it = items + 4 * item;
  const int t0 = it[0], ntok = it[1], n_keys = it[2];
  const long long row = (long long)H * D;   // token stride of q, pools, out
  const int* bt = table + (long long)t0 * WB;
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int r0 = rg * 16 + g;       // this lane's rows: r0 and r0 + 8
  // each row sees keys up to its own position (rows past the item, zero
  // queries that are never stored, none on an edge tile)
  const int pos0 = r0 < ntok ? pos[t0 + r0] : -1;
  const int pos1 = r0 + 8 < ntok ? pos[t0 + r0 + 8] : -1;
  const int pmin = pos[t0];         // positions never fall along an item
  const int ntiles = (n_keys + BN - 1) / BN;
  // the item's table entries, staged once (the first TBL of them), so
  // that a tile's row addresses wait on no device-memory read
  constexpr int TBL = 256;
  __shared__ int bts[TBL];
  const int nblk = (n_keys + BS - 1) / BS;
  for (int i = threadIdx.x; i < min(nblk, TBL); i += NT) bts[i] = bt[i];
  __syncthreads();
  auto block_of = [&](int i) { return i < TBL ? bts[i] : bt[i]; };

  // keys k0 .. k0 + BN - 1 gathered through the table row; keys past the
  // last visible one (their scales too) zero-filled. Columns at or past D
  // are never read.
  auto load_kv = [&](int n) {
    const int k0 = n * BN, s = n % NSTG;
    constexpr int PER = INT8 ? 8 : 4;   // elements a copy moves
    const int cpr = D / PER;
    for (int idx = threadIdx.x; idx < BN * cpr; idx += NT) {
      const int r = idx / cpr;
      const int c = (idx - r * cpr) * PER;
      const int kp = k0 + r;
      const bool ok = kp < n_keys;
      const long long off =
          ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * row + h * D + c
             : 0;
      if constexpr (INT8) {
        cp_async8(Kc + (s * BN + r) * DPB + c, k_pool + off, ok);
        cp_async8(Vc + (s * BN + r) * DPB + c, v_pool + off, ok);
      } else {
        cp_async16(Ks + (s * BN + r) * DP + c, k_pool + off, ok);
        cp_async16(Vs + (s * BN + r) * DP + c, v_pool + off, ok);
      }
    }
    if constexpr (INT8) {
      if (threadIdx.x < BN) {
        const int kp = k0 + threadIdx.x;
        const bool ok = kp < n_keys;
        const long long at =
            ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * H + h : 0;
        cp_async4(Ksc + s * BN + threadIdx.x, k_scale + at, ok);
        cp_async4(Vsc + s * BN + threadIdx.x, v_scale + at, ok);
      }
    }
  };
  {  // the item's queries; rows past it zero
    const int cpr = D / 4;
    const float* qb = q + (long long)t0 * row + h * D;
    for (int idx = threadIdx.x; idx < BM * cpr; idx += NT) {
      const int r = idx / cpr;
      const int c = (idx - r * cpr) * 4;
      const bool ok = r < ntok;
      cp_async16(Qs + r * DP + c, ok ? qb + r * row + c : qb, ok);
    }
  }
  // the first NSTG - 1 tiles in flight (q with the first)
#pragma unroll
  for (int n = 0; n < NSTG - 1; ++n) {
    if (n < ntiles) load_kv(n);
    cp_async_commit();
  }

  const float* Qw = Qs + rg * 16 * DP;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    if (n + NSTG - 1 < ntiles) load_kv(n + NSTG - 1);
    cp_async_commit();
    cp_async_wait<NSTG - 1>();
    __syncthreads();
    const int k0 = n * BN + kh * KH;  // this warp's first key
    const int st = n % NSTG;
    const float* Kt = Ks + (st * BN + kh * KH) * DP;
    const float* Vt = Vs + (st * BN + kh * KH) * DP;
    const int8_t* Kct = Kc + (st * BN + kh * KH) * DPB;
    const int8_t* Vct = Vc + (st * BN + kh * KH) * DPB;
    const float* Kst = Ksc + st * BN + kh * KH;
    const float* Vst = Vsc + st * BN + kh * KH;

    // s = q.k^T over the warp's keys, every product 3xTF32 (two over
    // exact codes)
    float s[NS][4];
#pragma unroll
    for (int c = 0; c < NS; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KS; ++kc) {
      if (kc * 8 < D) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Qw, kc * 8, ah, al);
        if constexpr (INT8)
          mma_rows_codes<NS, DPB>(s, ah, al, Kct, kc * 8);
        else
          attn_tf32::mma_rows<NS, DP>(s, ah, al, Kt, kc * 8);
      }
    }
    // only keys past the item's first position cross a row's diagonal
    const bool edge = k0 + KH - 1 > pmin;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        const bool vis = !edge || k0 + col <= (e < 2 ? pos0 : pos1);
        float x = s[c][e] * sl;
        if constexpr (INT8) x *= Kst[col];
        x = vis ? x : -INFINITY;
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
        float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += p;
        else sum1 += p;
        if constexpr (INT8) p *= Vst[8 * c + 2 * t + (e & 1)];
        s[c][e] = p;
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= a0; acc[c][1] *= a0;
      acc[c][2] *= a1; acc[c][3] *= a1;
    }
    // o += p.v over the warp's keys, p split in registers
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      if constexpr (INT8)
        mma_cols_codes<NO, NS, DPB>(acc, s, kk, Vct, D);
      else
        attn_tf32::mma_cols<NO, NS, DP>(acc, s, kk, Vt, D);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // the two key halves' (m, l, o), half 0's first: half 1 leaves its
  // unnormalised o in the q tile's rows and its m, l beside them
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int col0 = 2 * t;
  if (kh == 1) {
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      if (c * 8 < D) {
        *reinterpret_cast<float2*>(Qs + r0 * DP + 8 * c + col0) =
            make_float2(acc[c][0], acc[c][1]);
        *reinterpret_cast<float2*>(Qs + (r0 + 8) * DP + 8 * c + col0) =
            make_float2(acc[c][2], acc[c][3]);
      }
    }
    if (t == 0) {
      half_m[r0] = m0;
      half_l[r0] = l0;
      half_m[r0 + 8] = m1;
      half_l[r0 + 8] = l1;
    }
  }
  __syncthreads();
  if (kh == 1) return;
  // o = (acc_0 w_0 + acc_1 w_1) / max(l_0 w_0 + l_1 w_1, 1e-30), w_h =
  // 2^(m_h - max(m_0, m_1)) (0 where a half saw no key); the item's rows
  // only, from the fragments
  const float mb0 = half_m[r0], mb1 = half_m[r0 + 8];
  const float mx0 = fmaxf(m0, mb0), mx1 = fmaxf(m1, mb1);
  const float wa0 = m0 == -INFINITY ? 0.f : exp2f(m0 - mx0);
  const float wa1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mx1);
  const float wb0 = mb0 == -INFINITY ? 0.f : exp2f(mb0 - mx0);
  const float wb1 = mb1 == -INFINITY ? 0.f : exp2f(mb1 - mx1);
  const float ls0 = fmaxf(l0 * wa0 + half_l[r0] * wb0, 1e-30f);
  const float ls1 = fmaxf(l1 * wa1 + half_l[r0 + 8] * wb1, 1e-30f);
  float* ob = out + (long long)t0 * row + h * D;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = 8 * c + col0;
    if (c * 8 < D) {
      const float2 b0 = *reinterpret_cast<const float2*>(Qs + r0 * DP + col);
      const float2 b1 =
          *reinterpret_cast<const float2*>(Qs + (r0 + 8) * DP + col);
      if (r0 < ntok)
        *reinterpret_cast<float2*>(ob + r0 * row + col) = make_float2(
            (acc[c][0] * wa0 + b0.x * wb0) / ls0,
            (acc[c][1] * wa0 + b0.y * wb0) / ls0);
      if (r0 + 8 < ntok)
        *reinterpret_cast<float2*>(ob + (r0 + 8) * row + col) = make_float2(
            (acc[c][2] * wa1 + b1.x * wb1) / ls1,
            (acc[c][3] * wa1 + b1.y * wb1) / ls1);
    }
  }
}

// The entries of a chunk item's table row that the kernels at head dims in
// (128, 256] stage in shared memory, so that a tile's row addresses wait
// on no device-memory read (an item walks at most 256 blocks' keys
// without touching device memory for an address).
constexpr int CHUNK_TBL = 256;

// The wgmma chunk kernel's threads: one warpgroup, the item's 64 query
// rows (one wgmma M).
constexpr int TC256_NT = 128;

// The wgmma chunk kernel's shared memory (bytes) for pools of P: the q
// tile and the K/V tiles, 128-byte swizzled at 256 columns (two stages;
// one for int8, whose two stages hold the codes as read, with their
// scales, and are widened into it tile by tile: |code| <= 128 is exact in
// bf16), and the item's table entries.
template <typename P>
constexpr size_t chunk_tc256_smem() {
  constexpr bool INT8 = sizeof(P) == 1;
  return (size_t)wg_tile::TILE * (1 + 2 * (INT8 ? 1 : 2)) +
         (INT8 ? (size_t)2 * 2 * wg_tile::BN * (wg_tile::DMAX + sizeof(float))
               : 0) +
         sizeof(int) * CHUNK_TBL;
}

// ---------------------------------------------------------------------------
// route 1 at head dims in (128, 256], runs of two or more tokens: grid
// (items * H); block TC256_NT, one warpgroup on the item's 64 query rows.
// items as chunked_tc_kernel's, and its arithmetic: s = q.k^T on
// wgmma.m64n64k16 from the swizzled q and K tiles (fp32 sums of exact
// 16-bit products), scaled in fp32 in base 2 (times k_scale for int8);
// the mask only on tiles past the item's first position; keys past the
// last visible one zero-filled; p (times v_scale) split into two 16-bit
// terms for o += p.v on wgmma.m64n256k16 with p in registers and V read
// MN-major; o = acc / max(l, 1e-30), the item's rows only.
// ---------------------------------------------------------------------------
template <typename P>
__global__ void __launch_bounds__(TC256_NT, 1)
    chunked_tc256_kernel(const __nv_bfloat16* __restrict__ q,
                         const P* __restrict__ k_pool,
                         const P* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ table,
                         const int* __restrict__ pos,
                         const int* __restrict__ items,
                         __nv_bfloat16* __restrict__ out, int H, int D,
                         int BS, int WB, float scale) {
  using T = __nv_bfloat16;
  using attn_tc::quad_max;
  using attn_tc::quad_sum;
  using attn_tile::cp_async16;
  using attn_tile::cp_async_commit;
  using attn_tile::cp_async_wait;
  using attn_tile::pack16;
  using wg_tile::BN;
  using wg_tile::DMAX;
  using wg_tile::swz;
  using wg_tile::TILE;
  constexpr int NT = TC256_NT;
  constexpr int BM = 64;                   // query rows: one item
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int KV = INT8 ? 1 : 2;         // bf16 K/V stages
  constexpr int CODES = INT8 ? 2 * BN * DMAX : 0;   // a pool's staged codes
  constexpr int SCALES = INT8 ? 2 * BN : 0;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* Qs = smem;                      // q; then o
  uint8_t* Ks = Qs + TILE;                 // [KV] K tiles
  uint8_t* Vs = Ks + KV * TILE;            // [KV] V tiles
  // int8: the codes as read [2][BN][DMAX] and their scales [2][BN]
  int8_t* Kc = reinterpret_cast<int8_t*>(Vs + KV * TILE);
  int8_t* Vc = Kc + CODES;
  float* Ksc = reinterpret_cast<float*>(Vc + CODES);
  float* Vsc = Ksc + SCALES;
  int* bts = reinterpret_cast<int*>(Vsc + SCALES);   // [CHUNK_TBL]
  if (threadIdx.x == 0 && (hopper::smem_u32(smem) & 1023)) __trap();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int item = blockIdx.x / H;
  const int h = blockIdx.x - item * H;
  const int* it = items + 4 * item;
  const int t0 = it[0], ntok = it[1], n_keys = it[2];
  const long long row = (long long)H * D;   // token stride of q, pools, out
  const int* bt = table + (long long)t0 * WB;
  const int dk = (D + 15) & ~15;
  const int cpr = dk >> 3;          // 16-byte chunks of a row (8 codes)
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int r0 = warp * 16 + g;     // this lane's rows: r0 and r0 + 8
  // each row sees keys up to its own position (rows past the item, zero
  // queries that are never stored, none on an edge tile)
  const int pos0 = r0 < ntok ? pos[t0 + r0] : -1;
  const int pos1 = r0 + 8 < ntok ? pos[t0 + r0 + 8] : -1;
  const int pmin = pos[t0];         // positions never fall along an item
  const int ntiles = (n_keys + BN - 1) / BN;
  const int nblk = (n_keys + BS - 1) / BS;
  for (int i = threadIdx.x; i < min(nblk, CHUNK_TBL); i += NT) bts[i] = bt[i];
  __syncthreads();
  auto block_of = [&](int i) { return i < CHUNK_TBL ? bts[i] : bt[i]; };

  // keys k0 .. k0 + 63 gathered through the table row into stage n & 1;
  // keys past the last visible one (their scales too), and the head dim's
  // zero padding, zero-filled
  auto load_kv = [&](int n) {
    const int k0 = n * BN, s = n & 1;
    for (int idx = threadIdx.x; idx < BN * cpr; idx += NT) {
      const int r = idx / cpr;
      const int cc = idx - r * cpr;
      const int kp = k0 + r;
      const bool ok = kp < n_keys && cc * 8 < D;
      const long long off =
          ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * row + h * D +
                   cc * 8
             : 0;
      if constexpr (INT8) {
        cp_async8(Kc + (s * BN + r) * DMAX + cc * 8, k_pool + off, ok);
        cp_async8(Vc + (s * BN + r) * DMAX + cc * 8, v_pool + off, ok);
      } else {
        cp_async16(Ks + s * TILE + swz(r, cc, BN), k_pool + off, ok);
        cp_async16(Vs + s * TILE + swz(r, cc, BN), v_pool + off, ok);
      }
    }
    if constexpr (INT8) {
      if (threadIdx.x < BN) {
        const int kp = k0 + threadIdx.x;
        const bool ok = kp < n_keys;
        const long long at =
            ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * H + h : 0;
        cp_async4(Ksc + s * BN + threadIdx.x, k_scale + at, ok);
        cp_async4(Vsc + s * BN + threadIdx.x, v_scale + at, ok);
      }
    }
  };
  wg_tile::load_tile(Qs, q + t0 * row + h * D, row, BM, ntok, D, dk, NT);
  load_kv(0);
  cp_async_commit();

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    if (n + 1 < ntiles) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    hopper::fence_proxy_async();   // the copies, before wgmma reads them
    __syncthreads();
    const int k0 = n * BN;
    const uint8_t* Kt = Ks + (INT8 ? 0 : (n & 1) * TILE);
    const uint8_t* Vt = Vs + (INT8 ? 0 : (n & 1) * TILE);
    const float* Kst = Ksc + (n & 1) * BN;
    const float* Vst = Vsc + (n & 1) * BN;
    if constexpr (INT8) {   // widen this stage's codes into the bf16 tiles
      const int8_t* kc = Kc + (n & 1) * BN * DMAX;
      const int8_t* vc = Vc + (n & 1) * BN * DMAX;
      for (int idx = threadIdx.x; idx < BN * cpr; idx += NT) {
        const int r = idx / cpr;
        const int cc = idx - r * cpr;
        const int8_t* src[2] = {kc + r * DMAX + cc * 8,
                                vc + r * DMAX + cc * 8};
        uint8_t* dst[2] = {Ks + swz(r, cc, BN), Vs + swz(r, cc, BN)};
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = pack16((float)src[o][2 * e], (float)src[o][2 * e + 1],
                          static_cast<const T*>(nullptr));
          *reinterpret_cast<uint4*>(dst[o]) = make_uint4(w[0], w[1], w[2],
                                                         w[3]);
        }
      }
      hopper::fence_proxy_async();
      __syncthreads();
    }

    // s = q.k^T (fp32 sums of exact 16-bit products), scaled in fp32
    float s[32];
    hopper::wgmma_fence();
    wg_tile::scores<T>(s, Qs, BM, 0, Kt, dk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(s);
    // only tiles past the item's first position cross a row's diagonal
    const bool edge = k0 + BN - 1 > pmin;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        const bool vis = !edge || k0 + col <= (e < 2 ? pos0 : pos1);
        float x = s[4 * c + e] * sl;
        if constexpr (INT8) x *= Kst[col];
        x = vis ? x : -INFINITY;
        s[4 * c + e] = x;
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
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * c + e];
        float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += p;
        else sum1 += p;
        if constexpr (INT8) p *= Vst[8 * c + 2 * t + (e & 1)];
        s[4 * c + e] = p;
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[4 * i] *= a0;
      acc[4 * i + 1] *= a0;
      acc[4 * i + 2] *= a1;
      acc[4 * i + 3] *= a1;
    }
    wg_tile::wide_product<T>(acc, s, Vt);   // o += p.v, p in two terms
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // o = acc / max(l, 1e-30) through the q tile's shared memory
  const float ls0 = fmaxf(quad_sum(l0), 1e-30f);
  const float ls1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (8 * i < dk) {
      wg_tile::put_pair<T>(Qs, BM, r0, i, t, acc[4 * i] / ls0,
                           acc[4 * i + 1] / ls0);
      wg_tile::put_pair<T>(Qs, BM, r0 + 8, i, t, acc[4 * i + 2] / ls1,
                           acc[4 * i + 3] / ls1);
    }
  }
  __syncthreads();
  wg_tile::store_tile(out + t0 * row + h * D, row, Qs, BM, ntok, D, NT);
}

// The 3xTF32 chunk kernel at head dims in (128, 256]: keys per streamed
// tile (two stages) and threads (8 warps, two on each 16 query rows, each
// owning half of the head dim: 128 output columns and the half of s =
// q.k^T it sums).
constexpr int TF32W_BN = 32;
constexpr int TF32W_NT = 256;

// Its shared memory (bytes): the fp32 q tile and two K/V stages, fp32
// rows 260 floats apart, or int8 codes rows 264 bytes apart with their
// fp32 scales; the pairs' partial s (add_pair); the item's table entries.
template <typename P>
constexpr size_t chunk_tf32w_smem() {
  constexpr int BN = TF32W_BN, DP = 256 + 4, DPB = 256 + 8;
  constexpr bool INT8 = sizeof(P) == 1;
  return sizeof(float) * (size_t)attn_tc::BM * DP +
         (INT8 ? (size_t)2 * 2 * BN * DPB + sizeof(float) * 2 * 2 * BN
               : sizeof(float) * (size_t)2 * 2 * BN * DP) +
         sizeof(float) * (size_t)(TF32W_NT / 32) * (BN / 8) * 4 * 32 +
         sizeof(int) * CHUNK_TBL;
}

// ---------------------------------------------------------------------------
// route 2 at head dims in (128, 256], runs of two or more tokens in fp32:
// grid (items * H); block TF32W_NT. items as chunked_tc_kernel's; the
// arithmetic of chunked_tf32_kernel (every product 3xTF32, two over exact
// codes, each folded into its sum by an fp32 add; s scaled in base 2,
// times k_scale; the mask only on edge tiles; keys past the last visible
// one and their scales zero-filled; v_scale into p before its split; o =
// acc / max(l, 1e-30), the item's rows only) over 32-key tiles in two
// stages, with one online softmax a row. Warps w and w ^ 4 share rows 16
// (w % 4) .. + 15: warp w sums s over head-dim columns 128 (w / 4) .. +
// 127, the two add their partial tiles through shared memory (own +
// other's, the same bits in both), both run the same softmax, and each
// owns those 128 columns of o.
// ---------------------------------------------------------------------------
template <typename P>
__global__ void __launch_bounds__(TF32W_NT, 1)
    chunked_tf32w_kernel(const float* __restrict__ q,
                         const P* __restrict__ k_pool,
                         const P* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ table,
                         const int* __restrict__ pos,
                         const int* __restrict__ items,
                         float* __restrict__ out, int H, int D, int BS,
                         int WB, float scale) {
  using attn_tc::BM;
  using attn_tc::quad_max;
  using attn_tc::quad_sum;
  using attn_tf32::a_rows;
  using attn_tf32::add_pair;
  using attn_tile::cp_async16;
  using attn_tile::cp_async_commit;
  using attn_tile::cp_async_wait;
  constexpr int NT = TF32W_NT;
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int BN = TF32W_BN;      // keys per streamed tile
  constexpr int DP = 256 + 4;       // fp32 row pitch (floats)
  constexpr int DPB = 256 + 8;      // int8 row pitch (bytes)
  constexpr int HALF = 128;         // head-dim columns a warp owns
  constexpr int NO = HALF / 8;      // a warp's output n-tiles
  constexpr int NS = BN / 8;        // score n-tiles
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BM][DP]
  float* Ks = Qs + BM * DP;                         // fp32: [2][BN][DP]
  float* Vs = Ks + 2 * BN * DP;                     // fp32: [2][BN][DP]
  // int8: the codes [2][BN][DPB] and their scales [2][BN]
  int8_t* Kc = reinterpret_cast<int8_t*>(Qs + BM * DP);
  int8_t* Vc = Kc + 2 * BN * DPB;
  float* Ksc = reinterpret_cast<float*>(Vc + 2 * BN * DPB);
  float* Vsc = Ksc + 2 * BN;
  float* Xs = INT8 ? Vsc + 2 * BN : Vs + 2 * BN * DP;  // [8][NS * 4][32]
  int* bts = reinterpret_cast<int*>(Xs + (NT / 32) * NS * 4 * 32);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;                   // row group
  const int c0 = (warp >> 2) * HALF;         // first column the warp owns
  const int item = blockIdx.x / H;
  const int h = blockIdx.x - item * H;
  const int* it = items + 4 * item;
  const int t0 = it[0], ntok = it[1], n_keys = it[2];
  const long long row = (long long)H * D;   // token stride of q, pools, out
  const int* bt = table + (long long)t0 * WB;
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int r0 = rg * 16 + g;       // this lane's rows: r0 and r0 + 8
  // each row sees keys up to its own position (rows past the item, zero
  // queries that are never stored, none on an edge tile)
  const int pos0 = r0 < ntok ? pos[t0 + r0] : -1;
  const int pos1 = r0 + 8 < ntok ? pos[t0 + r0 + 8] : -1;
  const int pmin = pos[t0];         // positions never fall along an item
  const int ntiles = (n_keys + BN - 1) / BN;
  const int nblk = (n_keys + BS - 1) / BS;
  for (int i = threadIdx.x; i < min(nblk, CHUNK_TBL); i += NT) bts[i] = bt[i];
  __syncthreads();
  auto block_of = [&](int i) { return i < CHUNK_TBL ? bts[i] : bt[i]; };

  // keys k0 .. k0 + BN - 1 gathered through the table row into stage n &
  // 1; keys past the last visible one (their scales too) zero-filled.
  // Columns at or past D are never read.
  auto load_kv = [&](int n) {
    const int k0 = n * BN, s = n & 1;
    constexpr int PER = INT8 ? 8 : 4;   // elements a copy moves
    const int cpr = D / PER;
    for (int idx = threadIdx.x; idx < BN * cpr; idx += NT) {
      const int r = idx / cpr;
      const int c = (idx - r * cpr) * PER;
      const int kp = k0 + r;
      const bool ok = kp < n_keys;
      const long long off =
          ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * row + h * D + c
             : 0;
      if constexpr (INT8) {
        cp_async8(Kc + (s * BN + r) * DPB + c, k_pool + off, ok);
        cp_async8(Vc + (s * BN + r) * DPB + c, v_pool + off, ok);
      } else {
        cp_async16(Ks + (s * BN + r) * DP + c, k_pool + off, ok);
        cp_async16(Vs + (s * BN + r) * DP + c, v_pool + off, ok);
      }
    }
    if constexpr (INT8) {
      if (threadIdx.x < BN) {
        const int kp = k0 + threadIdx.x;
        const bool ok = kp < n_keys;
        const long long at =
            ok ? ((long long)block_of(kp / BS) * BS + kp % BS) * H + h : 0;
        cp_async4(Ksc + s * BN + threadIdx.x, k_scale + at, ok);
        cp_async4(Vsc + s * BN + threadIdx.x, v_scale + at, ok);
      }
    }
  };
  {  // the item's queries; rows past it zero
    const int cpr = D / 4;
    const float* qb = q + (long long)t0 * row + h * D;
    for (int idx = threadIdx.x; idx < BM * cpr; idx += NT) {
      const int r = idx / cpr;
      const int c = (idx - r * cpr) * 4;
      const bool ok = r < ntok;
      cp_async16(Qs + r * DP + c, ok ? qb + r * row + c : qb, ok);
    }
  }
  load_kv(0);   // with q
  cp_async_commit();

  const float* Qw = Qs + rg * 16 * DP;   // the warp's 16 rows
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    if (n + 1 < ntiles) load_kv(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = n * BN;
    const int st = n & 1;
    const float* Kt = Ks + st * BN * DP;
    const float* Vt = Vs + st * BN * DP + c0;   // the warp's columns
    const int8_t* Kct = Kc + st * BN * DPB;
    const int8_t* Vct = Vc + st * BN * DPB + c0;
    const float* Kst = Ksc + st * BN;
    const float* Vst = Vsc + st * BN;

    // s = q.k^T over the warp's half of the head dim, every product
    // 3xTF32 (two over exact codes); then the pair's halves added
    float s[NS][4];
#pragma unroll
    for (int c = 0; c < NS; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HALF; kk += 8) {
      const int kc = c0 + kk;
      if (kc < D) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Qw, kc, ah, al);
        if constexpr (INT8)
          mma_rows_codes<NS, DPB>(s, ah, al, Kct, kc);
        else
          attn_tf32::mma_rows<NS, DP>(s, ah, al, Kt, kc);
      }
    }
    add_pair<NS, 4>(Xs, s);   // warps w and w ^ 4
    // only tiles past the item's first position cross a row's diagonal
    const bool edge = k0 + BN - 1 > pmin;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * c + 2 * t + (e & 1);
        const bool vis = !edge || k0 + col <= (e < 2 ? pos0 : pos1);
        float x = s[c][e] * sl;
        if constexpr (INT8) x *= Kst[col];
        x = vis ? x : -INFINITY;
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
        float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        if (e < 2) sum0 += p;
        else sum1 += p;
        if constexpr (INT8) p *= Vst[8 * c + 2 * t + (e & 1)];
        s[c][e] = p;
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= a0; acc[c][1] *= a0;
      acc[c][2] *= a1; acc[c][3] *= a1;
    }
    // o += p.v over the warp's columns, p split in registers
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      if constexpr (INT8)
        mma_cols_codes<NO, NS, DPB>(acc, s, kk, Vct, D - c0);
      else
        attn_tf32::mma_cols<NO, NS, DP>(acc, s, kk, Vt, D - c0);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // o = acc / max(l, 1e-30), the item's rows and the warp's columns, from
  // the fragments
  const float ls0 = fmaxf(quad_sum(l0), 1e-30f);
  const float ls1 = fmaxf(quad_sum(l1), 1e-30f);
  float* ob = out + (long long)t0 * row + h * D + c0;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = 8 * c + 2 * t;
    if (c * 8 < D - c0) {
      if (r0 < ntok)
        *reinterpret_cast<float2*>(ob + r0 * row + col) =
            make_float2(acc[c][0] / ls0, acc[c][1] / ls0);
      if (r0 + 8 < ntok)
        *reinterpret_cast<float2*>(ob + (r0 + 8) * row + col) =
            make_float2(acc[c][2] / ls1, acc[c][3] / ls1);
    }
  }
}

// ---------------------------------------------------------------------------
// routes 1 and 2, runs of one token: grid (H * splits, items), clusters of
// (splits, 1, 1); block THREADS. items int32 [n][4]: token, 1, keys
// (its position + 1), 0.
// ---------------------------------------------------------------------------
template <typename T, typename P, int TPKP>
__global__ void __launch_bounds__(THREADS) chunked_decode_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ items, T* __restrict__ out, int H, int D, int BS,
    int WB, float scale, int splits) {
  constexpr int KT = WalkSmem<TPKP, 1>::KT;
  __shared__ __align__(16) WalkSmem<TPKP, 1> sm;
  const int h = blockIdx.x / splits;
  const int* it = items + 4 * blockIdx.y;
  const int tok = it[0], n_keys = it[2];
  const long first = (long)tok * H * D + (long)h * D;
  const int rank =
      splits > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  int k_lo, k_hi;
  cluster_share<KT>(n_keys, rank, splits, k_lo, k_hi);
  walk_keys<T, P, TPKP, 1>(sm, q + first, k_pool, v_pool, k_scale, v_scale,
                           table + (long)tok * WB, n_keys - 1, 1, H, D, BS,
                           h, scale, k_lo, k_hi);
  finish_cluster<T, TPKP, 1>(sm, out + first, 1, H, D, rank, splits);
}

// The chunk items' kernel for q of T and tiles of DMAX columns:
// chunked_tc_kernel for bf16, chunked_tf32_kernel for fp32; at DMAX = 256
// chunked_tc256_kernel and chunked_tf32w_kernel.
template <typename T, typename P, int DMAX>
cudaError_t launch_chunks(const void* q, const void* k_pool,
                          const void* v_pool, const float* k_scale,
                          const float* v_scale, const int* table,
                          const int* pos, const int* items, int n_items,
                          void* out, int H, int D, int BS, int WB,
                          float scale, cudaStream_t st) {
  constexpr bool TF32 = std::is_same<T, float>::value;
  constexpr bool WIDE = DMAX > 128;
  void (*fn)(const T*, const P*, const P*, const float*, const float*,
             const int*, const int*, const int*, T*, int, int, int, int,
             float);
  size_t smem;
  int threads;
  if constexpr (TF32 && WIDE) {
    fn = chunked_tf32w_kernel<P>;
    smem = chunk_tf32w_smem<P>();
    threads = TF32W_NT;
  } else if constexpr (TF32) {
    fn = chunked_tf32_kernel<P, DMAX>;
    smem = chunk_tf32_smem<P, DMAX>();
    threads = TF32_NT;
  } else if constexpr (WIDE) {
    fn = chunked_tc256_kernel<P>;
    smem = chunk_tc256_smem<P>();
    threads = TC256_NT;
  } else {
    fn = chunked_tc_kernel<P, DMAX>;
    smem = chunk_smem<P, DMAX>();
    threads = attn_tc::NT;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fn<<<(unsigned)n_items * (unsigned)H, threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, table, pos, items,
      static_cast<T*>(out), H, D, BS, WB, scale);
  return cudaGetLastError();
}

constexpr size_t SMEM_LIMIT = 232448;   // 227 KB of dynamic shared memory
static_assert(chunk_tc256_smem<__nv_bfloat16>() <= SMEM_LIMIT &&
                  chunk_tc256_smem<int8_t>() <= SMEM_LIMIT,
              "the wgmma chunk kernel's tiles exceed a block's shared memory");
static_assert(chunk_tf32w_smem<float>() <= SMEM_LIMIT &&
                  chunk_tf32w_smem<int8_t>() <= SMEM_LIMIT,
              "the wide 3xTF32 chunk kernel's tiles exceed a block's shared "
              "memory");

template <typename T, typename P>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const float* k_scale,
                          const float* v_scale, const int* table,
                          const int* items, int n_items, void* out, int H,
                          int D, int BS, int WB, float scale, int splits,
                          cudaStream_t st) {
  const dim3 grid(H * splits, n_items, 1);
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pool);
  const P* vp = static_cast<const P*>(v_pool);
  T* op = static_cast<T*>(out);
  cudaError_t err = cudaSuccess;
#define CHUNKED_DECODE_LAUNCH(TP)                                          \
  err = launch_clusters(chunked_decode_kernel<T, P, TP>, grid, splits, st, \
                        qp, kp, vp, k_scale, v_scale, table, items, op, H, \
                        D, BS, WB, scale, splits)
  PAGED_DISPATCH_D(D, CHUNKED_DECODE_LAUNCH);
#undef CHUNKED_DECODE_LAUNCH
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The stream a call's decode items run on beside its chunk items (on the
// caller's stream), and the events that fork it from and join it back to
// the caller's stream: made once per device, at first use.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
constexpr int MAX_DEVICES = 64;

cudaError_t side_stream(Side*& side) {
  static Side sides[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Side& s = sides[dev];
  if (s.stream == nullptr) {
    if ((err = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (err = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (err = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking)) !=
            cudaSuccess)
      return err;
  }
  side = &s;
  return cudaSuccess;
}

// The chunk items' kernel on `st` and the decode items' kernel beside it
// on the side stream, forked from and joined back to `st`, so the two
// short kernels overlap; everything after the call on `st` waits for
// both. One kind alone runs on `st`. T: q's type (bf16: route 1, fp32:
// route 2).
template <typename T, typename P>
cudaError_t launch_runs(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* table, const int* pos, const int* items,
                        int n_chunk, int n_decode, void* out, int H, int D,
                        int BS, int WB, float scale, int splits,
                        cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  cudaStream_t dst = st;   // the decode items' stream
  Side* side = nullptr;
  if (n_chunk > 0 && n_decode > 0) {
    if ((err = side_stream(side)) != cudaSuccess ||
        (err = cudaEventRecord(side->fork, st)) != cudaSuccess ||
        (err = cudaStreamWaitEvent(side->stream, side->fork, 0)) !=
            cudaSuccess)
      return err;
    dst = side->stream;
  }
  if (n_decode > 0) {
    err = launch_decode<T, P>(q, k_pool, v_pool, k_scale, v_scale, table,
                           items + 4 * n_chunk, n_decode, out, H, D, BS, WB,
                           scale, splits, dst);
    if (err != cudaSuccess) return err;
  }
  if (n_chunk > 0) {
#define CHUNKED_CHUNKS_LAUNCH(DM)                                          \
  launch_chunks<T, P, DM>(q, k_pool, v_pool, k_scale, v_scale, table, pos, \
                          items, n_chunk, out, H, D, BS, WB, scale, st)
    if (D <= 64) err = CHUNKED_CHUNKS_LAUNCH(64);
    else if (D <= 128) err = CHUNKED_CHUNKS_LAUNCH(128);
    else err = CHUNKED_CHUNKS_LAUNCH(256);
#undef CHUNKED_CHUNKS_LAUNCH
    if (err != cudaSuccess) return err;
  }
  if (side != nullptr) {
    if ((err = cudaEventRecord(side->join, side->stream)) != cudaSuccess)
      return err;
    err = cudaStreamWaitEvent(st, side->join, 0);
  }
  return err;
}

// The run kernels' checks and launch, for q of T (routes 1 and 2).
template <typename T, typename FP>
int run_kernels(const void* q, const void* k_pool, const void* v_pool,
                const void* k_scale, const void* v_scale, const void* table,
                const void* pos, const void* items, int n_chunk,
                int n_decode, void* out, int NT, int H, int D, int BS,
                int WB, float scale, int int8, int splits, void* stream) {
  if (D < 8 || D > MAX_D || D % 8 != 0 || BS < 1 || WB < 1 || NT < 1 ||
      H < 1 || n_chunk < 0 || n_decode < 0 || n_chunk + n_decode < 1 ||
      n_decode > 65535 || (long long)n_chunk * H > 0x7fffffffLL ||
      splits < 1 || splits > MAX_SPLITS ||
      (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  const int* it = static_cast<const int*>(items);
  const cudaError_t err =
      int8 ? launch_runs<T, int8_t>(q, k_pool, v_pool, ks, vs, tb, ps, it,
                                    n_chunk, n_decode, out, H, D, BS, WB,
                                    scale, splits, st)
           : launch_runs<T, FP>(q, k_pool, v_pool, nullptr, nullptr, tb, ps,
                                it, n_chunk, n_decode, out, H, D, BS, WB,
                                scale, splits, st);
  return (int)err;
}

template <typename T, typename P>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* k_scale, const void* v_scale, const void* table,
            const void* pos, void* out, int NT, int H, int D, int BS, int WB,
            float scale, cudaStream_t st) {
  const dim3 grid(H, NT);
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pool);
  const P* vp = static_cast<const P*>(v_pool);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  T* op = static_cast<T*>(out);
#define CHUNKED_PREFILL_LAUNCH(TP)                                       \
  chunked_prefill_kernel<T, P, TP><<<grid, THREADS, 0, st>>>(            \
      qp, kp, vp, ksp, vsp, tb, ps, op, NT, H, D, BS, WB, scale)
  PAGED_DISPATCH_D(D, CHUNKED_PREFILL_LAUNCH);
#undef CHUNKED_PREFILL_LAUNCH
}

}  // namespace

extern "C" {

// dtype (of q, out and an fp pool): 0 = float32, 1 = bfloat16. int8: 1 for
// int8 pools with fp32 scales k_scale / v_scale [N, BS, H]. Returns
// cudaGetLastError() after the launch (0 = launched). Shapes, dtypes,
// contiguity and alignment are checked by the Python wrapper.
int chunked_prefill_attention_fwd(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* pos, void* out, int NT, int H,
                                  int D, int BS, int WB, float scale,
                                  int dtype, int int8, void* stream) {
  if (D < VEC || D > MAX_D || D % VEC != 0 || BS < 1 || WB < 1 || NT < 1 ||
      NT > 65535 || H < 1 || (dtype != 0 && dtype != 1) ||
      (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && int8)
    launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table,
                                  pos, out, NT, H, D, BS, WB, scale, st);
  else if (dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr,
                                         nullptr, table, pos, out, NT, H, D,
                                         BS, WB, scale, st);
  else if (int8)
    launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, pos,
                          out, NT, H, D, BS, WB, scale, st);
  else
    launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, table, pos,
                         out, NT, H, D, BS, WB, scale, st);
  return (int)cudaGetLastError();
}

// Route 1 (bf16 q; bf16 pools, or int8 pools with fp32 scales k_scale /
// v_scale [N, BS, H]; D a multiple of 8 in [8, 256]): items int32
// [n_chunk + n_decode][4] from the host's run list (ops/transformer/
// chunked_prefill.py: chunked_runs), the chunk items first; the decode
// items' keys split over `splits` blocks of a cluster (1 to 8). Launches
// the chunk kernel when n_chunk > 0 and the decode kernel when n_decode >
// 0. Returns the first launch error, else cudaGetLastError() (0 =
// launched).
int chunked_prefill_tc_fwd(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* table,
                           const void* pos, const void* items, int n_chunk,
                           int n_decode, void* out, int NT, int H, int D,
                           int BS, int WB, float scale, int int8, int splits,
                           void* stream) {
  return run_kernels<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, k_scale, v_scale, table, pos, items, n_chunk,
      n_decode, out, NT, H, D, BS, WB, scale, int8, splits, stream);
}

// Route 2: chunked_prefill_tc_fwd's arguments and checks with fp32 q and
// out over fp32 pools, or int8 pools with fp32 scales: the chunk items on
// chunked_tf32_kernel (3xTF32), the decode items on the fp32 split walk.
int chunked_prefill_tf32_fwd(const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const void* table,
                             const void* pos, const void* items, int n_chunk,
                             int n_decode, void* out, int NT, int H, int D,
                             int BS, int WB, float scale, int int8,
                             int splits, void* stream) {
  return run_kernels<float, float>(q, k_pool, v_pool, k_scale, v_scale,
                                   table, pos, items, n_chunk, n_decode, out,
                                   NT, H, D, BS, WB, scale, int8, splits,
                                   stream);
}

const char* chunked_prefill_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

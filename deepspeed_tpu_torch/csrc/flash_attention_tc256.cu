// Flash attention forward, dq and dk/dv on Hopper's warpgroup tensor cores
// (wgmma, sm_90a), for bf16 and fp16 with head_dim a multiple of 8 in
// (128, 256].
//
// Replaces, for those types and head dims, three Pallas TPU kernels of
// deepspeed_tpu/ops/transformer/flash_attention.py: _fwd_kernel (the
// forward, pallas_call at :205), _bwd_dq_kernel (dq, :390) and
// _bwd_dkv_kernel (dk and dv, :420). Each computes exactly the function
// that flash_attention.cu's header states (bottom-right causal j <= i +
// Sk - Sq; the key mask multiplying p; lse of the undropped mass; a row
// whose keys are all masked gives o = 0 and lse = m + log(1e-30); the
// dropout keep-mask Drop::keep(i, j) regenerated in registers, never
// stored), through the C interface of flash_attention_tc.cu's forward, dq
// and dk/dv. fp32 at these head dims runs flash_attention_tf32.cu's
// forward and flash_attention.cu's FMA dq and dk/dv.
//
// What bounds it on an H100: at [B, S, H, D] = [4, 512, 8, 256] bf16
// causal the forward must move q, k, v and o, 33.5 MB, 10.0 us at 3.35
// TB/s, against 4.3 GFLOP of products (4.4 us at 989 TFLOP/s); dq moves
// q, k, v, dO and dq, 42 MB, 12.6 us, against 8.6 GFLOP with the split ds
// (8.7 us); dk/dv moves q, k, v, dO, dk and dv, 50 MB, 15.1 us, against
// 8.6 GFLOP (8.7 us). Bytes bound all three; the FMA kernels ran at 66x,
// 75x and 84x those bounds.
//
// Why flash_attention_tc.cu's design does not widen to D = 256: it gives
// each warp 16 rows and keeps the forward's q fragments and o accumulator,
// and dk/dv's two accumulators, in registers: at D = 256 that is 192 and
// 256 registers a thread before s, p or an address (255 at most).
//
// What the design does:
// - products on wgmma: a warpgroup (128 threads) owns 64 rows; s = q.k^T
//   is m64n64k16 with both operands in shared memory (32 accumulator
//   registers a thread); the wide product is m64n256k16 with its 64 x
//   256 fp32 accumulator in 128 registers a thread and A in registers
//   (the "RS" form): p (forward) and p^T, ds^T (dk/dv) go from the s
//   accumulator, packed in pairs, straight into the A fragments, with no
//   trip through shared memory; its B (V, dO or q) is read MN-major
//   through a descriptor. Products of 16-bit inputs are exact in fp32, so
//   s and dp are the TPU kernel's fp32 dots up to the order of the sums;
//   the softmax scale multiplies s in fp32;
// - p and ds are fp32 and are not rounded once to 16 bits: each is split
//   into hi = T(x) and lo = T(x - hi) and multiplied twice (split16,
//   ~2^-17 of its size kept), as flash_attention_tc.cu does, for 1.5x the
//   forward's tensor work (6.5 GFLOP at the shape above, still under the
//   bytes bound at the card's rate);
// - every tile lives in shared memory in wgmma's 128-byte-swizzled layout
//   (64-column blocks of 128-byte rows, a row's 16-byte chunks permuted
//   by its place in its 8-row group), filled by cp.async (16-byte copies;
//   ragged rows and the columns of a head dim padded to 16 zero-filled)
//   and fenced to the async proxy before wgmma reads it; the same layout
//   is a K-major operand (q and k in s, v and dO in dp^T) and an MN-major
//   one (V in p.V, dO in dv, q in dk);
// - dq: a block owns 64 queries, q and dO resident (64 KB); 64-key K and
//   V tiles stream through DQ_STAGES stages (64 KB a stage). s = q.k^T
//   and dp = dO.v^T are the forward's s product (m64n64k16, K-major from
//   shared memory), s scaled in fp32 as the forward scales it, so p =
//   exp2(s scale log2(e) - lse log2(e)) comes from the scores the lse was
//   made of. Its accumulators, 128 (dq) + 32 (s) + 32 (dp) registers a
//   thread on one warpgroup, are split over DQ_WGS = 2: warpgroup 0
//   computes s and p, warpgroup 1 dp; p goes to warpgroup 1 through 16 KB
//   of shared memory, which forms ds = p (D dp - delta) once, splits it
//   into hi / lo A fragments and hands them back in the same 16 KB; each
//   warpgroup then adds ds.K over half of dq's columns (m64n128k16, K
//   read MN-major as the forward reads V), 64 accumulator registers a
//   thread. 208.5 KB of shared memory, one block an SM, 226 registers,
//   no spill. tools/probe_flash_tc256.py timed it at [4, 512, 8, 256]
//   bf16 causal (H100, device time, two chip calls): 0.0503-0.0519 ms,
//   against 0.0573-0.0580 for one warpgroup doing all of it (251
//   registers, no spill), 0.0564-0.0570 for two warpgroups with one K/V
//   stage and 0.0558-0.0563 for one with one stage;
// - the forward: a block of FWD_WGS warpgroups owns FWD_WGS x 64 queries,
//   q resident (64 KB at two warpgroups); 64-key K and V tiles stream
//   through a ring of FWD_STAGES stages (64 KB a stage). At two
//   warpgroups and two stages that is 192 KB; one block an SM. The online
//   softmax runs on the s accumulator (a row lives in the 4 lanes of a
//   quad: max by two shuffles; the row sum stays a per-lane partial until
//   the end); a warpgroup skips the tiles its rows cannot see;
// - dk/dv: a block owns 64 keys, K and V resident (64 KB); 64-query q and
//   dO tiles stream through two stages (128 KB). Its two accumulators, dv
//   and dk, are 256 registers a thread on one warpgroup, so two
//   warpgroups split them: warpgroup 0 computes s^T = k.q^T and owns dv,
//   warpgroup 1 computes dp^T = v.dO^T and owns dk. Warpgroup 0 hands
//   p^T (fp32, undropped) to warpgroup 1 through 16 KB of shared memory
//   (each thread's 32 values to the thread of the same place).
//   tools/probe_flash_tc256.py timed that against warpgroup 1 computing
//   s^T again and against each warpgroup owning half of the head dim of
//   both, and the forward at one and two warpgroups and two and three
//   stages, and picked the design and the constants below;
// - the causal mask is evaluated only on tiles that cross the diagonal or
//   the ragged end; tiles above the diagonal are never loaded. Forward
//   and dq blocks start with the last query tiles (the longest walks),
//   dk/dv blocks with the first key tiles;
// - no atomics: every output element is summed by one thread in a fixed
//   order, so two launches give the same bits; o, dq, dk and dv leave
//   through shared memory in 16-byte stores.

#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "wgmma.cuh"
#include "wgmma_tile.cuh"

namespace {

using attn_tc::quad_max;
using attn_tc::quad_sum;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;
using attn_tile::Drop;
using attn_tile::split16;
using attn_tile::Strides;
using attn_tile::strides_of;
using hopper::fence_acc;
using hopper::fence_proxy_async;
using hopper::fence_regs;
using hopper::smem_u32;
using hopper::wgmma128_rs;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

using wg_tile::BN;                 // rows of a streamed tile
using wg_tile::DMAX;               // the widest head; tiles hold 256 columns
using wg_tile::desc_mn;
using wg_tile::load_tile;
using wg_tile::put_pair;
using wg_tile::ROWB;
using wg_tile::scores;
using wg_tile::store_tile;
using wg_tile::TILE;               // one 64-row tile of 16-bit values
using wg_tile::wide_product;

constexpr int WG = 128;            // threads of a warpgroup
constexpr int BM = 64;             // rows a warpgroup owns
constexpr int SMEM_LIMIT = 232448;   // 227 KB of dynamic shared memory
// tools/probe_flash_tc256.py's picks
constexpr int FWD_WGS = 2;         // consumer warpgroups of a forward block
constexpr int FWD_STAGES = 2;      // the forward's K/V ring
constexpr int DQ_WGS = 2;          // warpgroups over a dq block's 64 rows
constexpr int DQ_STAGES = 2;       // dq's K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// forward: grid (B * H, ceil(Sq / (64 NWG))); the block's query tile is
// counted from the end, so the longest causal walks start first
// ---------------------------------------------------------------------------
template <typename T, int NWG, int STAGES, bool DROP>
__global__ void __launch_bounds__(WG* NWG, 1) flash_fwd_tc256_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ lse, Strides st, int H, int Sq, int Sk, int D,
    float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int NT = WG * NWG;
  constexpr int QROWS = BM * NWG;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* Qs = smem;                          // [QROWS] q; then o
  uint8_t* Ks = Qs + NWG * TILE;               // [STAGES] K tiles
  uint8_t* Vs = Ks + STAGES * TILE;            // [STAGES] V tiles
  float* Ms = reinterpret_cast<float*>(Vs + STAGES * TILE);  // [STAGES][BN]
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();

  const int wg = threadIdx.x / WG;
  const int warp = (threadIdx.x % WG) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qb0 = (gridDim.y - 1 - blockIdx.y) * QROWS;
  const int offset = Sk - Sq;
  const int nq = min(QROWS, Sq - qb0);
  const int dk = (D + 15) & ~15;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * Sk : nullptr;
  const Drop drop(seed, bh, thresh, inv_keep);
  // keys past the reach of the block's last query are visible to no query
  const int k_end = causal ? min(Sk, qb0 + nq + offset) : Sk;
  const int ntiles = (k_end + BN - 1) / BN;
  const float sl = scale * LOG2E;   // s in base-2 units: exp2(s' - m')
  const int q0 = qb0 + wg * BM;     // this warpgroup's first query
  const int i0 = q0 + warp * 16 + g;  // this lane's rows: i0 and i0 + 8
  // keys at or past wg_end are visible to none of this warpgroup's rows
  const int wg_end = q0 >= Sq ? 0 : causal ? min(Sk, q0 + BM + offset) : Sk;

  auto load_kv = [&](int it) {
    const int k0 = it * BN, s = it % STAGES;
    const int valid = min(BN, Sk - k0);
    load_tile(Ks + s * TILE, kb + k0 * st.ks, st.ks, BN, valid, D, dk, NT);
    load_tile(Vs + s * TILE, vb + k0 * st.vs, st.vs, BN, valid, D, dk, NT);
    if (mb && threadIdx.x < BN)
      Ms[s * BN + threadIdx.x] =
          (int)threadIdx.x < valid ? mb[k0 + threadIdx.x] : 0.f;
  };
  load_tile(Qs, q + b * st.qb + h * st.qh + qb0 * st.qs, st.qs, QROWS, nq,
            D, dk, NT);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + STAGES - 1 < ntiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();   // the copies, before wgmma reads them
    __syncthreads();
    const int k0 = it * BN;
    const uint8_t* Kt = Ks + (it % STAGES) * TILE;
    const uint8_t* Vt = Vs + (it % STAGES) * TILE;
    const float* Mt = Ms + (it % STAGES) * BN;
    if (k0 < wg_end) {
      // s = q.k^T (fp32 sums), then scaled in fp32, base-2 units
      float s[32];
      wgmma_fence();
      scores<T>(s, Qs, QROWS, wg * BM, Kt, dk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      const bool edge =
          k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + offset);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * n + e] * sl;
          if (edge) {
            const int j = k0 + 8 * n + 2 * t + (e & 1);
            const int i = e < 2 ? i0 : i0 + 8;
            if (j >= Sk || (causal && j > i + offset)) x = -INFINITY;
          }
          s[4 * n + e] = x;
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
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * n + e];
          const int c = 8 * n + 2 * t + (e & 1);
          float p = x == -INFINITY ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
          if (mb) p *= Mt[c];
          if (e < 2) sum0 += p;   // the normaliser keeps the undropped mass
          else sum1 += p;
          if (DROP) p = drop.apply(p, e < 2 ? i0 : i0 + 8, k0 + c);
          s[4 * n + e] = p;
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
      wide_product<T>(acc, s, Vt);   // o += p.v, p in two 16-bit terms
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // o = acc / max(l, 1e-30) through the q tile's shared memory (each
  // warpgroup's own rows, which only its products read)
  const float ls0 = fmaxf(quad_sum(l0), 1e-30f);
  const float ls1 = fmaxf(quad_sum(l1), 1e-30f);
  const int r0 = wg * BM + warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (8 * i < dk) {
      put_pair<T>(Qs, QROWS, r0, i, t, acc[4 * i] / ls0,
                  acc[4 * i + 1] / ls0);
      put_pair<T>(Qs, QROWS, r0 + 8, i, t, acc[4 * i + 2] / ls1,
                  acc[4 * i + 3] / ls1);
    }
  }
  if (t == 0) {
    if (i0 < Sq) lse[(long long)bh * Sq + i0] = m0 * LN2 + logf(ls0);
    if (i0 + 8 < Sq) lse[(long long)bh * Sq + i0 + 8] = m1 * LN2 + logf(ls1);
  }
  __syncthreads();
  store_tile(out + (((long long)b * Sq + qb0) * H + h) * D, (long long)H * D,
             Qs, QROWS, nq, D, NT);
}

// acc += x B over 64 rows of B (MN-major, the 128 columns at b): x, an
// accumulator of a scores product, already split in the A fragments hi
// and lo; waits for the products
template <typename T>
__device__ __forceinline__ void half_product(float (&acc)[64],
                                             uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4],
                                             const uint8_t* b) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    wgmma128_rs<T>(acc, hi[kc], desc_mn(b, BN, kc), 1);
    wgmma128_rs<T>(acc, lo[kc], desc_mn(b, BN, kc), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    fence_regs(hi[kc]);
    fence_regs(lo[kc]);
  }
}

// ---------------------------------------------------------------------------
// dq: grid (B * H, ceil(Sq / 64)), NWG = 2 warpgroups over the block's 64
// queries (counted from the end, so the longest causal walks start first),
// walking key tiles up to the last key its last query can see: 0 computes
// s and p, 1 dp and ds, and each owns half of dq's columns
// (tools/probe_flash_tc256.py patches in one warpgroup doing all of it).
// ---------------------------------------------------------------------------
template <typename T, int NWG, int STAGES, bool DROP>
__global__ void __launch_bounds__(WG* NWG, 1) flash_bwd_dq_tc256_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq_out, Strides st, int H, int Sq, int Sk, int D,
    float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int NT = WG * NWG;
  constexpr int NB = DMAX / NWG;       // dq columns a warpgroup owns
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* Qs = smem;                  // q, resident; then dq
  uint8_t* Os = Qs + TILE;             // dO, resident
  uint8_t* Ks = Os + TILE;             // [STAGES] K tiles
  uint8_t* Vs = Ks + STAGES * TILE;    // [STAGES] V tiles
  float* Ms = reinterpret_cast<float*>(Vs + STAGES * TILE);  // [STAGES][BN]
  // two warpgroups: [32][WG] words, p (fp32) from warpgroup 0, then ds's
  // hi and lo A fragments from warpgroup 1 (each thread's to the thread
  // of the same place)
  uint32_t* Xs = reinterpret_cast<uint32_t*>(Ms + STAGES * BN);
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();

  const int wg = threadIdx.x / WG;
  const int tw = threadIdx.x % WG;
  const int warp = tw >> 5, lane = threadIdx.x & 31;
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
  // keys past the reach of the block's last query are visible to no query
  const int k_end = causal ? min(Sk, q0 + nq + offset) : Sk;
  const int ntiles = (k_end + BN - 1) / BN;
  const float sl = scale * LOG2E;
  const int i0 = q0 + warp * 16 + g;   // this lane's rows: i0 and i0 + 8
  // lse (base 2) and delta of the lane's rows; rows past Sq read zeros
  // (their q and dO are zero-filled, so their ds is 0; they are not stored)
  const long long at = (long long)bh * Sq;
  const float ls0 = i0 < Sq ? lse[at + i0] * LOG2E : 0.f;
  const float ls1 = i0 + 8 < Sq ? lse[at + i0 + 8] * LOG2E : 0.f;
  const float de0 = i0 < Sq ? delta[at + i0] : 0.f;
  const float de1 = i0 + 8 < Sq ? delta[at + i0 + 8] : 0.f;

  auto load_kv = [&](int it) {
    const int k0 = it * BN, s = it % STAGES;
    const int valid = min(BN, Sk - k0);
    load_tile(Ks + s * TILE, kb + k0 * st.ks, st.ks, BN, valid, D, dk, NT);
    load_tile(Vs + s * TILE, vb + k0 * st.vs, st.vs, BN, valid, D, dk, NT);
    if (mb && threadIdx.x < BN)
      Ms[s * BN + threadIdx.x] =
          (int)threadIdx.x < valid ? mb[k0 + threadIdx.x] : 0.f;
  };
  load_tile(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, BM, nq, D, dk,
            NT);
  load_tile(Os, dout + ((long long)b * Sq + q0) * orow + (long long)h * D,
            orow, BM, nq, D, dk, NT);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_kv(s);
    cp_async_commit();
  }

  float acc[NB / 2];                   // dq, columns wg NB .. wg NB + NB - 1
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + STAGES - 1 < ntiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();   // the copies, before wgmma reads them
    __syncthreads();
    const int k0 = it * BN;
    const uint8_t* Kt = Ks + (it % STAGES) * TILE;
    const uint8_t* Vt = Vs + (it % STAGES) * TILE;
    const float* Mt = Ms + (it % STAGES) * BN;
    const bool edge =
        k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + offset);
    // p = exp2(s scale log2(e) - lse log2(e)) mask_j on the element (n, e)
    // of an accumulator of s (as the forward scales s), 0 where key j is
    // hidden from query i
    auto prob = [&](float sv, int n, int e) {
      const int c = 8 * n + 2 * t + (e & 1);
      const int j = k0 + c;
      const int i = e < 2 ? i0 : i0 + 8;
      const bool vis = !edge || (j < Sk && (!causal || j <= i + offset));
      float p = vis ? exp2f(sv * sl - (e < 2 ? ls0 : ls1)) : 0.f;
      if (mb) p *= Mt[c];
      return p;
    };
    // ds = p (D dp - delta_i)
    auto dsv = [&](float p, float d, int n, int e) {
      if (DROP)
        d = drop.apply(d, e < 2 ? i0 : i0 + 8, k0 + 8 * n + 2 * t + (e & 1));
      return p * (d - (e < 2 ? de0 : de1));
    };

    // warpgroup 0: s = q.k^T, then p; warpgroup 1: dp = dO.v^T
    float x[32];
    wgmma_fence();
    scores<T>(x, wg ? Os : Qs, BM, 0, wg ? Vt : Kt, dk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Xs[(4 * n + e) * WG + tw] = __float_as_uint(prob(x[4 * n + e],
                                                           n, e));
    }
    __syncthreads();   // p handed over
    uint32_t hi[4][4], lo[4][4];
    const T* tag = nullptr;
    if (wg == 1) {
      // ds, split once into hi = T(ds) and lo = T(ds - hi) and handed
      // back in the slots p came in
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * n + e] = dsv(__uint_as_float(Xs[(4 * n + e) * WG + tw]),
                             x[4 * n + e], n, e);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1], hi[kc][r],
                  lo[kc][r], tag);
          Xs[(4 * kc + r) * WG + tw] = hi[kc][r];
          Xs[(16 + 4 * kc + r) * WG + tw] = lo[kc][r];
        }
    }
    __syncthreads();   // ds handed back
    if (wg == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hi[kc][r] = Xs[(4 * kc + r) * WG + tw];
          lo[kc][r] = Xs[(16 + 4 * kc + r) * WG + tw];
        }
    }
    // dq[:, wg NB ..] += ds.k[:, wg NB ..]
    half_product<T>(acc, hi, lo, Kt + wg * (NB / 64) * BN * ROWB);
    __syncthreads();  // this stage (and Xs) consumed before it is refilled
  }

  // dq = scale acc through the q tile's shared memory
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < NB / 8; ++i) {
    const int cc = wg * (NB / 8) + i;   // the 16-byte chunk of the row
    if (8 * cc < dk) {
      put_pair<T>(Qs, BM, r0, cc, t, acc[4 * i] * scale,
                  acc[4 * i + 1] * scale);
      put_pair<T>(Qs, BM, r0 + 8, cc, t, acc[4 * i + 2] * scale,
                  acc[4 * i + 3] * scale);
    }
  }
  __syncthreads();
  store_tile(dq_out + ((long long)b * Sq + q0) * orow + (long long)h * D,
             orow, Qs, BM, nq, D, NT);
}

// ---------------------------------------------------------------------------
// dk and dv: grid (B * H, ceil(Sk / 64)), 256 threads; the block owns 64
// keys and walks query tiles from the first query that can see its first
// key. Warpgroup 0 owns dv, warpgroup 1 dk.
// ---------------------------------------------------------------------------
template <typename T, bool DROP>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dkv_tc256_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk_out, T* __restrict__ dv_out, Strides st, int H,
    int Sq, int Sk, int D, float scale, int causal, uint32_t seed,
    int thresh, float inv_keep) {
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* Ks = smem;                  // K, resident
  uint8_t* Vs = Ks + TILE;             // V, resident
  uint8_t* Qs = Vs + TILE;             // [2] q tiles; then the dk tile
  uint8_t* Os = Qs + 2 * TILE;         // [2] dO tiles; then the dv tile
  float* Ls = reinterpret_cast<float*>(Os + 2 * TILE);  // [2][BN] lse'
  float* Es = Ls + 2 * BN;             // [2][BN] delta
  float* Px = Es + 2 * BN;             // [32][WG] p^T
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();

  const int wg = threadIdx.x / WG;     // 0: s^T and dv; 1: dp^T and dk
  const int tw = threadIdx.x % WG;
  const int warp = tw >> 5, lane = threadIdx.x & 31;
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
  const int it0 = q_first / BN;
  const int ntiles = (Sq + BN - 1) / BN;

  auto load_q = [&](int it) {
    const int q0 = it * BN, s = (it - it0) & 1;
    const int valid = min(BN, Sq - q0);
    load_tile(Qs + s * TILE, qb + q0 * st.qs, st.qs, BN, valid, D, dk, NT);
    load_tile(Os + s * TILE, ob + q0 * orow, orow, BN, valid, D, dk, NT);
    if (threadIdx.x < BN) {
      const bool ok = (int)threadIdx.x < valid;
      const long long at = (long long)bh * Sq + q0 + threadIdx.x;
      Ls[s * BN + threadIdx.x] = ok ? lse[at] * LOG2E : 0.f;
      Es[s * BN + threadIdx.x] = ok ? delta[at] : 0.f;
    }
  };
  load_tile(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BM, nk, D, dk,
            NT);
  load_tile(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BM, nk, D, dk,
            NT);
  load_q(it0);
  cp_async_commit();

  float acc[128];                      // dv (warpgroup 0) or dk (1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int it = it0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int q0 = it * BN, s_ = (it - it0) & 1;
    const uint8_t* Qt = Qs + s_ * TILE;
    const uint8_t* Ot = Os + s_ * TILE;
    const float* Lt = Ls + s_ * BN;
    const float* Et = Es + s_ * BN;
    const bool edge =
        q0 + BN > Sq || (causal && q0 + offset < k0 + BM - 1);
    // p^T = exp(s^T - lse_i) mask_j on the element (n, e) of an
    // accumulator of s^T: the row is the key j, the column the query i
    auto prob = [&](float sv, int n, int e) {
      const int c = 8 * n + 2 * t + (e & 1);
      const int i = q0 + c;
      const int j = e < 2 ? j0 : j0 + 8;
      const bool vis = !edge || (i < Sq && (!causal || j <= i + offset));
      return vis ? exp2f(sv * sl - Lt[c]) * (e < 2 ? km0 : km1) : 0.f;
    };

    // warpgroup 0: s^T = k.q^T; warpgroup 1: dp^T = v.dO^T
    float x[32];
    wgmma_fence();
    scores<T>(x, wg ? Vs : Ks, BM, 0, wg ? Ot : Qt, dk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = prob(x[4 * n + e], n, e);
          Px[(4 * n + e) * WG + tw] = p;
          float pd = p;
          if (DROP)
            pd = drop.apply(p, q0 + 8 * n + 2 * t + (e & 1),
                            e < 2 ? j0 : j0 + 8);   // (query, key)
          x[4 * n + e] = pd;                         // D p^T, for dv
        }
    }
    __syncthreads();   // p^T handed over
    if (wg == 1) {
      // ds^T = p^T (D dp^T - delta_i)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const float p = Px[(4 * n + e) * WG + tw];
          float d = x[4 * n + e];
          if (DROP) d = drop.apply(d, q0 + c, e < 2 ? j0 : j0 + 8);
          x[4 * n + e] = p * (d - Et[c]);
        }
    }
    // dv += (D p^T).dO (warpgroup 0), dk += ds^T.q (warpgroup 1)
    wide_product<T>(acc, x, wg ? Qt : Ot);
    __syncthreads();  // this stage (and Px) consumed before refilled
  }

  // dk (times the softmax scale) and dv through the first stage's q and
  // dO tiles
  uint8_t* tile = wg ? Qs : Os;
  const float mul = wg ? scale : 1.f;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (8 * i < dk) {
      put_pair<T>(tile, BM, r0, i, t, acc[4 * i] * mul,
                  acc[4 * i + 1] * mul);
      put_pair<T>(tile, BM, r0 + 8, i, t, acc[4 * i + 2] * mul,
                  acc[4 * i + 3] * mul);
    }
  }
  __syncthreads();
  const long long off = ((long long)b * Sk + k0) * orow + (long long)h * D;
  store_tile(dk_out + off, orow, Qs, BM, nk, D, NT);
  store_tile(dv_out + off, orow, Os, BM, nk, D, NT);
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

constexpr size_t fwd_smem(int nwg, int stages) {
  return (size_t)(nwg + 2 * stages) * TILE + sizeof(float) * stages * BN;
}
// q and dO resident, STAGES of K and V, the stages' key mask and, at two
// warpgroups, the 16 KB handoff of p and ds
constexpr size_t dq_smem(int nwg, int stages) {
  return (size_t)(2 + 2 * stages) * TILE + sizeof(float) * stages * BN +
         (nwg > 1 ? sizeof(uint32_t) * 32 * WG : 0);
}
constexpr size_t dkv_smem() {
  return (size_t)6 * TILE + sizeof(float) * 4 * BN + sizeof(float) * 32 * WG;
}
static_assert(fwd_smem(FWD_WGS, FWD_STAGES) <= SMEM_LIMIT,
              "the forward's tiles exceed a block's shared memory");
static_assert(dq_smem(DQ_WGS, DQ_STAGES) <= SMEM_LIMIT,
              "dq's tiles exceed a block's shared memory");
static_assert(dkv_smem() <= SMEM_LIMIT,
              "dk/dv's tiles exceed a block's shared memory");

template <typename Fn>
cudaError_t set_smem(Fn fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool DROP>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (w == FWD) {
    constexpr size_t smem = fwd_smem(FWD_WGS, FWD_STAGES);
    auto fn = flash_fwd_tc256_kernel<T, FWD_WGS, FWD_STAGES, DROP>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sq + BM * FWD_WGS - 1) / (BM * FWD_WGS));
    fn<<<grid, WG * FWD_WGS, smem, stream>>>(
        q, k, v, a.mask, static_cast<T*>(a.out), a.lse, a.st, a.H, a.Sq,
        a.Sk, a.D, a.scale, a.causal, a.seed, a.thresh, a.inv_keep);
  } else if (w == DQ) {
    constexpr size_t smem = dq_smem(DQ_WGS, DQ_STAGES);
    auto fn = flash_bwd_dq_tc256_kernel<T, DQ_WGS, DQ_STAGES, DROP>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sq + BM - 1) / BM);
    fn<<<grid, WG * DQ_WGS, smem, stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.mask, a.lse_in, a.delta,
        static_cast<T*>(a.dq), a.st, a.H, a.Sq, a.Sk, a.D, a.scale,
        a.causal, a.seed, a.thresh, a.inv_keep);
  } else {
    constexpr size_t smem = dkv_smem();
    auto fn = flash_bwd_dkv_tc256_kernel<T, DROP>;
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    const dim3 grid(a.B * a.H, (a.Sk + BM - 1) / BM);
    fn<<<grid, 2 * WG, smem, stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.mask, a.lse_in, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st, a.H, a.Sq, a.Sk,
        a.D, a.scale, a.causal, a.seed, a.thresh, a.inv_keep);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_drop(Which w, const Args& a, cudaStream_t stream) {
  // rate 0 (threshold 0, scale 1) is the variant without the hash
  return a.thresh > 0 || a.inv_keep != 1.f ? launch<T, true>(w, a, stream)
                                           : launch<T, false>(w, a, stream);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (a.D <= 128 || a.D > DMAX || a.D % 8 != 0 || a.B < 1 || a.H < 1 ||
      a.Sq < 1 || a.Sk < 1 || (a.causal && a.Sq > a.Sk) || a.thresh < 0 ||
      a.thresh > (1 << 24) ||
      (a.Sq + BM - 1) / BM > 65535 || (a.Sk + BM - 1) / BM > 65535)
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

// The arguments of flash_attention_tc.cu's flash_attention_tc_fwd,
// flash_attention_tc_bwd_dq and flash_attention_tc_bwd_dkv, with dtype 1
// (bfloat16) or 2 (float16) and D a multiple of 8 in (128, 256]. Returns
// cudaGetLastError() after the launch (0 = launched).
int flash_attention_tc256_fwd(const void* q, const void* k, const void* v,
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

int flash_attention_tc256_bwd_dq(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* mask, const float* lse,
                                 const float* delta, void* dq,
                                 const long long* strides, int B, int H,
                                 int Sq, int Sk, int D, float scale,
                                 int causal, uint32_t seed, int thresh,
                                 float inv_keep, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.lse_in = lse;
  a.delta = delta; a.dq = dq; a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(DQ, a, dtype, stream);
}

int flash_attention_tc256_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* mask, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  const long long* strides, int B, int H,
                                  int Sq, int Sk, int D, float scale,
                                  int causal, uint32_t seed, int thresh,
                                  float inv_keep, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.lse_in = lse;
  a.delta = delta; a.dk = dk; a.dv = dv; a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(DKV, a, dtype, stream);
}

const char* flash_attention_tc256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

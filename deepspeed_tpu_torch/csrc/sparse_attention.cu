// Block-sparse attention forward and backward for Hopper (sm_90a), on
// fp32 FMAs.
//
// The first versions of the three Pallas TPU kernels of deepspeed_tpu/
// ops/sparse_attention/sparse_attention.py: _sparse_kernel (forward),
// _sparse_bwd_dq_kernel and _sparse_bwd_dkv_kernel (backward). They run
// on no path: the FMA route (ops/sparse_attention/sparse_attention.py,
// _route) takes only inputs these kernels refuse too. fp32 takes the
// 3xTF32 forward, dq and dk/dv of sparse_attention_tf32.cu; bf16 and
// fp16 take the tensor-core forward, dq and dk/dv of
// sparse_attention_tc.cu at blocks that are multiples of 64 and of
// sparse_attention_tc16.cu at other multiples of 16. chip_smoke.py holds
// and times these beside them on the same inputs. All compute the same
// function. A layout
// [H, NB, NB] of blocks of `block` positions (NB = S / block) says which
// key blocks each query block attends. The host turns it into index lists:
// kv_idx [H, NB, max_kv] with kv_cnt [H, NB] (the active key blocks of
// each query block, ascending) and, for dk/dv, the transposed q_idx / q_cnt.
// For every (batch, head), query i in block qi and key j in block ki:
//
//   visible(i, j) = layout[h, qi, ki] && (!causal || j <= i)
//                   && (!key_mask || key_mask[b, j] > 0)
//   s_ij  = (scale * q_i) . k_j                          (fp32)
//   m_i   = max_{visible j} s_ij,  p_ij = exp(s_ij - m_i) on visible pairs
//   l_i   = sum_j p_ij
//   o_i   = sum_j p_ij v_j / l_i,  lse_i = m_i + log(l_i)
//
// A row with no visible key gets o = 0 and lse = -1e30. Masked pairs are
// selected out (they take no part in the max, the sum or any gradient), as
// the TPU kernel's select to -1e30 makes them; a tile whose pairs are all
// masked leaves the row's state unchanged, so tiles above the causal
// diagonal are skipped outright. The backward recomputes, with delta_i =
// dO_i . o_i computed by the caller and lse clamped at -5e29,
//
//   p_ij  = exp(s_ij - max(lse_i, -5e29)) on visible pairs, 0 elsewhere
//   ds_ij = p_ij (dO_i . v_j - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = sum_i ds_ij (scale * q_i),      dv_j = sum_i p_ij dO_i
//
// What bounds it on an H100: at the long-sequence training shape (B*H =
// 12, S = 16384, D = 64, bf16, BigBird block 256: 2832 active blocks, 5.8%
// of the causal square) the forward must move q, k, v and o, 4 x 25.2 MB,
// 30 us at 3.35 TB/s, and do 41 GFLOP over the visible pairs, 42 us at
// the 989 TFLOP/s of dense bf16: operations bound it. These kernels
// multiply in fp32 FMAs (67 TFLOP/s), as the TPU kernels do, so they are
// bound by the FMA rate.
//
// What the design does (the flash kernels of flash_attention.cu, walking
// a list of blocks instead of every block):
// - a thread block owns a tile of TILE query rows (fwd, dq) or key rows
//   (dk/dv) inside one layout block, and streams the other axis through
//   shared memory in tiles of TILE rows, only over the blocks its layout
//   row (or column) lists, with a trip count of its own: a query row that
//   sees 3 blocks does not wait for the densest row. TILE is 64 when the
//   layout block is a multiple of 64, else 32 or 16, so a tile never
//   straddles two layout rows whose lists differ;
// - no atomics, and every output element is summed by one thread in a
//   fixed order: dk/dv walk the transposed lists, so the key blocks of a
//   global column (attended by every query block) make the longest walk
//   and are the critical path of that kernel;
// - q, k and v are read through their [B, S, H, D] strides (views of the
//   fused QKV projection, no transpose copy), 16-byte vector loads.
//
// Layout of a block (THREADS = 256 threads): the TILE rows it owns get
// LPR = 256 / TILE neighbouring lanes each; a row's lanes split the
// streamed tile's scores (lane g takes columns g, g + LPR, ...), reduce
// with shuffles, and split the D output columns (float4 slices g,
// g + LPR, ...).

#include <math.h>

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

constexpr float NEG_INF = -1e30f;  // lse of a row with no visible key
constexpr float LSE_FLOOR = -5e29f;

// ---------------------------------------------------------------------------
// forward: grid (S / TILE, B * H)
// ---------------------------------------------------------------------------
template <typename T, int DMAX, int TILE>
__global__ void __launch_bounds__(THREADS) sparse_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const int* __restrict__ kv_idx,
    const int* __restrict__ kv_cnt, int max_kv, T* __restrict__ out,
    float* __restrict__ lse, Strides st, int H, int S, int D, int block,
    float scale, int causal) {
  constexpr int LPR = THREADS / TILE;   // lanes per row
  constexpr int DP = DMAX + 4;          // padded row: no bank conflicts
  constexpr int NS = TILE / LPR;        // scores per lane per tile
  constexpr int NV = DMAX / (4 * LPR);  // float4 output slices per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [TILE][DP] scale * q
  float* Ks = Qs + TILE * DP;           // [TILE][DP]
  float* Vs = Ks + TILE * DP;           // [TILE][DP]
  float* Ps = Vs + TILE * DP;           // [TILE][TILE + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * TILE;
  const int nb = S / block;
  const long long row = (long long)h * nb + q0 / block;
  const int r = threadIdx.x / LPR;
  const int g = threadIdx.x % LPR;
  const int i = q0 + r;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const int* list = kv_idx + row * max_kv;
  const int cnt = kv_cnt[row];

  load_tile<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, TILE,
                   TILE, D, scale);

  float m = -INFINITY, l = 0.f;
  float4 acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qr = Qs + r * DP;
  float* pr = Ps + r * (TILE + 1);

  for (int n = 0; n < cnt; ++n) {
    const int kbeg = list[n] * block;
    for (int k0 = kbeg; k0 < kbeg + block; k0 += TILE) {
      if (causal && k0 > q0 + TILE - 1) break;  // above the diagonal
      __syncthreads();  // the previous tile is consumed
      load_tile<T, DP>(Ks, kb + k0 * st.ks, st.ks, TILE, TILE, D, 1.f);
      load_tile<T, DP>(Vs, vb + k0 * st.vs, st.vs, TILE, TILE, D, 1.f);
      __syncthreads();

      float s[NS];
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) s[jj] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
        for (int jj = 0; jj < NS; ++jj)
          s[jj] += dot4(qa, *reinterpret_cast<const float4*>(
                                Ks + (g + LPR * jj) * DP + d));
      }
      float mt = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int j = k0 + g + LPR * jj;
        const bool vis = (!causal || j <= i) && (!mb || mb[j] > 0.f);
        s[jj] = vis ? s[jj] : -INFINITY;
        mt = fmaxf(mt, s[jj]);
      }
      const float m_new = fmaxf(m, row_max<LPR>(mt));
      float alpha = 1.f, sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const float p = s[jj] != -INFINITY ? expf(s[jj] - m_new) : 0.f;
        pr[g + LPR * jj] = p;
        sum += p;
      }
      if (m_new != -INFINITY) alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
      l = l * alpha + row_sum<LPR>(sum);
      m = m_new;
      __syncwarp();  // the row's lanes wrote pr; the same lanes read it

#pragma unroll
      for (int e = 0; e < NV; ++e) {
        acc[e].x *= alpha; acc[e].y *= alpha;
        acc[e].z *= alpha; acc[e].w *= alpha;
      }
      for (int c = 0; c < TILE; ++c) {
        const float p = pr[c];
        const float* vr = Vs + c * DP;
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          const int d = 4 * (g + LPR * e);
          if (d < D) fma4(acc[e], p, *reinterpret_cast<const float4*>(vr + d));
        }
      }
    }
  }

  const bool seen = l > 0.f;
  const float inv = seen ? 1.f / l : 0.f;
  T* orow = out + (((long long)b * S + i) * H + h) * D;
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    const int d = 4 * (g + LPR * e);
    if (d < D)
      store4(orow + d, make_float4(acc[e].x * inv, acc[e].y * inv,
                                   acc[e].z * inv, acc[e].w * inv));
  }
  if (g == 0) lse[(long long)bh * S + i] = seen ? m + logf(l) : NEG_INF;
}

// ---------------------------------------------------------------------------
// backward, dq: grid (S / TILE, B * H). dout is contiguous [B, S, H, D];
// lse and delta [B * H, S].
// ---------------------------------------------------------------------------
template <typename T, int DMAX, int TILE>
__global__ void __launch_bounds__(THREADS) sparse_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const int* __restrict__ kv_idx, const int* __restrict__ kv_cnt,
    int max_kv, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Strides st, int H,
    int S, int D, int block, float scale, int causal) {
  constexpr int LPR = THREADS / TILE;
  constexpr int DP = DMAX + 4;
  constexpr int NS = TILE / LPR;
  constexpr int NV = DMAX / (4 * LPR);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // [TILE][DP] scale * q
  float* Os = Qs + TILE * DP;           // [TILE][DP] dout
  float* Ks = Os + TILE * DP;           // [TILE][DP]
  float* Vs = Ks + TILE * DP;           // [TILE][DP]
  float* Ps = Vs + TILE * DP;           // [TILE][TILE + 1] ds

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * TILE;
  const int nb = S / block;
  const long long row = (long long)h * nb + q0 / block;
  const int r = threadIdx.x / LPR;
  const int g = threadIdx.x % LPR;
  const int i = q0 + r;
  const long long orow_stride = (long long)H * D;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * S : nullptr;
  const int* list = kv_idx + row * max_kv;
  const int cnt = kv_cnt[row];

  load_tile<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, TILE,
                   TILE, D, scale);
  load_tile<T, DP>(Os, dout + ((long long)b * S + q0) * orow_stride +
                           (long long)h * D,
                   orow_stride, TILE, TILE, D, 1.f);
  const float lse_i = fmaxf(lse[(long long)bh * S + i], LSE_FLOOR);
  const float delta_i = delta[(long long)bh * S + i];

  float4 acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qr = Qs + r * DP;
  const float* dor = Os + r * DP;
  float* pr = Ps + r * (TILE + 1);

  for (int n = 0; n < cnt; ++n) {
    const int kbeg = list[n] * block;
    for (int k0 = kbeg; k0 < kbeg + block; k0 += TILE) {
      if (causal && k0 > q0 + TILE - 1) break;
      __syncthreads();
      load_tile<T, DP>(Ks, kb + k0 * st.ks, st.ks, TILE, TILE, D, 1.f);
      load_tile<T, DP>(Vs, vb + k0 * st.vs, st.vs, TILE, TILE, D, 1.f);
      __syncthreads();

      float s[NS], dp[NS];
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) s[jj] = dp[jj] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qr + d);
        const float4 oa = *reinterpret_cast<const float4*>(dor + d);
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          const int c = g + LPR * jj;
          s[jj] += dot4(qa, *reinterpret_cast<const float4*>(Ks + c * DP + d));
          dp[jj] += dot4(oa, *reinterpret_cast<const float4*>(Vs + c * DP + d));
        }
      }
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int j = k0 + g + LPR * jj;
        const bool vis = (!causal || j <= i) && (!mb || mb[j] > 0.f);
        pr[g + LPR * jj] = vis ? expf(s[jj] - lse_i) * (dp[jj] - delta_i)
                               : 0.f;
      }
      __syncwarp();

      for (int c = 0; c < TILE; ++c) {
        const float ds = pr[c];
        const float* kr = Ks + c * DP;
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          const int d = 4 * (g + LPR * e);
          if (d < D) fma4(acc[e], ds, *reinterpret_cast<const float4*>(kr + d));
        }
      }
    }
  }

  T* drow = dq + ((long long)b * S + i) * orow_stride + (long long)h * D;
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    const int d = 4 * (g + LPR * e);
    if (d < D)
      store4(drow + d, make_float4(acc[e].x * scale, acc[e].y * scale,
                                   acc[e].z * scale, acc[e].w * scale));
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: grid (S / TILE, B * H), over the transposed lists
// ---------------------------------------------------------------------------
template <typename T, int DMAX, int TILE>
__global__ void __launch_bounds__(THREADS) sparse_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const int* __restrict__ q_idx, const int* __restrict__ q_cnt, int max_q,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, Strides st, int H, int S, int D,
    int block, float scale, int causal) {
  constexpr int LPR = THREADS / TILE;
  constexpr int DP = DMAX + 4;
  constexpr int NS = TILE / LPR;
  constexpr int NV = DMAX / (4 * LPR);
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                     // [TILE][DP]
  float* Vs = Ks + TILE * DP;           // [TILE][DP]
  float* Qs = Vs + TILE * DP;           // [TILE][DP] scale * q
  float* Os = Qs + TILE * DP;           // [TILE][DP] dout
  float* Ps = Os + TILE * DP;           // [TILE][TILE + 1] p
  float* Ds = Ps + TILE * (TILE + 1);   // [TILE][TILE + 1] ds
  float* Ls = Ds + TILE * (TILE + 1);   // [TILE] clamped lse
  float* Es = Ls + TILE;                // [TILE] delta

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * TILE;
  const int nb = S / block;
  const long long col = (long long)h * nb + k0 / block;
  const int c = threadIdx.x / LPR;
  const int g = threadIdx.x % LPR;
  const int j = k0 + c;
  const long long orow_stride = (long long)H * D;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + (long long)b * S * orow_stride + (long long)h * D;
  const bool kept = !mask || mask[(long long)b * S + j] > 0.f;
  const int* list = q_idx + col * max_q;
  const int cnt = q_cnt[col];

  load_tile<T, DP>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, TILE,
                   TILE, D, 1.f);
  load_tile<T, DP>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, TILE,
                   TILE, D, 1.f);

  float4 dka[NV], dva[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    dka[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* kr = Ks + c * DP;
  const float* vr = Vs + c * DP;
  float* pr = Ps + c * (TILE + 1);
  float* dr = Ds + c * (TILE + 1);

  for (int n = 0; n < cnt; ++n) {
    const int qbeg = list[n] * block;
    for (int q0 = qbeg; q0 < qbeg + block; q0 += TILE) {
      if (causal && q0 + TILE - 1 < k0) continue;  // sees none of the keys
      __syncthreads();
      load_tile<T, DP>(Qs, qb + q0 * st.qs, st.qs, TILE, TILE, D, scale);
      load_tile<T, DP>(Os, ob + q0 * orow_stride, orow_stride, TILE, TILE, D,
                       1.f);
      for (int t = threadIdx.x; t < TILE; t += THREADS) {
        Ls[t] = fmaxf(lse[(long long)bh * S + q0 + t], LSE_FLOOR);
        Es[t] = delta[(long long)bh * S + q0 + t];
      }
      __syncthreads();

      float s[NS], dp[NS];
#pragma unroll
      for (int ii = 0; ii < NS; ++ii) s[ii] = dp[ii] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(kr + d);
        const float4 va = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
        for (int ii = 0; ii < NS; ++ii) {
          const int rr = g + LPR * ii;
          s[ii] += dot4(*reinterpret_cast<const float4*>(Qs + rr * DP + d), ka);
          dp[ii] += dot4(*reinterpret_cast<const float4*>(Os + rr * DP + d), va);
        }
      }
#pragma unroll
      for (int ii = 0; ii < NS; ++ii) {
        const int rr = g + LPR * ii;
        const bool vis = kept && (!causal || j <= q0 + rr);
        float p = 0.f, ds = 0.f;
        if (vis) {
          p = expf(s[ii] - Ls[rr]);
          ds = p * (dp[ii] - Es[rr]);
        }
        pr[rr] = p;
        dr[rr] = ds;
      }
      __syncwarp();

      for (int rr = 0; rr < TILE; ++rr) {
        const float p = pr[rr];
        const float ds = dr[rr];
        const float* qrow = Qs + rr * DP;
        const float* orow = Os + rr * DP;
#pragma unroll
        for (int e = 0; e < NV; ++e) {
          const int d = 4 * (g + LPR * e);
          if (d < D) {
            fma4(dva[e], p, *reinterpret_cast<const float4*>(orow + d));
            fma4(dka[e], ds, *reinterpret_cast<const float4*>(qrow + d));
          }
        }
      }
    }
  }

  const long long off = ((long long)b * S + j) * orow_stride +
                        (long long)h * D;
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    const int d = 4 * (g + LPR * e);
    if (d < D) {
      store4(dk + off + d, dka[e]);
      store4(dv + off + d, dva[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <int DMAX, int TILE>
constexpr size_t smem_bytes(Which w) {
  return sizeof(float) *
         (w == FWD ? (size_t)3 * TILE * (DMAX + 4) + TILE * (TILE + 1)
          : w == DQ ? (size_t)4 * TILE * (DMAX + 4) + TILE * (TILE + 1)
                    : (size_t)4 * TILE * (DMAX + 4) +
                          2 * TILE * (TILE + 1) + 2 * TILE);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *mask, *lse_in, *delta;
  const int *idx, *cnt;
  int max_idx;
  void *out, *dq, *dk, *dv;
  float* lse;
  Strides st;
  int B, H, S, D, block;
  float scale;
  int causal;
};

template <typename T, int DMAX, int TILE>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX, TILE>(w);
  const dim3 grid(a.S / TILE, a.B * a.H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (w == FWD) {
    auto fn = sparse_fwd_kernel<T, DMAX, TILE>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<grid, THREADS, smem, stream>>>(
        q, k, v, a.mask, a.idx, a.cnt, a.max_idx, static_cast<T*>(a.out),
        a.lse, a.st, a.H, a.S, a.D, a.block, a.scale, a.causal);
  } else if (w == DQ) {
    auto fn = sparse_bwd_dq_kernel<T, DMAX, TILE>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.mask, a.idx, a.cnt, a.max_idx, a.lse_in, a.delta,
        static_cast<T*>(a.dq), a.st, a.H, a.S, a.D, a.block, a.scale,
        a.causal);
  } else {
    auto fn = sparse_bwd_dkv_kernel<T, DMAX, TILE>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, a.mask, a.idx, a.cnt, a.max_idx, a.lse_in, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st, a.H, a.S, a.D,
        a.block, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t dispatch_tile(Which w, const Args& a, cudaStream_t stream) {
  if (a.block % 64 == 0) return launch<T, DMAX, 64>(w, a, stream);
  if (a.block % 32 == 0) return launch<T, DMAX, 32>(w, a, stream);
  return launch<T, DMAX, 16>(w, a, stream);
}

template <typename T>
cudaError_t dispatch_d(Which w, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return dispatch_tile<T, 64>(w, a, stream);
  return dispatch_tile<T, 128>(w, a, stream);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (a.D < 8 || a.D > 128 || a.D % 8 != 0 || a.B < 1 || a.H < 1 ||
      a.block < 16 || a.block % 16 != 0 || a.S < a.block ||
      a.S % a.block != 0 || a.max_idx < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = dispatch_d<float>(w, a, st);
  else if (dtype == 1) err = dispatch_d<__nv_bfloat16>(w, a, st);
  else if (dtype == 2) err = dispatch_d<__half>(w, a, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 9 host int64s,
// the batch, sequence and head strides of q, k and v in elements (the head
// dim is contiguous). mask: [B, S] fp32 (> 0 = keep), or null. kv_idx:
// int32 [H, S / block, max_kv], kv_cnt: int32 [H, S / block]. out:
// contiguous [B, S, H, D]; lse: [B * H, S] fp32. Every call returns
// cudaGetLastError() after its launch (0 = launched). The Python wrapper
// checks shapes, dtypes and 16-byte alignment.
int sparse_attention_fwd(const void* q, const void* k, const void* v,
                         const float* mask, const int* kv_idx,
                         const int* kv_cnt, int max_kv, void* out, float* lse,
                         const long long* strides, int B, int H, int S, int D,
                         int block, float scale, int causal, int dtype,
                         void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.idx = kv_idx; a.cnt = kv_cnt;
  a.max_idx = max_kv; a.out = out; a.lse = lse; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal;
  return run(FWD, a, dtype, stream);
}

// dout: contiguous [B, S, H, D]; lse, delta: [B * H, S] fp32; dq:
// contiguous [B, S, H, D].
int sparse_attention_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* mask,
                            const int* kv_idx, const int* kv_cnt, int max_kv,
                            const float* lse, const float* delta, void* dq,
                            const long long* strides, int B, int H, int S,
                            int D, int block, float scale, int causal,
                            int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.idx = kv_idx;
  a.cnt = kv_cnt; a.max_idx = max_kv; a.lse_in = lse; a.delta = delta;
  a.dq = dq; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal;
  return run(DQ, a, dtype, stream);
}

// q_idx: int32 [H, S / block, max_q] (the transposed layout's lists),
// q_cnt: int32 [H, S / block]. dk, dv: contiguous [B, S, H, D].
int sparse_attention_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* mask,
                             const int* q_idx, const int* q_cnt, int max_q,
                             const float* lse, const float* delta, void* dk,
                             void* dv, const long long* strides, int B, int H,
                             int S, int D, int block, float scale, int causal,
                             int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.idx = q_idx;
  a.cnt = q_cnt; a.max_idx = max_q; a.lse_in = lse; a.delta = delta;
  a.dk = dk; a.dv = dv; a.st = strides_of(strides);
  a.B = B; a.H = H; a.S = S; a.D = D; a.block = block; a.scale = scale;
  a.causal = causal;
  return run(DKV, a, dtype, stream);
}

const char* sparse_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

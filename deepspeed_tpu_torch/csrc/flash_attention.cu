// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of deepspeed_tpu/ops/transformer/
// flash_attention.py: _fwd_kernel (forward), _bwd_dq_kernel and
// _bwd_dkv_kernel (backward). For every (batch, head), query i and key j:
//
//   visible(i, j) = !causal || j <= i + (Sk - Sq)       (bottom-right causal)
//   s_ij  = (scale * q_i) . k_j                          (fp32)
//   m_i   = max_{visible j} s_ij      (keys masked by kv_mask included)
//   p_ij  = exp(s_ij - m_i) * kv_mask_j                  (the mask multiplies p)
//   l_i   = sum_j p_ij
//   o_i   = sum_j p_ij v_j / max(l_i, 1e-30)
//   lse_i = m_i + log(max(l_i, 1e-30))
//
// and, with delta_i = dO_i . o_i computed by the caller,
//
//   p_ij  = exp(s_ij - lse_i) * kv_mask_j,  dp_ij = dO_i . v_j
//   ds_ij = p_ij (dp_ij - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j
//   dk_j  = sum_i ds_ij (scale * q_i),      dv_j = sum_i p_ij dO_i
//
// A row whose keys are all masked gets o = 0 and lse = m + log(1e-30), and
// contributes nothing to any gradient, as in the TPU kernel.
//
// Attention dropout (the dropout branch of the three TPU kernels): with
// keep_ij the counter hash of (seed, b * H + h, i, j) (Drop::keep in
// attention_tile.cuh, the bits of the JAX dropout_keep_mask) and r = 1 /
// (1 - rate),
//
//   o_i   = sum_j D_ij p_ij v_j / max(l_i, 1e-30),  D_ij = keep_ij ? r : 0
//           (l_i and lse_i keep the full, undropped mass)
//   ds_ij = p_ij (D_ij dp_ij - delta_i),            dv_j = sum_i D_ij p_ij dO_i
//
// The host computes the seed, the integer threshold and r (in fp32), and
// the kernels regenerate the mask from absolute (row, col) in every pass:
// no mask is stored. Each kernel is compiled twice; rate 0 runs the
// variant without the hash.
//
// What bounds it on an H100: at the training shape (B*H = 192, S = 512,
// D = 64, bf16, causal) the forward must move q, k, v and o, 4 x 12.6 MB,
// about 15 us at 3.35 TB/s, and do 6.4 GFLOP, 6.5 us at the 989 TFLOP/s of
// dense bf16 on the tensor cores: bytes bound it. These kernels do their
// products as fp32 FMAs (67 TFLOP/s), as the TPU kernel multiplies in
// fp32, so they are bound by the FMA rate, about 0.1 ms for the forward.
// No route runs them: flash_attention_tc.cu holds the tensor-core
// forward, dq and dk/dv that take bf16 and fp16 up to D = 128,
// flash_attention_tc256.cu the wgmma forward, dq and dk/dv that take them
// in (128, 256], and flash_attention_tf32.cu the 3xTF32 forward, dq and
// dk/dv that take fp32 up to D = 256. They stay as those kernels' first
// versions, which chip_smoke.py holds and times on the same inputs.
//
// What the design does:
// - every kernel streams one axis in tiles through shared memory and keeps
//   its output tile in registers: the [S, S] scores never reach device
//   memory; the forward writes only o and lse;
// - tiles above the causal diagonal are never loaded (the forward and dq
//   stop at the last key the tile's last query can see, dkv starts at the
//   first query that can see the tile's first key);
// - the backward is two kernels with no atomics: dq walks key tiles for a
//   tile of queries, dkv walks query tiles for a tile of keys, so every
//   output element is summed by one thread in a fixed order and the
//   backward is deterministic;
// - q, k and v are read through their [B, S, H, D] strides (a view of the
//   fused QKV projection is read in place, with no transpose copy);
//   16-byte vector loads of 8 elements, converted to fp32 in shared memory.
//
// Layout of a block (THREADS = 256 threads): the 64 rows of the tile a
// block owns (queries for fwd/dq, keys for dkv) get 4 neighbouring lanes
// each. The streamed tile has BC rows; a row's 4 lanes split its BC scores
// (lane g takes columns g, g + 4, ...), reduce with shuffles, and split the
// D output columns (lane g takes float4 slices g, g + 4, ...).

#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using namespace attn_tile;

constexpr int ROWS = 64;              // rows of the tile a block owns
constexpr int LPR = THREADS / ROWS;   // lanes per row

// ---------------------------------------------------------------------------
// forward: grid (ceil(Sq / ROWS), B * H)
// ---------------------------------------------------------------------------
template <typename T, int DMAX, int BC, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out,
    float* __restrict__ lse, Strides st, int H, int Sq, int Sk, int D,
    float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int DP = DMAX + 4;      // padded row: 16-byte rows, no conflicts
  constexpr int NS = BC / LPR;      // scores per lane per tile
  constexpr int NV = DMAX / (4 * LPR);  // float4 output slices per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [ROWS][DP] scale * q
  float* Ks = Qs + ROWS * DP;       // [BC][DP]
  float* Vs = Ks + BC * DP;         // [BC][DP]
  float* Ps = Vs + BC * DP;         // [ROWS][BC + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * ROWS;
  const int r = threadIdx.x / LPR;
  const int g = threadIdx.x % LPR;
  const int i = q0 + r;
  const int offset = Sk - Sq;
  const int nq = min(ROWS, Sq - q0);
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * Sk : nullptr;
  const Drop drop(seed, bh, thresh, inv_keep);

  load_tile<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, ROWS,
                   nq, D, scale);
  // keys past the reach of the tile's last query are visible to no query
  const int k_end = causal ? min(Sk, q0 + nq + offset) : Sk;

  float m = -INFINITY, l = 0.f;
  float4 acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qr = Qs + r * DP;
  float* pr = Ps + r * (BC + 1);

  for (int k0 = 0; k0 < k_end; k0 += BC) {
    const int nk = min(BC, Sk - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile<T, DP>(Ks, kb + k0 * st.ks, st.ks, BC, nk, D, 1.f);
    load_tile<T, DP>(Vs, vb + k0 * st.vs, st.vs, BC, nk, D, 1.f);
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
      const bool vis = j < Sk && (!causal || j <= i + offset);
      s[jj] = vis ? s[jj] : -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    const float m_new = fmaxf(m, row_max<LPR>(mt));
    float alpha = 1.f, sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int j = k0 + g + LPR * jj;
      float p = 0.f;
      if (s[jj] != -INFINITY) {
        p = expf(s[jj] - m_new);
        if (mb) p *= mb[j];
      }
      sum += p;  // the normaliser keeps the undropped mass
      pr[g + LPR * jj] = DROP ? drop.apply(p, i, j) : p;
    }
    if (m_new != -INFINITY) alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    l = l * alpha + row_sum<LPR>(sum);
    m = m_new;
    __syncwarp();  // the row's 4 lanes wrote pr; the same lanes read it

#pragma unroll
    for (int e = 0; e < NV; ++e) {
      acc[e].x *= alpha; acc[e].y *= alpha;
      acc[e].z *= alpha; acc[e].w *= alpha;
    }
    for (int c = 0; c < nk; ++c) {
      const float p = pr[c];
      const float* vr = Vs + c * DP;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int d = 4 * (g + LPR * e);
        if (d < D) fma4(acc[e], p, *reinterpret_cast<const float4*>(vr + d));
      }
    }
  }

  if (i < Sq) {
    const float ls = fmaxf(l, 1e-30f);
    T* orow = out + (((long long)b * Sq + i) * H + h) * D;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int d = 4 * (g + LPR * e);
      if (d < D)
        store4(orow + d, make_float4(acc[e].x / ls, acc[e].y / ls,
                                     acc[e].z / ls, acc[e].w / ls));
    }
    if (g == 0) lse[(long long)bh * Sq + i] = m + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// backward, dq: grid (ceil(Sq / ROWS), B * H). dout is contiguous
// [B, Sq, H, D]; lse and delta [B * H, Sq].
// ---------------------------------------------------------------------------
template <typename T, int DMAX, int BC, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, Strides st, int H, int Sq, int Sk, int D, float scale,
    int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int DP = DMAX + 4;
  constexpr int NS = BC / LPR;
  constexpr int NV = DMAX / (4 * LPR);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [ROWS][DP] scale * q
  float* Os = Qs + ROWS * DP;       // [ROWS][DP] dout
  float* Ks = Os + ROWS * DP;       // [BC][DP]
  float* Vs = Ks + BC * DP;         // [BC][DP]
  float* Ps = Vs + BC * DP;         // [ROWS][BC + 1] ds

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * ROWS;
  const int r = threadIdx.x / LPR;
  const int g = threadIdx.x % LPR;
  const int i = q0 + r;
  const int offset = Sk - Sq;
  const int nq = min(ROWS, Sq - q0);
  const long long orow_stride = (long long)H * D;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* mb = mask ? mask + (long long)b * Sk : nullptr;
  const Drop drop(seed, bh, thresh, inv_keep);

  load_tile<T, DP>(Qs, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, ROWS,
                   nq, D, scale);
  load_tile<T, DP>(Os, dout + ((long long)b * Sq + q0) * orow_stride +
                           (long long)h * D,
                   orow_stride, ROWS, nq, D, 1.f);
  const float lse_i = i < Sq ? lse[(long long)bh * Sq + i] : 0.f;
  const float delta_i = i < Sq ? delta[(long long)bh * Sq + i] : 0.f;
  const int k_end = causal ? min(Sk, q0 + nq + offset) : Sk;

  float4 acc[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qr = Qs + r * DP;
  const float* dor = Os + r * DP;
  float* pr = Ps + r * (BC + 1);

  for (int k0 = 0; k0 < k_end; k0 += BC) {
    const int nk = min(BC, Sk - k0);
    __syncthreads();
    load_tile<T, DP>(Ks, kb + k0 * st.ks, st.ks, BC, nk, D, 1.f);
    load_tile<T, DP>(Vs, vb + k0 * st.vs, st.vs, BC, nk, D, 1.f);
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
      const bool vis = i < Sq && j < Sk && (!causal || j <= i + offset);
      float ds = 0.f;
      if (vis) {
        float p = expf(s[jj] - lse_i);
        if (mb) p *= mb[j];
        ds = p * ((DROP ? drop.apply(dp[jj], i, j) : dp[jj]) - delta_i);
      }
      pr[g + LPR * jj] = ds;
    }
    __syncwarp();

    for (int c = 0; c < nk; ++c) {
      const float ds = pr[c];
      const float* kr = Ks + c * DP;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        const int d = 4 * (g + LPR * e);
        if (d < D) fma4(acc[e], ds, *reinterpret_cast<const float4*>(kr + d));
      }
    }
  }

  if (i < Sq) {
    T* row = dq + ((long long)b * Sq + i) * orow_stride + (long long)h * D;
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int d = 4 * (g + LPR * e);
      if (d < D)
        store4(row + d, make_float4(acc[e].x * scale, acc[e].y * scale,
                                    acc[e].z * scale, acc[e].w * scale));
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: grid (ceil(Sk / ROWS), B * H)
// ---------------------------------------------------------------------------
template <typename T, int DMAX, int BC, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, Strides st, int H, int Sq, int Sk,
    int D, float scale, int causal, uint32_t seed, int thresh,
    float inv_keep) {
  constexpr int DP = DMAX + 4;
  constexpr int NS = BC / LPR;
  constexpr int NV = DMAX / (4 * LPR);
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [ROWS][DP]
  float* Vs = Ks + ROWS * DP;       // [ROWS][DP]
  float* Qs = Vs + ROWS * DP;       // [BC][DP] scale * q
  float* Os = Qs + BC * DP;         // [BC][DP] dout
  float* Ps = Os + BC * DP;         // [ROWS][BC + 1] p
  float* Ds = Ps + ROWS * (BC + 1); // [ROWS][BC + 1] ds
  float* Ls = Ds + ROWS * (BC + 1); // [BC] lse
  float* Es = Ls + BC;              // [BC] delta

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * ROWS;
  const int c = threadIdx.x / LPR;
  const int g = threadIdx.x % LPR;
  const int j = k0 + c;
  const int offset = Sk - Sq;
  const int nk = min(ROWS, Sk - k0);
  const long long orow_stride = (long long)H * D;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + (long long)b * Sq * orow_stride + (long long)h * D;
  const float km = (mask && j < Sk) ? mask[(long long)b * Sk + j] : 1.f;
  const Drop drop(seed, bh, thresh, inv_keep);

  load_tile<T, DP>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, ROWS,
                   nk, D, 1.f);
  load_tile<T, DP>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, ROWS,
                   nk, D, 1.f);
  // the first query that can see the tile's first key
  const int q_first = causal ? max(0, k0 - offset) : 0;

  float4 dka[NV], dva[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    dka[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* kr = Ks + c * DP;
  const float* vr = Vs + c * DP;
  float* pr = Ps + c * (BC + 1);
  float* dr = Ds + c * (BC + 1);

  for (int q0 = (q_first / BC) * BC; q0 < Sq; q0 += BC) {
    const int nq = min(BC, Sq - q0);
    __syncthreads();
    load_tile<T, DP>(Qs, qb + q0 * st.qs, st.qs, BC, nq, D, scale);
    load_tile<T, DP>(Os, ob + q0 * orow_stride, orow_stride, BC, nq, D, 1.f);
    for (int t = threadIdx.x; t < BC; t += THREADS) {
      Ls[t] = t < nq ? lse[(long long)bh * Sq + q0 + t] : 0.f;
      Es[t] = t < nq ? delta[(long long)bh * Sq + q0 + t] : 0.f;
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
      const int i = q0 + rr;
      const bool vis = rr < nq && j < Sk && (!causal || j <= i + offset);
      float p = 0.f, ds = 0.f;
      if (vis) {
        p = expf(s[ii] - Ls[rr]) * km;
        if (DROP) {
          const bool kp = drop.keep(i, j);
          ds = p * ((kp ? dp[ii] * drop.inv_keep : 0.f) - Es[rr]);
          p = kp ? p * drop.inv_keep : 0.f;  // dv sums the dropped p
        } else {
          ds = p * (dp[ii] - Es[rr]);
        }
      }
      pr[rr] = p;
      dr[rr] = ds;
    }
    __syncwarp();

    for (int rr = 0; rr < nq; ++rr) {
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

  if (j < Sk) {
    const long long off = ((long long)b * Sk + j) * orow_stride +
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
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <int DMAX, int BC>
constexpr size_t smem_bytes(Which w) {
  return sizeof(float) *
         (w == FWD ? (size_t)(ROWS + 2 * BC) * (DMAX + 4) + ROWS * (BC + 1)
          : w == DQ ? (size_t)(2 * ROWS + 2 * BC) * (DMAX + 4) +
                          ROWS * (BC + 1)
                    : (size_t)(2 * ROWS + 2 * BC) * (DMAX + 4) +
                          2 * ROWS * (BC + 1) + 2 * BC);
}

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

template <typename T, int DMAX, int BC, bool DROP>
cudaError_t launch(Which w, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX, BC>(w);
  const int rows = w == DKV ? a.Sk : a.Sq;  // the axis the blocks split
  const dim3 grid((rows + ROWS - 1) / ROWS, a.B * a.H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (w == FWD) {
    auto fn = flash_fwd_kernel<T, DMAX, BC, DROP>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<grid, THREADS, smem, stream>>>(q, k, v, a.mask, static_cast<T*>(a.out),
                                        a.lse, a.st, a.H, a.Sq, a.Sk, a.D,
                                        a.scale, a.causal, a.seed, a.thresh,
                                        a.inv_keep);
  } else if (w == DQ) {
    auto fn = flash_bwd_dq_kernel<T, DMAX, BC, DROP>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<grid, THREADS, smem, stream>>>(q, k, v, dout, a.mask, a.lse_in,
                                        a.delta, static_cast<T*>(a.dq), a.st,
                                        a.H, a.Sq, a.Sk, a.D, a.scale,
                                        a.causal, a.seed, a.thresh,
                                        a.inv_keep);
  } else {
    auto fn = flash_bwd_dkv_kernel<T, DMAX, BC, DROP>;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<grid, THREADS, smem, stream>>>(q, k, v, dout, a.mask, a.lse_in,
                                        a.delta, static_cast<T*>(a.dk),
                                        static_cast<T*>(a.dv), a.st, a.H, a.Sq,
                                        a.Sk, a.D, a.scale, a.causal, a.seed,
                                        a.thresh, a.inv_keep);
  }
  return cudaGetLastError();
}

template <typename T, bool DROP>
cudaError_t dispatch_d(Which w, const Args& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<T, 64, 64, DROP>(w, a, stream);
  if (a.D <= 128) return launch<T, 128, 64, DROP>(w, a, stream);
  return launch<T, 256, 32, DROP>(w, a, stream);
}

template <typename T>
cudaError_t dispatch_drop(Which w, const Args& a, cudaStream_t stream) {
  // rate 0 (threshold 0, scale 1) is the variant without the hash
  return a.thresh > 0 || a.inv_keep != 1.f ? dispatch_d<T, true>(w, a, stream)
                                           : dispatch_d<T, false>(w, a, stream);
}

int run(Which w, const Args& a, int dtype, void* stream) {
  if (a.D < 8 || a.D > 256 || a.D % 8 != 0 || a.B < 1 || a.H < 1 ||
      a.Sq < 1 || a.Sk < 1 || (a.causal && a.Sq > a.Sk) || a.thresh < 0 ||
      a.thresh > (1 << 24))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = dispatch_drop<float>(w, a, st);
  else if (dtype == 1) err = dispatch_drop<__nv_bfloat16>(w, a, st);
  else if (dtype == 2) err = dispatch_drop<__half>(w, a, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. strides: 9 host int64s,
// the batch, sequence and head strides of q, k and v in elements (the head
// dim is contiguous). mask: [B, Sk] fp32 0/1, or null. out: contiguous
// [B, Sq, H, D]; lse: [B * H, Sq] fp32. Dropout: seed (uint32), thresh =
// int(rate * 2**24) (0: no dropout) and inv_keep = 1 / (1 - rate), as the
// host computes them. Every call returns cudaGetLastError() after its
// launch (0 = launched). The Python wrapper checks shapes, dtypes and
// 16-byte alignment.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* mask, void* out, float* lse,
                        const long long* strides, int B, int H, int Sq, int Sk,
                        int D, float scale, int causal, uint32_t seed,
                        int thresh, float inv_keep, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.out = out; a.lse = lse;
  a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(FWD, a, dtype, stream);
}

// dout: contiguous [B, Sq, H, D]; lse, delta: [B * H, Sq] fp32; dq:
// contiguous [B, Sq, H, D].
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
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

// dk, dv: contiguous [B, Sk, H, D].
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const float* mask,
                            const float* lse, const float* delta, void* dk,
                            void* dv, const long long* strides, int B, int H,
                            int Sq, int Sk, int D, float scale, int causal,
                            uint32_t seed, int thresh, float inv_keep,
                            int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.lse_in = lse;
  a.delta = delta; a.dk = dk; a.dv = dv; a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  return run(DKV, a, dtype, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// The dk/dv design that tools/probe_flash_tc256.py measures beside the
// kept one (deepspeed_tpu_torch/csrc/flash_attention_tc256.cu, included
// here whole): each of the block's two warpgroups owns one half of the
// head dim of both dk and dv (two m64n128 accumulators, 128 registers a
// thread) instead of all of one of them. Each computes the partial s^T =
// k.q^T and dp^T = v.dO^T over its half of the head dim; warpgroup 0
// hands its partials to warpgroup 1 through 32 KB of shared memory,
// warpgroup 1 adds them to its own and hands the sums back (two
// barriers), so both hold the same bits of s^T and dp^T, and each forms
// p^T and ds^T and multiplies them into its half. Shared memory: K, V,
// two stages of q and dO and the 32 KB exchange, 225 KB.
//
// Built only by the probe:
//   nvcc <build.NVCC_FLAGS> -I deepspeed_tpu_torch/csrc -o halves.so \
//        tools/flash_tc256_dkv_halves.cu
// exports flash_attention_tc256_fwd and flash_attention_tc256_bwd_dq (the
// kept forward and dq) and flash_attention_tc256_halves_bwd_dkv (this
// dk/dv, the kept one's arguments). The m64n128k16 product it uses,
// wgmma128_rs, is wgmma.cuh's.

#include "flash_attention_tc256.cu"


namespace {

// acc += x B[:, half] (128 columns from the 64-column block c0 / 64 on),
// x split into two 16-bit terms; waits for the products
template <typename T>
__device__ __forceinline__ void half_product(float (&acc)[64],
                                             const float (&x)[32],
                                             const uint8_t* b, int c0) {
  uint32_t hi[4][4], lo[4][4];
  const T* tag = nullptr;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1], hi[kc][r],
              lo[kc][r], tag);
  const uint8_t* bh = b + (c0 >> 6) * BN * ROWB;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    wgmma128_rs<T>(acc, hi[kc], desc_mn(bh, BN, kc), 1);
    wgmma128_rs<T>(acc, lo[kc], desc_mn(bh, BN, kc), 1);
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

template <typename T, bool DROP>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dkv_halves_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ mask,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk_out, T* __restrict__ dv_out, Strides st, int H,
    int Sq, int Sk, int D, float scale, int causal, uint32_t seed,
    int thresh, float inv_keep) {
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Vs + TILE;             // [2] q tiles; then the dk tile
  uint8_t* Os = Qs + 2 * TILE;         // [2] dO tiles; then the dv tile
  float* Ls = reinterpret_cast<float*>(Os + 2 * TILE);  // [2][BN]
  float* Es = Ls + 2 * BN;             // [2][BN]
  float* X = Es + 2 * BN;              // [64][WG]: s^T then dp^T partials
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();

  const int wg = threadIdx.x / WG;     // owns columns 128 wg .. + 127
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
  const long long orow = (long long)H * D;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* ob = dout + (long long)b * Sq * orow + (long long)h * D;
  const Drop drop(seed, bh, thresh, inv_keep);
  const float sl = scale * LOG2E;
  const int j0 = k0 + warp * 16 + g;
  const float km0 = (mask && j0 < Sk) ? mask[(long long)b * Sk + j0] : 1.f;
  const float km1 =
      (mask && j0 + 8 < Sk) ? mask[(long long)b * Sk + j0 + 8] : 1.f;
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int it0 = q_first / BN;
  const int ntiles = (Sq + BN - 1) / BN;
  const int c0 = 128 * wg;             // the warpgroup's first column

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

  float dva[64], dka[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dva[i] = dka[i] = 0.f;

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

    // the partial s^T and dp^T over this warpgroup's half of the head dim
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int kc = 8 * wg + kk;
      if (kc * 16 < dk) {
        wgmma64<T>(s, desc_k(Ks, BM, 0, kc), desc_k(Qt, BN, 0, kc), kk > 0);
        wgmma64<T>(dp, desc_k(Vs, BM, 0, kc), desc_k(Ot, BN, 0, kc),
                   kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        X[e * WG + tw] = s[e];
        X[(32 + e) * WG + tw] = dp[e];
      }
    }
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = X[e * WG + tw] + s[e];
        dp[e] = X[(32 + e) * WG + tw] + dp[e];
        X[e * WG + tw] = s[e];
        X[(32 + e) * WG + tw] = dp[e];
      }
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = X[e * WG + tw];
        dp[e] = X[(32 + e) * WG + tw];
      }
    }
    // p^T (into s, dropped out for dv) and ds^T (into dp)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const int i = q0 + c;
        const int j = e < 2 ? j0 : j0 + 8;
        const bool vis = !edge || (i < Sq && (!causal || j <= i + offset));
        float p = vis ? exp2f(s[4 * n + e] * sl - Lt[c]) * (e < 2 ? km0 : km1)
                      : 0.f;
        float d = dp[4 * n + e];
        if (DROP) {
          const bool kp = drop.keep(i, j);
          d = kp ? d * drop.inv_keep : 0.f;
          dp[4 * n + e] = p * (d - Et[c]);
          p = kp ? p * drop.inv_keep : 0.f;
        } else {
          dp[4 * n + e] = p * (d - Et[c]);
        }
        s[4 * n + e] = p;
      }
    half_product<T>(dva, s, Ot, c0);
    half_product<T>(dka, dp, Qt, c0);
    __syncthreads();  // this stage (and X) consumed before refilled
  }

  const int r0 = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int cc = 16 * wg + i;
    if (8 * cc < dk) {
      put_pair<T>(Qs, BM, r0, cc, t, dka[4 * i] * scale,
                  dka[4 * i + 1] * scale);
      put_pair<T>(Qs, BM, r0 + 8, cc, t, dka[4 * i + 2] * scale,
                  dka[4 * i + 3] * scale);
      put_pair<T>(Os, BM, r0, cc, t, dva[4 * i], dva[4 * i + 1]);
      put_pair<T>(Os, BM, r0 + 8, cc, t, dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
  __syncthreads();
  const long long off = ((long long)b * Sk + k0) * orow + (long long)h * D;
  store_tile(dk_out + off, orow, Qs, BM, nk, D, NT);
  store_tile(dv_out + off, orow, Os, BM, nk, D, NT);
}

constexpr size_t HALVES_SMEM =
    (size_t)6 * TILE + sizeof(float) * 4 * BN + sizeof(float) * 64 * WG;
static_assert(HALVES_SMEM <= SMEM_LIMIT, "the halves split does not fit");

template <typename T, bool DROP>
cudaError_t launch_halves(const Args& a, cudaStream_t stream) {
  auto fn = flash_bwd_dkv_halves_kernel<T, DROP>;
  cudaError_t err = set_smem(fn, HALVES_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sk + BM - 1) / BM);
  fn<<<grid, 2 * WG, HALVES_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.mask,
      a.lse_in, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st,
      a.H, a.Sq, a.Sk, a.D, a.scale, a.causal, a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t halves_drop(const Args& a, cudaStream_t stream) {
  return a.thresh > 0 || a.inv_keep != 1.f
             ? launch_halves<T, true>(a, stream)
             : launch_halves<T, false>(a, stream);
}

}  // namespace

extern "C" int flash_attention_tc256_halves_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* mask, const float* lse, const float* delta, void* dk,
    void* dv, const long long* strides, int B, int H, int Sq, int Sk, int D,
    float scale, int causal, uint32_t seed, int thresh, float inv_keep,
    int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.mask = mask; a.lse_in = lse;
  a.delta = delta; a.dk = dk; a.dv = dv; a.st = strides_of(strides);
  a.B = B; a.H = H; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.seed = seed; a.thresh = thresh; a.inv_keep = inv_keep;
  if (D <= 128 || D > DMAX || D % 8 != 0 || B < 1 || H < 1 || Sq < 1 ||
      Sk < 1 || (causal && Sq > Sk) || (Sk + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)halves_drop<__nv_bfloat16>(a, st);
  if (dtype == 2) return (int)halves_drop<__half>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The walk shared by the paged decode kernel (paged_attention.cu, TPU
// kernel #1) and the ragged chunked-prefill kernel (chunked_prefill.cu,
// TPU kernel #2): one thread block attends a run of up to MAX_S queries of
// one head, at consecutive positions p0 .. p0 + ns - 1 of one sequence,
// over that sequence's K/V pool blocks through its row of the block
// table. Key j (table-relative) is visible to query i iff j <= p0 + i.
// The softmax runs online in fp32; the output is written in q's dtype.
// walk_keys walks a contiguous range of the keys and leaves the block's
// partial state (m, l and the warps' unnormalised sums) in a WalkSmem;
// attend_run walks them all and writes the output (the first chunked-
// prefill kernel's whole walk); the decode kernel and the chunked-prefill
// kernel's decode rows give each block of a cluster a share of the keys
// (cluster_share) and combine the partials through distributed shared
// memory (finish_cluster; launch_clusters launches such a grid).
//
// Pools are in q's dtype (float or bf16) or int8. An int8 pool carries
// per-(token, head) fp32 scales [N, BS, H]: each key row's thread group
// reads its own head's scale at stride H and dequantizes k = code * scale
// in fp32 (never rounded to bf16), as the TPU kernels do.
//
// Layout of one thread block (THREADS threads): a key row of D elements is
// read by D / 8 threads, 8 elements each (16 bytes for bf16, 32 for fp32,
// 8 codes for int8), rounded up to TPKP, a power of two, so that a row's
// threads form an aligned group inside a warp and reduce with shuffles.
// KPP = THREADS / TPKP keys are processed side by side, NPASS times per
// tile of KT = NPASS * KPP keys; each tile's K and V loads are all issued
// at the tile's start, so a tile costs about one device-memory latency.
//
// Masked keys contribute nothing at all: their score is replaced by -inf
// (a select, not arithmetic) and their value row is skipped, not
// multiplied by 0, so a non-finite value in the scratch block or in an
// unwritten slot cannot reach the output. Every output element is summed
// by one thread in a fixed order, with no atomics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace paged {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_S = 8;    // queries per thread block
constexpr int MAX_D = 256;  // largest head_dim
constexpr int VEC = 8;      // elements of a row per thread
constexpr int NPASS = 4;    // rows per thread per tile, loaded together
constexpr int MAX_SPLITS = 8;   // the portable cluster size
constexpr unsigned FULL = 0xffffffffu;

// One thread's 8-element slice of a K or V row, as loaded.
template <typename P>
struct Slice;
template <>
struct Slice<float> {
  float4 a, b;
};
template <>
struct Slice<__nv_bfloat16> {
  uint4 a;
};
template <>
struct Slice<int8_t> {
  uint2 a;
};

__device__ __forceinline__ void load(const float* p, Slice<float>& s) {
  s.a = *reinterpret_cast<const float4*>(p);
  s.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Slice<__nv_bfloat16>& s) {
  s.a = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load(const int8_t* p, Slice<int8_t>& s) {
  s.a = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void unpack(const Slice<float>& s,
                                       float (&x)[VEC]) {
  x[0] = s.a.x; x[1] = s.a.y; x[2] = s.a.z; x[3] = s.a.w;
  x[4] = s.b.x; x[5] = s.b.y; x[6] = s.b.z; x[7] = s.b.w;
}
__device__ __forceinline__ void unpack(const Slice<__nv_bfloat16>& s,
                                       float (&x)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&s.a);
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
// int8 codes, sign-extended byte by byte (little-endian: byte k of a word
// is element k).
__device__ __forceinline__ void unpack(const Slice<int8_t>& s,
                                       float (&x)[VEC]) {
  const unsigned w[2] = {s.a.x, s.a.y};
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    x[k] = (float)((int)(w[k / 4] << (24 - 8 * (k % 4))) >> 24);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The shared memory of one walk of up to NQ queries: q * scale, the
// tile's scores and probabilities, the online-softmax state and the warps'
// partial sums.
template <int TPKP, int NQ = MAX_S>
struct WalkSmem {
  static constexpr int KT = NPASS * (THREADS / TPKP);  // keys per tile
  static constexpr int DMAX = VEC * TPKP;  // widest head this TPKP covers
  float q_s[NQ][DMAX];                     // q * scale, fp32 (first: 16 B)
  float p_s[NQ][KT];                       // scores, then probs
  float m_s[NQ];                           // running max
  float l_s[NQ];                           // running normaliser
  float a_s[NQ];                           // tile rescale factor
  float red[NWARPS][NQ][DMAX];             // the warps' partial sums
};

// Walk keys k_lo .. k_hi - 1 (table-relative, k_lo a multiple of the tile
// KT) of one run. ``q`` points at the run's first query's head ``h`` row;
// consecutive queries are ``row = H * D`` elements apart (the pools' token
// stride too). ``bt``: the sequence's table row of WB block ids. Called by
// all THREADS threads, with 1 <= ns <= NQ uniform across the block. D <=
// VEC * TPKP. NQ sizes the per-thread accumulators (NQ x VEC registers),
// so a single-query decode instantiates NQ = 1. Leaves in ``sm`` the
// run's m_s and l_s over these keys (m = -inf, l = 0 for a query that saw
// none) and in red[w][i][d] warp w's sum of p v over them.
template <typename T, typename P, int TPKP, int NQ = MAX_S>
__device__ __forceinline__ void walk_keys(
    WalkSmem<TPKP, NQ>& sm, const T* __restrict__ q,
    const P* __restrict__ k_pool, const P* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ bt, int p0, int ns, int H, int D, int BS,
    int h, float scale, int k_lo, int k_hi) {
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int KPP = THREADS / TPKP;  // keys per pass
  constexpr int KT = WalkSmem<TPKP, NQ>::KT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = tid % TPKP;  // which 8-element slice of a row
  const int g = tid / TPKP;  // which key of a pass
  const bool has_slice = t * VEC < D;
  auto& q_s = sm.q_s;
  auto& p_s = sm.p_s;
  auto& m_s = sm.m_s;
  auto& l_s = sm.l_s;
  auto& a_s = sm.a_s;
  auto& red = sm.red;

  const long row = (long)H * D;  // elements between tokens
  for (int idx = tid; idx < ns * D; idx += THREADS) {
    const int i = idx / D;
    const int d = idx - i * D;
    q_s[i][d] = to_float(q[i * row + d]) * scale;
  }
  if (tid < NQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  float acc[NQ][VEC];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

  const long head_off = (long)h * D + t * VEC;

  for (int k0 = k_lo; k0 < k_hi; k0 += KT) {
    const int nk = min(KT, k_hi - k0);
    // 0. issue every K and V load of the tile (and int8 scales)
    Slice<P> ks[NPASS], vs[NPASS];
    float ksc[NPASS], vsc[NPASS];
#pragma unroll
    for (int r = 0; r < NPASS; ++r) {
      const int j = r * KPP + g;
      if (j < nk && has_slice) {
        const int kp = k0 + j;
        const long tok = (long)bt[kp / BS] * BS + kp % BS;
        load(k_pool + tok * row + head_off, ks[r]);
        load(v_pool + tok * row + head_off, vs[r]);
        if (INT8) {
          ksc[r] = k_scale[tok * H + h];
          vsc[r] = v_scale[tok * H + h];
        }
      }
    }

    // 1. scores of the tile's keys against every query
#pragma unroll
    for (int r = 0; r < NPASS; ++r) {
      const int j = r * KPP + g;
      float part[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) part[i] = 0.f;
      if (j < nk && has_slice) {
        float kx[VEC];
        unpack(ks[r], kx);
        if (INT8) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kx[e] *= ksc[r];
        }
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i < ns) {
            const float4 qa = *reinterpret_cast<const float4*>(
                &q_s[i][t * VEC]);
            const float4 qb = *reinterpret_cast<const float4*>(
                &q_s[i][t * VEC + 4]);
            part[i] = qa.x * kx[0] + qa.y * kx[1] + qa.z * kx[2] +
                      qa.w * kx[3] + qb.x * kx[4] + qb.y * kx[5] +
                      qb.z * kx[6] + qb.w * kx[7];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i < ns) {  // uniform across the block
#pragma unroll
          for (int off = TPKP >> 1; off > 0; off >>= 1)
            part[i] += __shfl_xor_sync(FULL, part[i], off);
        }
      }
      if (t == 0) {
        for (int i = 0; i < ns; ++i)
          p_s[i][j] = (j < nk && k0 + j <= p0 + i) ? part[i] : -INFINITY;
      }
    }
    __syncthreads();

    // 2. online-softmax statistics, one warp per query
    for (int i = warp; i < ns; i += NWARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32)
        if (k0 + j <= p0 + i) mx = fmaxf(mx, p_s[i][j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new == -INFINITY) {  // no key of this query seen yet
        for (int j = lane; j < KT; j += 32) p_s[i][j] = 0.f;
      } else {
        alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        for (int j = lane; j < KT; j += 32) {
          const float p =
              (j < nk && k0 + j <= p0 + i) ? expf(p_s[i][j] - m_new) : 0.f;
          p_s[i][j] = p;
          sum += p;
        }
      }
      sum = warp_sum(sum);
      __syncwarp();  // every lane has read m_s[i] before lane 0 writes it
      if (lane == 0) {
        m_s[i] = m_new;
        l_s[i] = l_s[i] * alpha + sum;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

    // 3. rescale the partial accumulators, add this tile's values
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i < ns) {
        const float alpha = a_s[i];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
      }
    }
#pragma unroll
    for (int r = 0; r < NPASS; ++r) {
      const int j = r * KPP + g;
      if (j < nk && has_slice) {
        const int kp = k0 + j;
        float vx[VEC];
        unpack(vs[r], vx);
        if (INT8) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vx[e] *= vsc[r];
        }
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i < ns && kp <= p0 + i) {
            const float p = p_s[i][j];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] += p * vx[e];
          }
        }
      }
    }
    __syncthreads();  // p_s is rewritten by the next tile
  }

  // Sum the key groups' partial accumulators: inside each warp with
  // shuffles, then across warps through shared memory.
#pragma unroll
  for (int off = TPKP; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      if (i < ns)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[i][e] += __shfl_xor_sync(FULL, acc[i][e], off);
  }
  if (lane < TPKP && has_slice) {
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      if (i < ns)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[warp][i][t * VEC + e] = acc[i][e];
  }
  __syncthreads();
}

// The output of a run walked whole by walk_keys: the warps' sums over
// max(l, 1e-30), in q's dtype.
template <typename T, int TPKP, int NQ = MAX_S>
__device__ __forceinline__ void finish_run(const WalkSmem<TPKP, NQ>& sm,
                                           T* __restrict__ out, int ns,
                                           int H, int D) {
  const long row = (long)H * D;
  for (int idx = threadIdx.x; idx < ns * D; idx += THREADS) {
    const int i = idx / D;
    const int d = idx - i * D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += sm.red[w][i][d];
    store(out + i * row + d, sum / fmaxf(sm.l_s[i], 1e-30f));
  }
}

// Attend one run over all its visible keys (keys past the last query's
// position are visible to no query) and write its output: walk_keys over
// 0 .. min(WB * BS, p0 + ns), then finish_run.
template <typename T, typename P, int TPKP>
__device__ __forceinline__ void attend_run(
    const T* __restrict__ q, T* __restrict__ out,
    const P* __restrict__ k_pool, const P* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ bt, int WB, int p0, int ns, int H, int D, int BS,
    int h, float scale) {
  __shared__ __align__(16) WalkSmem<TPKP> sm;
  walk_keys<T, P, TPKP>(sm, q, k_pool, v_pool, k_scale, v_scale, bt, p0, ns,
                        H, D, BS, h, scale, 0, min(WB * BS, p0 + ns));
  finish_run<T, TPKP>(sm, out, ns, H, D);
}

// This block's share [k_lo, k_hi) of the n_keys keys of a run whose walk
// is split over the `splits` blocks of a cluster (rank: this block's
// rank): contiguous runs of whole KT-key tiles, rank by rank; a share may
// hold none.
template <int KT>
__device__ __forceinline__ void cluster_share(int n_keys, int rank,
                                              int splits, int& k_lo,
                                              int& k_hi) {
  const int nt = (n_keys + KT - 1) / KT;
  k_lo = min(n_keys, rank * nt / splits * KT);
  k_hi = min(n_keys, (rank + 1) * nt / splits * KT);
}

// The output of a run whose keys the `splits` blocks of a cluster walked
// share by share (walk_keys over cluster_share's range), each leaving its
// partial (m, l, o) in its own shared memory. With one split, finish_run.
// Else rank 0 reads the partials through distributed shared memory in
// rank order after cluster.sync(), combines them (o = sum_r e^(m_r - M)
// o_r / sum_r e^(m_r - M) l_r) and writes the output; no block leaves
// while rank 0 reads its partial. Called by every thread of every block
// of the cluster.
template <typename T, int TPKP, int NQ>
__device__ __forceinline__ void finish_cluster(WalkSmem<TPKP, NQ>& sm,
                                               T* __restrict__ out, int ns,
                                               int H, int D, int rank,
                                               int splits) {
  namespace cg = cooperative_groups;
  constexpr int DMAX = WalkSmem<TPKP, NQ>::DMAX;
  __shared__ float wgt[MAX_SPLITS][NQ];      // e^(m_r - M), rank 0
  __shared__ float lsum[NQ];                 // sum_r e^(m_r - M) l_r
  if (splits == 1) {
    finish_run<T, TPKP, NQ>(sm, out, ns, H, D);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();

  // this block's partial o: the warps' sums, in place in red[0]
  for (int idx = threadIdx.x; idx < ns * D; idx += THREADS) {
    const int i = idx / D;
    const int d = idx - i * D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += sm.red[w][i][d];
    sm.red[0][i][d] = sum;
  }
  cluster.sync();   // every block's partial is in its shared memory
  if (rank == 0) {
    if (threadIdx.x < ns) {
      const int i = threadIdx.x;
      float mx = -INFINITY;
      for (int r = 0; r < splits; ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(&sm.m_s[0], r)[i]);
      float l = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float m = cluster.map_shared_rank(&sm.m_s[0], r)[i];
        const float w = m == -INFINITY ? 0.f : expf(m - mx);
        wgt[r][i] = w;
        l += cluster.map_shared_rank(&sm.l_s[0], r)[i] * w;
      }
      lsum[i] = l;
    }
    __syncthreads();
    const long row = (long)H * D;
    for (int idx = threadIdx.x; idx < ns * D; idx += THREADS) {
      const int i = idx / D;
      const int d = idx - i * D;
      float o = 0.f;
      for (int r = 0; r < splits; ++r)
        o += cluster.map_shared_rank(&sm.red[0][0][0], r)[i * DMAX + d] *
             wgt[r][i];
      store(out + i * row + d, o / fmaxf(lsum[i], 1e-30f));
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its partial
}

// Launch `kernel` on `grid` in clusters of (splits, 1, 1), THREADS
// threads a block, static shared memory only.
template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), dim3 grid, int splits,
                            cudaStream_t st, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// Instantiate ``KERNEL<T, P, TPKP>`` for head_dim D (TPKP = the power of
// two >= D / 8) by calling LAUNCH(TPKP); shared by both kernels' hosts.
#define PAGED_DISPATCH_D(D, LAUNCH) \
  do {                              \
    if ((D) <= 8) LAUNCH(1);        \
    else if ((D) <= 16) LAUNCH(2);  \
    else if ((D) <= 32) LAUNCH(4);  \
    else if ((D) <= 64) LAUNCH(8);  \
    else if ((D) <= 128) LAUNCH(16); \
    else LAUNCH(32);                \
  } while (0)

}  // namespace paged

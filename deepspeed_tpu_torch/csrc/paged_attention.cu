// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/transformer/
// paged_attention.py:_decode_kernel. It computes the same function: the
// queries q [B, S, H, D] of each sequence attend over the K/V pools
// [N, BS, H, D] through that sequence's row of the block table [B, WB];
// table-relative key j is visible to query i iff j <= pos[b] + i; the
// softmax runs online in fp32; the output [B, S, H, D] is in q's dtype.
// The gathered [B, WB*BS, H, D] K/V copy is never materialised.
//
// What bounds it on an H100: device-memory bytes. Each (sequence, layer)
// must read 2 * ctx * H * D * sizeof(dtype) bytes of K and V (ctx = the
// keys the sequence's last query can see) and does only ~4 flops per
// element read, far below the ~295 flop/byte at which the tensor cores
// become the limit. At 3.35 TB/s a batch of 8 sequences of 1024 bf16
// tokens with H=12, D=64 reads 8 * 2 * 1024 * 12 * 64 * 2 bytes = 25.2 MB
// of K and V, so it needs at least 25.2 MB / 3.35 TB/s = 7.5 us.
//
// What the design does about that bound:
// - it reads each visible K and V row exactly once, as 16-byte vector loads
//   by neighbouring threads, and stops the walk after the last key any
//   query of the block can see (keys past pos[b] + S - 1 are never read,
//   table entries past them are never looked up);
// - each tile's K and V loads are all issued at the tile's start, so a
//   thread has 2 * NPASS loads in flight and a tile costs about one
//   device-memory latency, not one per pass;
// - nothing but the output is written to device memory: q, the scores,
//   the running max / normaliser and the accumulator stay on chip.
// It is a simple kernel, not yet a fast one: one thread block per (head,
// sequence, group of up to MAX_S queries) walks the keys tile by tile, so
// a batch of 8 x 12 heads gives 96 blocks for 132 SMs and the card cannot
// keep enough bytes in flight to reach its bound. TMA, wgmma, a split of
// the key axis across blocks and cross-tile prefetch are later work.
//
// Layout of one thread block (THREADS threads): a key row of D elements is
// read by D / 8 threads, 8 elements (16 bytes for bf16) each, rounded up to
// TPKP, a power of two, so that a row's threads form an aligned group
// inside a warp and reduce with shuffles. KPP = THREADS / TPKP keys are
// processed side by side, NPASS times per tile of KT = NPASS * KPP keys.
//
// Masked keys contribute nothing at all: their score is replaced by -inf
// (a select, not arithmetic) and their value row is skipped, not multiplied
// by 0, so a non-finite value in the scratch block or in an unwritten slot
// cannot reach the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_S = 8;    // queries per thread block
constexpr int MAX_D = 256;  // largest head_dim
constexpr int VEC = 8;      // elements of a row per thread
constexpr int NPASS = 4;    // rows per thread per tile, loaded together
constexpr unsigned FULL = 0xffffffffu;

// One thread's 8-element slice of a K or V row, as loaded.
template <typename T>
struct Slice;
template <>
struct Slice<float> {
  float4 a, b;
};
template <>
struct Slice<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ void load(const float* p, Slice<float>& s) {
  s.a = *reinterpret_cast<const float4*>(p);
  s.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     Slice<__nv_bfloat16>& s) {
  s.a = *reinterpret_cast<const uint4*>(p);
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

// grid: (H, B, ceil(S / MAX_S)); block: THREADS. D <= 8 * TPKP.
template <typename T, int TPKP>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ block_table,
    const int* __restrict__ pos, T* __restrict__ out, int S, int H, int D,
    int BS, int WB, float scale) {
  constexpr int KPP = THREADS / TPKP;  // keys per pass
  constexpr int KT = NPASS * KPP;      // keys per tile
  constexpr int DMAX = VEC * TPKP;     // widest head this TPKP covers

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * MAX_S;
  const int ns = min(MAX_S, S - s0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = tid % TPKP;  // which 8-element slice of a row
  const int g = tid / TPKP;  // which key of a pass
  const bool has_slice = t * VEC < D;

  __shared__ __align__(16) float q_s[MAX_S][DMAX];  // q * scale, fp32
  __shared__ float p_s[MAX_S][KT];                  // scores, then probs
  __shared__ float m_s[MAX_S];                      // running max
  __shared__ float l_s[MAX_S];                      // running normaliser
  __shared__ float a_s[MAX_S];                      // tile rescale factor
  __shared__ float red[NWARPS][MAX_S][DMAX];

  const long row = (long)H * D;  // elements between tokens
  const int p0 = pos[b] + s0;    // position of this block's first query
  for (int idx = tid; idx < ns * D; idx += THREADS) {
    const int i = idx / D;
    const int d = idx - i * D;
    q_s[i][d] = to_float(q[((long)b * S + s0 + i) * row + (long)h * D + d])
                * scale;
  }
  if (tid < MAX_S) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  float acc[MAX_S][VEC];
#pragma unroll
  for (int i = 0; i < MAX_S; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

  // Keys past the last query's position are visible to no query here.
  const int n_keys = min(WB * BS, p0 + ns);
  const int* bt = block_table + (long)b * WB;
  const long head_off = (long)h * D + t * VEC;

  for (int k0 = 0; k0 < n_keys; k0 += KT) {
    const int nk = min(KT, n_keys - k0);

    // 0. issue every K and V load of the tile
    Slice<T> ks[NPASS], vs[NPASS];
#pragma unroll
    for (int r = 0; r < NPASS; ++r) {
      const int j = r * KPP + g;
      if (j < nk && has_slice) {
        const int kp = k0 + j;
        const long tok = (long)bt[kp / BS] * BS + kp % BS;
        load(k_pool + tok * row + head_off, ks[r]);
        load(v_pool + tok * row + head_off, vs[r]);
      }
    }

    // 1. scores of the tile's keys against every query
#pragma unroll
    for (int r = 0; r < NPASS; ++r) {
      const int j = r * KPP + g;
      float part[MAX_S];
#pragma unroll
      for (int i = 0; i < MAX_S; ++i) part[i] = 0.f;
      if (j < nk && has_slice) {
        float kx[VEC];
        unpack(ks[r], kx);
#pragma unroll
        for (int i = 0; i < MAX_S; ++i) {
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
      for (int i = 0; i < MAX_S; ++i) {
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
    for (int i = 0; i < MAX_S; ++i) {
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
#pragma unroll
        for (int i = 0; i < MAX_S; ++i) {
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
    for (int i = 0; i < MAX_S; ++i)
      if (i < ns)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[i][e] += __shfl_xor_sync(FULL, acc[i][e], off);
  }
  if (lane < TPKP && has_slice) {
#pragma unroll
    for (int i = 0; i < MAX_S; ++i)
      if (i < ns)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[warp][i][t * VEC + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = tid; idx < ns * D; idx += THREADS) {
    const int i = idx / D;
    const int d = idx - i * D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red[w][i][d];
    store(out + ((long)b * S + s0 + i) * row + (long)h * D + d,
          sum / fmaxf(l_s[i], 1e-30f));
  }
}

template <typename T>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* block_table, const void* pos, void* out, int B,
            int S, int H, int D, int BS, int WB, float scale,
            cudaStream_t st) {
  const dim3 grid(H, B, (S + MAX_S - 1) / MAX_S);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const int* bt = static_cast<const int*>(block_table);
  const int* ps = static_cast<const int*>(pos);
  T* op = static_cast<T*>(out);
#define PAGED_DECODE_LAUNCH(TP)                                        \
  paged_decode_kernel<T, TP><<<grid, THREADS, 0, st>>>(qp, kp, vp, bt, \
                                                       ps, op, S, H, D, \
                                                       BS, WB, scale)
  if (D <= 8) PAGED_DECODE_LAUNCH(1);
  else if (D <= 16) PAGED_DECODE_LAUNCH(2);
  else if (D <= 32) PAGED_DECODE_LAUNCH(4);
  else if (D <= 64) PAGED_DECODE_LAUNCH(8);
  else if (D <= 128) PAGED_DECODE_LAUNCH(16);
  else PAGED_DECODE_LAUNCH(32);
#undef PAGED_DECODE_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched). Shapes, dtypes, contiguity and 16-byte alignment
// are checked by the Python wrapper; this checks only what it relies on.
int paged_decode_attention_fwd(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_table,
                               const void* pos, void* out, int B, int S,
                               int H, int D, int BS, int WB, float scale,
                               int dtype, void* stream) {
  if (D < VEC || D > MAX_D || D % VEC != 0 || BS < 1 || WB < 1 || B < 1 ||
      S < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(q, k_pool, v_pool, block_table, pos, out, B, S, H,
                          D, BS, WB, scale, st);
  else
    launch<float>(q, k_pool, v_pool, block_table, pos, out, B, S, H, D, BS,
                  WB, scale, st);
  return (int)cudaGetLastError();
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

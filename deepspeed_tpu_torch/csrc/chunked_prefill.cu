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
// What the design does about that bound: consecutive tokens of one prompt
// chunk share their table row and sit at consecutive positions. A thread
// block takes such a run of up to MAX_S = 8 tokens together (the shared
// walk of paged_walk.cuh, the paged decode kernel's), so each K/V row is
// read once per 8 chunk tokens instead of once per token; a decode token
// is a run of one. The grid is (H, T); the block of token t first decides
// whether t leads a run: t continues t - 1 when pos[t] == pos[t-1] + 1 and
// their table rows are equal, and a run is cut at every position that is a
// multiple of MAX_S, so each token can find its run's leader without a
// scan. Blocks of the other tokens of a run return at once. Every
// (t, h) output element is written by one thread, summed in a fixed
// order, with no atomics. Pad tokens (an all-scratch row at position 0)
// are runs of one that read scratch block 0 and write only their own rows.
// Still simple, not fast: no tensor cores, no TMA, and the key walk of a
// long decode row is not split across blocks.

#include "paged_walk.cuh"

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

const char* chunked_prefill_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

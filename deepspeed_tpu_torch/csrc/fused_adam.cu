// Fused multi-tensor Adam(W) update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/adam/fused_update.py:
// fused_adam_update_kernel. One pass reads each parameter's fp32 master p,
// its gradient g and both moments m and v once, runs the Adam(W)
// recurrence in fp32 registers, and writes p', m', v' (and, optionally, p'
// cast to the compute dtype). The op order is FusedAdam.update's leaf
// chain, pinned with the _rn intrinsics so that no multiply-add is
// contracted into an FMA: the kernel matches the plain PyTorch version to
// the bit.
//
// Unlike the TPU kernel, which is launched once per parameter, this is ONE
// launch over the whole parameter list: a device table holds every
// tensor's pointers and size, and a chunk table splits the tensors into
// CHUNK-element pieces, one thread block each.
//
// What bounds it on an H100: device-memory bytes. 28 bytes per parameter
// (read p, g, m, v; write p', m', v', all fp32) against ~12 flops: GPT-2's
// 124.4 M parameters move 3.48 GB, at least 1.04 ms at 3.35 TB/s; 30 bytes
// (3.73 GB, 1.11 ms) with the bf16 copy of p' that a bf16 training step
// has it write for its next forward. Each
// thread keeps ILP independent elements' loads in flight and neighbouring
// threads touch neighbouring addresses; nothing else is read or written.
//
// Table layout (int64): ptr[5][L] (p, g, m, v, cast-out or 0), size[L],
// chunk_tensor[n_chunks], chunk_start[n_chunks].

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;

__device__ __forceinline__ float load_g(const void* g, long long i,
                                        int dtype) {
  if (dtype == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i]);
  return static_cast<const float*>(g)[i];
}

__device__ __forceinline__ void store_cast(void* c, long long i, float x,
                                           int dtype) {
  if (dtype == 1) static_cast<__nv_bfloat16*>(c)[i] = __float2bfloat16(x);
  else if (dtype == 2) static_cast<__half*>(c)[i] = __float2half(x);
}

__global__ void __launch_bounds__(THREADS) fused_adam_kernel(
    const long long* __restrict__ table, int L, int n_chunks, int chunk,
    const float* __restrict__ scalars, float b1, float omb1, float b2,
    float omb2, float eps, float wd, int adamw, int g_dtype,
    int cast_dtype) {
  const int ci = blockIdx.x;
  const int t = (int)table[6 * L + ci];
  const long long start = table[6 * L + n_chunks + ci];
  const long long n = table[5 * L + t];
  const long long end = start + chunk < n ? start + chunk : n;
  float* __restrict__ p = reinterpret_cast<float*>(table[t]);
  const void* g = reinterpret_cast<const void*>(table[L + t]);
  float* __restrict__ m = reinterpret_cast<float*>(table[2 * L + t]);
  float* __restrict__ v = reinterpret_cast<float*>(table[3 * L + t]);
  void* cast = reinterpret_cast<void*>(table[4 * L + t]);
  const float lr = scalars[0];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];

  for (long long base = start + threadIdx.x; base < end;
       base += (long long)ILP * THREADS) {
    float pr[ILP], gr[ILP], mr[ILP], vr[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < end) {
        pr[u] = p[i];
        gr[u] = load_g(g, i, g_dtype);
        mr[u] = m[i];
        vr[u] = v[i];
      }
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < end) {
        float gg = gr[u];
        if (wd != 0.f && !adamw) gg = __fadd_rn(gg, __fmul_rn(wd, pr[u]));
        const float mm = __fadd_rn(__fmul_rn(b1, mr[u]), __fmul_rn(omb1, gg));
        const float vv = __fadd_rn(__fmul_rn(b2, vr[u]),
                                   __fmul_rn(omb2, __fmul_rn(gg, gg)));
        const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, bc2)), eps);
        float upd = __fdiv_rn(__fdiv_rn(mm, bc1), denom);
        if (wd != 0.f && adamw) upd = __fadd_rn(upd, __fmul_rn(wd, pr[u]));
        const float pn = __fsub_rn(pr[u], __fmul_rn(lr, upd));
        p[i] = pn;
        m[i] = mm;
        v[i] = vv;
        if (cast_dtype) store_cast(cast, i, pn, cast_dtype);
      }
    }
  }
}

}  // namespace

extern "C" {

// table: device int64 table (layout above); scalars: device fp32 [lr, bc1,
// bc2]. g_dtype: 0 = float32, 1 = bfloat16. cast_dtype: 0 = none,
// 1 = bfloat16, 2 = float16. Returns cudaGetLastError() after the launch.
int fused_adam_multi_tensor(const void* table, int L, int n_chunks,
                            int chunk, const float* scalars, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, int adamw, int g_dtype, int cast_dtype,
                            void* stream) {
  if (L < 1 || n_chunks < 1 || chunk < 1 || g_dtype < 0 || g_dtype > 1 ||
      cast_dtype < 0 || cast_dtype > 2)
    return (int)cudaErrorInvalidValue;
  fused_adam_kernel<<<n_chunks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), L, n_chunks, chunk, scalars, b1,
      omb1, b2, omb2, eps, wd, adamw, g_dtype, cast_dtype);
  return (int)cudaGetLastError();
}

const char* fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

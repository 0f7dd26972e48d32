// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deepspeed_tpu/ops/transformer/
// paged_attention.py:_decode_kernel. It computes the same function: the
// queries q [B, S, H, D] of each sequence attend over the K/V pools
// [N, BS, H, D] through that sequence's row of the block table [B, WB];
// table-relative key j is visible to query i iff j <= pos[b] + i; the
// softmax runs online in fp32; the output [B, S, H, D] is in q's dtype.
// The pools are in q's dtype, or int8 with fp32 scales [N, BS, H] (the
// TPU kernel's int8 branch), dequantized in fp32 as each key is read. The
// gathered [B, WB*BS, H, D] K/V copy is never materialised.
//
// What bounds it on an H100: device-memory bytes. Each (sequence, layer)
// must read 2 * ctx * H * D * sizeof(pool element) bytes of K and V (ctx =
// the keys the sequence's last query can see), plus 2 * ctx * H * 4 bytes
// of scales for an int8 pool, and does only ~4 flops per element read, far
// below the ~295 flop/byte at which the tensor cores become the limit. At
// 3.35 TB/s a batch of 8 sequences of 1024 bf16 tokens with H=12, D=64
// reads 8 * 2 * 1024 * 12 * 64 * 2 bytes = 25.2 MB of K and V, so it needs
// at least 25.2 MB / 3.35 TB/s = 7.5 us; an int8 pool halves the codes'
// bytes (14.2 MB with its scales).
//
// What the design does about that bound (the walk itself is
// paged_walk.cuh, shared with the chunked-prefill kernel):
// - it reads each visible K and V row exactly once, as vector loads by
//   neighbouring threads, and stops the walk after the last key any query
//   of the block can see (table entries past it are never looked up);
// - each tile's K and V loads are all issued at the tile's start;
// - nothing but the output is written to device memory.
// It is a simple kernel, not yet a fast one: one thread block per (head,
// sequence, group of up to MAX_S queries) walks the keys tile by tile, so
// a batch of 8 x 12 heads gives 96 blocks for 132 SMs and the card cannot
// keep enough bytes in flight to reach its bound. TMA, wgmma, a split of
// the key axis across blocks and cross-tile prefetch are later work.

#include "paged_walk.cuh"

namespace {

using namespace paged;

// grid: (H, B, ceil(S / MAX_S)); block: THREADS.
template <typename T, typename P, int TPKP>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ pos, T* __restrict__ out, int S, int H, int D,
    int BS, int WB, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * MAX_S;
  const long first = ((long)b * S + s0) * H * D + (long)h * D;
  attend_run<T, P, TPKP>(q + first, out + first, k_pool, v_pool, k_scale,
                         v_scale, block_table + (long)b * WB, WB,
                         pos[b] + s0, min(MAX_S, S - s0), H, D, BS, h,
                         scale);
}

template <typename T, typename P>
void launch(const void* q, const void* k_pool, const void* v_pool,
            const void* k_scale, const void* v_scale,
            const void* block_table, const void* pos, void* out, int B,
            int S, int H, int D, int BS, int WB, float scale,
            cudaStream_t st) {
  const dim3 grid(H, B, (S + MAX_S - 1) / MAX_S);
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pool);
  const P* vp = static_cast<const P*>(v_pool);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_table);
  const int* ps = static_cast<const int*>(pos);
  T* op = static_cast<T*>(out);
#define PAGED_DECODE_LAUNCH(TP)                                           \
  paged_decode_kernel<T, P, TP><<<grid, THREADS, 0, st>>>(                \
      qp, kp, vp, ksp, vsp, bt, ps, op, S, H, D, BS, WB, scale)
  PAGED_DISPATCH_D(D, PAGED_DECODE_LAUNCH);
#undef PAGED_DECODE_LAUNCH
}

}  // namespace

extern "C" {

// dtype (of q, out and an fp pool): 0 = float32, 1 = bfloat16. int8: 1 for
// int8 pools with fp32 scales k_scale / v_scale [N, BS, H] (else both may
// be null). Returns cudaGetLastError() after the launch (0 = launched).
// Shapes, dtypes, contiguity and 16-byte alignment are checked by the
// Python wrapper; this checks only what it relies on.
int paged_decode_attention_fwd(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* block_table,
                               const void* pos, void* out, int B, int S,
                               int H, int D, int BS, int WB, float scale,
                               int dtype, int int8, void* stream) {
  if (D < VEC || D > MAX_D || D % VEC != 0 || BS < 1 || WB < 1 || B < 1 ||
      S < 1 || H < 1 || (dtype != 0 && dtype != 1) ||
      (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && int8)
    launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                  block_table, pos, out, B, S, H, D, BS, WB,
                                  scale, st);
  else if (dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr,
                                         nullptr, block_table, pos, out, B,
                                         S, H, D, BS, WB, scale, st);
  else if (int8)
    launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, block_table,
                          pos, out, B, S, H, D, BS, WB, scale, st);
  else
    launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, block_table,
                         pos, out, B, S, H, D, BS, WB, scale, st);
  return (int)cudaGetLastError();
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
//   of the run can see (table entries past it are never looked up);
// - each tile's K and V loads are all issued at the tile's start;
// - the key axis is split across a thread-block cluster, in one launch:
//   one thread block per (head, sequence, group of up to MAX_S queries)
//   would give a batch of 8 x 12 heads 96 blocks for 132 SMs, each walking
//   1024 keys tile by tile, too few bytes in flight to approach the bound.
//   The grid's x axis is (head, split); the `splits` blocks of a cluster
//   (at most 8, the portable cluster size) each walk a contiguous share of
//   the run's visible key tiles (a share may hold none) and leave their
//   partial (m, l, o) in fp32 in their own shared memory. After
//   cluster.sync(), rank 0 reads the partials through distributed shared
//   memory in rank order, combines them (o = sum_r e^(m_r - M) o_r / sum_r
//   e^(m_r - M) l_r) and writes the output. No scratch in device memory,
//   no second launch (a decode step keeps one launch per layer), no
//   atomics, a fixed combine order; the host picks `splits` from the
//   window and the batch (paged_attention.py: paged_decode_splits);
// - nothing but the output is written to device memory.
// With splits = 1 a block walks the whole run, as the first version did.
// A single-token decode (S = 1) runs an instantiation for one query per
// block, whose accumulators take 8 registers per thread instead of 64, so
// more blocks stay resident and more K/V loads are in flight.
// TMA and cross-tile prefetch are later work.

#include <cooperative_groups.h>

#include "paged_walk.cuh"

namespace {

using namespace paged;
namespace cg = cooperative_groups;

// grid: (H * splits, B, ceil(S / NQ)), clusters of (splits, 1, 1);
// block: THREADS. NQ queries per block: 1 for a single-token decode (its
// accumulators take NQ x 8 registers per thread), else MAX_S.
template <typename T, typename P, int TPKP, int NQ>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ pos, T* __restrict__ out, int S, int H, int D,
    int BS, int WB, float scale, int splits) {
  constexpr int KT = WalkSmem<TPKP, NQ>::KT;
  __shared__ __align__(16) WalkSmem<TPKP, NQ> sm;

  const int h = blockIdx.x / splits;
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * NQ;
  const int ns = min(NQ, S - s0);
  const int p0 = pos[b] + s0;
  const long first = ((long)b * S + s0) * H * D + (long)h * D;
  // this block's share of the run's visible key tiles
  const int n_keys = min(WB * BS, p0 + ns);
  const int rank = splits > 1 ? (int)cg::this_cluster().block_rank() : 0;
  int k_lo, k_hi;
  cluster_share<KT>(n_keys, rank, splits, k_lo, k_hi);
  walk_keys<T, P, TPKP, NQ>(sm, q + first, k_pool, v_pool, k_scale,
                            v_scale, block_table + (long)b * WB, p0, ns, H,
                            D, BS, h, scale, k_lo, k_hi);
  finish_cluster<T, TPKP, NQ>(sm, out + first, ns, H, D, rank, splits);
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_table, const void* pos, void* out,
                   int B, int S, int H, int D, int BS, int WB, float scale,
                   int splits, cudaStream_t st) {
  const dim3 grid(H * splits, B, S == 1 ? 1 : (S + MAX_S - 1) / MAX_S);
  const T* qp = static_cast<const T*>(q);
  const P* kp = static_cast<const P*>(k_pool);
  const P* vp = static_cast<const P*>(v_pool);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_table);
  const int* ps = static_cast<const int*>(pos);
  T* op = static_cast<T*>(out);
  cudaError_t err = cudaSuccess;
#define PAGED_DECODE_LAUNCH(TP)                                          \
  err = S == 1 ? launch_clusters(paged_decode_kernel<T, P, TP, 1>, grid, \
                                 splits, st, qp, kp, vp, ksp, vsp, bt,   \
                                 ps, op, S, H, D, BS, WB, scale, splits) \
               : launch_clusters(paged_decode_kernel<T, P, TP, MAX_S>,   \
                                 grid, splits, st, qp, kp, vp, ksp, vsp, \
                                 bt, ps, op, S, H, D, BS, WB, scale,     \
                                 splits)
  PAGED_DISPATCH_D(D, PAGED_DECODE_LAUNCH);
#undef PAGED_DECODE_LAUNCH
  return err;
}

}  // namespace

extern "C" {

// dtype (of q, out and an fp pool): 0 = float32, 1 = bfloat16. int8: 1 for
// int8 pools with fp32 scales k_scale / v_scale [N, BS, H] (else both may
// be null). splits: blocks per (head, sequence, query group), 1 to 8, each
// walking a share of the keys. Returns the launch's error, else
// cudaGetLastError() after it (0 = launched). Shapes, dtypes, contiguity
// and 16-byte alignment are checked by the Python wrapper; this checks
// only what it relies on.
int paged_decode_attention_fwd(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* block_table,
                               const void* pos, void* out, int B, int S,
                               int H, int D, int BS, int WB, float scale,
                               int dtype, int int8, int splits,
                               void* stream) {
  if (D < VEC || D > MAX_D || D % VEC != 0 || BS < 1 || WB < 1 || B < 1 ||
      S < 1 || H < 1 || (dtype != 0 && dtype != 1) || splits < 1 ||
      splits > MAX_SPLITS ||
      (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1 && int8)
    err = launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                        block_table, pos, out, B, S, H, D,
                                        BS, WB, scale, splits, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, block_table, pos, out, B, S, H,
        D, BS, WB, scale, splits, st);
  else if (int8)
    err = launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                block_table, pos, out, B, S, H, D, BS, WB,
                                scale, splits, st);
  else
    err = launch<float, float>(q, k_pool, v_pool, nullptr, nullptr,
                               block_table, pos, out, B, S, H, D, BS, WB,
                               scale, splits, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

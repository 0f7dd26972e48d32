// Hopper (sm_90a) primitives shared by the kernels that run warpgroup
// matrix products: fused_ln_tc.cu (TPU kernels #6, #7 in 16 bits),
// fused_ln_tf32.cu (#6, #7 in fp32, as 3xTF32),
// flash_attention_tc256.cu (#3-#5 at head dims in (128, 256]) and
// chunked_prefill.cu (#2's bf16 chunk items at those head dims).
//
// - mbarriers and TMA tensor loads (cp.async.bulk.tensor) for producer /
//   consumer rings;
// - wgmma: shared-memory matrix descriptors (gmma_desc), the fence /
//   commit / wait of an asynchronous group, register fences that keep the
//   compiler from moving accumulator or A-fragment accesses across one,
//   and the products the kernels issue: m64n128k16 with both operands in
//   shared memory (wgmma128), m64n64k16 likewise (wgmma64), and
//   m64n256k16 and m64n128k16 with A in registers (wgmma256_rs,
//   wgmma128_rs), and the TF32 m64n128k8 with A in registers
//   (wgmma128_tf32_rs).
//
// The accumulator layout of every shape: d[4 i + 2 h + e] is row 16 warp
// + lane / 4 + 8 h (warp and lane within the warpgroup), column 8 i + 2
// (lane % 4) + e. An A fragment in registers is mma.sync.m16n8k16's A
// fragment of the warp's 16 rows: a[0] (row g, k 2t, 2t + 1), a[1] (row g
// + 8, the same k), a[2] (row g, k 2t + 8, 2t + 9), a[3] (row g + 8, k 2t
// + 8, 2t + 9), g = lane / 4, t = lane % 4; so the accumulator registers
// d[8 c .. 8 c + 7] of two neighbouring 8-column tiles, packed in pairs,
// are the A fragment of k-step c of the next product.

#pragma once

#include <cuda.h>   // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait of more
// than ~2^34 cycles (seconds) traps, so a broken pipeline fails its
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// a 2-D box of a tensor map into shared memory; c0 runs along the
// contiguous dimension. Boxes past the tensor's edge fill with zeros and
// still count their whole size against the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the consumer warpgroups' own barrier (the producer warp does not join)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// A wgmma matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1: 128-byte, 2: 64-byte). K-major
// swizzled operands: stride = the 8-row group's bytes, leading unused.
// MN-major 128-byte swizzle: leading = the bytes between two 64-wide MN
// blocks, stride = the bytes between two 8-deep k groups.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lead,
                                              uint32_t stride,
                                              uint64_t swizzle) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for A fragments held in registers (wgmma reads them
// asynchronously: they stay live, unchanged, until the wait)
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WGMMA_M64N128K16_SS(TYPE)                                          \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "%64, %65, p, 1, 1, %67, %68;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

// d (+)= A B over k 16: A [64 x 16] and B [16 x 128] from descriptors; TA /
// TB: 0 K-major, 1 MN-major. The accumulator layout: d[4 i + 2 h + e] is
// row 16 warp + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_M64N128K16_SS("bf16");
  } else {
    WGMMA_M64N128K16_SS("f16");
  }
}

#define WGMMA_M64N64K16_SS(TYPE)                                            \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(a), "l"(b), "r"(scale_d))

#define WGMMA_M64N256K16_RS(TYPE)                                           \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPE "." TYPE " "      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                            \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                            \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                            \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                            \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                            \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                        \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                    \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                    \
      "%120, %121, %122, %123, %124, %125, %126, %127}, "                   \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),    \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),    \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),    \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),    \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),    \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),    \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),    \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),    \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),\
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),\
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),\
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),\
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),\
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))


#define WGMMA_M64N128K16_RS(TYPE)                                           \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "      \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

// d (+)= A B over k 16, A [64 x 16] and B [16 x 64] from descriptors,
// both K-major
template <typename T>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_M64N64K16_SS("bf16");
  } else {
    WGMMA_M64N64K16_SS("f16");
  }
}

// d (+)= A B over k 16: A [64 x 16] from registers (a, this thread's
// fragment), B [16 x 256] from a descriptor, MN-major (its rows are the k
// index, its 256 columns contiguous)
template <typename T>
__device__ __forceinline__ void wgmma256_rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_M64N256K16_RS("bf16");
  } else {
    WGMMA_M64N256K16_RS("f16");
  }
}

// d (+)= A B over k 16: A [64 x 16] from registers, B [16 x 128] from a
// descriptor, MN-major (as wgmma256_rs, over 128 columns)
template <typename T>
__device__ __forceinline__ void wgmma128_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WGMMA_M64N128K16_RS("bf16");
  } else {
    WGMMA_M64N128K16_RS("f16");
  }
}

// d (+)= A B over k 8 in TF32: A [64 x 8] from registers, B [8 x 128]
// from a descriptor, K-major (TF32 has no transpose bit: both operands
// are read K-major). The A fragment is mma.sync.m16n8k8's of the warp's
// 16 rows: a[0] (row g, k t), a[1] (row g + 8, k t), a[2] (row g, k t +
// 4), a[3] (row g + 8, k t + 4), g = lane / 4, t = lane % 4; each a
// TF32 value's bits (an fp32 with its low 13 bits clear).
__device__ __forceinline__ void wgmma128_tf32_rs(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace hopper

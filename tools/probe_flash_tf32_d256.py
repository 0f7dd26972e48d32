#!/usr/bin/env python3
"""Design probe of the 3xTF32 flash kernels at head dims in (128, 256]
(``deepspeed_tpu_torch/csrc/flash_attention_tf32.cu``'s DMAX = 256
instances) on one GPU.

    python3 tools/probe_flash_tf32_d256.py [fwd|bwd|all]   # default all

Builds variants of the source with ``nvcc`` into
``build/flash_tf32_d256_variants/`` (a directory ``.gitignore`` lists),
one per process, all started together, by setting its constants. The
forward's (``fwd``), with the backward's constants as the source has
them:

- ``split1``: ``FWD256_SPLIT`` = 1: four warps a block, each owning one
  16-row group and all 256 columns of o (128 accumulator registers a
  thread), 32-key tiles (200 KB of shared memory, one block an SM);
- ``split2``: ``FWD256_SPLIT`` = 2, ``FWD256_SHARE_S`` off: eight warps,
  two over each 16-row group, each computing all of the group's s and
  its softmax itself and owning 128 columns of o (twice the s products,
  half the accumulator);
- ``split2_share``: the same with ``FWD256_SHARE_S`` on: each warp of a
  pair sums s over its half of the head dim and the two add their
  partial sums through 16 KB of shared memory (216 KB);
- ``split1_bs16`` and ``split2_share_bs16``: 16-key tiles (``BS`` = 16:
  133 and 141 KB, still one block an SM at D = 256).

The backward's (``bwd``: dq and dk/dv, two warps on each 16-row group,
each owning 128 columns of dq, or of dk and dv), with the forward's
constants as the source has them:

- ``r64_t16_halves``: ``BWD256_ROWS`` = 64 resident rows a block (eight
  warps), ``BWD256_TILE`` = 16-row streamed tiles, the source's dk/dv:
  each dk/dv warp owns half of dk's and half of dv's columns and the
  pair adds partial s^T and dp^T (216 KB);
- ``r64_t16_owners``: the same with dk/dv's kernel replaced by
  :data:`OWNERS_DKV`: one warp of a pair owns dv and sums s^T, the other
  dk and dp^T, p^T handed over;
- ``r32_t32_halves`` and ``r32_t32_owners``: 32 resident rows (four
  warps) and 32-row tiles (216 KB).

Prints each variant's registers and spill stores for the D = 256
kernels it changes; holds each on ``chip_smoke.py``'s fp32 flash cases
above D = 128 (``compare_flash_case`` over ``FLASH_CASES_256``,
``FLASH_DROP_CASES_256`` and ``FLASH_NONCAUSAL_CASES_256`` at dropout 0
and 0.1: every kernel against the plain version within 1e-5, bit-equal
over two launches, the FMA kernels on the same inputs, the whole
autograd path); then times the kernels it changes at
``FLASH_D256_SHAPE`` ([4, 512, 8, 256] fp32 causal, 4-layer rotation)
at dropout 0 and 0.1, in two rounds of opposite order, beside the FMA
kernels on the same inputs and SDPA's fp32 forward or whole backward
(memory-efficient backend, TF32 off), all as device time
(``chip_smoke.device_ms``). ``bwd`` also checks, on one warp, whether
s^T = k.q^T summed by halves gives the bits of s = q.k^T, with the
three products in ``mma3``'s default order and in its swapped one. A
variant that fails to build or to hold is reported and skipped; the
exit code is then 1. Exits 2 without CUDA.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "flash_tf32_d256_variants")
NAME = "flash_attention_tf32"
CONSTANTS = {"split": ("constexpr int FWD256_SPLIT = {};", r"\d+"),
             "share": ("constexpr bool FWD256_SHARE_S = {};", r"\w+"),
             "bs": ("constexpr int BS = {};", r"\d+"),
             "rows": ("constexpr int BWD256_ROWS = {};", r"\d+"),
             "tile": ("constexpr int BWD256_TILE = {};", r"\d+")}
# name: the constants it sets
VARIANTS = {
    "fwd": {"split1": {"split": 1, "share": "false", "bs": 32},
            "split2": {"split": 2, "share": "false", "bs": 32},
            "split2_share": {"split": 2, "share": "true", "bs": 32},
            "split1_bs16": {"split": 1, "share": "false", "bs": 16},
            "split2_share_bs16": {"split": 2, "share": "true", "bs": 16}},
    "bwd": {"r64_t16_halves": {"rows": 64, "tile": 16},
            "r64_t16_owners": {"rows": 64, "tile": 16, "owners": True},
            "r32_t32_halves": {"rows": 32, "tile": 32},
            "r32_t32_owners": {"rows": 32, "tile": 32, "owners": True}}}
# dk/dv's "owners" split, in place of the kept kernel (from its comment to
# its closing brace): the pair's first warp sums s^T over both halves
# (half 0 + half 1: the same bits), hands p^T over through shared memory
# and owns all of dv; the second sums dp^T and owns all of dk (one p^T
# tile a pair in Xs)
OWNERS_DKV = r"""// dk and dv (owners): grid (B * H, ceil(Sk / BWD256_ROWS))
template <bool DROP>
__global__ void __launch_bounds__(BWD256_ROWS * 4, 1)
    flash_bwd_dkv_tf32_d256_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ mask, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dk_out,
        float* __restrict__ dv_out, Strides st, int H, int Sq, int Sk, int D,
        float scale, int causal, uint32_t seed, int thresh, float inv_keep) {
  constexpr int DP = 256 + 4;
  constexpr int BK = BWD256_ROWS;
  constexpr int BQ = BWD256_TILE;
  constexpr int NTH = BK * 4;
  constexpr int NG = BK / 16;
  constexpr int NO = 32;
  constexpr int NS = BQ / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DP;
  float* Qs = Vs + BK * DP;
  float* Os = Qs + 2 * BQ * DP;
  float* Ls = Os + 2 * BQ * DP;
  float* Es = Ls + 2 * BQ;
  float* Xs = Es + 2 * BQ;          // the pair's p^T

  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp = wid % NG;
  const int second = wid / NG;      // the pair's second warp: dk
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BK;
  const int offset = Sk - Sq;
  const int nk = min(BK, Sk - k0);
  const long long orow = (long long)H * D;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* ob = dout + (long long)b * Sq * orow + (long long)h * D;
  const Drop drop(seed, bh, thresh, inv_keep);
  const float sl = scale * LOG2E;
  const int j0 = k0 + warp * 16 + g;
  const float km0 = (mask && j0 < Sk) ? mask[(long long)b * Sk + j0] : 1.f;
  const float km1 =
      (mask && j0 + 8 < Sk) ? mask[(long long)b * Sk + j0 + 8] : 1.f;
  const int q_first = causal ? max(0, k0 - offset) : 0;
  const int it0 = q_first / BQ;
  const int ntiles = (Sq + BQ - 1) / BQ;

  auto load_q = [&](int it) {
    const int q0 = it * BQ, s = (it - it0) & 1;
    const int valid = min(BQ, Sq - q0);
    load_rows<DP, NTH>(Qs + s * BQ * DP, qb + q0 * st.qs, st.qs, BQ, valid,
                       D);
    load_rows<DP, NTH>(Os + s * BQ * DP, ob + q0 * orow, orow, BQ, valid,
                       D);
    if (threadIdx.x < BQ) {
      const bool ok = (int)threadIdx.x < valid;
      const long long at = (long long)bh * Sq + q0 + threadIdx.x;
      Ls[s * BQ + threadIdx.x] = ok ? lse[at] * LOG2E : 0.f;
      Es[s * BQ + threadIdx.x] = ok ? delta[at] : 0.f;
    }
  };
  load_rows<DP, NTH>(Ks, k + b * st.kb + h * st.kh + k0 * st.ks, st.ks, BK,
                     nk, D);
  load_rows<DP, NTH>(Vs, v + b * st.vb + h * st.vh + k0 * st.vs, st.vs, BK,
                     nk, D);
  load_q(it0);
  cp_async_commit();

  float acc[NO][4];                 // dv (first warp) or dk (second)
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* Kw = Ks + warp * 16 * DP;
  const float* Vw = Vs + warp * 16 * DP;

  for (int it = it0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_q(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = it * BQ, s_ = (it - it0) & 1;
    const float* Qt = Qs + s_ * BQ * DP;
    const float* Ot = Os + s_ * BQ * DP;
    const float* Lt = Ls + s_ * BQ;
    const float* Et = Es + s_ * BQ;
    const bool edge =
        q0 + BQ > Sq || (causal && q0 + offset < k0 + BK - 1);

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if (!second) {
      float s1[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s1[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 128; kk += 8) {
        uint32_t ah[4], al[4];
        a_rows<DP>(Kw, kk, ah, al);
        mma_rows<NS, DP, true>(s, ah, al, Qt, kk);
        if (128 + kk < D) {
          a_rows<DP>(Kw, 128 + kk, ah, al);
          mma_rows<NS, DP, true>(s1, ah, al, Qt, 128 + kk);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += s1[n][e];
    } else {
#pragma unroll
      for (int kc = 0; kc < 256; kc += 8) {
        if (kc < D) {
          uint32_t ah[4], al[4];
          a_rows<DP>(Vw, kc, ah, al);
          mma_rows<NS, DP>(dp, ah, al, Ot, kc);
        }
      }
    }
    float* Pp = Xs + warp * NS * 4 * 32 + lane;   // the pair's p^T
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const int i = q0 + c;
        const int j = e < 2 ? j0 : j0 + 8;
        const bool kp = !DROP || drop.keep(i, j);
        if (!second) {
          const bool vis = !edge || (i < Sq && (!causal || j <= i + offset));
          const float p = vis ? exp2f(s[n][e] * sl - Lt[c]) *
                                    (e < 2 ? km0 : km1)
                              : 0.f;
          Pp[(4 * n + e) * 32] = p;
          s[n][e] = DROP ? (kp ? p * drop.inv_keep : 0.f) : p;
        } else {
          dp[n][e] = DROP ? (kp ? dp[n][e] * drop.inv_keep : 0.f) : dp[n][e];
        }
      }
    __syncthreads();   // the first warps' p^T is in Xs
    if (second) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          dp[n][e] = Pp[(4 * n + e) * 32] * (dp[n][e] - Et[c]);
        }
#pragma unroll
      for (int kk = 0; kk < NS; ++kk)
        mma_cols<NO, NS, DP>(acc, dp, kk, Qt, D);
    } else {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) mma_cols<NO, NS, DP>(acc, s, kk, Ot, D);
    }
    __syncthreads();
  }

  const long long off = ((long long)b * Sk + k0) * orow + (long long)h * D;
  store_acc_at<NO>((second ? dk_out : dv_out) + off, orow, acc,
                   second ? scale : 1.f, warp * 16, nk, D);
}

"""
# the kept kernel's text, from its first line to the line after it, and
# the owners split's shared-memory term (one p^T tile a pair, not two
# partial tiles a warp)
KEPT_DKV = ("// dk and dv: grid (B * H, ceil(Sk / BWD256_ROWS));",
            "// ---------------------------------------------------------"
            "------------------\n// launch\n")
OWNERS_SMEM = ("  if (wide) floats += 4 * rows * tile;",
               "  if (wide) floats += (w == DKV ? 1 : 4) * rows * tile;")

# the kernels each set changes, as ptxas names them
KERNELS = {"fwd": r"flash_fwd_tf32_kernelILi256E",
           "bwd": r"flash_bwd_(?:dq|dkv)_tf32_d256_kernel"}

# one warp: s = q.k^T and s^T = k.q^T over 256 columns, each summed by
# halves of 128 as the D = 256 kernels sum them (16 queries, 16 keys)
SCORE_ORDER_CU = r"""
#include "tf32_mma.cuh"

template <bool SWAP>
__device__ void scores(const float* a, const float* b, float (&s)[2][4]) {
  float part[2][2][4] = {};
  for (int h = 0; h < 2; ++h)
    for (int kk = 0; kk < 128; kk += 8) {
      uint32_t ah[4], al[4];
      attn_tf32::a_rows<260>(a, 128 * h + kk, ah, al);
      attn_tf32::mma_rows<2, 260, SWAP>(part[h], ah, al, b, 128 * h + kk);
    }
  for (int n = 0; n < 2; ++n)
    for (int e = 0; e < 4; ++e) s[n][e] = part[0][n][e] + part[1][n][e];
}

// out [3][16 queries][16 keys]: s, then s^T in the default and the swapped
// order, transposed back
__global__ void score_order_kernel(const float* q, const float* k,
                                   float* out) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  float s[3][2][4];
  scores<false>(q, k, s[0]);
  scores<false>(k, q, s[1]);
  scores<true>(k, q, s[2]);
  for (int v = 0; v < 3; ++v)
    for (int n = 0; n < 2; ++n)
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? g : g + 8, c = 8 * n + 2 * t + (e & 1);
        out[v * 256 + (v ? c : r) * 16 + (v ? r : c)] = s[v][n][e];
      }
}

extern "C" int score_order(const float* q, const float* k, float* out,
                           void* stream) {
  score_order_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(q, k, out);
  return (int)cudaGetLastError();
}
"""


def owners(src: str) -> str:
    """The source with dk/dv's kept kernel replaced by :data:`OWNERS_DKV`
    and its shared-memory term by the owners split's."""
    first, last = KEPT_DKV
    if src.count(first) != 1 or src.count(last) != 1 or \
            src.count(OWNERS_SMEM[0]) != 1:
        raise SystemExit("probe_flash_tf32_d256: dk/dv's D = 256 kernel "
                         "or its shared-memory term not found once in the "
                         "source")
    text = (src[:src.index(first)] + OWNERS_DKV
            + src[src.index(last):])
    return text.replace(*OWNERS_SMEM)


def variants(src: str, which) -> dict:
    """The source with each variant's constants set (and dk/dv's owners
    split where it asks for it), by variant name."""
    found = {}
    for key, (pattern, value) in CONSTANTS.items():
        found[key] = re.compile(re.escape(pattern).replace(r"\{\}", value))
        if len(found[key].findall(src)) != 1:
            raise SystemExit(f"probe_flash_tf32_d256: {pattern!r} not "
                             f"found once in the source")
    out = {}
    for kind in which:
        for name, values in VARIANTS[kind].items():
            text = owners(src) if values.get("owners") else src
            for key, value in values.items():
                if key in CONSTANTS:
                    text = found[key].sub(CONSTANTS[key][0].format(value),
                                          text)
            out[name] = (kind, text)
    return out


def score_order(torch, build, nvcc) -> None:
    """Builds and runs :data:`SCORE_ORDER_CU` on 256 random pairs of
    [16, 256] q and k (magnitudes 1e-2 to 1e2); prints how many of s's
    elements the two orders of s^T miss bit for bit."""
    path = os.path.join(OUT, "score_order.cu")
    with open(path, "w") as f:
        f.write(SCORE_ORDER_CU)
    lib_path = os.path.join(OUT, "score_order.so")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
                    lib_path, path], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.score_order.argtypes = [ctypes.c_void_p] * 4
    g = torch.Generator(device="cpu").manual_seed(7)
    miss = [0, 0]
    n = 0
    for trial in range(256):
        mag = 10.0 ** (4 * trial / 255 - 2)
        q, k = (torch.zeros(16, 260) for _ in range(2))
        q[:, :256] = torch.randn(16, 256, generator=g) * mag
        k[:, :256] = torch.randn(16, 256, generator=g)
        q, k = q.cuda(), k.cuda()
        out = torch.empty(3, 16, 16, device="cuda")
        rc = lib.score_order(q.data_ptr(), k.data_ptr(), out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"score_order: launch failed ({rc})")
        bits = out.view(torch.int32)
        miss[0] += int((bits[1] != bits[0]).sum())
        miss[1] += int((bits[2] != bits[0]).sum())
        n += 256
    print(f"score order: of {n} scores s = q.k^T (halves added), s^T = "
          f"k.q^T in mma3's default order misses {miss[0]} bit for bit, in "
          f"its swapped order {miss[1]}", flush=True)


def main() -> int:
    import torch

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    kinds = ("fwd", "bwd") if which == "all" else (which,)
    if which not in ("fwd", "bwd", "all"):
        raise SystemExit(f"usage: {sys.argv[0]} [fwd|bwd|all]")
    if not torch.cuda.is_available():
        print("probe_flash_tf32_d256: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, flush=True)
    with open(os.path.join(build.CSRC, NAME + ".cu")) as f:
        srcs = variants(f.read(), kinds)
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise SystemExit("probe_flash_tf32_d256: nvcc not found")
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (kind, text) in srcs.items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             os.path.join(OUT, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    if "bwd" in kinds:
        score_order(torch, build, nvcc)
    good, failed = [], []
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed:\n{err[-6000:]}", flush=True)
            failed.append(name)
            continue
        report = out + err
        blocks = re.findall(r"Compiling entry function '(\S*(?:"
                            + KERNELS[srcs[name][0]]
                            + r")\S*)'(.*?)(?=Compiling entry|$)",
                            report, re.S)
        for kname, body in blocks:
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            short = kname[kname.find("flash_"):]
            print(f"{name}: {short[:short.find('Ev') + 2]} registers "
                  f"{regs.group(1) if regs else '?'}, spill stores "
                  f"{spill.group(1) if spill else '?'} bytes", flush=True)
        good.append(name)

    def bind(name):
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        real = build.load
        build.load = lambda _n: lib
        try:
            fa._FN.pop(NAME, None)
            return fa._kernel(NAME)
        finally:
            build.load = real

    f32 = torch.float32
    held = []
    for name in good:
        fa._FN[NAME] = bind(name)
        beyond, n, worst = [], 0, {}
        for cases, rate, causal in (
                (cs.FLASH_CASES_256, 0.0, True),
                (cs.FLASH_DROP_CASES_256, cs.FLASH_DROPOUT, True),
                (cs.FLASH_NONCAUSAL_CASES_256, 0.0, False),
                (cs.FLASH_NONCAUSAL_CASES_256, cs.FLASH_DROPOUT, False)):
            for case in cases:
                n += 1
                try:
                    routes = cs.compare_flash_case(
                        torch, fa, f32, case, worst, rate,
                        cs.FLASH_DROPOUT_SEED if rate else None,
                        causal=causal)
                    if routes != ("tf32",) * 3:
                        beyond.append(f"{case}: routes {routes}")
                except RuntimeError as e:
                    beyond.append(str(e)[:300])
        errs = {key: f"{worst[(key, 'float32')][0]:.3g}"
                for key in ("fwd", "dq", "dk", "dv", "autograd dqkv")
                if (key, "float32") in worst}
        print(f"{name}: {n - len(beyond)} of {n} fp32 flash cases above D "
              f"= 128 within 1e-5 (max |err| {errs}); beyond: {beyond}",
              flush=True)
        (failed if beyond else held).append(name)

    if not held:
        return 1
    b, s, h, d = cs.FLASH_D256_SHAPE
    scale = d ** -0.5
    layers = [cs.flash_case(torch, f32, b, s, h, d, seed=100 + i)
              for i in range(4)]
    it = {"i": 0}

    def nxt(items):
        it["i"] = (it["i"] + 1) % len(items)
        return items[it["i"]]

    kernels = {kind: {"fwd": [fa.flash_attention_fwd_tf32]}
               if kind == "fwd" else
               {"dq": [fa.flash_attention_bwd_dq_tf32],
                "dkv": [fa.flash_attention_bwd_dkv_tf32]}
               for kind in kinds}
    prepped = {}
    for rate in (0.0, 0.1):
        drop = (rate, cs.FLASH_DROPOUT_SEED if rate else None)
        fa._FN[NAME] = bind(held[0])    # the forward: held to 1e-5
        prepped[rate] = []
        for _qkv, q, k, v, dout, _m in layers:
            out, lse = fa.flash_attention_fwd(q, k, v, None, True, scale,
                                              *drop)
            delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
            prepped[rate].append((q, k, v, dout, lse, delta))

        def fma(key):
            def run():
                q, k, v, dout, lse, delta = nxt(prepped[rate])
                if key == "fwd":
                    fa._launch_fwd("flash_attention", q, k, v, None, True,
                                   scale, *drop)
                else:
                    (fa._launch_dq if key == "dq" else fa._launch_dkv)(
                        "flash_attention", q, k, v, dout, None, lse, delta,
                        True, scale, *drop)
            return run

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa_in = []
            for _qkv, q, k, v, dout, _m in layers:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              .requires_grad_() for t in (q, k, v))
                o = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, dropout_p=rate)
                sdpa_in.append((qt, kt, vt, o,
                                dout.transpose(1, 2).contiguous()))

            def sdpa_fwd():
                qt, kt, vt, _o, _do = nxt(sdpa_in)
                with torch.no_grad():
                    F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, dropout_p=rate)

            def sdpa_bwd():
                qt, kt, vt, o, dot = nxt(sdpa_in)
                torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

            lib = {"fwd": cs.device_ms(torch, sdpa_fwd)[0],
                   "bwd": cs.device_ms(torch, sdpa_bwd)[0]}
        del sdpa_in
        for kind in kinds:
            firsts = {key: f"{cs.device_ms(torch, fma(key))[0]:.4f}"
                      for key in kernels[kind]}
            print(f"dropout {rate}: the FMA kernels on the same inputs "
                  f"{firsts} ms, SDPA fp32 (efficient) forward "
                  f"{lib['fwd']:.4f} ms, whole backward "
                  f"{lib['bwd']:.4f} ms (device time)", flush=True)
    for rnd, order in enumerate((held, list(reversed(held)))):
        for name in order:
            fa._FN[NAME] = bind(name)
            kind = srcs[name][0]
            for rate in (0.0, 0.1):
                drop = (rate, cs.FLASH_DROPOUT_SEED if rate else None)
                times = {}
                for key, (wrapper,) in kernels[kind].items():
                    def call():
                        q, k, v, dout, lse, delta = nxt(prepped[rate])
                        if key == "fwd":
                            wrapper(q, k, v, None, True, scale, *drop)
                        else:
                            wrapper(q, k, v, dout, None, lse, delta, True,
                                    scale, *drop)
                    times[key] = f"{cs.device_ms(torch, call)[0]:.4f}"
                print(f"round {rnd} {name} dropout {rate}: {times} ms "
                      f"(device time, fp32 {list(cs.FLASH_D256_SHAPE)} "
                      f"causal)", flush=True)
    fa._FN.pop(NAME, None)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

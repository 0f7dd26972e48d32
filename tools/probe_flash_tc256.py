#!/usr/bin/env python3
"""Design probe of the wgmma flash forward, dq and dk/dv at head dims in
(128, 256] (``deepspeed_tpu_torch/csrc/flash_attention_tc256.cu``) on one
GPU.

    python3 tools/probe_flash_tc256.py

Builds eight variants with ``nvcc`` into ``build/flash_tc256_variants/``
(a directory ``.gitignore`` lists), one per process, all started
together: seven of the source, by setting its design constants or by a
text patch,

- ``kept``: the source as it is;
- ``fwd_1wg``: the forward at one consumer warpgroup a block (64 queries,
  two 64-key K/V stages, 160 KB) instead of ``FWD_WGS``;
- ``fwd_1wg_3stages``: the same with three stages (224 KB);
- ``dkv_recompute``: the source patched by ``RECOMPUTE``: the dk
  warpgroup computes s^T itself instead of reading p^T from the dv
  warpgroup through shared memory (16 KB less of it);
- ``dq_1wg``: dq on one warpgroup a block (``DQ_WGS`` = 1 and the loop's
  two-warpgroup body replaced by ``ONE_WG``): it computes s and dp,
  turns dp into ds in place and owns all 256 columns of dq
  (m64n256k16), with no handoff (192 KB);
- ``dq_1stage``: dq on two warpgroups with one K/V stage
  (``DQ_STAGES`` = 1: a tile's loads wait for the previous tile's
  products; 144 KB);
- ``dq_1wg_1stage``: both (128 KB);

and ``dkv_halves``: ``tools/flash_tc256_dkv_halves.cu``, the source
(included whole) with a dk/dv kernel whose two warpgroups each own one
half of the head dim of both dk and dv (their partial s^T and dp^T
summed through shared memory), beside the kept forward and dq.

Prints each variant's registers and spill stores; runs each through
chip_smoke.py's flash cases above D = 128 (``compare_flash_case`` over
``FLASH_CASES_256``, ``FLASH_DROP_CASES_256`` and
``FLASH_NONCAUSAL_CASES_256`` at dropout 0 and 0.1, bf16 and fp16) and
prints how many stay within its tolerances; then at
``FLASH_D256_SHAPE`` ([4, 512, 8, 256] bf16 causal, 4-layer rotation)
the forward's, dq's and dk/dv's device time (``chip_smoke.device_ms``)
at dropout 0 and 0.1, in two rounds of opposite order, beside the FMA
kernels on the same inputs. A variant that fails to build or to hold is
reported and skipped; the exit code is then 1. Exits 2 without CUDA.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "flash_tc256_variants")
SEED = -123456789
CONSTANTS = {"wgs": "constexpr int FWD_WGS = {};",
             "stages": "constexpr int FWD_STAGES = {};",
             "dq_wgs": "constexpr int DQ_WGS = {};",
             "dq_stages": "constexpr int DQ_STAGES = {};"}
# (kept text, variant text) pairs, each found once in the source: dk/dv's
# warpgroup 1 computes s^T = k.q^T beside dp^T and forms p^T itself, so
# neither p^T's 16 KB of shared memory nor its barrier is needed
RECOMPUTE = (
    ("""    scores<T>(x, wg ? Vs : Ks, BM, 0, wg ? Ot : Qt, dk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);
    if (wg == 0) {""", """    scores<T>(x, wg ? Vs : Ks, BM, 0, wg ? Ot : Qt, dk);
    wgmma_commit();
    float y[32];
    if (wg) {
      scores<T>(y, Ks, BM, 0, Qt, dk);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(x);
    fence_acc(y);
    if (wg == 0) {"""),
    ("""          Px[(4 * n + e) * WG + tw] = p;
""", ""),
    ("""    __syncthreads();   // p^T handed over
""", ""),
    ("const float p = Px[(4 * n + e) * WG + tw];",
     "const float p = prob(y[4 * n + e], n, e);"),
    ("sizeof(float) * 4 * BN + sizeof(float) * 32 * WG;",
     "sizeof(float) * 4 * BN;"),
)
# dq's two-warpgroup loop body, from its first line to its last, and the
# one-warpgroup body that replaces it (DQ_WGS = 1): one warpgroup computes
# s and dp, turns dp into ds in place and adds ds.k over all 256 columns
TWO_WG = ("    // warpgroup 0: s = q.k^T, then p; warpgroup 1: dp = dO.v^T\n",
          "    half_product<T>(acc, hi, lo, Kt + wg * (NB / 64) * BN * ROWB);"
          "\n")
ONE_WG = """    // s = q.k^T and dp = dO.v^T; dp becomes ds; dq += ds.k
    float s[32], dp[32];
    wgmma_fence();
    scores<T>(s, Qs, BM, 0, Kt, dk);
    scores<T>(dp, Os, BM, 0, Vt, dk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] = dsv(prob(s[4 * n + e], n, e), dp[4 * n + e], n, e);
    wide_product<T>(acc, dp, Kt);
"""


def variants(src: str) -> dict:
    found = {}
    for key, pattern in CONSTANTS.items():
        m = re.search(re.escape(pattern).replace(r"\{\}", r"(\w+)"), src)
        if not m:
            raise SystemExit(f"probe_flash_tc256: {pattern!r} not found")
        found[key] = m.group(1)

    def with_(**kw):
        text = src
        for key, value in kw.items():
            text = text.replace(CONSTANTS[key].format(found[key]),
                                CONSTANTS[key].format(value))
        return text

    recompute = src
    for kept, variant in RECOMPUTE:
        if recompute.count(kept) != 1:
            raise SystemExit(f"probe_flash_tc256: {kept!r} not found once "
                             f"in the source")
        recompute = recompute.replace(kept, variant)
    if any(src.count(line) != 1 for line in TWO_WG):
        raise SystemExit("probe_flash_tc256: dq's two-warpgroup body not "
                         "found once in the source")
    first = src.index(TWO_WG[0])
    last = src.index(TWO_WG[1]) + len(TWO_WG[1])

    def one_wg(text):
        at = text.index(TWO_WG[0])
        return text[:at] + ONE_WG + text[at + last - first:]

    return {"kept": src,
            "fwd_1wg": with_(wgs=1, stages=2),
            "fwd_1wg_3stages": with_(wgs=1, stages=3),
            "dkv_recompute": recompute,
            "dq_1wg": one_wg(with_(dq_wgs=1, dq_stages=2)),
            "dq_1stage": with_(dq_wgs=2, dq_stages=1),
            "dq_1wg_1stage": one_wg(with_(dq_wgs=1, dq_stages=1))}


HALVES = "dkv_halves"


def bind(path: str) -> dict:
    lib = ctypes.CDLL(path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 5 + [f32, i32, ctypes.c_uint32, i32, f32, i32, ptr]
    dkv = ("flash_attention_tc256_halves_bwd_dkv"
           if os.path.basename(path) == HALVES + ".so"
           else "flash_attention_tc256_bwd_dkv")
    out = {}
    for key, sym, n in (("fwd", "flash_attention_tc256_fwd", 7),
                        ("dq", "flash_attention_tc256_bwd_dq", 9),
                        ("dkv", dkv, 10)):
        fn = getattr(lib, sym)
        fn.argtypes = [ptr] * n + shape
        fn.restype = i32
        out[key] = fn
    err = lib.flash_attention_tc256_error_string
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    out["err"] = err
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_tc256: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), torch.__version__)
    with open(os.path.join(build.CSRC, "flash_attention_tc256.cu")) as f:
        srcs = variants(f.read())
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise SystemExit("probe_flash_tc256: nvcc not found")
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    paths = {HALVES: os.path.join(HERE, "tools",
                                  "flash_tc256_dkv_halves.cu")}
    for name, text in srcs.items():
        paths[name] = os.path.join(OUT, name + ".cu")
        with open(paths[name], "w") as f:
            f.write(text)
    for name, path in paths.items():
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             os.path.join(OUT, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    good, failed = [], []
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed:\n{err[-6000:]}", flush=True)
            failed.append(name)
            continue
        report = out + err
        regs = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                          r"registers", report, re.S)
        spills = re.findall(r"(\d+) bytes spill stores", report)
        warns = sorted(set(re.findall(r"warning[^\n]*", report)))
        print(name, [(re.sub(r"^.*_cu_[0-9a-f]{8}\d+", "", n)[:44], int(r))
                     for n, r in regs], "spill stores", spills,
              "warnings", warns[:6], flush=True)
        good.append(name)

    held = []
    for name in good:
        fa._FN["flash_attention_tc256"] = bind(os.path.join(OUT,
                                                            name + ".so"))
        beyond = []
        n = 0
        for dtype in (torch.bfloat16, torch.float16):
            for cases, rate, causal in (
                    (cs.FLASH_CASES_256, 0.0, True),
                    (cs.FLASH_DROP_CASES_256, cs.FLASH_DROPOUT, True),
                    (cs.FLASH_NONCAUSAL_CASES_256, 0.0, False),
                    (cs.FLASH_NONCAUSAL_CASES_256, cs.FLASH_DROPOUT, False)):
                for case in cases:
                    n += 1
                    try:
                        routes = cs.compare_flash_case(
                            torch, fa, dtype, case, {}, rate,
                            SEED if rate else None, causal=causal)
                        if routes != ("tc256",) * 3:
                            beyond.append(f"{case}: routes {routes}")
                    except RuntimeError as e:
                        beyond.append(str(e)[:300])
        print(f"{name}: {n - len(beyond)} of {n} chip_smoke flash cases "
              f"above D = 128 within its tolerances; beyond: {beyond}",
              flush=True)
        if beyond:
            failed.append(name)
        else:
            held.append(name)

    b, s, h, d = cs.FLASH_D256_SHAPE
    scale = d ** -0.5
    prepped = []
    for i in range(4):
        _qkv, q, k, v, dout, _m = cs.flash_case(torch, torch.bfloat16, b, s,
                                                h, d, seed=100 + i)
        out, lse = fa._launch_fwd("flash_attention", q, k, v, None, True,
                                  scale, 0.0, None)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        prepped.append((q, k, v, dout, lse, delta.contiguous()))
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(prepped)
        return prepped[it["i"]]

    for rate in (0.0, 0.1):
        drop = (rate, SEED if rate else None)

        def fma_fwd():
            q, k, v = nxt()[:3]
            fa._launch_fwd("flash_attention", q, k, v, None, True, scale,
                           *drop)

        def fma_dq():
            q, k, v, dout, lse, delta = nxt()
            fa._launch_dq("flash_attention", q, k, v, dout, None, lse,
                          delta, True, scale, *drop)

        def fma_dkv():
            q, k, v, dout, lse, delta = nxt()
            fa._launch_dkv("flash_attention", q, k, v, dout, None, lse,
                           delta, True, scale, *drop)

        print(f"FMA kernels on the same inputs, dropout {rate}: fwd "
              f"{cs.device_ms(torch, fma_fwd)[0]:.4f} ms, dq "
              f"{cs.device_ms(torch, fma_dq)[0]:.4f} ms, dkv "
              f"{cs.device_ms(torch, fma_dkv)[0]:.4f} ms (device time)",
              flush=True)
    for rnd, order in enumerate((held, list(reversed(held)))):
        for name in order:
            fa._FN["flash_attention_tc256"] = bind(os.path.join(
                OUT, name + ".so"))
            for rate in (0.0, 0.1):
                drop = (rate, SEED if rate else None)

                def fwd():
                    q, k, v = nxt()[:3]
                    fa.flash_attention_fwd_tc256(q, k, v, None, True, scale,
                                                 *drop)

                def dq():
                    q, k, v, dout, lse, delta = nxt()
                    fa.flash_attention_bwd_dq_tc256(
                        q, k, v, dout, None, lse, delta, True, scale, *drop)

                def dkv():
                    q, k, v, dout, lse, delta = nxt()
                    fa.flash_attention_bwd_dkv_tc256(
                        q, k, v, dout, None, lse, delta, True, scale, *drop)

                t_fwd, _ = cs.device_ms(torch, fwd)
                t_dq, _ = cs.device_ms(torch, dq)
                t_dkv, _ = cs.device_ms(torch, dkv)
                print(f"round {rnd} {name} dropout {rate}: fwd {t_fwd:.4f} "
                      f"ms, dq {t_dq:.4f} ms, dkv {t_dkv:.4f} ms (device "
                      f"time, bf16 {list(cs.FLASH_D256_SHAPE)} causal)",
                      flush=True)
    fa._FN.pop("flash_attention_tc256", None)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

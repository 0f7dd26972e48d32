#!/usr/bin/env python3
"""Check and design probe of the fp32 chunked-prefill run kernels
(``deepspeed_tpu_torch/csrc/chunked_prefill.cu``: ``chunked_tf32_kernel``
for runs of two or more tokens, ``chunked_decode_kernel<float>`` for
decode rows) on one GPU.

    python3 tools/probe_chunked_tf32.py [--check]

Builds the source and prints every kernel's registers and spills. Holds
the fp32 run kernels against the plain version (atol 1e-5, NaN scratch,
pad rows excluded, bit-equal over two launches) at ``chip_smoke.py``'s
T=256 mixed step and its chunk across 64 tokens, over fp32 and int8
pools, also at head dims 8, 72 and 128. With ``--check`` it stops there.
Else it builds variants of the source (``tf32_mma.cuh``, its products'
header, inlined) with ``nvcc`` into ``build/chunked_tf32_variants/`` (a
directory ``.gitignore`` lists), all started together:

- ``source``: the source as it is (64-key tiles, each warp of a 16-row
  group's pair on 32 of its keys; two K/V stages; q's hi/lo fragments
  split from shared memory at every tile);
- ``bn32``: 32-key tiles (16 keys a warp);
- ``stages3``: three K/V stages (two tiles in flight behind the one
  used) where they fit (not fp32 pools at DMAX = 128);
- ``q_regs``: q's hi/lo fragments split once, at the first tile, and
  kept in registers at DMAX = 64;
- ``one_warp``: one warp a row group (4 warps) on every key of a tile,
  so no halves to combine;
- ``one_product``: hi.hi alone (wrong at fp32's 1e-5: timed only);
- ``no_mma``: the tile loop without its products (wrong: timed only, the
  loads, splits and softmax alone).

Holds every variant but the last two like the source, then times each at
the T=256 mixed step (8 layers' pools in rotation, device time): the run
kernels, the chunk items alone and each launch's kernel time by the
profiler, over fp32 and int8 pools, with items of 64 tokens and of 32
(``TC_TOKENS``), in two rounds of opposite order, beside the first kernel
on the same inputs. Exits non-zero without CUDA or on any miss.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "chunked_tf32_variants")
HEADER = '#include "tf32_mma.cuh"\n'
LO_TERMS = "    mma8(d, ah, bl);\n    mma8(d, al, bh);\n  } else {\n" \
           "    mma8(d, al, bh);\n    mma8(d, ah, bl);\n  }\n  mma8(d, ah, bh);\n"
CODE_LO = "  attn_tf32::mma8(d, al, b);\n"
CODE_HI = "  attn_tf32::mma8(d, ah, b);\n"
BN = "constexpr int TF32_BN = 64;"
NSTG = "  constexpr int NSTG = TF32_STAGES;\n"   # the smem size's and the kernel's
QW = "  const float* Qw = Qs + rg * 16 * DP;\n"
Q_SPLIT = "        a_rows<DP>(Qw, kc * 8, ah, al);\n"
NT = "constexpr int TF32_NT = 256;"
KH = "  constexpr int KH = BN / 2;"
HALF_M = "const float mb0 = half_m[r0], mb1 = half_m[r0 + 8];"
HALF_L0 = "half_l[r0] * wb0"
HALF_L1 = "half_l[r0 + 8] * wb1"
TOL = 1e-5
# (label, tokens, decode positions, chunks, head dim)
CASES = (("T=256 mixed", 256, None, None, 64),
         ("T=128 chunks across 64", 128, "cross", "cross", 64),
         ("T=128 D=8", 128, "cross", "cross", 8),
         ("T=128 D=72", 128, "cross", "cross", 72),
         ("T=128 D=128", 128, "cross", "cross", 128))


def variants(src: str) -> dict:
    for text, n in ((LO_TERMS, 1), (CODE_LO, 1), (CODE_HI, 1), (BN, 1),
                    (NSTG, 2), (QW, 1), (Q_SPLIT, 1), (NT, 1), (KH, 1),
                    (HALF_M, 1), (HALF_L0, 1), (HALF_L1, 1)):
        if src.count(text) != n:
            raise SystemExit(f"probe_chunked_tf32: {text!r} moved")
    q_regs = src.replace(QW, QW + "  uint32_t qh[DMAX <= 64 ? KS : 1][4], "
                         "ql[DMAX <= 64 ? KS : 1][4];\n").replace(
        Q_SPLIT, "        if constexpr (DMAX <= 64) {\n"
                 "          if (n == 0) a_rows<DP>(Qw, kc * 8, qh[kc], "
                 "ql[kc]);\n"
                 "#pragma unroll\n"
                 "          for (int e = 0; e < 4; ++e) {\n"
                 "            ah[e] = qh[kc][e];\n"
                 "            al[e] = ql[kc][e];\n"
                 "          }\n"
                 "        } else {\n  " + Q_SPLIT + "        }\n")
    # one key half: half 1's (m, l, o) never written, so weighed by 0
    one_warp = (src.replace(NT, "constexpr int TF32_NT = 128;")
                .replace(KH, "  constexpr int KH = BN;")
                .replace(HALF_M, "const float mb0 = -INFINITY, mb1 = "
                         "-INFINITY;")
                .replace(HALF_L0, "0.f").replace(HALF_L1, "0.f"))
    return {"source": src,
            "bn32": src.replace(BN, "constexpr int TF32_BN = 32;"),
            "stages3": src.replace(NSTG, "  constexpr int NSTG = sizeof(P) "
                                   "== 1 || DMAX <= 64 ? 3 : 2;\n"),
            "q_regs": q_regs,
            "one_warp": one_warp,
            "one_product": src.replace(LO_TERMS, "  } else {\n  }\n"
                                       "  mma8(d, ah, bh);\n").replace(
                CODE_LO, ""),
            "no_mma": src.replace(LO_TERMS, "  } else {\n  }\n").replace(
                CODE_LO, "").replace(CODE_HI, "")}


def tf32_report(text: str) -> str:
    """The ``-Xptxas -v`` lines of each ``chunked_tf32_kernel``
    instantiation: registers, stack frame and spill stores (the mangled
    template arguments: ``f`` fp32 or ``a`` int8 pools, then DMAX)."""
    out = []
    for block in text.split("Compiling entry function")[1:]:
        m = re.search(r"chunked_tf32_kernelI(\w+?)EEv", block)
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", block)
        out.append(f"{m.group(1)}: {regs and regs.group(1)} registers, "
                   f"{frame and frame.group(1)} bytes stack, "
                   f"{frame and frame.group(2)} bytes spilled")
    return "; ".join(out) or "no chunked_tf32_kernel in the report"


def case_inputs(torch, cs, case, int8, layers=1, seed=0):
    _label, t, dpos, chunks, d = case
    dpos = cs.MIXED_DECODE_POS if dpos is None else cs.CROSS_DECODE_POS
    chunks = cs.MIXED_CHUNKS if chunks is None else cs.CROSS_CHUNKS
    return cs.chunked_case(torch, torch.float32, t, dpos, chunks,
                           seed=t + d + int8 + seed, layers=layers,
                           int8=int8, d=d)


def hold(torch, cs, cp, tag):
    """The fp32 run kernels against the plain version in CASES over fp32
    and int8 pools; returns the worst error."""
    worst = 0.0
    for case in CASES:
        for int8 in (False, True):
            q, pools, table, pos, n_real, _b = case_inputs(torch, cs, case,
                                                           int8)
            args = (q, *pools[0], table, pos)
            got, again = (cp.chunked_prefill_attention_tf32(*args,
                                                            block_size=16)
                          for _ in range(2))
            want = cp.chunked_prefill_attention_reference(*args,
                                                          block_size=16)
            torch.cuda.synchronize()
            if not cs.same_bits(torch, got, again):
                cs.fail(f"probe_chunked_tf32 {tag} {case[0]} int8={int8}: "
                        f"two launches differ")
            err = (got[:n_real] - want[:n_real]).abs().max().item()
            if not torch.isfinite(got[:n_real]).all() or not err <= TOL:
                cs.fail(f"probe_chunked_tf32 {tag} {case[0]} int8={int8}: "
                        f"max |err| {err:.3g}")
            worst = max(worst, err)
    print(f"{tag}: held in every case, max |err| {worst:.3g} (atol {TOL})",
          flush=True)
    return worst


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_chunked_tf32: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] not in ([], ["--check"]):
        print("usage: probe_chunked_tf32.py [--check]", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import chunked_prefill as cp

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    lib = build.build_all(["chunked_prefill"])[0]
    print(f"{os.path.relpath(lib, HERE)}: "
          f"{cs.ptxas_summary(lib, each=True)}", flush=True)
    with open(lib[:-3] + ".log") as f:
        print(f"source chunked_tf32_kernel: {tf32_report(f.read())}",
              flush=True)
    hold(torch, cs, cp, "source")
    if sys.argv[1:] == ["--check"]:
        return 0

    with open(os.path.join(build.CSRC, "chunked_prefill.cu")) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "tf32_mma.cuh")) as f:
        srcs = variants(src.replace(HEADER, f.read()))
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             os.path.join(OUT, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_chunked_tf32: {name} failed:\n{err}")
        print(f"{name} chunked_tf32_kernel: {tf32_report(err)}",
              flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        mine = lib.chunked_prefill_tf32_fwd
        ref = cp._kernel()["tf32"]
        mine.argtypes, mine.restype = ref.argtypes, ref.restype
        fns[name] = mine
    source_fn = cp._kernel()["tf32"]

    def use(name):
        cp._FN["tf32"] = fns[name]

    for name in srcs:
        if name not in ("source", "one_product", "no_mma"):
            use(name)
            hold(torch, cs, cp, name)
    cp._FN["tf32"] = source_fn

    # timing at the mixed step, 8 layers' pools in rotation (no NaN)
    data = {}
    for int8 in (False, True):
        q, pools, table, pos, _n, _b = case_inputs(torch, cs, CASES[0], int8,
                                                   layers=8, seed=5)
        for k, v, ks, vs in pools:
            if int8:
                ks[0] = 1.0
                vs[0] = 1.0
            else:
                k[0] = 0.0
                v[0] = 0.0
        runs = {}
        for tokens in (64, 32):
            cp.TC_TOKENS = tokens
            r = cp.chunked_runs(table.cpu(), pos.cpu(), 16)
            runs[tokens] = (r, cp.ChunkedRuns(r.items[:r.n_chunk],
                                              np.zeros((0, 4))))
        cp.TC_TOKENS = 64
        data[int8] = (q, pools, table, pos, runs)
    it = {"i": 0}

    def call(int8, tokens, chunk_only):
        q, pools, table, pos, runs = data[int8]
        r = runs[tokens][1 if chunk_only else 0]

        def go():
            it["i"] = (it["i"] + 1) % len(pools)
            cp.chunked_prefill_attention_tf32(q, *pools[it["i"]], table, pos,
                                              block_size=16, runs=r)
        return go

    def first(int8):
        q, pools, table, pos, _runs = data[int8]

        def go():
            it["i"] = (it["i"] + 1) % len(pools)
            cp._launch_walk(q, *pools[it["i"]], table, pos, 16, None)
        return go

    times, kernels = {}, {}
    order = list(srcs)
    for names in (order, order[::-1]):
        for name in names:
            use(name)
            for int8 in (False, True):
                for tokens in (64, 32):
                    for chunk_only in (False, True):
                        key = (f"{name} {'int8' if int8 else 'fp32'} "
                               f"items of {tokens}"
                               + (" chunk items alone" if chunk_only
                                  else ""))
                        ms, per = cs.device_ms(
                            torch, call(int8, tokens, chunk_only), iters=20,
                            warmup=3, names=chunk_only)
                        times.setdefault(key, []).append(round(ms, 4))
                        if per:
                            kernels.setdefault(key, []).append(
                                {n[:40]: round(v, 4) for n, v in per.items()})
    cp._FN["tf32"] = source_fn
    for int8 in (False, True):
        times[f"first kernel {'int8' if int8 else 'fp32'}"] = [round(
            cs.device_ms(torch, first(int8))[0], 4)]
    print(f"probe_chunked_tf32 timing at the T=256 mixed step ({card}; "
          f"device ms, two rounds): {json.dumps(times)}", flush=True)
    print(f"probe_chunked_tf32 kernel times by the profiler (ms a call): "
          f"{json.dumps(kernels)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

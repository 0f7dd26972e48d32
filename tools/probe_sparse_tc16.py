#!/usr/bin/env python3
"""Check and design probe of the 16-row tensor-core block-sparse forward
and backward (``deepspeed_tpu_torch/csrc/sparse_attention_tc16.cu``) on
one GPU.

    python3 tools/probe_sparse_tc16.py

Builds the source (and ``sparse_attention.cu``, the fp32 route) and
prints its registers, shared memory and spills; holds the forward, dq and
dk/dv against their plain versions in ``chip_smoke.py``'s phase 2d cases
at blocks of 16 and 32 ((b), (g), (h): fixed 16 with a key mask, BigBird
32 causal, D = 128), at SPARSE_SMALL_CAP16 too, bit-equal over two
launches. Then builds variants of the source with ``nvcc`` into
``build/sparse_tc16_variants/`` (a directory ``.gitignore`` lists), one
per process, all started together:

- ``source``: the source as it is;
- ``branchy``: the step's products always take the copy that tests each
  entry's bit (the copy for a warp that lists all 4 entries never runs);
- ``two_blocks``: both kernels at 2 blocks an SM at D <= 64 (more
  registers, no spills);
- ``three_blocks``: dq at 3 blocks an SM at D <= 64 instead of 4 (dk/dv
  runs 3 in every variant);
- ``four_blocks_bq32``: dk/dv at 4 blocks an SM (at most 128 registers),
  streaming 32 queries a step;
- ``bq32``: dk/dv streams 32 queries a step at 3 blocks an SM;
- ``fwd_three_blocks``: the forward at 3 blocks an SM at D <= 64 instead
  of 4;
- ``no_products``: every load, wait and store of the walk, no product
  (wrong results: timed only);
- ``no_steps``: each block's prologue and epilogue only (wrong results:
  timed only).

Holds every variant but the last two against the plain versions at the
sparse BERT shape ([8, 512, 16, 64] bf16, BERT_SPARSE, non-causal, key
mask; the forward's o and lse), then times the forward, dq and dk/dv of
every variant on 4 layers' inputs in rotation, in two rounds of opposite
order. Exits non-zero without CUDA or on any miss.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "sparse_tc16_variants")
FULL = "constexpr unsigned FULL_LIVE = (1u << EPS) - 1;"
LIVE = "      live |= ((unsigned)(Wt[ENTRY * e + 1] >> warp) & 1u) << e;"
STEPS = "  const int steps = (cnt + EPS - 1) / EPS;"
DQ_BOUNDS = "__launch_bounds__(NT, DMAX <= 64 ? 4 : 1) sparse_dq"
DKV_BOUNDS = "__launch_bounds__(NT, DMAX <= 64 ? 3 : 1) sparse_dkv"
FWD_BOUNDS = "__launch_bounds__(NT, DMAX <= 64 ? 4 : 1) sparse_fwd"
BQ = "  constexpr int BQ = DMAX <= 64 ? 64 : 32;"
HELD = ("source", "branchy", "two_blocks", "three_blocks",
        "four_blocks_bq32", "bq32", "fwd_three_blocks")
KERNELS = ("fwd", "dq", "dkv")


def bounds(src: str, dq: int, dkv: int) -> str:
    return src.replace(DQ_BOUNDS, DQ_BOUNDS.replace("4 : 1", f"{dq} : 1")) \
        .replace(DKV_BOUNDS, DKV_BOUNDS.replace("3 : 1", f"{dkv} : 1"))


def variants(src: str) -> dict:
    for text, n in ((FULL, 3), (LIVE, 3), (STEPS, 3), (DQ_BOUNDS, 1),
                    (DKV_BOUNDS, 1), (FWD_BOUNDS, 1), (BQ, 2)):
        if src.count(text) != n:
            raise SystemExit(f"probe_sparse_tc16: {text!r} moved")
    bq32 = src.replace(BQ, "  constexpr int BQ = 32;")
    return {"source": src,
            "branchy": src.replace(FULL, "constexpr unsigned FULL_LIVE = ~0u;"),
            "two_blocks": bounds(src, 2, 2),
            "three_blocks": bounds(src, 3, 3),
            "four_blocks_bq32": bounds(bq32, 4, 4),
            "bq32": bq32,
            "fwd_three_blocks": src.replace(
                FWD_BOUNDS, FWD_BOUNDS.replace("4 : 1", "3 : 1")),
            "no_products": src.replace(LIVE, "      live |= 0u * e;"),
            "no_steps": src.replace(STEPS, "  const int steps = 0 * cnt;")}


def bert_inputs(torch, cs, sp):
    """4 layers' inputs at the sparse BERT shape, as
    ``time_sparse_block16`` makes them."""
    import numpy as np

    b, s, h, d = 8, 512, 16, 64
    scale = d ** -0.5
    layout = cs.sparse_layout(cs.BERT_SPARSE, h, s)
    plan = sp.sparse_plan(layout, cs.BERT_SPARSE["block"])
    lens = np.random.default_rng(5).integers(s // 2, s + 1, b)
    mask = torch.from_numpy(np.arange(s)[None] < lens[:, None]).cuda()
    layers = []
    for i in range(4):
        _qkv, q, k, v, dout, _m = cs.flash_case(torch, torch.bfloat16, b, s,
                                                h, d, seed=400 + i)
        q, k, v, km = sp._prepare(q, k, v, mask, plan)
        out, lse = sp.sparse_attention_fwd(q, k, v, km, plan, False, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        layers.append((q, k, v, dout, km, lse, delta.contiguous(), plan,
                       False, scale))
    return layers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sparse_tc16: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build

    sp = cs.sparse_module()
    print(cs.card_line())
    libs = build.build_all(["sparse_attention_tc16", "sparse_attention"])
    print(f"{os.path.relpath(libs[0], HERE)}: "
          f"{cs.ptxas_summary(libs[0], each=True)}")
    cases = [c for c in cs.SPARSE_CASES if c[0] in ("b", "g", "h")]
    cs.check_sparse_attention(torch, {}, cases=cases, timing=False)

    with open(os.path.join(build.CSRC, "sparse_attention_tc16.cu")) as f:
        srcs = variants(f.read())
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
    src_fns = sp._kernel("sparse_attention_tc16")
    fns = {}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_sparse_tc16: {name} failed:\n{err}")
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", err)))
        print(f"{name}: spill stores {spills}")
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        fns[name] = {}
        for key, fn in src_fns.items():
            sym = {"err": "sparse_attention_tc16_error_string",
                   "fwd": "sparse_attention_tc16_fwd"}.get(
                       key, f"sparse_attention_tc16_bwd_{key}")
            got = getattr(lib, sym)
            got.argtypes, got.restype = fn.argtypes, fn.restype
            fns[name][key] = got
    layers = bert_inputs(torch, cs, sp)
    a = layers[0]
    fa = (*a[:3], a[4], *a[7:])
    want_o, want_lse = sp.sparse_fwd_reference(*fa)
    want_dq = sp.sparse_bwd_dq_reference(*a)
    want_dkv = torch.cat(sp.sparse_bwd_dkv_reference(*a), -1)
    for name in HELD:
        sp._FN["sparse_attention_tc16"] = fns[name]
        o, lse = sp.sparse_attention_fwd_tc16(*fa)
        dq = sp.sparse_attention_bwd_dq_tc16(*a)
        dkv = torch.cat(sp.sparse_attention_bwd_dkv_tc16(*a), -1)
        torch.cuda.synchronize()
        errs = [float((x.float() - w.float()).abs().max())
                for x, w in ((o, want_o), (dq, want_dq), (dkv, want_dkv))]
        lse_err = float((lse - want_lse).abs().max())
        print(f"{name}: max |err| o {errs[0]:.3g}, lse {lse_err:.3g}, dq "
              f"{errs[1]:.3g}, dk/dv {errs[2]:.3g}")
        if not max(errs) < 0.05 or not lse_err <= cs.SPARSE_LSE_TOL:
            raise SystemExit(f"probe_sparse_tc16: {name} disagrees")
    it = {"i": 0}

    def call(which):
        def go():
            it["i"] = (it["i"] + 1) % len(layers)
            x = layers[it["i"]]
            if which == "fwd":
                return sp.sparse_attention_fwd_tc16(*x[:3], x[4], *x[7:])
            fn = (sp.sparse_attention_bwd_dq_tc16 if which == "dq" else
                  sp.sparse_attention_bwd_dkv_tc16)
            return fn(*x)
        return go

    times = {}
    order = list(fns)
    for names in (order, order[::-1]):
        for name in names:
            sp._FN["sparse_attention_tc16"] = fns[name]
            times.setdefault(name, []).append(tuple(
                round(cs.device_ms(torch, call(w), iters=20, warmup=3)[0], 4)
                for w in KERNELS))
    sp._FN["sparse_attention_tc16"] = src_fns
    print(f"16-row (forward, dq, dk/dv) device ms at the sparse BERT shape "
          f"by variant (two rounds): {times}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Check and design probe of the 3xTF32 block-sparse dq and dk/dv
(``deepspeed_tpu_torch/csrc/sparse_attention_tf32.cu``) on one GPU.

    python3 tools/probe_sparse_tf32.py [--check]

Builds the source (and ``sparse_attention.cu``, whose FMA forward gives
the lse and whose FMA dq and dk/dv are the first versions) and prints
each kernel's registers and spills. Holds dq and dk/dv against their
plain versions in fp32, within 1e-5 of the reference's largest |value|,
bit-equal over two launches, the FMA dq and dk/dv on the same inputs
beside them (CASES: the long-sequence path's layout, BigBird block 256
causal, at seq 4096 and at its own [1, 16384, 12, 64]; sparse BERT's
``fixed`` block 16 with a key mask holding an all-padding row, also at a
cap of 1 step, where every walk splits; head dims 8, 72 and 128). With
``--check`` it stops there. Else it builds variants of the source (with
``tf32_mma.cuh``, its products' header, inlined) with ``nvcc`` into
``build/sparse_tf32_variants/`` (a directory ``.gitignore`` lists), all
started together:

- ``source``: the source as it is (one walk entry, 16 rows, a step; 4
  blocks an SM at D <= 64);
- ``eps2``: 2 entries (32 rows) a step, 3 blocks an SM;
- ``eps4``: 4 entries (64 rows) a step, 2 blocks an SM;
- ``one_product``: hi.hi alone (one TF32 product; wrong at fp32's 1e-5:
  timed only).

Holds ``eps2`` and ``eps4`` like the source, then times dq and dk/dv of
every variant at the path's shape [1, 16384, 12, 64] fp32 on 4 layers'
inputs in rotation, in two rounds of opposite order, beside the FMA
kernels on the same inputs, all as device time, and the source at split
caps of 4, 16, 64 and 256 steps. Exits non-zero without CUDA or on
any miss.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "sparse_tf32_variants")
HEADER = '#include "tf32_mma.cuh"\n'
LO_TERMS = "  mma8(d, al, bh);\n  mma8(d, ah, bl);\n"
EPS = "constexpr int EPS = 1;"
BLOCKS = "constexpr int BLOCKS64 = 4;"
HELD = ("source", "eps2", "eps4")
REL = 1e-5                       # of the reference's largest |value|
# (case, B, S, H, D, layout, causal, key mask, cap)
CASES = (
    ("a", 1, 4096, 12, 64, "long", True, False, None),
    ("b", 2, 1024, 12, 64, "fixed16", False, True, None),
    ("b cap 1", 2, 1024, 12, 64, "fixed16", False, True, 1),
    ("d8", 2, 1024, 4, 8, "bigbird16", True, True, 1),
    ("d72", 1, 1024, 4, 72, "fixed64", False, False, None),
    ("d128", 2, 1024, 4, 128, "bigbird16", True, True, 1),
    ("long", 1, 16384, 12, 64, "long", True, False, None))


def layouts(cs):
    return {"long": cs.SPARSE_LONG,
            "fixed16": {"mode": "fixed", "block": 16},
            "bigbird16": dict(cs.SPARSE_LONG, block=16),
            "fixed64": {"mode": "fixed", "block": 64}}


def variants(src: str) -> dict:
    for text in (LO_TERMS, EPS, BLOCKS):
        if src.count(text) != 1:
            raise SystemExit(f"probe_sparse_tf32: {text!r} moved")
    return {"source": src,
            "eps2": src.replace(EPS, "constexpr int EPS = 2;").replace(
                BLOCKS, "constexpr int BLOCKS64 = 3;"),
            "eps4": src.replace(EPS, "constexpr int EPS = 4;").replace(
                BLOCKS, "constexpr int BLOCKS64 = 2;"),
            "one_product": src.replace(LO_TERMS, "")}


def inputs(torch, cs, sp, case, seed=0):
    """One case's fp32 inputs as the backward receives them: q, k, v
    views of one fused projection, dO x 0.1, the key mask (its second
    row all padding), lse from the FMA forward and delta."""
    _c, b, s, h, d, lay, causal, masked, _cap = case
    cfg = layouts(cs)[lay]
    plan = sp.sparse_plan(cs.sparse_layout(cfg, h, s), cfg["block"])
    _qkv, q, k, v, dout, mask = cs.flash_case(
        torch, torch.float32, b, s, h, d, seed=s + d + masked + seed,
        masked=masked, dout_scale=0.1)
    q, k, v, km = sp._prepare(q, k, v, mask, plan)
    scale = d ** -0.5
    out, lse = sp._launch_fma_fwd(q, k, v, km, plan, causal, scale)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, dout, km, lse, delta, plan, causal, scale


def hold(torch, cs, sp, tag, cases=CASES):
    """dq and dk/dv of the loaded library against the plain versions in
    ``cases``; returns the worst error over each reference's largest
    |value|, the FMA kernels' beside it."""
    worst = {}
    for case in cases:
        a = inputs(torch, cs, sp, case)
        cap = case[-1]
        got = [sp.sparse_attention_bwd_dq_tf32(*a, cap=cap),
               *sp.sparse_attention_bwd_dkv_tf32(*a, cap=cap)]
        again = [sp.sparse_attention_bwd_dq_tf32(*a, cap=cap),
                 *sp.sparse_attention_bwd_dkv_tf32(*a, cap=cap)]
        fma = [sp._launch_fma("dq", *a), *sp._launch_fma("dkv", *a)]
        ref = [sp.sparse_bwd_dq_reference(*a), *sp.sparse_bwd_dkv_reference(
            *a)]
        torch.cuda.synchronize()
        for name, g, g2, f, r in zip(("dq", "dk", "dv"), got, again, fma,
                                     ref):
            top = r.abs().max().item()
            err = (g - r).abs().max().item() / max(top, 1e-30)
            ferr = (f - r).abs().max().item() / max(top, 1e-30)
            if not cs.same_bits(torch, g, g2):
                cs.fail(f"probe_sparse_tf32 {tag} {case[0]} {name}: two "
                        f"launches differ")
            if not torch.isfinite(g).all() or not err <= REL:
                cs.fail(f"probe_sparse_tf32 {tag} {case[0]} {name}: "
                        f"{err:.3g} of the largest |value| {top:.3g}")
            if a[4] is not None and g[1].abs().max().item() != 0.0:
                cs.fail(f"probe_sparse_tf32 {tag} {case[0]} {name}: the "
                        f"all-padding batch row is not 0")
            worst[(case[0], name)] = (err, ferr, top)
        del a, got, again, fma, ref
        torch.cuda.empty_cache()
    print(f"{tag}: held in every case (error over the reference's largest "
          f"|value|, 3xTF32 / FMA, largest): " + json.dumps(
              {f"{c} {n}": [f"{e:.3g}", f"{f:.3g}", f"{t:.3g}"]
               for (c, n), (e, f, t) in worst.items()}), flush=True)
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sparse_tf32: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] not in ([], ["--check"]):
        print("usage: probe_sparse_tf32.py [--check]", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build

    sp = cs.sparse_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    libs = build.build_all(["sparse_attention_tf32", "sparse_attention"])
    print(f"{os.path.relpath(libs[0], HERE)}: "
          f"{cs.ptxas_summary(libs[0], each=True)}", flush=True)
    hold(torch, cs, sp, "source")
    if sys.argv[1:] == ["--check"]:
        return 0

    with open(os.path.join(build.CSRC, "sparse_attention_tf32.cu")) as f:
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
    src_fns = sp._kernel("sparse_attention_tf32")
    fns = {}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_sparse_tf32: {name} failed:\n{err}")
        regs = re.findall(r"Used (\d+) registers", err)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", err)))
        print(f"{name}: registers {regs}, spill stores {spills}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        fns[name] = {}
        for key, fn in src_fns.items():
            sym = ("sparse_attention_tf32_error_string" if key == "err" else
                   f"sparse_attention_tf32_bwd_{key}")
            mine = getattr(lib, sym)
            mine.argtypes, mine.restype = fn.argtypes, fn.restype
            fns[name][key] = mine

    def use(name):
        sp._FN["sparse_attention_tf32"] = fns[name]

    for name in HELD[1:]:
        use(name)
        hold(torch, cs, sp, name, CASES[1:3])

    # timing at the path's shape, 4 layers' inputs in rotation
    layers = [inputs(torch, cs, sp, CASES[-1], seed=1000 * i)
              for i in range(4)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(layers)
        return layers[it["i"]]

    def call(which, how, cap=None):
        def go():
            a = nxt()
            if how == "fma":
                return sp._launch_fma(which, *a)
            return (sp.sparse_attention_bwd_dq_tf32 if which == "dq" else
                    sp.sparse_attention_bwd_dkv_tf32)(*a, cap=cap)
        return go

    times = {}
    order = list(srcs) + ["fma"]
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            if name != "fma":
                use(name)
            for which in ("dq", "dkv"):
                ms = cs.device_ms(torch, call(which, "fma" if name == "fma"
                                              else "tf32"),
                                  iters=10, warmup=2)[0]
                times.setdefault(f"{name} {which}", []).append(ms)
    use("source")
    caps = {}
    for cap in (4, 16, 64, 256):
        caps[cap] = {which: cs.device_ms(torch, call(which, "tf32", cap),
                                         iters=10, warmup=2)[0]
                     for which in ("dq", "dkv")}
    plan = layers[0][7]
    nbytes = {w: cs.sparse_bytes_flops(layers[0][0], cs.sparse_pairs(
        plan.layout, plan.block, True), w) for w in ("dq", "dkv")}
    print(f"probe_sparse_tf32 timing fp32 [1, 16384, 12, 64] bigbird 256 "
          f"causal ({card}; device ms, two rounds): {json.dumps(times)}; "
          f"the source's split cap (steps of 64 rows): {json.dumps(caps)}; "
          f"bounds (bytes / 3.35 TB/s, flops / 165 TFLOP/s): "
          + json.dumps({w: [n / cs.HBM_BYTES_PER_S * 1e3,
                            f / cs.FP32_3XTF32_FLOPS * 1e3]
                        for w, (n, f) in nbytes.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

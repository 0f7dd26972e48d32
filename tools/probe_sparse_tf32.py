#!/usr/bin/env python3
"""Check and design probe of the 3xTF32 block-sparse forward, dq and
dk/dv (``deepspeed_tpu_torch/csrc/sparse_attention_tf32.cu``) on one GPU.

    python3 tools/probe_sparse_tf32.py [--check]

Builds the source (and ``sparse_attention.cu``, whose FMA forward, dq and
dk/dv are the first versions) and prints each kernel's registers and
spills. Holds the forward, dq and dk/dv against their plain versions in
fp32 (the forward's o to atol 1e-5 and its lse to 1e-5 on the rows with
a visible key, -1e30 exactly on the others; dq and dk/dv within 1e-5 of
the reference's largest |value|), bit-equal over two launches, the FMA
kernels on the same inputs beside them; dq and dk/dv read the 3xTF32
forward's lse (CASES: the long-sequence path's layout, BigBird block 256
causal, at seq 4096 and at its own [1, 16384, 12, 64]; sparse BERT's
``fixed`` block 16 with a key mask holding an all-padding row, also at a
cap of 1 step, where every walk splits; head dims 8, 72 and 128). With
``--check`` it stops there. Else it builds variants of the source (with
``tf32_mma.cuh``, its products' header, inlined) with ``nvcc`` into
``build/sparse_tf32_variants/`` (a directory ``.gitignore`` lists), all
started together:

- ``source``: the source as it is (dq and dk/dv: one walk entry, 16
  rows, a step, 4 blocks an SM at D <= 64; the forward: FEPS entries a
  step, FWD64 blocks an SM);
- ``eps2``, ``eps4``: dq and dk/dv at 2 entries (32 rows) a step and 3
  blocks an SM, at 4 entries (64 rows) and 2 blocks;
- ``fwd_eps1``, ``fwd_eps2``, ``fwd_eps4``: the forward at 1 entry a
  step and 4 blocks an SM, at 2 entries and 4 blocks, at 4 entries and 2
  blocks; ``fwd_eps2_b3``: 2 entries and 3 blocks (more registers); the
  one among them that is the source's setting is left out;
- ``one_product``: hi.hi alone (one TF32 product; wrong at fp32's 1e-5:
  timed only).

Holds every variant but ``one_product`` like the source at sparse BERT's
layout, then times the forward, dq and dk/dv of every variant at the
path's shape [1, 16384, 12, 64] fp32 and the forward also at sparse
BERT's [8, 512, 16, 64] fp32 (its layout and key mask), on 4 layers'
inputs in rotation, in two rounds of opposite order, beside the FMA
kernels on the same inputs, all as device time, and the source at split
caps of 4, 16, 64 and 256 steps. Exits non-zero without CUDA or on any
miss.
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
FEPS = re.compile(r"constexpr int FEPS = (\d+);")
FWD64 = re.compile(r"constexpr int FWD64 = (\d+);")
# the forward's (entries a step, blocks an SM at D <= 64) variants
FWD_VARIANTS = {"fwd_eps1": (1, 4), "fwd_eps2": (2, 4), "fwd_eps2_b3": (2, 3),
                "fwd_eps4": (4, 2)}
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
# sparse BERT's shape, its layout at block 16 and key mask (chip_smoke.py's
# time_sparse_fp32_block16)
BERT = ("bert", 8, 512, 16, 64, "bert16", False, True, None)


def layouts(cs):
    return {"long": cs.SPARSE_LONG,
            "bert16": cs.BERT_SPARSE,
            "fixed16": {"mode": "fixed", "block": 16},
            "bigbird16": dict(cs.SPARSE_LONG, block=16),
            "fixed64": {"mode": "fixed", "block": 64}}


def variants(src: str) -> dict:
    for text in (LO_TERMS, EPS, BLOCKS):
        if src.count(text) != 1:
            raise SystemExit(f"probe_sparse_tf32: {text!r} moved")
    if len(FEPS.findall(src)) != 1 or len(FWD64.findall(src)) != 1:
        raise SystemExit("probe_sparse_tf32: FEPS or FWD64 moved")
    out = {"source": src,
           "eps2": src.replace(EPS, "constexpr int EPS = 2;").replace(
               BLOCKS, "constexpr int BLOCKS64 = 3;"),
           "eps4": src.replace(EPS, "constexpr int EPS = 4;").replace(
               BLOCKS, "constexpr int BLOCKS64 = 2;"),
           "one_product": src.replace(LO_TERMS, "")}
    mine = (int(FEPS.search(src).group(1)), int(FWD64.search(src).group(1)))
    for name, (eps, blocks) in FWD_VARIANTS.items():
        if (eps, blocks) != mine:
            out[name] = FWD64.sub(
                f"constexpr int FWD64 = {blocks};",
                FEPS.sub(f"constexpr int FEPS = {eps};", src))
    return out


def inputs(torch, cs, sp, case, seed=0):
    """One case's fp32 inputs as the backward receives them: q, k, v
    views of one fused projection, dO x 0.1, the key mask (its second
    row all padding; at sparse BERT's shape chip_smoke's lengths), lse
    from the 3xTF32 forward and delta."""
    _c, b, s, h, d, lay, causal, masked, _cap = case
    cfg = layouts(cs)[lay]
    plan = sp.sparse_plan(cs.sparse_layout(cfg, h, s), cfg["block"])
    _qkv, q, k, v, dout, mask = cs.flash_case(
        torch, torch.float32, b, s, h, d, seed=s + d + masked + seed,
        masked=masked, dout_scale=0.1)
    if lay == "bert16":
        lens = torch.from_numpy(cs.sparse_bert_lens(b, s)).cuda()
        mask = torch.arange(s, device="cuda")[None] < lens[:, None]
    q, k, v, km = sp._prepare(q, k, v, mask, plan)
    scale = d ** -0.5
    out, lse = sp.sparse_attention_fwd_tf32(q, k, v, km, plan, causal,
                                            scale)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, dout, km, lse, delta, plan, causal, scale


def hold(torch, cs, sp, tag, cases=CASES):
    """The forward, dq and dk/dv of the loaded library against the plain
    versions in ``cases``; returns the worst errors (the forward's o and
    lse absolute, dq's and dk/dv's over each reference's largest |value|),
    the FMA kernels' beside them."""
    worst = {}
    for case in cases:
        a = inputs(torch, cs, sp, case)
        cap = case[-1]
        fa = (*a[:3], a[4], *a[7:])
        fwd = [sp.sparse_attention_fwd_tf32(*fa, cap=cap) for _ in range(2)]
        fma_o, fma_lse = sp._launch_fma_fwd(*fa)
        ref_o, ref_lse = sp.sparse_fwd_reference(*fa)
        torch.cuda.synchronize()
        seen = ref_lse > sp.NEG_INF / 2
        (o, lse), (o2, lse2) = fwd
        if not cs.same_bits(torch, o, o2) or \
                not cs.same_bits(torch, lse, lse2):
            cs.fail(f"probe_sparse_tf32 {tag} {case[0]} fwd: two launches "
                    f"differ")
        if not torch.equal(seen, lse > sp.NEG_INF / 2) or \
                not (lse[~seen] == sp.NEG_INF).all():
            cs.fail(f"probe_sparse_tf32 {tag} {case[0]} fwd: empty rows "
                    f"differ")
        errs = {"o": ((o - ref_o).abs().max().item(),
                      (fma_o - ref_o).abs().max().item()),
                "lse": ((lse - ref_lse)[seen].abs().max().item(),
                        (fma_lse - ref_lse)[seen].abs().max().item())}
        if not torch.isfinite(o).all() or not errs["o"][0] <= REL or \
                not errs["lse"][0] <= REL or \
                (a[4] is not None and o[1].abs().max().item() != 0.0):
            cs.fail(f"probe_sparse_tf32 {tag} {case[0]} fwd: o max |err| "
                    f"{errs['o'][0]:.3g}, lse {errs['lse'][0]:.3g}")
        tops = {"o": ref_o.abs().max().item(),
                "lse": ref_lse[seen].abs().max().item()}
        for name, (e, f) in errs.items():
            worst[(case[0], name)] = (e, f, tops[name])
        del fwd, o, o2, lse, lse2, fma_o, fma_lse, ref_o, ref_lse
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
    print(f"{tag}: held in every case (o, lse: max |err|; dq, dk, dv: "
          f"error over the reference's largest |value|; 3xTF32 / FMA, "
          f"largest): " + json.dumps(
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
    syms = {"err": "sparse_attention_tf32_error_string",
            "fwd": "sparse_attention_tf32_fwd",
            "dq": "sparse_attention_tf32_bwd_dq",
            "dkv": "sparse_attention_tf32_bwd_dkv"}
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
            mine = getattr(lib, syms[key])
            mine.argtypes, mine.restype = fn.argtypes, fn.restype
            fns[name][key] = mine

    def use(name):
        sp._FN["sparse_attention_tf32"] = fns[name]

    for name in srcs:
        if name not in ("source", "one_product"):
            use(name)
            hold(torch, cs, sp, name, CASES[1:3])

    # timing at the path's shape (and the forward's at sparse BERT's), 4
    # layers' inputs in rotation
    shapes = {"long": [inputs(torch, cs, sp, CASES[-1], seed=1000 * i)
                       for i in range(4)],
              "bert": [inputs(torch, cs, sp, BERT, seed=1000 * i)
                       for i in range(4)]}
    it = {"i": 0}

    def nxt(shape):
        it["i"] = (it["i"] + 1) % 4
        return shapes[shape][it["i"]]

    def call(which, how, cap=None, shape="long"):
        def go():
            a = nxt(shape)
            if which == "fwd":
                fa = (*a[:3], a[4], *a[7:])
                if how == "fma":
                    return sp._launch_fma_fwd(*fa)
                return sp.sparse_attention_fwd_tf32(*fa, cap=cap)
            if how == "fma":
                return sp._launch_fma(which, *a)
            return (sp.sparse_attention_bwd_dq_tf32 if which == "dq" else
                    sp.sparse_attention_bwd_dkv_tf32)(*a, cap=cap)
        return go

    times = {}
    order = list(srcs) + ["fma"]
    runs = (("fwd", "long"), ("dq", "long"), ("dkv", "long"),
            ("fwd", "bert"))
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            if name != "fma":
                use(name)
            for which, shape in runs:
                ms = cs.device_ms(torch, call(
                    which, "fma" if name == "fma" else "tf32",
                    shape=shape), iters=10, warmup=2)[0]
                key = f"{name} {which}" + (" bert" if shape == "bert"
                                           else "")
                times.setdefault(key, []).append(ms)
    use("source")
    caps = {}
    for cap in (4, 16, 64, 256):
        caps[cap] = {which: cs.device_ms(torch, call(which, "tf32", cap),
                                         iters=10, warmup=2)[0]
                     for which in ("fwd", "dq", "dkv")}
    layers = shapes["long"]
    plan = layers[0][7]
    nbytes = {w: cs.sparse_bytes_flops(layers[0][0], cs.sparse_pairs(
        plan.layout, plan.block, True), w) for w in ("fwd", "dq", "dkv")}
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

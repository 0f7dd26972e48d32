#!/usr/bin/env python3
"""Check and design probe of the 3xTF32 flash forward, dq and dk/dv
(``deepspeed_tpu_torch/csrc/flash_attention_tf32.cu``) on one GPU.

    python3 tools/probe_flash_tf32.py

Builds the source (and ``flash_attention.cu``, the FMA route) and prints
each kernel's registers and spills; holds the forward, dq and dk/dv
against their plain versions in ``chip_smoke.py``'s fp32 flash cases
(FLASH_CASES and FLASH_CASES_16 at dropout 0 and FLASH_DROP_CASES at 0.1,
causal; FLASH_NONCAUSAL_CASES at 0 and 0.1), the FMA kernels on the same
inputs, dq and dk/dv bit-equal over two launches, all-padding rows
exactly 0. Then
builds variants of the source (with ``tf32_mma.cuh``, its products'
header, inlined) with ``nvcc`` into
``build/flash_tf32_variants/`` (a directory ``.gitignore`` lists), one
per process, all started together:

- ``source``: the source as it is;
- ``presplit``: each streamed tile split once, after it lands, into hi
  (in place) and lo tiles in shared memory, which the fragment loads
  read, instead of a split at every fragment load (two more tiles: 87 KB
  a dq or dk/dv block at D <= 64, two blocks an SM; 70 KB a forward
  block);
- ``bs64``: streamed tiles of 64 rows, one dq or dk/dv block an SM
  fewer, two forward blocks;
- ``bs16``: streamed tiles of 16 rows, 4 dq or dk/dv blocks an SM (the
  forward's stay 4);
- ``fwd3``: the forward at three blocks an SM at D <= 64, not four;
- ``cvt``: the split by the ``cvt.rna.tf32.f32`` instruction (which
  ptxas expands with a case for inf and NaN) instead of two integer
  operations;
- ``one_product``: hi.hi alone (one TF32 product; wrong at fp32's 1e-5:
  timed only);
- ``no_products``: no mma at all, every load, split, softmax and store
  kept where its result is used (wrong results: timed only).

Prints the SASS opcode counts of the forward and dq kernels at D = 64
(``cuobjdump``, where the toolkit has it). Holds the variants that keep
the arithmetic like the source, then times the forward, dq and dk/dv of
every variant at the training shape [16, 512, 12, 64] fp32 causal on 4
layers' inputs in rotation, in two rounds of opposite order, beside the
FMA kernels on the same inputs and SDPA's fp32 forward and whole backward
(memory-efficient backend), all as device time. Exits non-zero without
CUDA or on any miss.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "flash_tf32_variants")
LO_TERMS = "  mma8(d, al, bh);\n  mma8(d, ah, bl);\n"
HI_TERM = "  mma8(d, ah, bh);\n"
BS = "constexpr int BS = 32;"
BLOCKS = "constexpr int BLOCKS64 = 3;"
FWD_BLOCKS = "constexpr int FWD64 = 4;"
RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
CVT = ('  uint32_t h;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(h) : '
       '"f"(x));\n  return h;')
HELD = ("source", "presplit", "bs64", "bs16", "fwd3", "cvt")
# the presplit variant: split_tile, and the lo tiles of the two streamed
# tiles after the resident and streamed tiles in shared memory
SPLIT_TILE = """// the rows x D floats of a landed tile as hi (in place) and lo (into
// `lo`, the same layout), by the whole block
template <int DP>
__device__ __forceinline__ void split_tile(float* tile, float* lo, int rows,
                                           int D) {
  const int cpr = D / 4;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += NT) {
    const int r = idx / cpr;
    const int at = r * DP + (idx - r * cpr) * 4;
    float4 x = *reinterpret_cast<const float4*>(tile + at);
    uint32_t h[4], l[4];
    attn_tf32::split_tf32(x.x, h[0], l[0]);
    attn_tf32::split_tf32(x.y, h[1], l[1]);
    attn_tf32::split_tf32(x.z, h[2], l[2]);
    attn_tf32::split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(tile + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

"""
# split_tile goes before load_rows, in the source's own namespace (NT)
LOAD_ROWS = "// rows x D floats of src (row stride"
# the 3xTF32 products' header, which the variants patch too: inlined
HEADER = '#include "tf32_mma.cuh"\n'
MS = "  float* Ms = Vs + 2 * BN * DP;     // [2][BN]\n"
ES = "  float* Es = Ls + 2 * BQ;          // [2][BQ] delta\n"
MT = "    const float* Mt = Ms + (it & 1) * BN;\n"
ET = "    const float* Et = Es + s_ * BQ;\n"
SPLIT = ("    split_tile<DP>({0}s + {1} * {3} * DP, {0}l, {3}, D);\n"
         "    split_tile<DP>({2}s + {1} * {3} * DP, {2}l, {3}, D);\n"
         "    __syncthreads();\n")
SMEM = "* BM + 4 * BS)"
# (pattern, replacement, matches)
PRESPLIT_SUBS = (
    (r"const float\* B, int (kc|D)\)", r"const float* B, const float* Bl, "
     r"int \1)", 2),
    (r"split_tf32\(B\[([^\]]+)\], (bh\[\d\]), (bl\[\d\])\);",
     r"\2 = __float_as_uint(B[\1]); \3 = __float_as_uint(Bl[\1]);", 4),
    (r"(mma_rows<NS, DP>\(\w+, ah, al, )(\w)t, kc\)", r"\1\2t, \2l, kc)", 5),
    (r"(mma_cols<NO, NS, DP>\(\w+, \w+, kk, )(\w)t, (D(?: - c0)?)\)",
     r"\1\2t, \2l, \3)", 4))


def presplit(src: str) -> str:
    """``src`` with each streamed tile split once in shared memory."""
    for pattern, repl, n in PRESPLIT_SUBS:
        src, got = re.subn(pattern, repl, src)
        if got != n:
            raise SystemExit(f"probe_flash_tf32: {pattern!r} matched {got}")
    return (src.replace(LOAD_ROWS, SPLIT_TILE + LOAD_ROWS)
            .replace(MS, MS + "  float* Kl = Ms + 2 * BN;\n"
                     "  float* Vl = Kl + BN * DP;\n")
            .replace(ES, ES + "  float* Ql = Es + 2 * BQ;\n"
                     "  float* Ol = Ql + BQ * DP;\n")
            .replace(MT, MT + SPLIT.format("K", "(it & 1)", "V", "BN"))
            .replace(ET, ET + SPLIT.format("Q", "s_", "O", "BQ"))
            .replace(SMEM, "* BM + 6 * BS)")
            .replace(BLOCKS, "constexpr int BLOCKS64 = 2;"))


def variants(src: str) -> dict:
    """The source, and each of its choices changed."""
    for text, n in ((LO_TERMS, 1), (HI_TERM, 1), (BS, 1), (BLOCKS, 1),
                    (FWD_BLOCKS, 1), (RNA, 1), (LOAD_ROWS, 1), (MS, 2),
                    (ES, 1), (MT, 2), (ET, 1), (SMEM, 1)):
        if src.count(text) != n:
            raise SystemExit(f"probe_flash_tf32: {text!r} moved")
    return {"source": src,
            "presplit": presplit(src),
            "bs64": src.replace(BS, "constexpr int BS = 64;").replace(
                BLOCKS, "constexpr int BLOCKS64 = 2;").replace(
                FWD_BLOCKS, "constexpr int FWD64 = 2;"),
            "bs16": src.replace(BS, "constexpr int BS = 16;").replace(
                BLOCKS, "constexpr int BLOCKS64 = 4;"),
            "fwd3": src.replace(FWD_BLOCKS, "constexpr int FWD64 = 3;"),
            "cvt": src.replace(RNA, CVT),
            "one_product": src.replace(LO_TERMS, ""),
            "no_products": src.replace(LO_TERMS + HI_TERM, "")}


def sass_ops(lib: str, kernel: str) -> dict:
    """Opcode counts of ``kernel``'s SASS in ``lib`` (cuobjdump), or {}."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if inside and m:
            op = m.group(1)
            counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:24])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_tf32: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    libs = build.build_all(["flash_attention_tf32", "flash_attention"])
    print(f"{os.path.relpath(libs[0], HERE)}: "
          f"{cs.ptxas_summary(libs[0], each=True)}", flush=True)

    def hold(tag):
        worst = {}
        f32 = torch.float32
        for cases, rate, causal in (
                (cs.FLASH_CASES + cs.FLASH_CASES_16, 0.0, True),
                (cs.FLASH_DROP_CASES, cs.FLASH_DROPOUT, True),
                (cs.FLASH_NONCAUSAL_CASES, 0.0, False),
                (cs.FLASH_NONCAUSAL_CASES, cs.FLASH_DROPOUT, False)):
            for case in cases:
                routes = cs.compare_flash_case(
                    torch, fa, f32, case, worst, rate,
                    cs.FLASH_DROPOUT_SEED if rate else None, causal=causal)
                if routes != ("tf32", "tf32", "tf32"):
                    cs.fail(f"probe_flash_tf32: routes {routes}")
        print(f"{tag}: held in every fp32 case; max |err| " + json.dumps(
            {k[0]: f"{v[0]:.3g}" for k, v in worst.items() if len(k) == 2}),
            flush=True)

    hold("source")
    with open(os.path.join(build.CSRC, "flash_attention_tf32.cu")) as f:
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
    src_fns = fa._kernel("flash_attention_tf32")
    fns = {}
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_flash_tf32: {name} failed:\n{err}")
        regs = re.findall(r"Used (\d+) registers", err)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", err)))
        print(f"{name}: registers {regs}, spill stores {spills}")
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        fns[name] = {}
        for key, fn in src_fns.items():
            sym = {"err": "flash_attention_tf32_error_string",
                   "fwd": "flash_attention_tf32_fwd"}.get(
                       key, f"flash_attention_tf32_bwd_{key}")
            got = getattr(lib, sym)
            got.argtypes, got.restype = fn.argtypes, fn.restype
            fns[name][key] = got
    for kernel in ("flash_fwd_tf32_kernel", "flash_bwd_dq_tf32_kernel"):
        print(f"SASS opcodes of {kernel}<64, false>: " + json.dumps(
            sass_ops(libs[0], kernel + "ILi64ELb0")), flush=True)
    for name in HELD[1:]:
        fa._FN["flash_attention_tf32"] = fns[name]
        hold(name)

    b, s, h, d = 16, 512, 12, 64
    scale = 1.0 / d ** 0.5
    layers = []
    for i in range(4):
        _qkv, q, k, v, dout, _m = cs.flash_case(torch, torch.float32, b, s,
                                                h, d, seed=100 + i)
        out, lse = fa.flash_attention_fwd(q, k, v, None, True, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        layers.append((q, k, v, dout, None, lse, delta.contiguous(), True,
                       scale))
    it = {"i": 0}

    def call(launch, lib, which):
        def go():
            it["i"] = (it["i"] + 1) % len(layers)
            q, k, v, dout, mask, lse, delta, causal, scale = layers[it["i"]]
            if which == "fwd":
                return launch(lib, q, k, v, mask, causal, scale, 0.0, None)
            return launch(lib, q, k, v, dout, mask, lse, delta, causal,
                          scale, 0.0, None)
        return go

    times = {}
    order = list(fns) + ["fma"]
    for names in (order, order[::-1]):
        for name in names:
            lib = "flash_attention" if name == "fma" else \
                "flash_attention_tf32"
            if name != "fma":
                fa._FN["flash_attention_tf32"] = fns[name]
            times.setdefault(name, []).append(tuple(
                round(cs.device_ms(torch, call(launch, lib, w), iters=20,
                                   warmup=3)[0], 4)
                for w, launch in (("fwd", fa._launch_fwd),
                                  ("dq", fa._launch_dq),
                                  ("dkv", fa._launch_dkv))))
    fa._FN["flash_attention_tf32"] = src_fns
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa_in = []
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        for q, k, v, dout, *_ in layers:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            sdpa_in.append((qt, kt, vt, o, dout.transpose(1, 2).contiguous()))

        def sdpa_fwd():
            it["i"] = (it["i"] + 1) % len(sdpa_in)
            qt, kt, vt, _o, _dot = sdpa_in[it["i"]]
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def sdpa_bwd():
            it["i"] = (it["i"] + 1) % len(sdpa_in)
            qt, kt, vt, o, dot = sdpa_in[it["i"]]
            torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

        sdpa_fwd_ms = cs.device_ms(torch, sdpa_fwd)[0]
        sdpa_ms = cs.device_ms(torch, sdpa_bwd)[0]
    print(f"fp32 [16, 512, 12, 64] causal (forward, dq, dk/dv) device ms by "
          f"variant (two rounds; 'fma' the FMA kernels on the same inputs), "
          f"SDPA's forward {sdpa_fwd_ms:.4f} ms and whole backward "
          f"{sdpa_ms:.4f} ms ({card}): {json.dumps(times)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

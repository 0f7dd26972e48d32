#!/usr/bin/env python3
"""Design probe of the wgmma forward of the fused LayerNorm + projection
(``deepspeed_tpu_torch/csrc/fused_ln_tc.cu``) on one GPU: what its
epilogue and its in-place normalisation of the panel cost beside the
products.

    python3 tools/probe_fused_ln_tc.py

Builds four variants of the source with ``nvcc`` into
``build/fused_ln_tc_variants/`` (a directory ``.gitignore`` lists), one
per process, all started together:

- ``source``: the source as it is;
- ``no_epilogue``: the forward's epilogue removed (no bias, activation or
  store; the accumulators are kept alive by a store that never runs);
- ``no_norm``: the panel left as TMA brings it in (x itself, not its
  LayerNorm);
- ``no_norm_no_epilogue``: both, so only the products and the W stream
  remain.

Only ``source`` computes the function; the others time what is left when
a part is gone. Prints each variant's registers and spill stores, checks
``source`` against the plain version, then times the forward of each
(``chip_smoke.device_ms``, bf16) at the training path's two sites (n 8192,
D 768, F 2304 and 3072 + GELU), in two rounds of opposite order. Exits
non-zero without CUDA.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "fused_ln_tc_variants")
EPI = "    // the epilogue, four groups of 32 columns"
NORM = ("for (int r = warp; r < PANEL_ROWS && row0 + r < n; "
        "r += CONSUMERS / 32) {")
KEEP = "    if (d[0] == 1234.5f && d[63] == 1.f) out[0] = d[5];\n"


def variants(src: str) -> dict:
    if src.count(EPI) != 1 or src.count(NORM) != 1:
        raise SystemExit("probe_fused_ln_tc: the source's epilogue or "
                         "normalisation moved")
    i = src.index(EPI)
    j = src.index("  }\n}\n", i)        # the end of the tile loop
    no_epi = src[:i] + KEEP + src[j:]
    skip = NORM.replace("r < PANEL_ROWS && row0 + r < n", "r < 0")
    return {"source": src, "no_epilogue": no_epi,
            "no_norm": src.replace(NORM, skip),
            "no_norm_no_epilogue": no_epi.replace(NORM, skip)}


def bind(path: str):
    lib = ctypes.CDLL(path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.fused_ln_tc_fwd
    fn.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, i32, i32,
                   i32, f32, i32, i32, ptr]
    fn.restype = i32
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_fused_ln_tc: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import fused as fz

    print(cs.card_line(), torch.__version__)
    with open(os.path.join(build.CSRC, "fused_ln_tc.cu")) as f:
        srcs = variants(f.read())
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise SystemExit("probe_fused_ln_tc: nvcc not found")
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
             os.path.join(OUT, name + ".so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_fused_ln_tc: {name} failed:\n{err}")
        report = out + err
        regs = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                          r"registers", report, re.S)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", report)))
        print(name, [(re.sub(r"^.*_cu_[0-9a-f]{8}\d+", "", n)[:40], int(r))
                     for n, r in regs if "ln_gemm" in n],
              "spill stores", spills)
        fns[name] = bind(os.path.join(OUT, name + ".so"))

    stream = torch.cuda.current_stream().cuda_stream
    for site in cs.FUSED_LN_SITES:
        n, d, f, act = site
        cases = [cs.fused_ln_case(torch, torch.bfloat16, n, d, f, seed=60 + j)
                 for j in range(2)]
        y = torch.empty(n, f, dtype=torch.bfloat16, device="cuda")
        it = {"i": 0}

        def call(fn):
            def run():
                it["i"] = (it["i"] + 1) % len(cases)
                x, gamma, beta, w, bias, _dy = cases[it["i"]]
                rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), 1,
                        w.data_ptr(), bias.data_ptr(), 1, y.data_ptr(),
                        None, n, d, f, 1e-5, int(act == "gelu"), 1, stream)
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
            return run

        x, gamma, beta, w, bias, _dy = cases[0]
        it["i"] = len(cases) - 1
        call(fns["source"])()
        want = fz.ln_matmul_reference(x, gamma, beta, w, bias,
                                      activation=act)
        err = float((y.float() - want.float()).abs().max())
        times = {}
        for rnd, order in enumerate((list(fns), list(reversed(list(fns))))):
            for name in order:
                ms, _ = cs.device_ms(torch, call(fns[name]))
                times.setdefault(name, []).append(round(ms, 4))
        print(f"forward bf16 n={n} D={d} F={f} {act}: device ms by variant "
              f"(two rounds) {times}; the source's max |err| against the "
              f"plain version {err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Design probe of the tensor-core flash kernels (``deepspeed_tpu_torch/
csrc/flash_attention_tc.cu``) on one GPU: what the two-term split of p and
ds costs, and what the source's register budget at D <= 64 buys.

    python3 tools/probe_flash_tc.py

Builds three variants of the source with ``nvcc`` into
``build/flash_tc_variants/`` (a directory ``.gitignore`` lists), one per
process, all started together:

- ``split``: the source as it is (p.V, dv and dk with their A operand
  split into hi = T(x) and lo = T(x - hi); at D <= 64 at least 4 forward
  and 3 dk/dv blocks per SM);
- ``one_term``: the same with the ``lo`` products removed (one rounding of
  p and ds to 16 bits, ~2^-9 of each instead of ~2^-17);
- ``loose``: the source without its minimum resident blocks at D <= 64
  (``__launch_bounds__(128)`` alone: the compiler's own register budget,
  fewer blocks per SM, no spills).

Prints each variant's registers and spill stores; runs each through
chip_smoke.py's 16-bit flash cases (``compare_flash_case`` over
``FLASH_CASES`` + ``FLASH_CASES_16`` at dropout 0 and the dropout cases,
bf16 and fp16) and prints how many stay within chip_smoke's tolerances;
then at GPT-2's training shape ([16, 512, 12, 64] bf16 causal, 4-layer
rotation) the forward's and dk/dv's device time (``chip_smoke.device_ms``)
at dropout 0 and 0.1 and their max |err| against the plain versions, in
two rounds of opposite order. Exits non-zero without CUDA.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "flash_tc_variants")
SEED = -123456789


def variants(src: str) -> dict:
    lo_fwd = "      mma16(acc[2 * dp], lo, b0, B);\n"
    lo_fwd1 = "      mma16(acc[2 * dp + 1], lo, b1, B);\n"
    fwd_bounds = "__launch_bounds__(NT, DMAX <= 64 ? 4 : 1)"
    dkv_bounds = "__launch_bounds__(NT, DMAX <= 64 ? 3 : 1)"
    if any(x not in src for x in (lo_fwd, lo_fwd1, fwd_bounds, dkv_bounds)):
        raise SystemExit("probe_flash_tc: the source's lo products or "
                         "launch bounds moved")
    return {
        "split": src,
        "one_term": src.replace(lo_fwd, "").replace(lo_fwd1, ""),
        "loose": src.replace(fwd_bounds, "__launch_bounds__(NT)").replace(
            dkv_bounds, "__launch_bounds__(NT)"),
    }


def bind(path: str) -> dict:
    lib = ctypes.CDLL(path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 5 + [f32, i32, ctypes.c_uint32, i32, f32, i32, ptr]
    out = {}
    for key, sym, n in (("fwd", "flash_attention_tc_fwd", 7),
                        ("dkv", "flash_attention_tc_bwd_dkv", 10)):
        fn = getattr(lib, sym)
        fn.argtypes = [ptr] * n + shape
        fn.restype = i32
        out[key] = fn
    err = lib.flash_attention_tc_error_string
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    out["err"] = err
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_tc: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    print(cs.card_line(), torch.__version__)
    with open(os.path.join(build.CSRC, "flash_attention_tc.cu")) as f:
        srcs = variants(f.read())
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise SystemExit("probe_flash_tc: nvcc not found")
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
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_flash_tc: {name} failed:\n{err}")
        report = out + err
        regs = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                          r"registers", report, re.S)
        spills = re.findall(r"(\d+) bytes spill stores", report)
        print(name, [(re.sub(r"^.*_cu_[0-9a-f]{8}\d+", "", n)[:36], int(r))
                     for n, r in regs], "spill stores", spills)

    for name in srcs:
        fa._FN["flash_attention_tc"] = bind(os.path.join(OUT, name + ".so"))
        beyond = []
        n = 0
        for dtype in (torch.bfloat16, torch.float16):
            for cases, rate in (
                    (cs.FLASH_CASES + cs.FLASH_CASES_16, 0.0),
                    (cs.FLASH_DROP_CASES + cs.FLASH_DROP_CASES_16,
                     cs.FLASH_DROPOUT)):
                for case in cases:
                    n += 1
                    try:
                        cs.compare_flash_case(torch, fa, dtype, case, {},
                                              rate, SEED if rate else None)
                    except RuntimeError as e:
                        beyond.append(str(e)[:160])
        print(f"{name}: {n - len(beyond)} of {n} chip_smoke flash cases "
              f"within its tolerances; beyond: {beyond}", flush=True)

    b, s, h, d = 16, 512, 12, 64
    scale = d ** -0.5
    prepped = []
    for i in range(4):
        _qkv, q, k, v, dout, _m = cs.flash_case(torch, torch.bfloat16, b, s,
                                                h, d, seed=100 + i)
        out, lse = fa.flash_attention_fwd(q, k, v, None, True, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        prepped.append((q, k, v, dout, lse, delta.contiguous()))
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(prepped)
        return prepped[it["i"]]

    for rnd, order in enumerate((list(srcs), list(reversed(list(srcs))))):
        for name in order:
            fa._FN["flash_attention_tc"] = bind(os.path.join(OUT,
                                                             name + ".so"))
            for rate in (0.0, 0.1):
                drop = (rate, SEED if rate else None)
                q, k, v, dout, lse, delta = prepped[0]
                o, _ = fa.flash_attention_fwd_tc(q, k, v, None, True, scale,
                                                 *drop)
                dk, dv = fa.flash_attention_bwd_dkv_tc(
                    q, k, v, dout, None, lse, delta, True, scale, *drop)
                want = fa.flash_attention_reference(
                    q, k, v, causal=True, dropout_rate=rate,
                    dropout_seed=drop[1])
                dk_w, dv_w = fa.flash_bwd_dkv_reference(
                    q, k, v, dout, None, lse, delta, True, scale, *drop)
                errs = [float((x.float() - y.float()).abs().max())
                        for x, y in ((o, want), (dk, dk_w), (dv, dv_w))]

                def fwd():
                    q, k, v = nxt()[:3]
                    fa.flash_attention_fwd_tc(q, k, v, None, True, scale,
                                              *drop)

                def dkv():
                    q, k, v, dout, lse, delta = nxt()
                    fa.flash_attention_bwd_dkv_tc(q, k, v, dout, None, lse,
                                                  delta, True, scale, *drop)

                t_fwd, _ = cs.device_ms(torch, fwd)
                t_dkv, _ = cs.device_ms(torch, dkv)
                print(f"round {rnd} {name} dropout {rate}: fwd {t_fwd:.4f} "
                      f"ms, dkv {t_dkv:.4f} ms (device time); max |err| "
                      f"o, dk, dv {errs}", flush=True)
    fa._FN.pop("flash_attention_tc", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

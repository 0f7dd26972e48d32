#!/usr/bin/env python3
"""Bit-identity of the 16-bit wgmma fused LayerNorm + projection
(``csrc/fused_ln_tc.cu``, kernels #6 and #7) up to ``fused.TC_MAX_D``
across a change to its source.

    python3 tools/check_fused_ln_tc_identity.py PARENT_DIR

``PARENT_DIR`` holds a checkout of the commit to compare with (e.g. made
by ``git archive``). Builds that checkout's ``csrc/fused_ln_tc.cu`` with
this checkout's nvcc flags, runs both builds' forward and backward on the
same inputs and compares y, dx, dgamma, dbeta, dW and dbias bit for bit.
The inputs are ``chip_smoke.py``'s phase-2 fused_ln cases at D up to
``TC_MAX_D`` (the resident panel's route), as ``check_fused_ln`` makes
them, in bf16 and fp16, with and without GELU, and the timed sites' first
input set. Needs one CUDA card; exits non-zero on any difference.
"""

import ctypes
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bind(lib):
    """``fused._kernel``'s ctypes binding of a library of fused_ln_tc.cu's
    C interface: (forward, backward, workspace size, error string)."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, bwd = lib.fused_ln_tc_fwd, lib.fused_ln_tc_bwd
    fwd.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, i32, i32,
                    i32, f32, i32, i32, ptr]
    bwd.argtypes = ([ptr, ptr, ptr, i32, ptr, ptr, i32] + [ptr] * 7
                    + [i32, i32, i32, f32, i32, i32, ptr])
    fwd.restype = bwd.restype = i32
    work = lib.fused_ln_tc_bwd_workspace
    work.argtypes = [i32] * 5
    work.restype = ctypes.c_longlong
    err = lib.fused_ln_tc_error_string
    err.argtypes = [i32]
    err.restype = ctypes.c_char_p
    return fwd, bwd, work, err


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: check_fused_ln_tc_identity.py PARENT_DIR (needs a CUDA "
              "card)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke as cs
    from check_walk_identity import bits, build_parent
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import fused as fz

    parent = os.path.abspath(sys.argv[1])
    builds = {"new": fz._kernel("fused_ln_tc"),
              "old": bind(build_parent(parent, "fused_ln_tc",
                                       build.NVCC_FLAGS))}
    cases = [(c, 40 + i) for i, c in enumerate(cs.FUSED_LN_CASES)
             if c[1] <= fz.TC_MAX_D]
    cases += [(c, 60) for c in cs.FUSED_LN_SITES]
    differ, checked = [], 0
    for dtype in (torch.bfloat16, torch.float16):
        for (n, d, f, act), seed in cases:
            x, gamma, beta, w, bias, dy = cs.fused_ln_case(torch, dtype, n, d,
                                                           f, seed=seed)
            args = fz._prepare(x, gamma, beta, w, bias)
            outs = {}
            for label, fns in builds.items():
                fz._FN["fused_ln_tc"] = fns
                outs[label] = (
                    fz._launch_fwd("fused_ln_tc", *args, 1e-5, act),
                    *fz._launch_bwd("fused_ln_tc", *args, dy, 1e-5, act))
            fz._FN["fused_ln_tc"] = builds["new"]
            torch.cuda.synchronize()
            checked += 1
            for key, a, b in zip(("y",) + cs.FUSED_LN_NAMES, outs["new"],
                                 outs["old"]):
                if not torch.equal(bits(a), bits(b)):
                    differ.append(f"{key} {dtype} n={n} D={d} F={f} {act}")
    print(f"check_fused_ln_tc_identity: {checked} cases (D <= "
          f"{fz.TC_MAX_D}, bf16 and fp16) of fused_ln_tc's forward and "
          f"backward (y, dx, dgamma, dbeta, dW, dbias) against {parent}: "
          f"{len(differ)} differ {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

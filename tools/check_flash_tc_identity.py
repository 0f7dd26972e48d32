#!/usr/bin/env python3
"""Bit-identity of the tensor-core flash kernels across a change to the
tile helpers they include.

    python3 tools/check_flash_tc_identity.py PARENT_DIR

``PARENT_DIR`` holds a checkout of the commit to compare with (e.g. made
by ``git archive``). Builds that checkout's ``csrc/flash_attention_tc.cu``
with this checkout's nvcc flags, runs both builds' forward, dq and dk/dv
on the same inputs (``chip_smoke.py``'s phase-2 flash inputs in bf16
and fp16, as ``compare_flash_case`` makes them: FLASH_CASES and
FLASH_CASES_16 at dropout 0, FLASH_DROP_CASES and FLASH_DROP_CASES_16 at
dropout 0.1; causal, q the last Sq rows of the fused projection) and
compares o, lse, dq, dk and dv bit for bit. Needs
one CUDA card; exits non-zero on any difference.
"""

import ctypes
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: check_flash_tc_identity.py PARENT_DIR (needs a CUDA "
              "card)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke as cs
    from check_walk_identity import bits, build_parent
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    parent = os.path.abspath(sys.argv[1])
    old = build_parent(parent, "flash_attention_tc", build.NVCC_FLAGS)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 5 + [f32, i32, ctypes.c_uint32, i32, f32, i32, ptr]
    fns = {}
    for key, sym, n_ptrs in (("fwd", "fwd", 7), ("dq", "bwd_dq", 9),
                             ("dkv", "bwd_dkv", 10)):
        fn = getattr(old, f"flash_attention_tc_{sym}")
        fn.argtypes = [ptr] * n_ptrs + shape
        fn.restype = i32
        fns[key] = fn
    differ, checked = [], 0
    for dtype in (torch.bfloat16, torch.float16):
        for cases, rate in (
                (cs.FLASH_CASES + cs.FLASH_CASES_16, 0.0),
                (cs.FLASH_DROP_CASES + cs.FLASH_DROP_CASES_16,
                 cs.FLASH_DROPOUT)):
            seed = cs.FLASH_DROPOUT_SEED if rate else None
            for b, sq, s, h, d, masked in cases:
                # compare_flash_case's inputs, seed and all
                _qkv, q, k, v, dout, mask = cs.flash_case(
                    torch, dtype, b, s, h, d,
                    seed=s + masked + 1000 * (d != 64) + 7 * (s - sq),
                    masked=masked)
                q, dout = q[:, s - sq:], dout[:, s - sq:].contiguous()
                q, k, v, m = fa._prepare(q, k, v, mask, True)
                scale = 1.0 / d ** 0.5
                drop = (rate, seed)
                new_o, new_lse = fa._launch_fwd("flash_attention_tc", q, k,
                                                v, m, True, scale, *drop)
                delta = (dout.float() * new_o.float()).sum(-1)
                delta = delta.transpose(1, 2).contiguous()
                new_dq = fa._launch_dq("flash_attention_tc", q, k, v, dout,
                                       m, new_lse, delta, True, scale, *drop)
                new_dk, new_dv = fa._launch_dkv("flash_attention_tc", q, k,
                                                v, dout, m, new_lse, delta,
                                                True, scale, *drop)
                old_o, old_dq, old_dk, old_dv = (torch.empty_like(t) for t in
                                                 (new_o, new_dq, new_dk,
                                                  new_dv))
                old_lse = torch.empty_like(new_lse)
                args = (fa._strides(q, k, v), b, h, sq, s, d, scale, 1,
                        *fa._drop_args(rate, seed), fa._DTYPE_CODES[dtype],
                        torch.cuda.current_stream().cuda_stream)
                p = fa._ptr
                rcs = (
                    fns["fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               p(m), old_o.data_ptr(), old_lse.data_ptr(),
                               *args),
                    fns["dq"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), p(m), new_lse.data_ptr(),
                              delta.data_ptr(), old_dq.data_ptr(), *args),
                    fns["dkv"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), p(m), new_lse.data_ptr(),
                               delta.data_ptr(), old_dk.data_ptr(),
                               old_dv.data_ptr(), *args))
                torch.cuda.synchronize()
                checked += 1
                what = (f"{dtype} B={b} Sq={sq} Sk={s} H={h} D={d} "
                        f"masked={masked} dropout={rate}")
                for name, a, o in (("o", new_o, old_o),
                                   ("lse", new_lse, old_lse),
                                   ("dq", new_dq, old_dq),
                                   ("dk", new_dk, old_dk),
                                   ("dv", new_dv, old_dv)):
                    if any(rcs) or not torch.equal(bits(a), bits(o)):
                        differ.append(f"{name} {what} rc={rcs}")
    print(f"check_flash_tc_identity: {checked} cases of the tensor-core "
          f"flash forward, dq and dk/dv (o, lse, dq, dk, dv) against "
          f"{parent}: {len(differ)} differ {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

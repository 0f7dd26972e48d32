#!/usr/bin/env python3
"""Bit-identity of the tensor-core flash kernels across a change to
their source or the tile helpers they include.

    python3 tools/check_flash_tc_identity.py PARENT_DIR [KERNEL]

``PARENT_DIR`` holds a checkout of the commit to compare with (e.g. made
by ``git archive``). ``KERNEL`` is ``flash_attention_tc`` (the default)
or ``flash_attention_tf32``. Builds that checkout's ``csrc/<KERNEL>.cu``
with this checkout's nvcc flags, runs both builds' forward, dq and dk/dv
on the same inputs and compares o, lse, dq, dk and dv bit for bit. The
inputs are ``chip_smoke.py``'s phase-2 flash inputs, as
``compare_flash_case`` makes them (q the last Sq rows of the fused
projection): for ``flash_attention_tc`` in bf16 and fp16, FLASH_CASES
and FLASH_CASES_16 at dropout 0, FLASH_DROP_CASES and
FLASH_DROP_CASES_16 at dropout 0.1, causal; for ``flash_attention_tf32``
in fp32, those and, above D = 128, FLASH_CASES_256 at dropout 0,
FLASH_DROP_CASES_256 at 0.1 (causal) and FLASH_NONCAUSAL_CASES_256 at
both (non-causal). Needs one CUDA card; exits non-zero on any
difference.
"""

import ctypes
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    name = sys.argv[2] if len(sys.argv) == 3 else "flash_attention_tc"
    if not torch.cuda.is_available() or len(sys.argv) not in (2, 3) or \
            name not in ("flash_attention_tc", "flash_attention_tf32"):
        print("usage: check_flash_tc_identity.py PARENT_DIR [KERNEL] "
              "(KERNEL flash_attention_tc or flash_attention_tf32; needs a "
              "CUDA card)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import chip_smoke as cs
    from check_walk_identity import bits, build_parent
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    parent = os.path.abspath(sys.argv[1])
    old = build_parent(parent, name, build.NVCC_FLAGS)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 5 + [f32, i32, ctypes.c_uint32, i32, f32, i32, ptr]
    fns = {}
    for key, sym, n_ptrs in (("fwd", "fwd", 7), ("dq", "bwd_dq", 9),
                             ("dkv", "bwd_dkv", 10)):
        fn = getattr(old, f"{name}_{sym}")
        fn.argtypes = [ptr] * n_ptrs + shape
        fn.restype = i32
        fns[key] = fn
    differ, checked = [], 0
    sets = [(cs.FLASH_CASES + cs.FLASH_CASES_16, 0.0, True),
            (cs.FLASH_DROP_CASES + cs.FLASH_DROP_CASES_16, cs.FLASH_DROPOUT,
             True)]
    dtypes = (torch.bfloat16, torch.float16)
    if name == "flash_attention_tf32":
        dtypes = (torch.float32,)
        sets += [(cs.FLASH_CASES_256, 0.0, True),
                 (cs.FLASH_DROP_CASES_256, cs.FLASH_DROPOUT, True),
                 (cs.FLASH_NONCAUSAL_CASES_256, 0.0, False),
                 (cs.FLASH_NONCAUSAL_CASES_256, cs.FLASH_DROPOUT, False)]
    for dtype in dtypes:
        for cases, rate, causal in sets:
            seed = cs.FLASH_DROPOUT_SEED if rate else None
            for b, sq, s, h, d, masked in cases:
                # compare_flash_case's inputs, seed and all
                _qkv, q, k, v, dout, mask = cs.flash_case(
                    torch, dtype, b, s, h, d,
                    seed=(s + masked + 1000 * (d != 64) + 7 * (s - sq)
                          + 31 * (not causal)), masked=masked,
                    dout_scale=cs.FLASH_DOUT_SCALE[str(dtype).split(".")[1]])
                q, dout = q[:, s - sq:], dout[:, s - sq:].contiguous()
                q, k, v, m = fa._prepare(q, k, v, mask, causal)
                scale = 1.0 / d ** 0.5
                drop = (rate, seed)
                new_o, new_lse = fa._launch_fwd(name, q, k, v, m, causal,
                                                scale, *drop)
                delta = (dout.float() * new_o.float()).sum(-1)
                delta = delta.transpose(1, 2).contiguous()
                new_dq = fa._launch_dq(name, q, k, v, dout, m, new_lse,
                                       delta, causal, scale, *drop)
                new_dk, new_dv = fa._launch_dkv(name, q, k, v, dout, m,
                                                new_lse, delta, causal,
                                                scale, *drop)
                old_o, old_dq, old_dk, old_dv = (torch.empty_like(t) for t in
                                                 (new_o, new_dq, new_dk,
                                                  new_dv))
                old_lse = torch.empty_like(new_lse)
                args = (fa._strides(q, k, v), b, h, sq, s, d, scale,
                        int(causal),
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
                        f"masked={masked} causal={causal} dropout={rate}")
                for out, a, o in (("o", new_o, old_o),
                                   ("lse", new_lse, old_lse),
                                   ("dq", new_dq, old_dq),
                                   ("dk", new_dk, old_dk),
                                   ("dv", new_dv, old_dv)):
                    if any(rcs) or not torch.equal(bits(a), bits(o)):
                        differ.append(f"{out} {what} rc={rcs}")
    print(f"check_flash_tc_identity: {checked} cases of {name}'s "
          f"forward, dq and dk/dv (o, lse, dq, dk, dv) against "
          f"{parent}: {len(differ)} differ {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Bit-identity of the paged kernels across a change to their shared walk.

    python3 tools/check_walk_identity.py PARENT_DIR

``PARENT_DIR`` holds a checkout of the commit to compare with (e.g. made
by ``git archive``; its kernel #1 takes a split count). Builds that
checkout's ``csrc/chunked_prefill.cu`` and ``csrc/paged_attention.cu``
with this checkout's nvcc flags, runs both builds on the same inputs
(``chip_smoke.py``'s phase-2 cases: the first chunked-prefill kernel #2,
``chunked_prefill_attention_fwd``, at the T=256 mixed and T=8 all-decode
steps, the paged decode kernel #1 at windows of 1 to 64 blocks and S = 1
and 5 at every split count from 1 to 8; fp32 and bf16 q, fp and int8
pools) and compares every output bit for bit, the NaN-reading pad rows
included. Needs one CUDA card; exits non-zero on any difference.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_parent(parent: str, name: str, nvcc_flags) -> ctypes.CDLL:
    from deepspeed_tpu_torch.ops import build

    out = os.path.join(parent, "build", "identity", f"{name}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([build.find_nvcc(), *nvcc_flags, "-o", out,
                    os.path.join(parent, "deepspeed_tpu_torch", "csrc",
                                 name + ".cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


def bits(t):
    import torch

    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: check_walk_identity.py PARENT_DIR (needs a CUDA card)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import chunked_prefill as cp
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    parent = os.path.abspath(sys.argv[1])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    old_cp = build_parent(parent, "chunked_prefill", build.NVCC_FLAGS)
    old_cp.chunked_prefill_attention_fwd.argtypes = (
        [ptr] * 8 + [i32] * 5 + [ctypes.c_float, i32, i32, ptr])
    old_pa = build_parent(parent, "paged_attention", build.NVCC_FLAGS)
    old_pa.paged_decode_attention_fwd.argtypes = (
        [ptr] * 8 + [i32] * 6 + [ctypes.c_float, i32, i32, i32, ptr])
    codes = {torch.float32: 0, torch.bfloat16: 1}
    bs, h, d = 16, 12, 64
    differ, checked = [], 0

    def p_(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream().cuda_stream
    for int8 in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            # kernel #2: phase 2's two steps
            for label, (t, dpos, chunks) in {
                    "T=256 mixed": (256, cs.MIXED_DECODE_POS,
                                    cs.MIXED_CHUNKS),
                    "T=8 all-decode": (8, cs.MIXED_DECODE_POS, [])}.items():
                q, pools, table, pos, _n, _b = cs.chunked_case(
                    torch, dtype, t, dpos, chunks, seed=t + int8, int8=int8)
                kp, vp, ks, vs = pools[0]
                new = cp._launch_walk(q, kp, vp, ks, vs, table, pos, bs,
                                      None)
                old = torch.empty_like(q)
                rc = old_cp.chunked_prefill_attention_fwd(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), p_(ks),
                    p_(vs), table.data_ptr(), pos.data_ptr(), old.data_ptr(),
                    t, h, d, bs, table.shape[1], d ** -0.5, codes[dtype],
                    int(int8), stream)
                torch.cuda.synchronize()
                checked += 1
                if rc or not torch.equal(bits(new), bits(old)):
                    differ.append(f"#2 {label} {dtype} int8={int8} rc={rc}")
            # kernel #1 at every split count against the parent's kernel
            for s in (1, 5):
                for wb in (1, 2, 4, 8, 16, 32, 64):
                    if s > wb * bs:
                        continue
                    q, pools, bt, pos = cs.paged_case(
                        torch, dtype, 8, s, h, d, bs, wb, seed=wb * 10 + s)
                    kp, vp, ks, vs = (cs.int8_pools(torch, pools)[0] if int8
                                      else (*pools[0], None, None))
                    for splits in range(1, 9):
                        new = pa._launch(q, kp, vp, ks, vs, bt, pos, bs,
                                         None, splits)
                        old = torch.empty_like(q)
                        rc = old_pa.paged_decode_attention_fwd(
                            q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                            p_(ks), p_(vs), bt.data_ptr(), pos.data_ptr(),
                            old.data_ptr(), 8, s, h, d, bs, wb, d ** -0.5,
                            codes[dtype], int(int8), splits, stream)
                        torch.cuda.synchronize()
                        checked += 1
                        if rc or not torch.equal(bits(new), bits(old)):
                            differ.append(f"#1 splits={splits} S={s} "
                                          f"WB={wb} {dtype} int8={int8} "
                                          f"rc={rc}")
    print(f"check_walk_identity: {checked} cases of kernels #2 (the first "
          f"kernel) and #1 (splits 1-8) against {parent}: {len(differ)} "
          f"differ {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A/B of the fp32 block-sparse routes (the forward, kernel #8; the
backward, kernels #9 and #10) on the fp32 long-sequence GPT-2 training
step, in one process on one GPU.

    python3 tools/ab_sparse_fp32.py [--part fwd|bwd|both] [--pairs N]

The step is ``chip_smoke.py``'s phase 5b: ``make_gpt("gpt2",
dtype=torch.float32)`` at seq 16384 (12 layers, width 768, dropout 0)
through ``initialize`` with LONG_FP32_CONFIG (``bench.py:bench_gpt2_long(
sparse=True)``'s micro 1, GAS 4, BigBird block 256 causal, Adam with the
fused update, ZeRO 2, no bf16 block). Host-clock step times move between
machines and calls, so the two routes are compared inside one process, on
one engine, in ABBA order. Side "tf32" is the route as it is (the 3xTF32
forward, dq and dk/dv of ``csrc/sparse_attention_tf32.cu``); side "fma"
swaps the part under test for its first version in
``csrc/sparse_attention.cu``: with ``--part fwd`` the FMA forward (dq and
dk/dv on 3xTF32 on both sides, reading each side's lse), with ``--part
bwd`` the FMA dq and dk/dv (the forward on 3xTF32 on both sides);
``both`` (the default) runs the forward's A/B, then the backward's. Each
round runs one untimed step, then 5 timed steps (host clock ending in a
synchronize); a round's number is its median. Then one profiled step a
side: device busy ms, the idle share against the side's median round, and
the device ms a step of the sparse kernels and the GEMMs. Prints the
card; exits non-zero without CUDA, or if a side did not launch the
kernels it names.
"""

import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
# the 3xTF32 wrappers each part swaps for its FMA kernel
PARTS = {"fwd": ("sparse_attention_fwd_tf32",),
         "bwd": ("sparse_attention_bwd_dq_tf32",
                 "sparse_attention_bwd_dkv_tf32")}


def ab(torch, cs, sp, engine, batches, per_step, part, pairs, card):
    """One part's ABBA rounds and profiled steps; prints and returns its
    record."""
    tf32 = {name: getattr(sp, name) for name in PARTS[part]}
    fma_calls = {"n": 0}

    def fma_fwd(q, k, v, key_mask, plan, causal, scale, cap=None):
        fma_calls["n"] += 1
        return sp._launch_fma_fwd(q, k, v, key_mask, plan, causal, scale)

    def fma_bwd(which):
        def run(*a, cap=None):
            fma_calls["n"] += 1
            return sp._launch_fma(which, *a)
        return run

    shims = {"sparse_attention_fwd_tf32": fma_fwd,
             "sparse_attention_bwd_dq_tf32": fma_bwd("dq"),
             "sparse_attention_bwd_dkv_tf32": fma_bwd("dkv")}

    def use(side):
        for name in tf32:
            setattr(sp, name, tf32[name] if side == "tf32" else shims[name])

    rounds = {"tf32": [], "fma": []}
    order = []
    for i in range(pairs):
        order += ["tf32", "fma"] if i % 2 == 0 else ["fma", "tf32"]
    for side in order:
        use(side)
        engine.train_batch(batches)
        torch.cuda.synchronize()
        before = [w.launches for w in tf32.values()] + [fma_calls["n"]]
        ms, _losses = cs.timed_steps(torch, engine, batches, STEPS)
        after = [w.launches for w in tf32.values()] + [fma_calls["n"]]
        got = tuple(a - b for a, b in zip(after, before))
        n = STEPS * per_step
        want = ((n,) * len(tf32) + (0,) if side == "tf32"
                else (0,) * len(tf32) + (len(tf32) * n,))
        if got != want:
            cs.fail(f"ab_sparse_fp32 {part}: side {side} launched "
                    f"({', '.join(tf32)}, fma) {got}, expected {want}")
        rounds[side].append(statistics.median(ms))
        print(f"{part} {side}: step ms {[round(x, 2) for x in ms]}",
              flush=True)
    wins = sum(a < b for a, b in zip(rounds["tf32"], rounds["fma"]))
    prof = {}
    for side in ("tf32", "fma"):
        use(side)
        st = cs.profile_step(torch, engine, batches,
                             f"fp32 long gpt2 {part} {side}",
                             pick=cs.LONG_FP32_PICK)
        if st is None:
            continue
        busy = st["device_busy_ms_per_step"]
        prof[side] = {"device_busy_ms": busy,
                      "idle_share": 1.0 - busy / statistics.median(
                          rounds[side]),
                      "profiled_idle_share": st["device_idle_share"],
                      "device_ms_per_step": st["picked_ms_per_step"]}
    use("tf32")
    med = {k: statistics.median(v) for k, v in rounds.items()}
    rec = {"part": part, "card": card, "order": order,
           "round_medians_ms": rounds, "median_of_rounds_ms": med,
           "tf32_minus_fma_ms": med["tf32"] - med["fma"],
           "tf32_faster_rounds": f"{wins} of {pairs}", "profiled": prof}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_sparse_fp32: no CUDA device", file=sys.stderr)
        return 2
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    if len(sys.argv) % 2 == 0 or not set(args) <= {"--part", "--pairs"} \
            or args.get("--part", "both") not in ("fwd", "bwd", "both"):
        print("usage: ab_sparse_fp32.py [--part fwd|bwd|both] [--pairs N]",
              file=sys.stderr)
        return 2
    part = args.get("--part", "both")
    pairs = int(args.get("--pairs", 4))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import build

    sp = cs.sparse_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    build.build_all(["sparse_attention", "sparse_attention_tf32",
                     "fused_adam"])
    engine, _model, cfg, batches = cs.long_engine(
        torch, cs.LONG_FP32_CONFIG, dtype=torch.float32)
    if engine.precision.dtype != torch.float32:
        cs.fail(f"ab_sparse_fp32: precision {engine.precision.name}")
    for _ in range(2):
        engine.train_batch(batches)
    torch.cuda.synchronize()
    per_step = cfg.num_layers * cs.LONG_CONFIG["gradient_accumulation_steps"]
    for p in (("fwd", "bwd") if part == "both" else (part,)):
        ab(torch, cs, sp, engine, batches, per_step, p, pairs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A/B of the block-sparse forward's route (kernel #8) on the sparse
BERT-large training step, in one process on one GPU.

    python3 tools/ab_sparse_fwd.py [--pairs N]

The sparse BERT step of ``chip_smoke.py``'s phase 8 (``bench.py:
bench_bert``'s configuration at seq 512 x micro 8, GAS 8, LAMB, bf16, with
BERT_SPARSE: the reference documentation's fixed block-16 layout) runs its
forward on the 16-row tensor-core kernel (``sparse_attention_fwd_tc16``).
Host-clock step times move 20-40% between machines and calls, so the two
routes are compared inside one process, on one engine, in ABBA order: side
"tc16" is the route as it is, side "fma" swaps the 16-row forward for the
FMA kernel of ``csrc/sparse_attention.cu`` (its first version; dq and
dk/dv stay on the 16-row kernels). Each round runs one untimed step, then
5 timed steps (host clock ending in a synchronize); a round's number is
its median. Then one profiled step a side: device busy ms, idle share and
#8's device ms. Before that, the host's enqueue time per call of each
route's forward (and of the 16-row dq and dk/dv) at [8, 512, 16, 64] bf16,
100 calls at a time. Prints the card; exits non-zero without CUDA, or if a
side's forward did not launch the kernel it names.
"""

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_sparse_fwd: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    pairs = int(args[1]) if args[:1] == ["--pairs"] and len(args) == 2 else 4
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.models import BERT_CONFIGS, init_bert_params
    from deepspeed_tpu_torch.ops import build

    card = cs.card_line()
    print(card, flush=True)
    build.build_all(["sparse_attention", "sparse_attention_tc16",
                     "flash_attention_tc", "fused_adam"])
    sp = cs.sparse_module()
    tc16 = sp.sparse_attention_fwd_tc16
    fma_calls = {"n": 0}

    def fma(q, k, v, key_mask, plan, causal, scale, cap=None):
        fma_calls["n"] += 1
        return sp._launch_fma_fwd(q, k, v, key_mask, plan, causal, scale)

    def use(side):
        sp.sparse_attention_fwd_tc16 = tc16 if side == "tc16" else fma

    # the host's enqueue time per call at the sparse BERT shape
    b, s, h, d = 8, 512, 16, 64
    scale = d ** -0.5
    plan = sp.sparse_plan(cs.sparse_layout(cs.BERT_SPARSE, h, s), 16)
    lens = np.random.default_rng(5).integers(s // 2, s + 1, b)
    mask = torch.from_numpy(np.arange(s)[None] < lens[:, None]).cuda()
    _qkv, q, k, v, dout, _m = cs.flash_case(torch, torch.bfloat16, b, s, h,
                                            d, seed=400)
    q, k, v, km = sp._prepare(q, k, v, mask, plan)
    fa = (q, k, v, km, plan, False, scale)
    out, lse = tc16(*fa)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    ba = (q, k, v, dout, km, lse, delta.contiguous(), plan, False, scale)
    host = {}
    for name, fn in (("fwd fma", lambda: fma(*fa)),
                     ("fwd tc16", lambda: tc16(*fa)),
                     ("dq tc16", lambda: sp.sparse_attention_bwd_dq_tc16(*ba)),
                     ("dkv tc16",
                      lambda: sp.sparse_attention_bwd_dkv_tc16(*ba))):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host[name] = []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            host[name].append((time.perf_counter() - t0) * 1e4)
            torch.cuda.synchronize()
    print(f"host enqueue us per call ({card}): {json.dumps(host)}",
          flush=True)
    del q, k, v, km, dout, out, lse, delta, fa, ba, _qkv
    torch.cuda.empty_cache()

    sd = init_bert_params(BERT_CONFIGS["bert-large"], seed=0)
    engine, _model, cfg = cs.bert_engine(torch, 512, 8, sd,
                                         sparse=cs.BERT_SPARSE)
    del sd
    gas = cs.BERT_CONFIG["gradient_accumulation_steps"]
    batches = cs.bert_batches(torch, cfg, gas, 8, 512)
    for _ in range(2):
        engine.train_batch(batches)
    torch.cuda.synchronize()
    per_step = cfg.num_layers * gas
    rounds = {"tc16": [], "fma": []}
    order = []
    for i in range(pairs):
        order += ["tc16", "fma"] if i % 2 == 0 else ["fma", "tc16"]
    for side in order:
        use(side)
        engine.train_batch(batches)
        torch.cuda.synchronize()
        before = (tc16.launches, fma_calls["n"])
        ms, _losses = cs.timed_steps(torch, engine, batches, STEPS)
        got = (tc16.launches - before[0], fma_calls["n"] - before[1])
        want = ((STEPS * per_step, 0) if side == "tc16" else
                (0, STEPS * per_step))
        if got != want:
            cs.fail(f"ab_sparse_fwd: side {side} launched (tc16, fma) {got}, "
                    f"expected {want}")
        rounds[side].append(statistics.median(ms))
        print(f"{side}: step ms {[round(x, 2) for x in ms]}", flush=True)
    wins = sum(a < b for a, b in zip(rounds["tc16"], rounds["fma"]))
    prof = {}
    for side in ("tc16", "fma"):
        use(side)
        st = cs.profile_step(torch, engine, batches, f"sparse BERT {side}",
                             pick=("sparse_fwd_tc16_kernel",
                                   "sparse_fwd_kernel"))
        prof[side] = {"device_busy_ms": st["device_busy_ms_per_step"],
                      "profiled_idle_share": st["device_idle_share"],
                      "fwd_device_ms": st["picked_ms_per_step"]}
    use("tc16")
    print(json.dumps({
        "card": card, "order": order, "round_medians_ms": rounds,
        "median_of_rounds_ms": {k: statistics.median(v)
                                for k, v in rounds.items()},
        "tc16_faster_rounds": f"{wins} of {pairs}", "profiled": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

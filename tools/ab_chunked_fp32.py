#!/usr/bin/env python3
"""A/B of kernel #2's fp32 routes on the served fp32 chunked trace, in one
process on one GPU.

    python3 tools/ab_chunked_fp32.py [--pairs N]

The trace is ``chip_smoke.py``'s phase 3: full-width GPT-2 (weights from
seed 0) in fp32, 16 requests in two waves, ``chunked_prefill:
{token_budget: 64}`` (the JAX default), served by ``chip_smoke.serve``,
which checks completion, leaks and each route's launch count. Host-clock
step times move between machines and calls, so the two routes are
compared inside one process in ABBA order: side "runs" is the route as it
is (``chunked_prefill._route`` sends fp32 q to the fp32 run kernels,
``chunked_tf32_kernel`` beside ``chunked_decode_kernel<float>``); side
"first" sends it to the first kernel (``chunked_prefill_kernel``). One
untimed serve a side, then ``--pairs`` (default 3) pairs of rounds; a
round's numbers are its mixed steps' median (host clock, each step ending
in a host fetch) and its TTFT median. Then 16 profiled mixed steps a side
(the step after the 8th admission): device busy ms a step, the idle share
and kernel #2's device ms a step. The tokens of both sides are compared
(the same fp32 function summed in other orders: equal, or a first
difference at a top-2 tie). Prints the card; exits non-zero without CUDA
or on a failed check.
"""

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = {"chunked_prefill": {"token_budget": 64}}
# kernel #2's kernels on each side, as the profiler names them
KERNELS = {"runs": ("chunked_tf32_kernel", "chunked_decode_kernel"),
           "first": ("chunked_prefill_kernel",)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_chunked_fp32: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args not in ([],) and not (len(args) == 2 and args[0] == "--pairs"
                                  and args[1].isdigit()):
        print("usage: ab_chunked_fp32.py [--pairs N]", file=sys.stderr)
        return 2
    pairs = int(args[1]) if args else 3
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.models import GPT_CONFIGS, init_gpt_params
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import chunked_prefill as cp
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    build.build_all(["chunked_prefill", "paged_attention"])
    cfg = GPT_CONFIGS["gpt2"]
    params = init_gpt_params(cfg, seed=0)
    requests = cs.trace(cfg)
    fp32 = torch.float32
    route = cp._route

    def first_route(dtype, pool_dtype, head_dim):
        got = route(dtype, pool_dtype, head_dim)
        return "walk" if got == "tf32" else got

    def use(side):
        cp._route = route if side == "runs" else first_route

    def serve(side):
        use(side)
        try:
            return cs.serve(torch, fp32, "kernel", params, requests,
                            **BUDGET)
        finally:
            cp._route = route

    tokens = {}
    for side in ("runs", "first"):
        srv, tokens[side], _m = serve(side)
    rounds = {"runs": [], "first": []}
    order = []
    for _ in range(pairs):
        order += ["runs", "first", "first", "runs"]
    for side in order:
        _s, toks, m = serve(side)
        if toks != tokens[side]:
            cs.fail(f"ab_chunked_fp32: side {side} served other tokens in "
                    f"a later round")
        rounds[side].append({"step_ms_median": statistics.median(
            m["step_ms"]), "ttft_ms_median": statistics.median(m["ttft_ms"]),
            "mixed_steps": m["mixed_steps"], "wall_s": m["wall_s"]})
    plens = [len(p) for p, _n in requests]
    ties = cs.check_identity(
        torch, srv.engine, "fp32 chunked@64, run kernels vs the first kernel",
        tokens["runs"], tokens["first"], plens)

    prof = {}
    for side in ("runs", "first"):
        use(side)
        try:
            srv = cs.serving_engine(torch, fp32, "kernel", params, **BUDGET)
            for p, n in requests[:8]:
                srv.submit(p, n)
            while srv.sched.queue_depth:
                srv.step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as pr:
                t0 = time.perf_counter()
                for _ in range(16):
                    info = srv.step()
                    if not info["active"]:
                        cs.fail(f"ab_chunked_fp32 {side}: the profile "
                                f"window ran out of work")
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            cp._route = route
        stats = cs.kernel_stats(pr.events(), 16, wall_us,
                                pick=KERNELS[side])
        if stats is None:
            cs.fail("ab_chunked_fp32: the profiler recorded no device "
                    "events")
        prof[side] = {"step_ms": stats["step_ms"],
                      "device_busy_ms_per_step":
                          stats["device_busy_ms_per_step"],
                      "device_idle_share": stats["device_idle_share"],
                      "kernel2_ms_per_step": stats["picked_ms_per_step"]}
    med = {side: statistics.median(r["step_ms_median"] for r in rs)
           for side, rs in rounds.items()}
    print(f"ab_chunked_fp32 ({card}; full-width GPT-2 fp32, 16 requests, "
          f"chunked at budget 64; {pairs} ABBA pairs, host clock): rounds "
          f"{json.dumps(rounds)}; median of the rounds' mixed-step medians: "
          f"run kernels {med['runs']:.3f} ms, first kernel "
          f"{med['first']:.3f} ms (runs / first "
          f"{med['runs'] / med['first']:.4f}); tie-rule differences {ties}; "
          f"profiled 16 mixed steps a side (under torch.profiler): "
          f"{json.dumps(prof)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

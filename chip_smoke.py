#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Device: requires CUDA, prints the card's name and power limit, builds
   every kernel of the serving path from the sources in this checkout.
2. Kernels against their plain PyTorch versions at the serving shapes of
   GPT-2 (12 heads, head_dim 64, block 16, 8 rows, 1 and 5 queries,
   windows of 1 to 64 blocks, ragged positions, table tails on a scratch
   block filled with NaN), in fp32 (atol 1e-5) and bf16 (atol 2e-2), and
   timed with CUDA events beside the plain version, the
   ``scaled_dot_product_attention`` yardstick and the bytes bound.
3. End to end: ``init_serving`` on full-width GPT-2 (random weights from a
   seed) serves 16 requests in two waves through
   ``decode_attention: "kernel"`` in bf16; the kernel's launch count must
   equal ``kernel_steps * num_layers``. The same trace in fp32 through
   "kernel" and "gather" must give the same tokens (and match
   ``generate``), except at a true tie of the top two logits.

Any failure exits non-zero. The last stdout line is
``{"ok": true, "device": {...}}``; before it come the card line and a
``{"kernels": [...]}`` line.
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32, outside the tensor cores
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TIE_GAP = 1e-4                   # top-2 logit gap of a true tie


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi prints them (NVML if absent)."""
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    import ctypes
    import torch

    nvml = ctypes.CDLL("libnvidia-ml.so.1")
    handle, mw = ctypes.c_void_p(), ctypes.c_uint()
    if nvml.nvmlInit_v2() or nvml.nvmlDeviceGetHandleByIndex_v2(
            0, ctypes.byref(handle)) or nvml.nvmlDeviceGetEnforcedPowerLimit(
            handle, ctypes.byref(mw)):
        fail("neither nvidia-smi nor NVML reads the power limit")
    return f"{torch.cuda.get_device_name(0)}, {mw.value / 1000:.2f} W"


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 2. paged decode attention against its plain version
# ---------------------------------------------------------------------------

def paged_case(torch, dtype, b, s, h, d, bs, wb, seed, layers=1):
    """Pools, tables and positions as the decode path makes them: each row
    owns distinct blocks for its visible keys, its table tail points at
    scratch block 0, and block 0 holds NaN (it must never be read)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = b * wb + 1
    pools = []
    for _ in range(layers):
        kp = torch.randn(n, bs, h, d, generator=g).to("cuda", dtype)
        vp = torch.randn(n, bs, h, d, generator=g).to("cuda", dtype)
        kp[0] = float("nan")
        vp[0] = float("nan")
        pools.append((kp, vp))
    bt = torch.zeros(b, wb, dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int32)
    perm = torch.randperm(n - 1, generator=g) + 1
    for r in range(b):
        # the last query sits anywhere in the window, the first row at its
        # end, so every window width is exercised in full
        last = (wb * bs - 1 if r == 0 else
                int(torch.randint(s - 1, wb * bs, (1,), generator=g)))
        used = last // bs + 1
        bt[r, :used] = perm[r * wb:r * wb + used].int()
        pos[r] = last - (s - 1)
    q = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
    return q, pools, bt.cuda(), pos.cuda()


def paged_bytes_flops(q, bt, pos, bs):
    """What the call must move and compute for these inputs: q read, the
    visible K and V rows read once, the table and positions read, the
    output written; 4 flops per (query, visible key, element)."""
    b, s, h, d = q.shape
    es = q.element_size()
    ctx = sum(min(bt.shape[1] * bs, int(p) + s) for p in pos.tolist())
    nbytes = (2 * q.numel() * es + 2 * ctx * h * d * es
              + bt.numel() * 4 + pos.numel() * 4)
    return nbytes, 4 * s * ctx * h * d


def check_paged_attention(torch, report):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.transformer.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    h, d, bs, b = 12, 64, 16, 8
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for s in (1, 5):
            for wb in (1, 2, 4, 8, 16, 32, 64):
                if s > wb * bs:
                    continue
                q, pools, bt, pos = paged_case(torch, dtype, b, s, h, d, bs,
                                               wb, seed=wb * 10 + s)
                kp, vp = pools[0]
                got = paged_decode_attention(q, kp, vp, None, None, bt, pos,
                                             block_size=bs)
                torch.cuda.synchronize()
                want = paged_decode_attention_reference(q, kp, vp, bt, pos,
                                                        block_size=bs)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err > KERNEL_TOL[name]:
                    fail(f"paged_decode_attention {name} S={s} WB={wb}: "
                         f"max |err| {err} > {KERNEL_TOL[name]} or "
                         f"non-finite")
                worst[(name, s)] = max(worst.get((name, s), 0.0), err)
    for (name, s), err in sorted(worst.items()):
        print(f"paged_decode_attention {name} S={s} WB=1..64: max |err| "
              f"{err:.3g} (atol {KERNEL_TOL[name]})")

    # Timing at the decode path's widest window (64 blocks = 1024
    # positions), rotating over 8 layers' pools (200 MB of bf16 K/V, of
    # which the visible rows are about 100 MB, twice the 50 MB L2) so that
    # each launch finds its pools cold, as a decode step's next layer does.
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for s in (1, 5):
            q, pools, bt, pos = paged_case(torch, dtype, b, s, h, d, bs, 64,
                                           seed=7 + s, layers=8)
            for kp, vp in pools:       # real keys only: the timing reads no
                kp[0] = 0.0            # NaN into the plain version
                vp[0] = 0.0
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(pools)
                return pools[it["i"]]

            kernel_ms = cuda_ms(lambda: paged_decode_attention(
                q, *nxt(), None, None, bt, pos, block_size=bs))
            plain_ms = cuda_ms(lambda: paged_decode_attention_reference(
                q, *nxt(), bt, pos, block_size=bs), iters=20)
            # yardstick: SDPA over K/V gathered beforehand, same mask
            length = 64 * bs
            kpos = torch.arange(length, device="cuda")
            qpos = pos.long()[:, None] + torch.arange(s, device="cuda")
            mask = (kpos[None, None] <= qpos[:, :, None])[:, None]
            gathered = [tuple(p[bt.long()].reshape(b, length, h, d)
                              .transpose(1, 2).contiguous() for p in pair)
                        for pair in pools]
            qt = q.transpose(1, 2).contiguous()
            git = {"i": 0}

            def gnxt():
                git["i"] = (git["i"] + 1) % len(gathered)
                return gathered[git["i"]]

            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, *gnxt(), attn_mask=mask))
            nbytes, flops = paged_bytes_flops(q, bt, pos, bs)
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / FP32_FLOPS) * 1e3
            timings[(name, s)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                      library_ms=library_ms,
                                      bound_ms=bound_ms, bytes=nbytes)
            print(f"paged_decode_attention timing {name} B={b} S={s} H={h} "
                  f"D={d} BS={bs} WB=64: kernel {kernel_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes} bytes / 3.35 TB/s)")
    main = timings[("bfloat16", 1)]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"],
                  library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                  bound_by="bytes",
                  max_abs_err=max(worst[("bfloat16", 1)],
                                  worst[("bfloat16", 5)]))


# ---------------------------------------------------------------------------
# 3. serving end to end
# ---------------------------------------------------------------------------

def trace(cfg):
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.permutation(np.linspace(16, 700, 16).astype(int))
    new = rng.integers(32, 65, 16)
    return [(rng.integers(0, cfg.vocab_size, int(t)).tolist(), int(n))
            for t, n in zip(lengths, new)]


def serving_engine(torch, dtype, mode, params):
    """Full-width GPT-2 behind ``init_serving``: 8 slots, KV block 16, a
    pool of 8 x 1024 positions (plus the scratch block)."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import make_gpt

    with torch.device("cuda"):
        model, _cfg = make_gpt("gpt2", dtype=dtype)
    bs = 16
    return dtt.init_serving(model, params=params, dtype=dtype, config={
        "serving": {"max_batch_size": 8, "kv_block_size": bs,
                    "kv_num_blocks": 8 * 1024 // bs + 1,
                    "decode_attention": mode}})


def serve(torch, dtype, mode, params, requests):
    from deepspeed_tpu_torch.ops.transformer.paged_attention import \
        paged_decode_attention

    srv = serving_engine(torch, dtype, mode, params)
    cfg = srv.model_cfg
    wave1 = 10
    rids = [srv.submit(p, n) for p, n in requests[:wave1]]
    decode_ms, decode_tokens = [], 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    while not srv.idle():
        ts = time.perf_counter()
        info = srv.step()        # ends in a host fetch: the card is done
        dt = time.perf_counter() - ts
        if not info["prefilled"] and info["active"]:
            decode_ms.append(dt * 1e3)
            decode_tokens += info["active"]
        if len(rids) == wave1 and info["finished"]:
            # second wave arrives once the first slot frees: backfill
            rids += [srv.submit(p, n) for p, n in requests[wave1:]]
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    res = srv.results
    for rid, (p, n) in zip(rids, requests):
        r = res.get(rid)
        if r is None or r["status"] != "finished" \
                or len(r["tokens"]) != len(p) + n:
            got = r and (r["status"], len(r["tokens"]))
            fail(f"{mode}/{dtype}: request {rid} did not finish with "
                 f"{len(p) + n} tokens: {got}")
    if srv.pool.used_blocks != 0:
        fail(f"{mode}/{dtype}: {srv.pool.used_blocks} KV blocks leaked")
    if max(srv.stats["slot_assignments"].values()) < 2:
        fail(f"{mode}/{dtype}: no slot served two requests (no backfill)")
    if mode == "kernel":
        want = srv.stats["kernel_steps"] * cfg.num_layers
        if launches != want or launches == 0:
            fail(f"kernel launches {launches} != kernel_steps x layers "
                 f"{want}")
    elif launches:
        fail(f"gather mode launched the kernel {launches} times")
    return srv, [res[r]["tokens"] for r in rids], dict(
        wall_s=wall, launches=launches, decode_ms=decode_ms,
        decode_tokens=decode_tokens,
        ttft_ms=[res[r]["ttft_ms"] for r in rids],
        decode_steps=srv.stats["decode_steps"],
        kernel_steps=srv.stats["kernel_steps"])


def first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def top2_gap(torch, engine, prefix) -> float:
    logits = engine.forward(torch.tensor([prefix]))["logits"][0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def check_identity(torch, engine, name, got, want, prompt_lens):
    """Token identity, except where the first difference sits on a true
    tie of the top two logits (then the rows legitimately diverge)."""
    ties = 0
    for i, (a, b) in enumerate(zip(got, want)):
        at = first_diff(a, b)
        if at is None and len(a) == len(b):
            continue
        if at is None or at < prompt_lens[i]:
            fail(f"{name}: request {i} differs in length or prompt")
        gap = top2_gap(torch, engine, a[:at])
        print(f"{name}: request {i} first differs at position {at}, "
              f"top-2 logit gap {gap:.3g}")
        if gap >= TIE_GAP:
            fail(f"{name}: request {i} differs at {at} with top-2 gap "
                 f"{gap} >= {TIE_GAP} (not a tie)")
        ties += 1
    return ties


def median(xs):
    return quantile(xs, 0.5)


def quantile(xs, f):
    """Linear-interpolated quantile ``f`` of ``xs``."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    x = f * (len(xs) - 1)
    lo = int(x)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (x - lo)


def profile_decode(torch, params, requests, steps=16):
    """Device busy share and device time by kernel over ``steps`` steady
    decode steps (8 active rows, no prefill) of the bf16 kernel path,
    from a ``torch.profiler`` trace. The profiler adds host time, so the
    idle share it shows is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    srv = serving_engine(torch, torch.bfloat16, "kernel", params)
    for p, n in requests[:8]:
        srv.submit(p, n)
    while srv.sched.queue_depth:        # one admission per step
        srv.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            info = srv.step()
            if info["prefilled"] or info["active"] != 8:
                fail(f"profile window is not steady decode: {info}")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("decode profile: the profiler recorded no device events; "
              "device busy share not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": steps, "step_ms": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy / steps / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "kernels_per_step": len(kernels) / steps,
           "top_kernels_ms_per_step": {
               n[:60]: t / steps / 1e3 for n, t in top}}
    print(f"decode profile (bf16, 8 active, under torch.profiler): "
          f"{json.dumps(out)}")
    return out


def check_serving(torch):
    from deepspeed_tpu_torch.models import GPT_CONFIGS, init_gpt_params

    cfg = GPT_CONFIGS["gpt2"]
    t0 = time.perf_counter()
    params = init_gpt_params(cfg, seed=0)
    print(f"gpt2 weights from seed 0: {time.perf_counter() - t0:.1f} s")
    requests = trace(cfg)
    plens = [len(p) for p, _ in requests]

    # the first run pays one-time costs (cuBLAS handles, allocator growth);
    # the second is the one measured
    serve(torch, torch.bfloat16, "kernel", params, requests)
    _srv, _toks, m = serve(torch, torch.bfloat16, "kernel", params,
                           requests)
    dec_s = sum(m["decode_ms"]) / 1e3
    serving = {
        "model": "gpt2", "dtype": "bfloat16", "requests": len(requests),
        "decode_attention": "kernel", "decode_steps": m["decode_steps"],
        "kernel_steps": m["kernel_steps"], "kernel_launches": m["launches"],
        "decode_tokens_per_s": m["decode_tokens"] / dec_s,
        "decode_step_ms_median": median(m["decode_ms"]),
        "decode_step_ms_p10": quantile(m["decode_ms"], 0.1),
        "decode_step_ms_p90": quantile(m["decode_ms"], 0.9),
        "ttft_ms_median": median(m["ttft_ms"]),
        "wall_s": m["wall_s"]}
    print(f"serving bf16 kernel: {json.dumps(serving)}")

    srv_k, toks_k, mk = serve(torch, torch.float32, "kernel", params,
                              requests)
    _srv_g, toks_g, mg = serve(torch, torch.float32, "gather", params,
                               requests)
    print(f"serving fp32: kernel {mk['wall_s']:.2f} s, gather "
          f"{mg['wall_s']:.2f} s; decode step median kernel "
          f"{median(mk['decode_ms']):.2f} ms, gather "
          f"{median(mg['decode_ms']):.2f} ms")
    ties = check_identity(torch, srv_k.engine, "fp32 kernel vs gather",
                          toks_k, toks_g, plens)
    # generate() is the token-identity oracle in both packages
    for i in sorted(range(len(requests)), key=lambda i: plens[i])[::5]:
        p, n = requests[i]
        gen = srv_k.engine.generate([p], max_new_tokens=n)[0].tolist()
        ties += check_identity(torch, srv_k.engine,
                               f"fp32 kernel vs generate (request {i})",
                               [toks_k[i]], [gen], [plens[i]])
    serving["fp32_ties"] = ties
    profile_decode(torch, params, requests)
    return serving


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import build

    pkg = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        fail(f"imported deepspeed_tpu_torch from {pkg}, not from this "
             f"checkout ({HERE})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device and build
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    lib = build.build("paged_attention")
    print(f"built {os.path.relpath(lib, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(lib[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    # 2. kernels against their plain versions
    report = {"name": "paged_decode_attention", "route": "cuda",
              "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
              "replaces": "deepspeed_tpu/ops/transformer/"
                          "paged_attention.py:69"}
    check_paged_attention(torch, report)

    # 3. the serving path end to end
    serving = check_serving(torch)
    report["launches"] = serving["kernel_launches"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: report[k] for k in keys}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

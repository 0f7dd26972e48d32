#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # everything, one card
    python3 chip_smoke.py --only kernels   # stop after phase 2

1. Device: requires CUDA, prints the card's name and power limit, builds
   every kernel from the sources in this checkout (one ``nvcc`` per
   source, all started together) and prints each ``-Xptxas -v`` report.
2. Kernels against their plain PyTorch versions at the main paths'
   shapes, in fp32 (atol 1e-5) and bf16 (atol 2e-2), each timed with CUDA
   events beside the plain version, a PyTorch yardstick and its bound:
   - paged decode attention at GPT-2's serving shapes (12 heads, head_dim
     64, block 16, 8 rows, 1 and 5 queries, windows of 1 to 64 blocks,
     table tails on a scratch block filled with NaN), over fp/bf16 pools
     and over int8 pools with fp32 scales (NaN scales on scratch), with
     fp32 and bf16 queries;
   - ragged chunked-prefill attention at the same shapes: a 256-token
     mixed step (8 decode rows at positions 100-1000, a 200-token chunk
     from 0, a 40-token chunk from 37, pad rows) and an 8-token
     all-decode step, fp/bf16 and int8 pools, pad rows excluded;
   - flash attention forward, dq and dk/dv at [16, 512, 12, 64] causal,
     with and without a key mask holding an all-padding row, and at S=5
     and S=300; the whole autograd path against the plain version's; fp32
     within 1e-5 (dO x 0.1), bf16 within one rounding step plus 1e-3 of
     the reference's RMS (0.15 on the autograd path; dO unscaled);
   - fused Adam, bit for bit, over GPT-2's 148 parameter tensors (with
     the bf16 copy of the new params that the bf16 training step uses);
   - block-sparse attention forward, dq and dk/dv (kernels #8-#10) at
     (a) [1, 4096, 12, 64], BigBird block 256, causal, fp32 and bf16,
     (b) [2, 1024, 12, 64], ``fixed`` block 16, bidirectional, with a key
     mask whose second batch row is all padding (o, dq, dk, dv exactly 0
     there, lse -1e30), fp32 and bf16, and (c) the path's shape [1, 16384,
     12, 64], bf16; each kernel and (a), (b) the whole autograd path, with
     flash's tolerances, lse to 1e-5; timed at (c) beside the plain
     version, SDPA with the layout-expanded mask and the bound;
   - the fused LayerNorm + projection forward and backward (kernels #6,
     #7) at the training path's two sites (n = 8192 rows, D = 768, F =
     2304 without activation and 3072 with GELU) and a tail (n = 300, D
     = 136, F = 200), fp32 and bf16, each kernel alone and the whole
     autograd path: fp32 within 1e-5 of each output's RMS, bf16 within
     one rounding step plus 1e-3 of it; timed in bf16 at the path's
     sites beside the plain versions and the unfused eager sequence
     (``F.layer_norm`` -> cast -> ``F.linear`` (-> GELU) and its autograd
     backward).
3. Serving end to end: ``init_serving`` on full-width GPT-2 (random
   weights from a seed) serves 16 requests in two waves:
   - bucketed bf16 through ``decode_attention: "kernel"`` (kernel #1
     launches == ``kernel_steps * num_layers``), and chunked prefill at
     token budget 256 (kernel #2 launches == ``mixed_steps *
     num_layers``, kernel #1 none, no plain attention at all); both timed
     on their second run;
   - fp32 token identity of "kernel", "gather", chunked prefill at budget
     64 and ``generate``, except at a true tie of the top two logits;
   - the int8 pool: bucketed bf16 through kernel #1's int8 branch (no
     gather), fp32 "kernel" vs "gather", and chunked fp32 with kernel #2
     against its plain version swapped in (tie rule on the int8 model);
   - a prefix trace (8 requests sharing a 512-token head), bucketed and
     chunked with ``prefix_cache``: >= 7 hits, tokens equal to the run
     without the cache (tie rule);
   - a profiled window of 16 decode steps and of 16 chunked mixed steps.
4. Training end to end: ``initialize`` -> ``train_batch`` on full-width
   GPT-2 with ``bench.py:bench_gpt2``'s configuration plus
   ``optimizer.fused_update``: each flash kernel launches 96 times and
   fused Adam once per step, no plain version runs, the loss falls; step
   time, tokens/s, model TFLOP/s and MFU, and a profiled step. Then, in
   fp32 at 2 layers, the kernels' path against the plain path (first-step
   gradients within 1e-4 of each leaf's norm, losses within 1e-5).
5. Long-sequence training: ``initialize`` -> ``train_batch`` on
   full-width GPT-2 at seq 16384 with ``bench.py:bench_gpt2_long(sparse=
   True)``'s configuration (BigBird block 256 through the
   ``sparse_attention`` block) plus ``optimizer.fused_update``: #8-#10
   launch 48 times each per step, fused Adam once, the flash kernels and
   every plain version never, the loss falls; step time, tokens/s, peak
   memory and a profiled step. Then the same configuration with dense
   flash attention (1 + 2 steps) for the sparse/dense tokens/s ratio, and
   in fp32 at 2 layers and seq 4096 the kernels' path against the plain
   path (``impl: "xla"``), held as in phase 4.
6. Training with the fused LayerNorm + projection sites: phase 4's
   configuration on ``make_gpt("gpt2", fused_ln=True)``: #6 and #7 launch
   192 times each per step (2 sites x 12 layers x GAS 8), flash 96, fused
   Adam once, no plain version, the loss falls; step time, tokens/s, MFU,
   peak memory, a profiled step and the ratio to phase 4's step; the
   "qkv" and "mlp" variants (1 + 2 steps each); then in fp32 at 2 layers
   the fused kernels' path against the unfused plain path, held as in
   phase 4.

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
BF16_FLOPS = 989e12              # H100 SXM dense bf16, tensor cores
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# Flash attention: in fp32, dO is scaled by 0.1 and every element held to
# atol 1e-5 (1e-4 of gradients near 0.1). In bf16, dO is unscaled and each
# element held to one bf16 rounding step of the reference's value plus a
# share of the reference's RMS: both sides round an fp32 result once, and
# where the fp32 values differ in their last bits the roundings may differ
# by one step (3.1e-2 for values in [4, 8), above a flat 2e-2). Each kernel
# gets the plain version's inputs (lse and delta included): 1e-3 of the
# RMS. The autograd path computes delta = rowsum(dO * O) from the bf16
# output, as the JAX kernel's backward does, where the plain version's
# autograd uses its fp32 output: that moves dq and dk by up to 0.057 of
# the RMS (the plain backward versions fed either delta, on the CPU at
# B=2, S=512), so that path is held to 0.15.
FLASH_DOUT_SCALE = {"float32": 0.1, "bfloat16": 1.0}
FLASH_BF16_RMS_TOL = {"kernel": 1e-3, "autograd": 0.15}
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


def ptxas_summary(lib: str) -> str:
    """One line from the ``-Xptxas -v`` report kept beside a library (the
    full report is the ``.log`` file): kernels compiled, the register
    range, and the kernels that spill."""
    import re

    regs, spills, name = [], [], None
    with open(lib[:-3] + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)) and name:
                # the kernel's name and template arguments, mangled
                spills.append(re.sub(r"^.*_cu_[0-9a-f]{8}\d+", "",
                                     name)[:48])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{len(spills)} spilling" + (f" ({spills})" if spills else ""))


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
# 2a'. the int8 branch of paged decode attention against its plain version
# ---------------------------------------------------------------------------

def int8_pools(torch, pools):
    """int8 codes and fp32 scales (the serving pool's quantization) of fp
    pools; the scratch block's scales are NaN, so a read of it would
    poison the output."""
    from deepspeed_tpu_torch.serving.kv_cache import _quant_tokens

    out = []
    for pair in pools:
        layer = []
        for p in pair:
            p = p.float().clone()
            p[0] = 0.0
            codes, scales = _quant_tokens(p)
            scales[0] = float("nan")
            layer.append((codes, scales))
        (kq, ks), (vq, vs) = layer
        out.append((kq, vq, ks, vs))
    return out


def int8_bytes(q, ctx_tokens, h, d):
    """Codes (1 byte per element) and fp32 scales (4 bytes per (token,
    head)) of K and V for ``ctx_tokens`` key rows, plus q read and out
    written."""
    es = q.element_size()
    return 2 * q.numel() * es + 2 * ctx_tokens * h * (d + 4)


def check_paged_attention_int8(torch, report):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.transformer.paged_attention import (
        dequantized, paged_decode_attention, paged_decode_attention_reference)

    h, d, bs, b = 12, 64, 16, 8
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for s in (1, 5):
            for wb in (1, 2, 4, 8, 16, 32, 64):
                if s > wb * bs:
                    continue
                q, pools, bt, pos = paged_case(torch, dtype, b, s, h, d, bs,
                                               wb, seed=wb * 10 + s + 1)
                kq, vq, ks, vs = int8_pools(torch, pools)[0]
                got = paged_decode_attention(q, kq, vq, ks, vs, bt, pos,
                                             block_size=bs)
                torch.cuda.synchronize()
                want = paged_decode_attention_reference(
                    q, kq, vq, bt, pos, block_size=bs, k_scale=ks,
                    v_scale=vs)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err > KERNEL_TOL[name]:
                    fail(f"paged_decode_attention int8 {name} q S={s} "
                         f"WB={wb}: max |err| {err} > {KERNEL_TOL[name]} or "
                         f"non-finite")
                worst[(name, s)] = max(worst.get((name, s), 0.0), err)
    for (name, s), err in sorted(worst.items()):
        print(f"paged_decode_attention int8 pools, {name} q, S={s} "
              f"WB=1..64: max |err| {err:.3g} (atol {KERNEL_TOL[name]}, "
              f"NaN scratch scales)")

    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for s in (1, 5):
            q, pools, bt, pos = paged_case(torch, dtype, b, s, h, d, bs, 64,
                                           seed=17 + s, layers=8)
            pools = int8_pools(torch, pools)
            for _kq, _vq, ks, vs in pools:   # no NaN into the timed calls
                ks[0] = 1.0
                vs[0] = 1.0
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(pools)
                return pools[it["i"]]

            def kern():
                kq, vq, ks, vs = nxt()
                paged_decode_attention(q, kq, vq, ks, vs, bt, pos,
                                       block_size=bs)

            def plain():
                kq, vq, ks, vs = nxt()
                paged_decode_attention_reference(q, kq, vq, bt, pos,
                                                 block_size=bs, k_scale=ks,
                                                 v_scale=vs)

            kernel_ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, iters=20)
            # yardstick: SDPA over K/V gathered and dequantized beforehand
            length = 64 * bs
            btl = bt.long()
            kpos = torch.arange(length, device="cuda")
            qpos = pos.long()[:, None] + torch.arange(s, device="cuda")
            mask = (kpos[None, None] <= qpos[:, :, None])[:, None]
            gathered = [tuple(dequantized(p, sc, btl).to(dtype)
                              .reshape(b, length, h, d).transpose(1, 2)
                              .contiguous() for p, sc in ((kq, ks), (vq, vs)))
                        for kq, vq, ks, vs in pools]
            qt = q.transpose(1, 2).contiguous()
            git = {"i": 0}

            def gnxt():
                git["i"] = (git["i"] + 1) % len(gathered)
                return gathered[git["i"]]

            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, *gnxt(), attn_mask=mask))
            ctx = sum(min(64 * bs, int(p) + s) for p in pos.tolist())
            nbytes = int8_bytes(q, ctx, h, d) + bt.numel() * 4 + b * 4
            flops = 4 * s * ctx * h * d
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / FP32_FLOPS) * 1e3
            timings[(name, s)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                      library_ms=library_ms,
                                      bound_ms=bound_ms)
            print(f"paged_decode_attention int8 pools timing, {name} q, "
                  f"B={b} S={s} H={h} D={d} BS={bs} WB=64: kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                  f"(pre-dequantized K/V) {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes} bytes / 3.35 TB/s)")
            del gathered, pools
    main = timings[("bfloat16", 1)]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"],
                  library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                  bound_by="bytes",
                  max_abs_err=max(worst[("bfloat16", 1)],
                                  worst[("bfloat16", 5)]))


# ---------------------------------------------------------------------------
# 2a''. ragged chunked-prefill attention against its plain version
# ---------------------------------------------------------------------------

MIXED_DECODE_POS = [100, 228, 357, 485, 614, 742, 871, 1000]
MIXED_CHUNKS = [(0, 200), (37, 40)]          # (first position, tokens)


def chunked_case(torch, dtype, n_tokens, decode_pos, chunks, seed,
                 layers=1, int8=False, h=12, d=64, bs=16, wb=64):
    """A mixed step's ragged batch as the engine builds it: one decode
    token per ``decode_pos`` (its sequence's blocks cover 0..pos), each
    chunk's tokens at consecutive positions (its sequence's blocks cover
    the chunk's end), then pad rows up to ``n_tokens`` (all-scratch table
    row, position 0). Every sequence owns distinct blocks; table tails
    and pads point at scratch block 0, which holds NaN (int8: NaN
    scales). Returns q, per-layer pools ``(k, v, k_scale, v_scale)``,
    table, pos, the number of real rows and the distinct blocks read."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    seqs = [(p, 1) for p in decode_pos] + list(chunks)
    need = [(p0 + c - 1) // bs + 1 for p0, c in seqs]
    n = sum(need) + 1
    perm = (torch.randperm(n - 1, generator=g) + 1).int()
    table = torch.zeros(n_tokens, wb, dtype=torch.int32)
    pos = torch.zeros(n_tokens, dtype=torch.int32)
    r, used = 0, 0
    for (p0, c), nb in zip(seqs, need):
        row = torch.zeros(wb, dtype=torch.int32)
        row[:nb] = perm[used:used + nb]
        used += nb
        for i in range(c):
            table[r] = row
            pos[r] = p0 + i
            r += 1
    if r > n_tokens:
        fail(f"chunked case holds {r} real rows, more than {n_tokens}")
    pools = []
    for _ in range(layers):
        kp = torch.randn(n, bs, h, d, generator=g).to("cuda", dtype)
        vp = torch.randn(n, bs, h, d, generator=g).to("cuda", dtype)
        kp[0] = float("nan")
        vp[0] = float("nan")
        pools.append((kp, vp))
    pools = (int8_pools(torch, pools) if int8
             else [(k, v, None, None) for k, v in pools])
    q = torch.randn(n_tokens, h, d, generator=g).to("cuda", dtype)
    blocks = sum(need) + (1 if r < n_tokens else 0)   # + scratch for pads
    return q, pools, table.cuda(), pos.cuda(), r, blocks


def chunked_bytes_flops(q, table, pos, blocks, bs, int8):
    """What one call must move and compute for these inputs: each
    distinct K/V block (and its scales) read once, q read, out written,
    table and positions read; 4 flops per (token, visible key, element)
    over every row, pad rows included."""
    t, h, d = q.shape
    es = q.element_size()
    per_token = h * (d + 4) if int8 else h * d * es
    nbytes = (2 * q.numel() * es + 2 * blocks * bs * per_token
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * (int(pos.long().sum()) + t) * h * d
    return nbytes, flops


def segment_sdpa_inputs(torch, q, pools, table, pos, n_real, bs):
    """The library yardstick's inputs: per segment (tokens sharing a table
    row), K/V gathered and dequantized beforehand, in q's dtype; queries
    padded to the longest segment, a visibility mask per segment (padded
    queries see key 0 only, so every row stays finite)."""
    from deepspeed_tpu_torch.ops.transformer.paged_attention import \
        dequantized

    t, h, d = q.shape
    tl, pl = table.tolist(), pos.tolist()
    segs, start = [], 0
    for r in range(1, n_real + 1):
        if r == n_real or tl[r] != tl[start] or pl[r] != pl[r - 1] + 1:
            segs.append((start, r - start))
            start = r
    sq = max(c for _s, c in segs)
    sk = table.shape[1] * bs
    qs = torch.zeros(len(segs), h, sq, d, dtype=q.dtype, device="cuda")
    mask = torch.zeros(len(segs), 1, sq, sk, dtype=torch.bool,
                       device="cuda")
    mask[..., 0] = True
    kpos = torch.arange(sk, device="cuda")
    rows = torch.tensor([s0 for s0, _c in segs], device="cuda")
    for i, (s0, c) in enumerate(segs):
        qs[i, :, :c] = q[s0:s0 + c].transpose(0, 1)
        mask[i, 0, :c] = kpos[None, :] <= pos[s0:s0 + c].long()[:, None]
    tb = table[rows].long()
    kv = [tuple(dequantized(p, sc, tb).to(q.dtype)
                .reshape(len(segs), sk, h, d).transpose(1, 2).contiguous()
                for p, sc in ((k, ks), (v, vs)))
          for k, v, ks, vs in pools]
    return qs, kv, mask


def check_chunked_prefill(torch, report):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.transformer.chunked_prefill import (
        chunked_prefill_attention, chunked_prefill_attention_reference)

    bs = 16
    shapes = {"T=256 mixed": (256, MIXED_DECODE_POS, MIXED_CHUNKS),
              "T=8 all-decode": (8, MIXED_DECODE_POS, [])}
    worst = {}
    for int8 in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            label = f"{'int8 pools, ' if int8 else ''}{name} q"
            for sname, (t, dpos, chunks) in shapes.items():
                q, pools, table, pos, n_real, _blocks = chunked_case(
                    torch, dtype, t, dpos, chunks, seed=t + int8,
                    int8=int8)
                kp, vp, ks, vs = pools[0]
                got = chunked_prefill_attention(q, kp, vp, ks, vs, table,
                                                pos, block_size=bs)
                torch.cuda.synchronize()
                want = chunked_prefill_attention_reference(
                    q, kp, vp, ks, vs, table, pos, block_size=bs)
                torch.cuda.synchronize()
                real = got[:n_real]
                err = (real.float() - want[:n_real].float()).abs().max()
                err = err.item()
                if not torch.isfinite(real).all() \
                        or err > KERNEL_TOL[name]:
                    fail(f"chunked_prefill_attention {label} {sname}: max "
                         f"|err| {err} > {KERNEL_TOL[name]} or non-finite "
                         f"real rows")
                worst[(label, sname)] = err
    for (label, sname), err in sorted(worst.items()):
        print(f"chunked_prefill_attention {label}, {sname} (H=12 D=64 "
              f"BS=16 WB=64, NaN scratch, pad rows excluded): max |err| "
              f"{err:.3g} (atol {KERNEL_TOL[label.split()[-2]]})")

    # Timing at the mixed step's shape, rotating over 8 layers' pools (no
    # NaN in the timed inputs: pads read a zeroed scratch block).
    timings = {}
    for int8 in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            label = f"{'int8 pools, ' if int8 else ''}{name} q"
            q, pools, table, pos, n_real, blocks = chunked_case(
                torch, dtype, 256, MIXED_DECODE_POS, MIXED_CHUNKS,
                seed=5 + int8, layers=8, int8=int8)
            for k, v, ks, vs in pools:
                if int8:
                    ks[0] = 1.0
                    vs[0] = 1.0
                else:
                    k[0] = 0.0
                    v[0] = 0.0
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(pools)
                return pools[it["i"]]

            kernel_ms = cuda_ms(lambda: chunked_prefill_attention(
                q, *nxt(), table, pos, block_size=bs))
            plain_ms = cuda_ms(lambda: chunked_prefill_attention_reference(
                q, *nxt(), table, pos, block_size=bs), iters=5, warmup=1)
            qs, kv, mask = segment_sdpa_inputs(torch, q, pools, table, pos,
                                               n_real, bs)
            git = {"i": 0}

            def gnxt():
                git["i"] = (git["i"] + 1) % len(kv)
                return kv[git["i"]]

            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, *gnxt(), attn_mask=mask))
            nbytes, flops = chunked_bytes_flops(q, table, pos, blocks, bs,
                                                 int8)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / FP32_FLOPS
            timings[label] = dict(
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            print(f"chunked_prefill_attention timing, {label}, T=256 mixed "
                  f"(decode rows at {MIXED_DECODE_POS}, chunks (first "
                  f"position, tokens) {MIXED_CHUNKS}, {256 - n_real} pads): "
                  f"kernel {kernel_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, SDPA per segment (pre-gathered) "
                  f"{library_ms:.4f} ms, bound "
                  f"{timings[label]['bound_ms']:.4f} ms "
                  f"({timings[label]['bound_by']}: {nbytes} bytes / 3.35 "
                  f"TB/s, {flops} flops / 67 TFLOP/s)")
            del pools, kv
    main = timings["bfloat16 q"]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"],
                  library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                  bound_by=main["bound_by"],
                  max_abs_err=max(worst[("bfloat16 q", s)] for s in shapes))


# ---------------------------------------------------------------------------
# 2b. flash attention forward and backward against their plain versions
# ---------------------------------------------------------------------------

def flash_case(torch, dtype, b, s, h, d, seed, masked=False,
               dout_scale=1.0):
    """q, k, v as the training path makes them: [B, S, H, D] views of one
    fused QKV projection [B, S, 3*H*D] (strided, read in place); dO
    normal, times ``dout_scale``. With ``masked``, a [B, S] key mask: row 0
    all real, row 1 all padding, the others padded at the end from a
    random length."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=g).to("cuda", dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    dout = (torch.randn(b, s, h, d, generator=g) * dout_scale).to(
        "cuda", dtype)
    mask = None
    if masked:
        lens = torch.randint(1, s + 1, (b,), generator=g)
        lens[0] = s
        if b > 1:
            lens[1] = 0
        mask = (torch.arange(s)[None, :] < lens[:, None]).to("cuda")
    return qkv, q, k, v, dout, mask


def bf16_step(torch, ref):
    """One bf16 rounding step (unit in the last place) at each element of
    ``ref``: 2**(e - 8) for |x| in [2**(e-1), 2**e); 0 where ref is 0."""
    r = ref.float()
    exp = torch.frexp(r.abs())[1]
    step = torch.ldexp(torch.ones_like(r), exp - 8)
    return torch.where(r == 0, torch.zeros_like(r), step)


def flash_bytes_flops(q, mask, which):
    """What one kernel must move and compute for these inputs (causal,
    self-attention): each input read once and each output written once;
    per visible (query, key) pair 2*D flops for each of its products (the
    forward has 2, dq 3, dk/dv 4)."""
    b, s, h, d = q.shape
    es = q.element_size()
    big = b * s * h * d * es               # one [B, S, H, D] tensor
    rows = b * h * s * 4                   # one fp32 [B, H, S] vector
    mbytes = 0 if mask is None else b * s * 4
    pairs = b * h * s * (s + 1) // 2
    if which == "fwd":                     # q, k, v -> o, lse
        return 4 * big + rows + mbytes, 4 * d * pairs
    if which == "dq":                      # q, k, v, dO, lse, delta -> dq
        return 5 * big + 2 * rows + mbytes, 6 * d * pairs
    return 6 * big + 2 * rows + mbytes, 8 * d * pairs  # -> dk, dv


def check_flash_attention(torch, reports):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    h, d = 12, 64
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = KERNEL_TOL[name]
        for b, s, masked in ((16, 512, False), (16, 512, True),
                             (4, 5, True), (4, 300, False), (4, 300, True)):
            qkv, q, k, v, dout, mask = flash_case(
                torch, dtype, b, s, h, d, seed=s + masked, masked=masked,
                dout_scale=FLASH_DOUT_SCALE[name])
            scale = 1.0 / d ** 0.5
            qp, kp, vp, mp = fa._prepare(q, k, v, mask, True)
            if qp.data_ptr() != q.data_ptr():
                fail("flash_attention copied an aligned strided view")
            out, lse = fa.flash_attention_fwd(qp, kp, vp, mp, True, scale)
            want = fa.flash_attention_reference(q, k, v, causal=True,
                                                kv_mask=mask)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            delta = delta.contiguous()
            dq = fa.flash_attention_bwd_dq(qp, kp, vp, dout, mp, lse, delta,
                                           True, scale)
            dk, dv = fa.flash_attention_bwd_dkv(qp, kp, vp, dout, mp, lse,
                                                delta, True, scale)
            torch.cuda.synchronize()
            dq_w = fa.flash_bwd_dq_reference(q, k, v, dout, mp, lse, delta,
                                             True, scale)
            dk_w, dv_w = fa.flash_bwd_dkv_reference(q, k, v, dout, mp, lse,
                                                    delta, True, scale)
            # the whole autograd path against the reference's autograd
            x1 = qkv.detach().clone().requires_grad_()
            x2 = qkv.detach().clone().requires_grad_()
            outs = []
            for x, fn in ((x1, fa.flash_attention),
                          (x2, fa.flash_attention_reference)):
                qq, kk, vv = (t.reshape(b, s, h, d)
                              for t in x.split(h * d, dim=-1))
                o = fn(qq, kk, vv, causal=True, kv_mask=mask)
                o.backward(dout)
                outs.append(o)
            torch.cuda.synchronize()
            pairs = {"fwd": (out, want), "dq": (dq, dq_w), "dk": (dk, dk_w),
                     "dv": (dv, dv_w), "autograd out": tuple(outs),
                     "autograd dqkv": (x1.grad, x2.grad)}
            for key, (got, ref) in pairs.items():
                if not torch.isfinite(got).all():
                    fail(f"flash {key} {name} B={b} S={s} masked={masked}: "
                         f"non-finite output")
                diff = (got.float() - ref.float()).abs()
                err = diff.max().item()
                rms = ref.float().pow(2).mean().sqrt().item()
                peak = ref.float().abs().max().item()
                if name == "float32":
                    rel = 0.0
                    bad = err > tol
                else:
                    rel = ((diff - bf16_step(torch, ref)).clamp_min(0).max()
                           .item() / max(rms, 1e-30))
                    bad = rel > FLASH_BF16_RMS_TOL[
                        "autograd" if key.startswith("autograd") else
                        "kernel"]
                if bad:
                    fail(f"flash {key} {name} B={b} S={s} masked={masked}: "
                         f"max |err| {err} (reference RMS {rms}, max |x| "
                         f"{peak}); beyond one bf16 step {rel} of the RMS")
                w = worst.get((key, name))
                if w is None or err > w[0]:
                    worst[(key, name)] = (err, rms, peak)
                w = worst.get((key, name, "rel"))
                worst[(key, name, "rel")] = max(w or 0.0, rel)
            if masked and b > 1 and (out[1].abs().max().item() != 0.0
                                     or dq[1].abs().max().item() != 0.0):
                fail("flash: the all-padding row is not exactly zero")
    for key, name in sorted(k for k in worst if len(k) == 2):
        err, rms, peak = worst[(key, name)]
        lim = FLASH_BF16_RMS_TOL["autograd" if key.startswith("autograd")
                                 else "kernel"]
        limit = (f"atol {KERNEL_TOL[name]}" if name == "float32" else
                 f"beyond one bf16 step: {worst[(key, name, 'rel')]:.3g} "
                 f"of the RMS, limit {lim}")
        print(f"flash_attention {key} {name} (B,S) in (16,512) (4,5) "
              f"(4,300), causal, with/without key mask, dO x "
              f"{FLASH_DOUT_SCALE[name]}: max |err| {err:.3g} where the "
              f"reference's RMS is {rms:.3g} and its max |x| {peak:.3g} "
              f"({limit})")

    # Timing at the training shape, bf16, causal, no mask, rotating over
    # 4 layers' inputs (150 MB, three times the 50 MB L2) as the step does.
    b, s = 16, 512
    layers = [flash_case(torch, torch.bfloat16, b, s, h, d, seed=100 + i)
              for i in range(4)]
    scale = 1.0 / d ** 0.5
    prepped = []
    for _qkv, q, k, v, dout, _m in layers:
        out, lse = fa.flash_attention_fwd(q, k, v, None, True, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        prepped.append((q, k, v, dout, lse, delta.contiguous()))
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(prepped)
        return prepped[it["i"]]

    def run_fwd():
        q, k, v = nxt()[:3]
        fa.flash_attention_fwd(q, k, v, None, True, scale)

    def run_dq():
        q, k, v, dout, lse, delta = nxt()
        fa.flash_attention_bwd_dq(q, k, v, dout, None, lse, delta, True,
                                  scale)

    def run_dkv():
        q, k, v, dout, lse, delta = nxt()
        fa.flash_attention_bwd_dkv(q, k, v, dout, None, lse, delta, True,
                                   scale)

    def plain_fwd():
        q, k, v = nxt()[:3]
        fa.flash_attention_reference(q, k, v, causal=True)

    def plain_dq():
        q, k, v, dout, lse, delta = nxt()
        fa.flash_bwd_dq_reference(q, k, v, dout, None, lse, delta, True,
                                  scale)

    def plain_dkv():
        q, k, v, dout, lse, delta = nxt()
        fa.flash_bwd_dkv_reference(q, k, v, dout, None, lse, delta, True,
                                   scale)

    # yardstick: SDPA (causal) on contiguous [B, H, S, D] copies
    sdpa_in = []
    for _qkv, q, k, v, dout, _m in layers:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa_in.append((qt, kt, vt, o, dout.transpose(1, 2).contiguous()))
    sit = {"i": 0}

    def snxt():
        sit["i"] = (sit["i"] + 1) % len(sdpa_in)
        return sdpa_in[sit["i"]]

    def sdpa_fwd():
        qt, kt, vt = snxt()[:3]
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_bwd():
        qt, kt, vt, o, dot = snxt()
        torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

    sdpa_fwd_ms = cuda_ms(sdpa_fwd)
    sdpa_bwd_ms = cuda_ms(sdpa_bwd)
    q0 = layers[0][1]
    for key, kern, plain, lib in (
            ("fwd", run_fwd, plain_fwd, sdpa_fwd_ms),
            ("dq", run_dq, plain_dq, sdpa_bwd_ms),
            ("dkv", run_dkv, plain_dkv, sdpa_bwd_ms)):
        kernel_ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=10, warmup=2)
        nbytes, flops = flash_bytes_flops(q0, None, key)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_FLOPS
        rep = reports[key]
        errs = ([worst[("fwd", "bfloat16")][0]] if key == "fwd" else
                [worst[("dq", "bfloat16")][0]] if key == "dq" else
                [worst[("dk", "bfloat16")][0],
                 worst[("dv", "bfloat16")][0]])
        rep.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(errs))
        print(f"flash_attention {key} timing bf16 B={b} S={s} H={h} D={d} "
              f"causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"SDPA {'fwd' if key == 'fwd' else 'bwd (dq+dk+dv)'} "
              f"{lib:.4f} ms, bound {rep['bound_ms']:.4f} ms "
              f"({nbytes} bytes / 3.35 TB/s, {flops} flops / 989 TFLOP/s)")


# ---------------------------------------------------------------------------
# 2d. block-sparse attention forward and backward against their plain
#     versions
# ---------------------------------------------------------------------------

# bench.py:bench_gpt2_long's layout: BigBird at block 256, causal
SPARSE_LONG = {"mode": "bigbird", "block": 256, "num_random_blocks": 1,
               "num_sliding_window_blocks": 3, "num_global_blocks": 1,
               "attention": "unidirectional"}
SPARSE_SEQ = 16384
SPARSE_LSE_TOL = 1e-5            # fp32 lse, from the same fp32 scores
# (case, B, S, layout block, causal, key mask): (a) the path's layout at
# seq 4096, (b) the reference's default block 16, bidirectional, with a
# key mask whose second batch row is all padding (rows with no visible
# key), (c) the path's own shape.
SPARSE_CASES = (("a", 1, 4096, SPARSE_LONG, True, False),
                ("b", 2, 1024, {"mode": "fixed", "block": 16}, False, True),
                ("c", 1, SPARSE_SEQ, SPARSE_LONG, True, False))


def sparse_module():
    import importlib

    # the package exports a function of the module's name
    return importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention")


def sparse_layout(block_cfg, heads, seq):
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparsity_config_from_dict

    return sparsity_config_from_dict(block_cfg, heads).make_layout(seq)


def sparse_pairs(layout, block, causal):
    """Visible (query, key) pairs of one batch row over all heads: a whole
    block for every active block below the diagonal, its lower triangle
    for a diagonal block, nothing above it when causal."""
    import numpy as np

    lay = np.asarray(layout) != 0
    if not causal:
        return int(lay.sum()) * block * block
    nb = lay.shape[1]
    below = int((lay & np.tril(np.ones((nb, nb), bool), -1)[None]).sum())
    diag = int((lay & np.eye(nb, dtype=bool)[None]).sum())
    return below * block * block + diag * block * (block + 1) // 2


def sparse_bytes_flops(q, pairs, which):
    """What one kernel must move and compute: each input read once and each
    output written once (the index lists are a few kB); per visible pair
    2*D flops for each of its products (the forward has 2, dq 3, dk/dv
    4). ``pairs``: visible pairs of one batch row."""
    b, s, h, d = q.shape
    big = b * s * h * d * q.element_size()   # one [B, S, H, D] tensor
    rows = b * h * s * 4                     # one fp32 [B, H, S] vector
    p = b * pairs
    if which == "fwd":                       # q, k, v -> o, lse
        return 4 * big + rows, 4 * d * p
    if which == "dq":                        # q, k, v, dO, lse, delta -> dq
        return 5 * big + 2 * rows, 6 * d * p
    return 6 * big + 2 * rows, 8 * d * p     # -> dk, dv


def sparse_plain_grads(torch, sp, q, k, v, dout, mask, plan, causal, scale):
    """The whole path on the plain versions, as the autograd Function runs
    it on the kernels: forward, delta from the output in its dtype, dq and
    dk/dv."""
    out, lse = sp.sparse_fwd_reference(q, k, v, mask, plan, causal, scale)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    args = (dout, mask, lse, delta.contiguous(), plan, causal, scale)
    dq = sp.sparse_bwd_dq_reference(q, k, v, *args)
    dk, dv = sp.sparse_bwd_dkv_reference(q, k, v, *args)
    b, s = q.shape[:2]
    return out, torch.cat([t.reshape(b, s, -1) for t in (dq, dk, dv)], -1)


def check_sparse_attention(torch, reports):
    """Kernels #8-#10 against their plain versions at cases (a) and (b)
    in fp32 and bf16, and (c) in bf16; each kernel and the whole autograd
    path, with flash's tolerances. Then timing at (c), the path's shape."""
    import torch.nn.functional as F

    sp = sparse_module()
    h, d = 12, 64
    scale = 1.0 / d ** 0.5
    worst = {}
    for case, b, s, block_cfg, causal, masked in SPARSE_CASES:
        layout = sparse_layout(block_cfg, h, s)
        block = block_cfg["block"]
        plan = sp.sparse_plan(layout, block)
        for dtype in ((torch.bfloat16,) if case == "c" else
                      (torch.float32, torch.bfloat16)):
            name = str(dtype).split(".")[1]
            qkv, q, k, v, dout, mask = flash_case(
                torch, dtype, b, s, h, d, seed=s + masked, masked=masked,
                dout_scale=FLASH_DOUT_SCALE[name])
            if masked:
                mask[0, s - 100:] = False      # row 1 is all padding
            qp, kp, vp, mp = sp._prepare(q, k, v, mask, plan)
            if qp.data_ptr() != q.data_ptr():
                fail("sparse_attention copied an aligned strided view")
            out, lse = sp.sparse_attention_fwd(qp, kp, vp, mp, plan, causal,
                                               scale)
            want, want_lse = sp.sparse_fwd_reference(q, k, v, mp, plan,
                                                     causal, scale)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            args = (dout, mp, lse, delta.contiguous(), plan, causal, scale)
            dq = sp.sparse_attention_bwd_dq(qp, kp, vp, *args)
            dk, dv = sp.sparse_attention_bwd_dkv(qp, kp, vp, *args)
            torch.cuda.synchronize()
            dq_w = sp.sparse_bwd_dq_reference(q, k, v, *args)
            dk_w, dv_w = sp.sparse_bwd_dkv_reference(q, k, v, *args)
            pairs = {"fwd": (out, want), "dq": (dq, dq_w), "dk": (dk, dk_w),
                     "dv": (dv, dv_w)}
            if case != "c":
                # the whole autograd path against the plain versions' chain
                x = qkv.detach().clone().requires_grad_()
                qq, kk, vv = (t.reshape(b, s, h, d)
                              for t in x.split(h * d, dim=-1))
                o = sp.sparse_attention(qq, kk, vv, layout, block,
                                        causal=causal, key_mask=mask)
                o.backward(dout)
                ref_o, ref_g = sparse_plain_grads(torch, sp, q, k, v, dout,
                                                  mp, plan, causal, scale)
                pairs["autograd out"] = (o, ref_o)
                pairs["autograd dqkv"] = (x.grad, ref_g)
            torch.cuda.synchronize()
            seen = want_lse > sp.NEG_INF / 2
            if not torch.equal(seen, lse > sp.NEG_INF / 2) or \
                    not (lse[~seen] == sp.NEG_INF).all():
                fail(f"sparse lse {case} {name}: empty rows differ")
            lse_err = (lse - want_lse)[seen].abs().max().item()
            if not lse_err <= SPARSE_LSE_TOL:
                fail(f"sparse lse {case} {name}: max |err| {lse_err}")
            for key, (got, ref) in pairs.items():
                if not torch.isfinite(got).all():
                    fail(f"sparse {key} {case} {name}: non-finite output")
                diff = (got.float() - ref.float()).abs()
                err = diff.max().item()
                rms = ref.float().pow(2).mean().sqrt().item()
                if name == "float32":
                    rel, bad = 0.0, err > KERNEL_TOL[name]
                else:
                    rel = ((diff - bf16_step(torch, ref)).clamp_min(0).max()
                           .item() / max(rms, 1e-30))
                    bad = rel > FLASH_BF16_RMS_TOL[
                        "autograd" if key.startswith("autograd") else
                        "kernel"]
                if bad:
                    fail(f"sparse {key} {case} {name}: max |err| {err} "
                         f"(reference RMS {rms}); beyond one bf16 step "
                         f"{rel} of the RMS")
                w = worst.get((key, name))
                if w is None or err > w[0]:
                    worst[(key, name)] = (err, rms, rel, lse_err)
            if masked:
                if any(t[1].abs().max().item() != 0.0
                       for t in (out, dq, dk, dv)):
                    fail(f"sparse {case} {name}: the all-padding batch row "
                         f"is not exactly zero")
                print(f"sparse_attention {case} {name}: batch row 1 (all "
                      f"padding): o, dq, dk, dv exactly 0, lse -1e30")
            del qkv, q, k, v, dout, out, lse, want, want_lse, dq, dk, dv
            del dq_w, dk_w, dv_w, pairs
            torch.cuda.empty_cache()
    for key, name in sorted(worst):
        err, rms, rel, lse_err = worst[(key, name)]
        path = "autograd" if key.startswith("autograd") else "kernel"
        lim = ("atol 1e-5" if name == "float32" else
               f"beyond one bf16 step {rel:.3g} of the RMS, limit "
               f"{FLASH_BF16_RMS_TOL[path]}")
        print(f"sparse_attention {key} {name} cases (a) [1,4096,12,64] "
              f"bigbird-256 causal, (b) [2,1024,12,64] fixed-16 "
              f"bidirectional with a key mask, (c) [1,16384,12,64] "
              f"bigbird-256 causal (bf16), dO x {FLASH_DOUT_SCALE[name]}: "
              f"max |err| {err:.3g} where the reference's RMS is "
              f"{rms:.3g} ({lim}); lse max |err| {lse_err:.3g}")

    # Timing at the path's shape, bf16, rotating over 4 layers' inputs
    # (300 MB of q/k/v, six times the 50 MB L2) as the step does.
    b, s = 1, SPARSE_SEQ
    layout = sparse_layout(SPARSE_LONG, h, s)
    block = SPARSE_LONG["block"]
    plan = sp.sparse_plan(layout, block)
    layers = [flash_case(torch, torch.bfloat16, b, s, h, d, seed=200 + i)
              for i in range(4)]
    prepped = []
    for _qkv, q, k, v, dout, _m in layers:
        out, lse = sp.sparse_attention_fwd(q, k, v, None, plan, True, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        prepped.append((q, k, v, dout, None, lse, delta.contiguous(), plan,
                        True, scale))
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(prepped)
        return prepped[it["i"]]

    def run(fn, plain):
        def go():
            q, k, v, dout, m, lse, delta, pl, c, sc = nxt()
            if fn == "fwd":
                (sp.sparse_fwd_reference if plain else
                 sp.sparse_attention_fwd)(q, k, v, m, pl, c, sc)
            elif fn == "dq":
                (sp.sparse_bwd_dq_reference if plain else
                 sp.sparse_attention_bwd_dq)(q, k, v, dout, m, lse, delta,
                                             pl, c, sc)
            else:
                (sp.sparse_bwd_dkv_reference if plain else
                 sp.sparse_attention_bwd_dkv)(q, k, v, dout, m, lse, delta,
                                              pl, c, sc)
        return go

    # yardstick: SDPA with the layout-expanded boolean mask (one layout
    # for every head here) on contiguous [B, H, S, D] copies
    if (layout != layout[:1]).any():
        fail("the timing layout differs between heads")
    am = sp._dense_mask(layout[0], block, "cuda")
    am &= torch.ones_like(am).tril()
    sdpa_in = []
    for _qkv, q, k, v, dout, _m in layers[:2]:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        sdpa_in.append((qt, kt, vt, o, dout.transpose(1, 2).contiguous()))
    sit = {"i": 0}

    def snxt():
        sit["i"] = (sit["i"] + 1) % len(sdpa_in)
        return sdpa_in[sit["i"]]

    def sdpa_fwd():
        qt, kt, vt = snxt()[:3]
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

    def sdpa_bwd():
        qt, kt, vt, o, dot = snxt()
        torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

    sdpa_fwd_ms = cuda_ms(sdpa_fwd, iters=5, warmup=2)
    sdpa_bwd_ms = cuda_ms(sdpa_bwd, iters=5, warmup=2)
    del sdpa_in
    torch.cuda.empty_cache()
    q0 = layers[0][1]
    npairs = sparse_pairs(layout, block, True)
    for key, lib in (("fwd", sdpa_fwd_ms), ("dq", sdpa_bwd_ms),
                     ("dkv", sdpa_bwd_ms)):
        kernel_ms = cuda_ms(run(key, False), iters=20, warmup=3)
        plain_ms = cuda_ms(run(key, True), iters=2, warmup=1)
        nbytes, flops = sparse_bytes_flops(q0, npairs, key)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_FLOPS
        rep = reports[key]
        errs = ([worst[("fwd", "bfloat16")][0]] if key == "fwd" else
                [worst[("dq", "bfloat16")][0]] if key == "dq" else
                [worst[("dk", "bfloat16")][0],
                 worst[("dv", "bfloat16")][0]])
        rep.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(errs))
        print(f"sparse_attention {key} timing bf16 B={b} S={s} H={h} D={d} "
              f"bigbird block {block} causal ({npairs} visible pairs, "
              f"{npairs / (h * s * (s + 1) / 2):.4f} of the causal square): "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"with the mask {'fwd' if key == 'fwd' else 'bwd (dq+dk+dv)'} "
              f"{lib:.4f} ms, bound {rep['bound_ms']:.4f} ms ({nbytes} "
              f"bytes / 3.35 TB/s, {flops} flops / 989 TFLOP/s)")
    del layers, prepped
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 2c. fused Adam against its plain version, bit for bit
# ---------------------------------------------------------------------------

def gpt2_param_shapes(torch):
    from deepspeed_tpu_torch.models import make_gpt

    with torch.device("meta"):
        model, _cfg = make_gpt("gpt2")
    return [tuple(p.shape) for p in model.state_dict().values()]


def adam_case(torch, shapes, seed, g_dtype=None):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, std):
        return torch.randn(shape, device="cuda", generator=g) * std

    params = [rnd(s, 0.02) for s in shapes]
    grads = [rnd(s, 1e-3) for s in shapes]
    if g_dtype is not None:
        grads = [x.to(g_dtype) for x in grads]
    exp_avg = [rnd(s, 1e-3) for s in shapes]
    exp_avg_sq = [rnd(s, 1e-3) ** 2 for s in shapes]
    return params, grads, exp_avg, exp_avg_sq


def check_fused_adam(torch, report):
    from deepspeed_tpu_torch.ops.adam import (AdamState, FusedAdam,
                                              fused_adam_apply)
    from deepspeed_tpu_torch.ops.adam.fused_update import \
        fused_adam_reference

    shapes = gpt2_param_shapes(torch)
    n = sum(int(torch.Size(s).numel()) for s in shapes)
    cases = [("gpt2 148 leaves, Adam(W) wd 0, fp32 grads", shapes,
              dict(lr=1e-4), None, torch.bfloat16),
             ("AdamW wd 0.01, bf16 grads", shapes[:6],
              dict(lr=1e-3, weight_decay=0.01), torch.bfloat16, None),
             ("Adam L2 wd 0.01", shapes[:6],
              dict(lr=1e-3, weight_decay=0.01, adamw_mode=False), None,
              torch.float16)]
    for label, shp, kw, g_dtype, cast in cases:
        opt = FusedAdam(**kw)
        p, g, m, v = adam_case(torch, shp, seed=len(shp), g_dtype=g_dtype)
        scalars = opt.step_scalars(5, None, "cuda")
        want = fused_adam_reference(opt, g, m, v, p, scalars, cast)
        pk, mk, vk = ([x.clone() for x in xs] for xs in (p, m, v))
        got = fused_adam_apply(opt, g, AdamState(4, mk, vk), pk,
                               cast_dtype=cast)
        torch.cuda.synchronize()
        got_lists = (got[0], got[1].exp_avg, got[1].exp_avg_sq) + (
            (got[2],) if cast is not None else ())
        for what, a_list, b_list in zip(("p", "m", "v", "cast"), got_lists,
                                        want):
            for i, (a, b_) in enumerate(zip(a_list, b_list)):
                if not torch.equal(a, b_):
                    diff = (a.float() - b_.float()).abs().max().item()
                    fail(f"fused_adam {label}: {what}[{i}] differs from "
                         f"the plain version (max |diff| {diff})")
        print(f"fused_adam {label}: bit-equal to the plain version "
              f"({len(shp)} tensors)")
        del p, g, m, v, pk, mk, vk, want, got, got_lists

    # Timing as the bf16 training step calls it: fp32 grads, and the new
    # masters also written in bf16 into the engine's buffers (30 bytes per
    # parameter); the same call without the cast beside it (28 bytes).
    opt = FusedAdam(lr=1e-4)
    p, g, m, v = adam_case(torch, shapes, seed=1)
    state = AdamState(4, m, v)
    casts = [torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")
             for x in p]
    kernel_ms = cuda_ms(lambda: fused_adam_apply(
        opt, g, state, p, cast_dtype=torch.bfloat16, cast_out=casts),
        iters=20)
    nocast_ms = cuda_ms(lambda: fused_adam_apply(opt, g, state, p), iters=20)
    scalars = opt.step_scalars(5, None, "cuda")
    plain_ms = cuda_ms(lambda: fused_adam_reference(
        opt, g, m, v, p, scalars, torch.bfloat16), iters=5, warmup=1)
    leaves = [x.clone().requires_grad_() for x in p]
    for leaf, grad in zip(leaves, g):
        leaf.grad = grad
    lib = torch.optim.Adam(leaves, lr=1e-4, fused=True)
    library_ms = cuda_ms(lib.step, iters=20)
    nbytes = 30 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 12 * n / FP32_FLOPS) * 1e3
    report.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by="bytes", max_abs_err=0.0)
    print(f"fused_adam timing, {len(shapes)} tensors, {n} params, fp32 "
          f"grads: kernel with the bf16 cast {kernel_ms:.4f} ms (1 launch; "
          f"bound {bound_ms:.4f} ms, {nbytes} bytes / 3.35 TB/s), without "
          f"the cast {nocast_ms:.4f} ms (bound "
          f"{28 * n / HBM_BYTES_PER_S * 1e3:.4f} ms), plain with the cast "
          f"{plain_ms:.4f} ms, torch.optim.Adam(fused=True) (no cast) "
          f"{library_ms:.4f} ms")
    del p, g, m, v, leaves, lib, casts


# ---------------------------------------------------------------------------
# 2e. fused LayerNorm + projection (kernels #6, #7) against their plain
#     versions
# ---------------------------------------------------------------------------

# (n, D, F, activation): the training path's two sites at micro 16 x seq
# 512 (LN1 + QKV, LN2 + fc + GELU) and a tail no tile divides (300 rows,
# D = 136, F = 200: ragged row, column and depth tiles)
FUSED_LN_SITES = ((16 * 512, 768, 2304, None), (16 * 512, 768, 3072, "gelu"))
FUSED_LN_TAIL = ((300, 136, 200, None), (300, 136, 200, "gelu"))
FUSED_LN_NAMES = ("dx", "dgamma", "dbeta", "dw", "dbias")
# Each output's max |err| over its plain version's RMS. fp32: the same
# products summed in other orders over 768 (y), 2304-3072 (dln, hence dx)
# and 8192 (dW, the row sums) terms, the largest difference over up to 25
# M outputs: 1.3e-5 of the RMS in the first run on the card (y at fc +
# GELU), so 5e-5, not flash's 1e-5. bf16, beyond one rounding step of the
# output: both sides round the fp32 LayerNorm output (and dy gelu'(pre))
# to bf16 before the product, and their fp32 values differ in the last
# bits (1.0f / sqrtf against torch.rsqrt, sums in other orders), so an
# element at a rounding boundary rounds to neighbouring bf16 values and
# moves a product by up to 2**-8 |ln| |w|, ~4e-3 of the RMS at these
# shapes (2.9e-3 measured); 1e-2.
FUSED_LN_TOL = {"float32": 5e-5, "bfloat16": 1e-2}


def fused_ln_case(torch, dtype, n, d, f, seed):
    """x [n, D] (mean 0.5, std 2), gamma ~ 1, beta and bias ~ 0.1, w [F, D]
    with std 1/sqrt(D), dy normal; all in ``dtype`` (the bf16 training
    step casts gamma, beta and bias to bf16 too)."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g) * std + mean).to(
            "cuda", dtype)

    return (rnd(n, d, std=2.0, mean=0.5), rnd(d, std=0.1, mean=1.0),
            rnd(d, std=0.1), rnd(f, d, std=d ** -0.5), rnd(f, std=0.1),
            rnd(n, f))


def fused_ln_bytes_flops(n, d, f, act, es, which):
    """What one call must move and compute: each input read once, each
    output written once; 2 n D F flops per product (the forward has 1, the
    backward 2, and 3 under GELU, whose pre-activation it recomputes)."""
    vectors = (2 * d + f) * es                       # gamma, beta, bias
    if which == "fwd":                               # x, W -> y
        return (n * d + f * d + n * f) * es + vectors, 2 * n * d * f
    # x, W, dy -> dx, dW, plus the vectors and their gradients
    return ((2 * n * d + 2 * f * d + n * f) * es + 2 * vectors,
            (3 if act else 2) * 2 * n * d * f)


def fused_ln_unfused(torch, x, gamma, beta, w, bias, act):
    """The yardstick: the port's unfused eager sequence for a site
    (models/gpt.py without fused_ln): fp32 F.layer_norm, the cast, F.linear
    in the compute dtype (cuBLAS), the tanh GELU."""
    import torch.nn.functional as F

    h = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(),
                     1e-5).to(w.dtype)
    y = F.linear(h, w, bias)
    return F.gelu(y, approximate="tanh") if act else y


def check_fused_ln(torch, reports):
    """#6 and #7 alone on the plain versions' inputs, and the whole
    autograd path (3-D x through ``ln_matmul``) against the plain
    versions, in fp32 and bf16 at the path's two sites and the tail
    (FUSED_LN_TOL);
    then timed in bf16 at the path's sites, per layer (both sites summed),
    beside the plain versions and the unfused eager sequence."""
    from deepspeed_tpu_torch.ops.transformer import fused as fz
    from torch.profiler import ProfilerActivity, profile

    worst, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for i, (n, d, f, act) in enumerate(FUSED_LN_SITES + FUSED_LN_TAIL):
            x, gamma, beta, w, bias, dy = fused_ln_case(torch, dtype, n, d,
                                                        f, seed=40 + i)
            kw = dict(eps=1e-5, activation=act)
            args = fz._prepare(x, gamma, beta, w, bias)
            if args[0].data_ptr() != x.data_ptr() or \
                    args[3].data_ptr() != w.data_ptr():
                fail("fused_ln copied a contiguous aligned operand")
            y = fz.ln_matmul_fwd(*args, **kw)
            grads = fz.ln_matmul_bwd(*args, dy, **kw)
            torch.cuda.synchronize()
            y_w = fz.ln_matmul_reference(x, gamma, beta, w, bias, **kw)
            grads_w = fz.ln_matmul_bwd_reference(x, gamma, beta, w, bias,
                                                 dy, **kw)
            # the whole path: x as [16, n / 16, D] through the Function
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, gamma, beta, w, bias)]
            x3 = leaves[0].reshape(16, -1, d) if n % 16 == 0 else leaves[0]
            y3 = fz.ln_matmul(x3, *leaves[1:], **kw)
            y3.backward(dy.reshape(y3.shape))
            torch.cuda.synchronize()
            pairs = [("fwd y", y, y_w), ("autograd y", y3.reshape(n, f),
                                         y_w)]
            pairs += [(f"bwd {k}", a, b) for k, a, b in
                      zip(FUSED_LN_NAMES, grads, grads_w)]
            pairs += [(f"autograd {k}", t.grad, b) for k, t, b in
                      zip(FUSED_LN_NAMES, leaves, grads_w)]
            for key, got, ref in pairs:
                if got.dtype != ref.dtype or got.shape != ref.shape:
                    fail(f"fused_ln {key} {name}: {got.dtype} "
                         f"{tuple(got.shape)}, plain {ref.dtype} "
                         f"{tuple(ref.shape)}")
                if not torch.isfinite(got).all():
                    fail(f"fused_ln {key} {name} n={n} F={f}: non-finite")
                diff = (got.float() - ref.float()).abs()
                rms = ref.float().pow(2).mean().sqrt().item()
                err = diff.max().item()
                if name == "bfloat16":
                    diff = (diff - bf16_step(torch, ref)).clamp_min(0)
                rel = diff.max().item() / max(rms, 1e-30)
                if rel > FUSED_LN_TOL[name]:
                    bad.append(f"{key} {name} n={n} D={d} F={f} {act}: max "
                               f"|err| {err}, {rel} of the plain version's "
                               f"RMS {rms}")
                k = (key.split()[0], name)
                w_ = worst.get(k, (0.0, 0.0))
                worst[k] = (max(w_[0], err), max(w_[1], rel))
                if i < len(FUSED_LN_SITES) and name == "bfloat16":
                    worst[("path", key.split()[0])] = max(
                        worst.get(("path", key.split()[0]), 0.0), err)
            del x, gamma, beta, w, bias, dy, args, y, grads, y_w, grads_w
            del leaves, x3, y3, pairs
    for (key, name), (err, rel) in sorted(
            (k, v) for k, v in worst.items() if k[0] != "path"):
        limit = (f"limit {FUSED_LN_TOL[name]}" if name == "float32" else
                 f"beyond one bf16 step; limit {FUSED_LN_TOL[name]}")
        print(f"fused_ln {key} {name} (path sites and tail, +-GELU): max "
              f"|err| {err:.3g}, {rel:.3g} of the plain version's RMS "
              f"({limit})")
    if bad:
        fail("fused_ln kernels disagree with their plain versions:\n  "
             + "\n  ".join(bad))

    # Timing at the path's sites, bf16, rotating over 2 sets of inputs
    sets = {site: [fused_ln_case(torch, torch.bfloat16, *site[:3],
                                 seed=60 + j) for j in range(2)]
            for site in FUSED_LN_SITES}
    times = {}
    for site, cases in sets.items():
        n, d, f, act = site
        kw = dict(eps=1e-5, activation=act)
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(cases)
            return cases[it["i"]]

        lib_in = []
        for x, gamma, beta, w, bias, dy in cases:
            leaves = [t.clone().requires_grad_()
                      for t in (x, gamma, beta, w, bias)]
            lib_in.append((leaves, fused_ln_unfused(torch, *leaves, act),
                           dy))

        def lib_fwd():
            with torch.no_grad():
                fused_ln_unfused(torch, *nxt()[:5], act)

        def lib_bwd():
            leaves, out, dy = lib_in[it["i"]]
            it["i"] = (it["i"] + 1) % len(cases)
            torch.autograd.grad(out, leaves, dy, retain_graph=True)

        t = {"fwd": cuda_ms(lambda: fz.ln_matmul_fwd(*nxt()[:5], **kw)),
             "bwd": cuda_ms(lambda: fz.ln_matmul_bwd(*nxt(), **kw),
                            iters=20),
             "plain fwd": cuda_ms(lambda: fz.ln_matmul_reference(
                 *nxt()[:5], **kw), iters=10, warmup=2),
             "plain bwd": cuda_ms(lambda: fz.ln_matmul_bwd_reference(
                 *nxt(), **kw), iters=5, warmup=1),
             "library fwd": cuda_ms(lib_fwd),
             "library bwd": cuda_ms(lib_bwd, iters=20)}
        for which in ("fwd", "bwd"):
            nbytes, flops = fused_ln_bytes_flops(n, d, f, act, 2, which)
            t[f"bound {which}"] = max(nbytes / HBM_BYTES_PER_S,
                                      flops / BF16_FLOPS) * 1e3
            t[f"by {which}"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                                >= flops / BF16_FLOPS else "operations")
            t[f"tflops {which}"] = flops / (t[which] / 1e3) / 1e12
        # the kernels of one forward and backward call, by device time
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                x, gamma, beta, w, bias, dy = nxt()
                fz.ln_matmul_fwd(x, gamma, beta, w, bias, **kw)
                fz.ln_matmul_bwd(x, gamma, beta, w, bias, dy, **kw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        t["profile per fwd + bwd"] = kernel_stats(prof.events(), 5, wall_us)
        times[site] = t
        print(f"fused_ln timing bf16 n={n} D={d} F={f} {act}: "
              f"{json.dumps(t)}")
        del lib_in
    del sets
    for which in ("fwd", "bwd"):
        rep = reports[which]
        rep.update(
            ms=sum(t[which] for t in times.values()),
            plain_ms=sum(t[f"plain {which}"] for t in times.values()),
            library_ms=sum(t[f"library {which}"] for t in times.values()),
            bound_ms=sum(t[f"bound {which}"] for t in times.values()),
            bound_by=times[FUSED_LN_SITES[0]][f"by {which}"],
            max_abs_err=worst[("path", which)])
        print(f"fused_ln {which} per layer (both sites, bf16): kernel "
              f"{rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms, unfused "
              f"eager sequence {rep['library_ms']:.4f} ms, bound "
              f"{rep['bound_ms']:.4f} ms ({rep['bound_by']})")


# ---------------------------------------------------------------------------
# 3. serving end to end
# ---------------------------------------------------------------------------

def serving_engine(torch, dtype, mode, params, **serving):
    """Full-width GPT-2 behind ``init_serving``: 8 slots, KV block 16, a
    pool of 8 x 1024 positions (plus the scratch block); ``serving`` adds
    keys of the serving block (chunked prefill, int8 pool, prefix
    cache)."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import make_gpt

    with torch.device("cuda"):
        model, _cfg = make_gpt("gpt2", dtype=dtype)
    bs = 16
    return dtt.init_serving(model, params=params, dtype=dtype, config={
        "serving": {"max_batch_size": 8, "kv_block_size": bs,
                    "kv_num_blocks": 8 * 1024 // bs + 1,
                    "decode_attention": mode, **serving}})


def serving_plain_targets(mode, chunked, prefix):
    """Plain versions a serving path must not call on the card: the
    kernels' plain versions always; under chunked prefill also any dense
    attention and any gather (its prompts go through kernel #2 too); on
    the bucketed kernel path the paged cache's gather (a prefix hit's tail
    prefill gathers by design, as in the JAX package, so not there)."""
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.transformer import (chunked_prefill,
                                                     paged_attention)
    from deepspeed_tpu_torch.serving.kv_cache import PagedLayerCache

    targets = [(paged_attention, "paged_decode_attention_reference"),
               (chunked_prefill, "chunked_prefill_attention_reference")]
    if chunked:
        targets.append((gpt, "xla_attention"))
    if chunked or (mode == "kernel" and not prefix):
        targets.append((PagedLayerCache, "_gather"))
    return targets


class KernelShims:
    """Swaps the serving attention for the duration of a run:

    - ``"plain"``: the chunked step's attention is its plain version (the
      module attribute the chunked cache looks up at each call);
    - ``"both"``: after each cache's ``update_attend`` (write, then the
      kernel), the plain version runs on the same pools and the largest
      difference is kept in ``max_err``; the kernel's output is used, so
      the run is the kernel path, held call by call.
    """

    def __init__(self, attention):
        from deepspeed_tpu_torch.ops.transformer import (chunked_prefill,
                                                         paged_attention)
        from deepspeed_tpu_torch.serving.kv_cache import (ChunkedLayerCache,
                                                          PagedLayerCache)
        self.attention = attention
        self.cp = chunked_prefill
        self.kernel = chunked_prefill.chunked_prefill_attention
        self.caches = (PagedLayerCache, ChunkedLayerCache)
        self.methods = tuple(c.update_attend for c in self.caches)
        # captured before any counting shim: these calls are the check's,
        # not the main path's
        self.plain = (paged_attention.paged_decode_attention_reference,
                      chunked_prefill.chunked_prefill_attention_reference)
        self.max_err = 0.0
        self.checked = 0

    def _note(self, out, ref):
        self.max_err = max(self.max_err,
                           (out.float() - ref.float()).abs().max().item())
        self.checked += 1

    def __enter__(self):
        shims = self
        paged, chunked = self.methods

        def both_paged(cache, q, k_new, v_new, softmax_scale=None):
            cache, o = paged(cache, q, k_new, v_new, softmax_scale)
            qk = q if cache.int8 else q.to(cache.k.dtype)
            ref = shims.plain[0](
                qk, cache.k, cache.v, cache.block_table, cache.pos,
                block_size=cache.block_size, softmax_scale=softmax_scale,
                k_scale=cache.k_scale, v_scale=cache.v_scale)
            shims._note(o, ref)
            return cache, o

        def both_chunked(cache, q, k_new, v_new, softmax_scale=None):
            cache, o = chunked(cache, q, k_new, v_new, softmax_scale)
            qk = q[0] if cache.int8 else q[0].to(cache.k.dtype)
            ref = shims.plain[1](
                qk, cache.k, cache.v, cache.k_scale, cache.v_scale,
                cache.block_table[cache.slots.long()], cache.pos,
                block_size=cache.block_size, softmax_scale=softmax_scale)
            shims._note(o[0], ref)
            return cache, o

        if self.attention == "plain":
            cp = self.cp
            cp.chunked_prefill_attention = (
                lambda *a, **k: cp.chunked_prefill_attention_reference(
                    *a, **k))
        elif self.attention == "both":
            self.caches[0].update_attend = both_paged
            self.caches[1].update_attend = both_chunked
        return self

    def __exit__(self, *exc):
        self.cp.chunked_prefill_attention = self.kernel
        for cls, method in zip(self.caches, self.methods):
            cls.update_attend = method


def serve(torch, dtype, mode, params, requests, wave1=10,
          second_wave="finish", attention="kernel", **serving):
    """Serve ``requests``: ``wave1`` at once, the rest when the first
    request finishes (backfill), or with ``second_wave="prefill"`` as soon
    as request 0 has its first token (so the rest find its prompt in the
    prefix cache). Checks completion, leaks, backfill, the kernels'
    launch counts and that no plain version ran on the main path.
    ``attention`` (``KernelShims``): "kernel"; "plain", the chunked
    step's kernel replaced by its plain version (nothing launches); or
    "both", every kernel call held against its plain version on the
    same inputs (``max_err`` in the metrics)."""
    from deepspeed_tpu_torch.ops.transformer import chunked_prefill
    from deepspeed_tpu_torch.ops.transformer.paged_attention import \
        paged_decode_attention

    srv = serving_engine(torch, dtype, mode, params, **serving)
    cfg = srv.model_cfg
    chunked = srv.scfg.chunked_prefill
    label = (f"{mode}/{dtype}/{attention}/" + ",".join(
        f"{k}={v}" for k, v in sorted(serving.items())))
    cp = chunked_prefill.chunked_prefill_attention
    rids = [srv.submit(p, n) for p, n in requests[:wave1]]
    step_ms, decode_tokens = [], 0
    paged_decode_attention.launches = 0
    cp.launches = 0
    swap_plain = attention == "plain"
    shims = KernelShims(attention)
    targets = ([(chunked_prefill, "chunked_prefill_attention_reference")]
               if swap_plain else serving_plain_targets(
                   mode, chunked, srv.prefix_cache is not None))
    with shims, PlainCalls(targets) as plain:
        t0 = time.perf_counter()
        while not srv.idle():
            ts = time.perf_counter()
            info = srv.step()  # ends in a host fetch: the card is done
            dt = time.perf_counter() - ts
            if info["active"] and (chunked or not info["prefilled"]):
                step_ms.append(dt * 1e3)
                decode_tokens += info["active"]
            if len(rids) == wave1 and (
                    info["finished"] if second_wave == "finish"
                    else rids[0] in info["prefilled"]):
                rids += [srv.submit(p, n) for p, n in requests[wave1:]]
        wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "chunked_prefill_attention": cp.launches}
    res = srv.results
    for rid, (p, n) in zip(rids, requests):
        r = res.get(rid)
        if r is None or r["status"] != "finished" \
                or len(r["tokens"]) != len(p) + n:
            got = r and (r["status"], len(r["tokens"]))
            fail(f"{label}: request {rid} did not finish with "
                 f"{len(p) + n} tokens: {got}")
    if srv.prefix_cache is not None:
        srv.prefix_cache.clear()
    if srv.pool.used_blocks != 0:
        fail(f"{label}: {srv.pool.used_blocks} KV blocks leaked")
    if second_wave == "finish" \
            and max(srv.stats["slot_assignments"].values()) < 2:
        fail(f"{label}: no slot served two requests (no backfill)")
    want = {"paged_decode_attention": 0, "chunked_prefill_attention": 0}
    if chunked and not swap_plain:
        want["chunked_prefill_attention"] = \
            srv.stats["mixed_steps"] * cfg.num_layers
    elif not chunked and mode == "kernel":
        want["paged_decode_attention"] = \
            srv.stats["kernel_steps"] * cfg.num_layers
    if launches != want or (chunked and not swap_plain
                            and not want["chunked_prefill_attention"]):
        fail(f"{label}: kernel launches {launches}, expected {want}")
    called = {k: v for k, v in plain.calls.items() if v}
    if swap_plain and not called:
        fail(f"{label}: the swapped-in plain version never ran")
    if not swap_plain and called:
        fail(f"{label}: a plain version ran on the main path: {called}")
    tokens = sum(n for _p, n in requests)
    if attention == "both" and (
            not shims.checked
            or shims.max_err > KERNEL_TOL[str(dtype).split(".")[1]]):
        fail(f"{label}: {shims.checked} kernel calls held against their "
             f"plain version, max |err| {shims.max_err}")
    return srv, [res[r]["tokens"] for r in rids], dict(
        wall_s=wall, launches=launches, step_ms=step_ms,
        max_err=shims.max_err, checked_calls=shims.checked,
        decode_tokens=decode_tokens, gen_tokens_per_s=tokens / wall,
        ttft_ms=[res[r]["ttft_ms"] for r in rids],
        decode_steps=srv.stats["decode_steps"],
        kernel_steps=srv.stats["kernel_steps"],
        mixed_steps=srv.stats["mixed_steps"],
        prefix_hits=srv.stats["prefix_hits"])


def first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def top2_gap(torch, engine, prefix) -> float:
    logits = engine.forward(torch.tensor([prefix]))["logits"][0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def int8_gap(torch, srv, chunked):
    """Top-2 logit gap of the int8 pool's model at a prefix, the way the
    serving path computes it (through the plain gather path, fp32):
    chunked, every token attends over pool K/V quantized when written;
    bucketed, the prompt attends over its own unquantized dense cache,
    is packed into the pool quantized, and each later token attends over
    the pool."""
    from deepspeed_tpu_torch.models import init_kv_cache
    from deepspeed_tpu_torch.serving.kv_cache import (PagedLayerCache,
                                                      init_paged_pools,
                                                      pack_prefill)

    cfg, bs = srv.model_cfg, srv.block_size

    def gap(prefix, prompt_len):
        n = len(prefix)
        nb = -(-n // bs)
        pools = init_paged_pools(cfg, nb + 1, bs, int8=True, device="cuda")
        blocks = torch.arange(1, nb + 1, device="cuda")
        bt = blocks.int()[None]
        ids = torch.tensor([prefix], device="cuda")

        def paged(lo):
            start = torch.tensor([lo], dtype=torch.int32, device="cuda")
            cache = [PagedLayerCache(*pools[i], bt, start, bs, "gather",
                                     dtype=srv._dtype)
                     for i in range(cfg.num_layers)]
            return srv.module(ids[:, lo:], position_ids=torch.arange(
                lo, n, device="cuda")[None], cache=cache)["logits"][0, -1]

        with torch.no_grad():
            if chunked:
                logits = paged(0)
            else:
                dense = init_kv_cache(cfg, 1, nb * bs, dtype=srv._dtype,
                                      device="cuda")
                out = srv.module(ids[:, :prompt_len], cache=dense, pos=0)
                logits = out["logits"][0, -1]
                pack_prefill(pools, blocks,
                             torch.stack([c[0][0] for c in dense]),
                             torch.stack([c[1][0] for c in dense]))
                if n > prompt_len:
                    logits = paged(prompt_len)
        top = torch.topk(logits.float(), 2).values
        return float(top[0] - top[1])

    return gap


def check_identity(torch, engine, name, got, want, prompt_lens, gap=None):
    """Token identity, except where the first difference sits on a true
    tie of the top two logits (then the rows legitimately diverge).
    ``gap(prefix, prompt_len)``: the model's top-2 gap there (default:
    the fp forward of ``engine``)."""
    ties = 0
    for i, (a, b) in enumerate(zip(got, want)):
        at = first_diff(a, b)
        if at is None and len(a) == len(b):
            continue
        if at is None or at < prompt_lens[i]:
            fail(f"{name}: request {i} differs in length or prompt")
        g = (gap(a[:at], prompt_lens[i]) if gap is not None
             else top2_gap(torch, engine, a[:at]))
        print(f"{name}: request {i} first differs at position {at}, "
              f"top-2 logit gap {g:.3g}")
        if g >= TIE_GAP:
            fail(f"{name}: request {i} differs at {at} with top-2 gap "
                 f"{g} >= {TIE_GAP} (not a tie)")
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


def kernel_stats(events, steps, wall_us):
    """Device busy time (union of kernel intervals), idle share and the
    top kernels by device time, per step, from profiler events."""
    from torch.autograd import DeviceType

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
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
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "step_ms": wall_us / steps / 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernels_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": {n[:70]: t / steps / 1e3
                                        for n, t in top}}


def profile_steps(torch, srv, steps, what, check):
    """Device busy share and device time by kernel over ``steps`` serving
    steps, from a ``torch.profiler`` trace. The profiler adds host time,
    so the idle share it shows is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            check(srv.step())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = kernel_stats(prof.events(), steps, wall_us)
    if out is None:
        print(f"{what} profile: the profiler recorded no device events; "
              f"device busy share not measured")
    else:
        print(f"{what} profile (under torch.profiler): {json.dumps(out)}")
    return out


def profile_decode(torch, params, requests, steps=16):
    """16 steady decode steps (8 active rows, no prefill) of the bf16
    bucketed kernel path."""
    srv = serving_engine(torch, torch.bfloat16, "kernel", params)
    for p, n in requests[:8]:
        srv.submit(p, n)
    while srv.sched.queue_depth:        # one admission per step
        srv.step()

    def steady(info):
        if info["prefilled"] or info["active"] != 8:
            fail(f"profile window is not steady decode: {info}")

    return profile_steps(torch, srv, steps, "decode (bf16, 8 active)",
                         steady)


def profile_chunked(torch, params, requests, steps=16):
    """16 mixed steps of the bf16 chunked path at budget 256, from the
    step after the 8th admission: prompt chunks still landing beside
    decode rows, then decode rows alone."""
    from deepspeed_tpu_torch.ops.transformer import chunked_prefill

    srv = serving_engine(torch, torch.bfloat16, "kernel", params,
                         chunked_prefill={"token_budget": 256})
    for p, n in requests[:8]:
        srv.submit(p, n)
    while srv.sched.queue_depth:
        srv.step()
    before = srv.stats["mixed_steps"]
    launched = chunked_prefill.chunked_prefill_attention.launches

    def mixed(info):
        if not info["active"]:
            fail(f"chunked profile window ran out of work: {info}")

    out = profile_steps(torch, srv, steps, "chunked mixed steps (bf16, "
                        "budget 256)", mixed)
    n = (chunked_prefill.chunked_prefill_attention.launches - launched)
    if srv.stats["mixed_steps"] - before != steps \
            or n != steps * srv.model_cfg.num_layers:
        fail(f"chunked profile: {n} kernel #2 launches in "
             f"{srv.stats['mixed_steps'] - before} mixed steps")
    return out


def trace(cfg):
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.permutation(np.linspace(16, 700, 16).astype(int))
    new = rng.integers(32, 65, 16)
    return [(rng.integers(0, cfg.vocab_size, int(t)).tolist(), int(n))
            for t, n in zip(lengths, new)]


def prefix_trace(cfg):
    """8 requests sharing a 512-token head (32 blocks of 16) with
    distinct tails of 16-128 tokens, 32-64 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(1)
    head = rng.integers(0, cfg.vocab_size, 512).tolist()
    tails = rng.permutation(np.linspace(16, 128, 8).astype(int))
    new = rng.integers(32, 65, 8)
    return [(head + rng.integers(0, cfg.vocab_size, int(t)).tolist(), int(n))
            for t, n in zip(tails, new)]


def step_summary(m):
    return {"steps": len(m["step_ms"]),
            "step_ms_median": median(m["step_ms"]),
            "step_ms_p10": quantile(m["step_ms"], 0.1),
            "step_ms_p90": quantile(m["step_ms"], 0.9),
            "ttft_ms_median": median(m["ttft_ms"]),
            "ttft_ms_p90": quantile(m["ttft_ms"], 0.9),
            "generated_tokens_per_s_over_wall": m["gen_tokens_per_s"],
            "wall_s": m["wall_s"]}


def check_serving(torch):
    from deepspeed_tpu_torch.models import GPT_CONFIGS, init_gpt_params

    cfg = GPT_CONFIGS["gpt2"]
    t0 = time.perf_counter()
    params = init_gpt_params(cfg, seed=0)
    print(f"gpt2 weights from seed 0: {time.perf_counter() - t0:.1f} s")
    requests = trace(cfg)
    plens = [len(p) for p, _ in requests]
    bf16, fp32 = torch.bfloat16, torch.float32
    out = {}

    # -- bucketed bf16 through kernel #1: the first run pays one-time costs
    # (cuBLAS handles, allocator growth); the second is the one measured
    serve(torch, bf16, "kernel", params, requests)
    _srv, _toks, m = serve(torch, bf16, "kernel", params, requests)
    dec_s = sum(m["step_ms"]) / 1e3
    serving = {
        "model": "gpt2", "dtype": "bfloat16", "requests": len(requests),
        "decode_attention": "kernel", "decode_steps": m["decode_steps"],
        "kernel_steps": m["kernel_steps"],
        "kernel_launches": m["launches"]["paged_decode_attention"],
        "decode_tokens_per_s": m["decode_tokens"] / dec_s,
        "decode_step_ms_median": median(m["step_ms"]),
        "decode_step_ms_p10": quantile(m["step_ms"], 0.1),
        "decode_step_ms_p90": quantile(m["step_ms"], 0.9),
        "ttft_ms_median": median(m["ttft_ms"]),
        "ttft_ms_p90": quantile(m["ttft_ms"], 0.9),
        "generated_tokens_per_s_over_wall": m["gen_tokens_per_s"],
        "wall_s": m["wall_s"]}
    print(f"serving bf16 kernel: {json.dumps(serving)}")
    out["bucketed"] = serving

    # -- chunked bf16 at budget 256 through kernel #2: the timed run
    chunk256 = {"chunked_prefill": {"token_budget": 256}}
    serve(torch, bf16, "kernel", params, requests, **chunk256)
    _srv, _toks, m = serve(torch, bf16, "kernel", params, requests,
                           **chunk256)
    chunked = {"dtype": "bfloat16", "token_budget": 256,
               "mixed_steps": m["mixed_steps"],
               "kernel_launches": m["launches"]["chunked_prefill_attention"],
               **step_summary(m)}
    print(f"serving bf16 chunked (kernel #2 launches == mixed_steps x 12, "
          f"kernel #1 launches 0, no plain attention): "
          f"{json.dumps(chunked)}")
    out["chunked"] = chunked

    # -- fp32 token identity: kernel #1 vs gather vs generate, and the
    # chunked path (budget 64, the JAX default) against both
    srv_k, toks_k, mk = serve(torch, fp32, "kernel", params, requests)
    _srv_g, toks_g, mg = serve(torch, fp32, "gather", params, requests)
    _srv_c, toks_c, mc = serve(torch, fp32, "kernel", params, requests,
                               chunked_prefill={"token_budget": 64})
    print(f"serving fp32: kernel {mk['wall_s']:.2f} s, gather "
          f"{mg['wall_s']:.2f} s, chunked@64 {mc['wall_s']:.2f} s; step "
          f"median kernel {median(mk['step_ms']):.2f} ms, gather "
          f"{median(mg['step_ms']):.2f} ms, chunked@64 "
          f"{median(mc['step_ms']):.2f} ms")
    eng = srv_k.engine
    ties = check_identity(torch, eng, "fp32 kernel vs gather", toks_k,
                          toks_g, plens)
    ties += check_identity(torch, eng, "fp32 chunked@64 vs bucketed kernel",
                           toks_c, toks_k, plens)
    # generate() is the token-identity oracle in both packages
    for i in sorted(range(len(requests)), key=lambda i: plens[i])[::5]:
        p, n = requests[i]
        gen = eng.generate([p], max_new_tokens=n)[0].tolist()
        ties += check_identity(torch, eng,
                               f"fp32 kernel vs generate (request {i})",
                               [toks_k[i]], [gen], [plens[i]])
        ties += check_identity(torch, eng,
                               f"fp32 chunked vs generate (request {i})",
                               [toks_c[i]], [gen], [plens[i]])
    serving["fp32_ties"] = ties

    # -- the int8 pool: bucketed bf16 through kernel #1's int8 branch
    # (measured second), fp32 kernel vs gather, chunked fp32 kernel #2 vs
    # its plain version swapped in
    serve(torch, bf16, "kernel", params, requests, int8_kv_cache=True)
    _srv, _toks, m = serve(torch, bf16, "kernel", params, requests,
                           int8_kv_cache=True)
    int8 = {"dtype": "bfloat16", "kernel_steps": m["kernel_steps"],
            "kernel_launches": m["launches"]["paged_decode_attention"],
            "decode_step_ms_median": median(m["step_ms"]),
            "ttft_ms_median": median(m["ttft_ms"]),
            "decode_tokens_per_s": m["decode_tokens"]
            / (sum(m["step_ms"]) / 1e3), "wall_s": m["wall_s"]}
    print(f"serving bf16 int8 pool, kernel (int8 launches == kernel_steps "
          f"x 12, no gather): {json.dumps(int8)}")
    out["int8"] = int8
    # fp32: runs of the int8 pool that differ only in fp32 summation
    # order do not stay token-identical at ties alone. Every new K/V row
    # is requantized: a value on a half step whose fp32 rounding differs
    # takes the next code, one quantization step (amax / 127) away, and
    # that moves later logits by far more than 1e-4. So each kernel is
    # held against its plain version call by call on the served run's own
    # pools (fp32 atol 1e-5), and the separately served paths are
    # compared for information.
    srv_ik, toks_ik, mik = serve(torch, fp32, "kernel", params, requests,
                                 attention="both", int8_kv_cache=True)
    _srv, toks_ig, _ = serve(torch, fp32, "gather", params, requests,
                             int8_kv_cache=True)
    i8c = {"int8_kv_cache": True, "chunked_prefill": {"token_budget": 64}}
    srv_ic, toks_ic, mic = serve(torch, fp32, "kernel", params, requests,
                                 attention="both", **i8c)
    _srv, toks_icp, _ = serve(torch, fp32, "kernel", params, requests,
                              attention="plain", **i8c)
    print(f"fp32 int8 pool, every kernel call held against its plain "
          f"version on the same pools: kernel #1 int8 {mik['checked_calls']}"
          f" calls, max |err| {mik['max_err']:.3g}; kernel #2 int8 "
          f"{mic['checked_calls']} calls, max |err| {mic['max_err']:.3g} "
          f"(atol 1e-5)")
    int8["fp32_max_err_kernel1"] = mik["max_err"]
    int8["fp32_max_err_kernel2"] = mic["max_err"]
    for key, name, got, want, chunked in (
            ("kernel_vs_gather", "int8 kernel vs gather", toks_ik, toks_ig,
             False),
            ("chunked_kernel_vs_plain", "int8 chunked, kernel #2 vs its "
             "plain version", toks_ic, toks_icp, True),
            ("chunked_vs_bucketed", "int8 chunked vs int8 bucketed",
             toks_ic, toks_ik, True)):
        gap = int8_gap(torch, srv_ic if chunked else srv_ik, chunked)
        diffs = [(i, at, plens[i], round(gap(a[:at], plens[i]), 6))
                 for i, (a, b) in enumerate(zip(got, want))
                 if (at := first_diff(a, b)) is not None]
        print(f"fp32 {name} (information): {len(diffs)} of "
              f"{len(requests)} requests differ; (request, first differing "
              f"position, prompt length, int8 top-2 gap there): {diffs}")
        int8[f"fp32_{key}_requests_differing"] = len(diffs)

    # -- the prefix cache: request 0 first, the rest once it has its first
    # token; bucketed and chunked against the same run without the cache
    preq = prefix_trace(cfg)
    pl = [len(p) for p, _ in preq]
    ref_srv, toks_ref, mref = serve(torch, fp32, "kernel", params, preq,
                                    wave1=1, second_wave="prefill")
    prefix = {"requests": len(preq), "shared_head": 512,
              "cold_ttft_ms_median": median(mref["ttft_ms"][1:])}
    for label, extra in (("bucketed", {}),
                         ("chunked", {"chunked_prefill":
                                      {"token_budget": 256}})):
        _srv, toks_p, mp = serve(torch, fp32, "kernel", params, preq,
                                 wave1=1, second_wave="prefill",
                                 prefix_cache=True, **extra)
        if mp["prefix_hits"] < 7:
            fail(f"prefix {label}: {mp['prefix_hits']} prefix hits < 7")
        ties = check_identity(torch, ref_srv.engine,
                              f"fp32 prefix {label} vs no prefix cache",
                              toks_p, toks_ref, pl)
        prefix[label] = {"prefix_hits": mp["prefix_hits"],
                         "warm_ttft_ms_median": median(mp["ttft_ms"][1:]),
                         "first_request_ttft_ms": mp["ttft_ms"][0],
                         "ties": ties, "wall_s": mp["wall_s"]}
    print(f"serving fp32 prefix trace (8 requests, 512-token shared head; "
          f"TTFT of requests 1-7, warm with the cache, cold without): "
          f"{json.dumps(prefix)}")
    out["prefix"] = prefix

    out["decode_profile"] = profile_decode(torch, params, requests)
    out["chunked_profile"] = profile_chunked(torch, params, requests)
    return out


KERNELS = (
    ("paged_decode_attention", "paged_attention",
     "deepspeed_tpu/ops/transformer/paged_attention.py:69"),
    ("paged_decode_attention_int8", "paged_attention",
     "deepspeed_tpu/ops/transformer/paged_attention.py:69"),
    ("chunked_prefill_attention", "chunked_prefill",
     "deepspeed_tpu/ops/transformer/chunked_prefill.py:65"),
    ("flash_attention_fwd", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:113"),
    ("flash_attention_bwd_dq", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:231"),
    ("flash_attention_bwd_dkv", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:287"),
    ("fused_adam", "fused_adam", "deepspeed_tpu/ops/adam/fused_update.py:52"),
    ("sparse_attention_fwd", "sparse_attention",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:88"),
    ("sparse_attention_bwd_dq", "sparse_attention",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:147"),
    ("sparse_attention_bwd_dkv", "sparse_attention",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:194"),
    ("fused_ln_matmul_fwd", "fused_ln",
     "deepspeed_tpu/ops/transformer/fused.py:68"),
    ("fused_ln_matmul_bwd", "fused_ln",
     "deepspeed_tpu/ops/transformer/fused.py:81"),
)


# ---------------------------------------------------------------------------
# 4. training end to end
# ---------------------------------------------------------------------------

TRAIN_CONFIG = {                  # bench.py:bench_gpt2's, plus the kernel
    "train_micro_batch_size_per_gpu": 16,
    "gradient_accumulation_steps": 8,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4},
                  "fused_update": True},
    "zero_optimization": {"stage": 2},
    "data_types": {"grad_accum_dtype": "bfloat16"},
    "bf16": {"enabled": True},
}
TRAIN_SEQ = 512
TRAIN_WARMUP, TRAIN_STEPS = 2, 5


def train_flops_per_step(n_params, batch, seq, hidden, layers):
    """bench.py:train_flops_per_step: 6 N per token for the dense path plus
    the attention score/value products, 12 S H per token per layer."""
    tokens = batch * seq
    return 6.0 * n_params * tokens + 12.0 * layers * hidden * seq * tokens


class PlainCalls:
    """Counts calls of the plain versions while the main path runs: the
    module (or class) attributes the wrappers call are swapped for
    counting shims. ``targets``: ``(owner, name)`` pairs; by default the
    training paths': dense and sparse attention, Adam and the fused
    LayerNorm + projection."""

    def __init__(self, targets=None):
        if targets is None:
            from deepspeed_tpu_torch.ops.adam import fused_update
            from deepspeed_tpu_torch.ops.transformer import (
                attention, flash_attention, fused)
            sp = sparse_module()
            targets = [(flash_attention, "flash_attention_reference"),
                       (attention, "xla_attention"),
                       (fused_update, "fused_adam_reference"),
                       (sp, "_xla_sparse"), (sp, "sparse_fwd_reference"),
                       (sp, "sparse_bwd_dq_reference"),
                       (sp, "sparse_bwd_dkv_reference"),
                       (fused, "ln_matmul_reference"),
                       (fused, "ln_matmul_bwd_reference")]
        self.targets = targets
        self.calls = {name: 0 for _m, name in self.targets}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))

            def shim(*a, _orig=orig, _name=name, **k):
                self.calls[_name] += 1
                return _orig(*a, **k)

            setattr(mod, name, shim)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def training_counters():
    """The launch counters of every kernel a training step may run."""
    from deepspeed_tpu_torch.ops.adam import fused_adam_apply
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused

    sp = sparse_module()
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "sparse_attention_fwd": sp.sparse_attention_fwd,
            "sparse_attention_bwd_dq": sp.sparse_attention_bwd_dq,
            "sparse_attention_bwd_dkv": sp.sparse_attention_bwd_dkv,
            "fused_adam": fused_adam_apply,
            "fused_ln_matmul_fwd": fused.ln_matmul_fwd,
            "fused_ln_matmul_bwd": fused.ln_matmul_bwd}


def timed_steps(torch, engine, batches, steps):
    """Host-clock ms of each ``train_batch`` (ending in a synchronize)
    and its loss."""
    step_ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine.train_batch(batches)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return step_ms, losses


def counted_steps(torch, engine, batches, per_step, what, warmup, steps):
    """The main path of a training phase: ``warmup`` steps, then every
    launch count set to 0 and ``steps`` timed steps with the plain
    versions counted. Fails unless each kernel launched ``per_step[name]``
    times per step, no plain version ran and the loss fell on the fixed
    batch. Returns (step ms, losses, launches); the peak memory counts
    from the timed steps."""
    import numpy as np

    counters = training_counters()
    losses = [float(engine.train_batch(batches)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with PlainCalls() as plain:
        step_ms, timed = timed_steps(torch, engine, batches, steps)
    launches = {name: fn.launches for name, fn in counters.items()}
    losses += timed
    for name, n in per_step.items():
        if launches[name] != steps * n:
            fail(f"{what}: {name} launched {launches[name]} times in "
                 f"{steps} steps, expected {steps * n}")
    if any(plain.calls.values()):
        fail(f"{what}: a plain version ran on the main path: "
             f"{plain.calls}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{what}: losses not finite or not falling on a fixed "
             f"batch: {losses}")
    return step_ms, losses, launches


def profile_step(torch, engine, batches, what):
    """Device busy share and device time by kernel of one profiled
    ``train_batch``; returns the stats, or None without device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    stats = kernel_stats(prof.events(), 1, wall_us)
    if stats is None:
        print(f"{what} profile: the profiler recorded no device events; "
              f"device busy share not measured")
    else:
        print(f"{what} profile (one train_batch under torch.profiler): "
              f"{json.dumps(stats)}")
    return stats


def train_engine(torch, fused_ln):
    """bench_gpt2's engine (TRAIN_CONFIG) on full-width GPT-2 with the
    given ``fused_ln``, its fixed batch, and the launches each kernel
    makes per step."""
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import gpt, init_gpt_params, make_gpt

    model, cfg = make_gpt("gpt2", dropout_rate=0.0, fused_ln=fused_ln)
    sd = init_gpt_params(cfg, seed=0)
    engine, _opt, _loader, _sched = dtt.initialize(model=model, params=sd,
                                                   config=TRAIN_CONFIG)
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    rng = np.random.default_rng(0)
    batches = {"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (gas, micro, TRAIN_SEQ), dtype=np.int32)).cuda()}
    per_layer = cfg.num_layers * gas
    sites = len(gpt._fused_ln_sites(fused_ln))
    per_step = {name: 0 for name in training_counters()}
    per_step.update({"flash_attention_fwd": per_layer,
                     "flash_attention_bwd_dq": per_layer,
                     "flash_attention_bwd_dkv": per_layer,
                     "fused_adam": 1,
                     "fused_ln_matmul_fwd": sites * per_layer,
                     "fused_ln_matmul_bwd": sites * per_layer})
    n_params = sum(int(np.prod(v.shape)) for v in sd.values())
    return engine, model, cfg, batches, per_step, n_params


def check_training(torch, card, fused_ln=False):
    """Phase 4 (unfused) or 6 (``fused_ln=True``): the counted, timed and
    profiled training steps."""
    from torch.profiler import ProfilerActivity, profile

    engine, model, cfg, batches, per_step, n_params = train_engine(
        torch, fused_ln)
    what = "fused_ln training" if fused_ln else "training"
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    step_ms, losses, launches = counted_steps(
        torch, engine, batches, per_step, what, TRAIN_WARMUP, TRAIN_STEPS)
    med = median(step_ms)
    tokens = gas * micro * TRAIN_SEQ
    flops = train_flops_per_step(n_params, gas * micro, TRAIN_SEQ,
                                 cfg.hidden_size, cfg.num_layers)
    training = {
        "model": "gpt2", "params": n_params, "micro_batch": micro,
        "gas": gas, "seq": TRAIN_SEQ, "dtype": "bfloat16",
        "fused_update": True, "fused_ln": fused_ln, "steps": TRAIN_STEPS,
        "step_ms_median": med, "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms,
        "tokens_per_s": tokens / (med / 1e3),
        "model_tflops_per_s": flops / (med / 1e3) / 1e12,
        "mfu_vs_989_tflops_dense_bf16": flops / (med / 1e3) / BF16_FLOPS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "launches": launches, "card": card}
    print(f"{what} bf16 gpt2 (initialize -> train_batch): "
          f"{json.dumps(training)}")

    if profile_step(torch, engine, batches, what) is not None:
        # A second step with the operands' shapes recorded (which costs
        # host time, so the idle share above comes from the first): the
        # matmuls by shape, i.e. which products take the GEMM time.
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            engine.train_batch(batches)
            torch.cuda.synchronize()

        def dev_us(a):
            return getattr(a, "self_device_time_total",
                           getattr(a, "self_cuda_time_total", 0.0))

        ops = [a for a in prof.key_averages(group_by_input_shape=True)
               if a.key in ("aten::mm", "aten::addmm", "aten::bmm")]
        ops.sort(key=lambda a: -dev_us(a))
        print(f"{what} profile, matmuls by input shape (op, shapes, "
              "device ms per step, calls): " + json.dumps(
                  [[a.key, str(a.input_shapes)[:90], dev_us(a) / 1e3,
                    a.count] for a in ops[:10]]))
    del engine, model
    torch.cuda.empty_cache()
    return training


def check_fused_ln_sites(torch, card, base_ms):
    """The one-site variants of phase 6, as tools/probe_fused_r5.py runs
    them: "qkv" and "mlp", 1 + 2 counted steps each (96 launches of #6
    and #7 per step, no plain version, the loss falls); step ms beside
    phase 4's unfused median from this run."""
    out = {}
    for mode in ("qkv", "mlp"):
        engine, model, _cfg, batches, per_step, _n = train_engine(torch,
                                                                  mode)
        step_ms, losses, launches = counted_steps(
            torch, engine, batches, per_step, f"fused_ln={mode!r} training",
            1, 2)
        out[mode] = {"step_ms": step_ms, "losses": losses,
                     "fused_ln_matmul_fwd": launches["fused_ln_matmul_fwd"],
                     "step_ratio_vs_unfused": median(step_ms) / base_ms}
        del engine, model, batches
        torch.cuda.empty_cache()
    print(f"fused_ln one-site variants (1 + 2 steps each; unfused step "
          f"{base_ms:.2f} ms, {card}): {json.dumps(out)}")
    return out


def check_training_fp32(torch, seq=512, micro=4, sparse=None,
                        fused_ln=False):
    """fp32 on the card, gpt2 width at 2 layers, GAS 2: the kernels' path
    (flash attention, or with ``sparse`` the block-sparse kernels, and
    fused Adam) against the plain path (``xla`` attention, the per-tensor
    Adam chain). The first step's accumulated gradients agree leaf by leaf
    to 1e-4 of the leaf's norm (each attention leaf is held on its own,
    not hidden in the norm of the whole tree, which the tied embedding's
    gradient dominates) and the 3 losses to 1e-5 relative. A ``sparse``
    block gets rng_seed 1 on both runs, so that each draws its layout
    fresh at this length: the same random blocks. With ``fused_ln`` the
    kernels' model fuses both LayerNorm sites (#6, #7) and the plain path
    runs the unfused model."""
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import init_gpt_params, make_gpt
    from deepspeed_tpu_torch.runtime.utils import global_norm

    counters = training_counters()
    counter = counters["sparse_attention_fwd" if sparse else
                       "flash_attention_fwd"]
    ln_counter = counters["fused_ln_matmul_bwd"]
    what = "sparse " if sparse else ""
    gas = 2
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 50257, (3, gas, micro, seq),
                                        dtype=np.int32)).cuda()
    runs = {}
    for label, impl, fused in (("kernels", "auto", True),
                               ("plain", "xla", False)):
        conf = {"train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": gas,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4},
                              "fused_update": fused},
                "zero_optimization": {"stage": 2}}
        if sparse:
            conf["sparse_attention"] = dict(sparse, impl=impl, rng_seed=1)
            over = {"max_seq_len": seq}
        else:
            over = {"attention_impl": impl}
        if fused_ln and label == "kernels":
            over["fused_ln"] = fused_ln
        model, cfg = make_gpt("gpt2", dropout_rate=0.0, num_layers=2,
                              dtype=torch.float32, **over)
        engine, *_ = dtt.initialize(model=model,
                                    params=init_gpt_params(cfg, seed=1),
                                    config=conf)
        before, ln_before = counter.launches, ln_counter.launches
        first = []
        for j in range(gas):
            first.append(engine.forward({"input_ids": ids[0, j]}))
            engine.backward(first[-1])
        grads = [g.clone() for g in engine.state.grad_acc]
        engine.step()
        losses = [float(torch.stack(first).mean())]
        for s in (1, 2):
            losses.append(float(engine.train_batch({"input_ids": ids[s]})))
        launched = counter.launches - before
        if (launched > 0) != (label == "kernels"):
            fail(f"fp32 comparison: the {label} run launched the {what}"
                 f"attention forward {launched} times")
        ln_launched = ln_counter.launches - ln_before
        if (ln_launched > 0) != (label == "kernels" and bool(fused_ln)):
            fail(f"fp32 comparison: the {label} run launched the fused_ln "
                 f"backward {ln_launched} times")
        runs[label] = (grads, losses)
        names = engine.param_names
        del engine, model
        torch.cuda.empty_cache()
    (gk, lk), (gp, lp) = runs["kernels"], runs["plain"]
    rel = {n: float(global_norm([a - b])) / float(global_norm([b]))
           for n, a, b in zip(names, gk, gp)}
    whole = (float(global_norm([a - b for a, b in zip(gk, gp)]))
             / float(global_norm(gp)))
    worst = max(rel, key=rel.get)
    keys = ("ln_1", "c_attn", "ln_2", "c_fc") if fused_ln else (
        "c_attn", "c_proj")
    attn = {n: f"{e:.3g}" for n, e in rel.items()
            if any(k in n for k in keys)}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    layout = (f", {sparse['mode']} block {sparse['block']}" if sparse
              else f", fused_ln={fused_ln!r}" if fused_ln else "")
    print(f"training fp32 gpt2-width 2 layers, micro {micro} x {seq}, GAS "
          f"2{layout}: kernels vs plain path: first-step grad |diff|/|grad| "
          f"per leaf: worst {worst} {rel[worst]:.3g} (limit 1e-4); "
          f"{'fused sites' if fused_ln else 'attention'} leaves "
          f"{json.dumps(attn)}; whole tree {whole:.3g}; "
          f"losses {lk} vs {lp}, max rel diff {loss_rel:.3g} (limit 1e-5)")
    if not rel[worst] <= 1e-4 or not loss_rel <= 1e-5:
        fail(f"training fp32{layout}: the kernels' path disagrees with the "
             f"plain path")


# ---------------------------------------------------------------------------
# 5. long-sequence training with block-sparse attention
# ---------------------------------------------------------------------------

LONG_CONFIG = {                   # bench.py:bench_gpt2_long(sparse=True)'s,
    "train_micro_batch_size_per_gpu": 1,     # plus the fused update
    "gradient_accumulation_steps": 4,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4},
                  "fused_update": True},
    "zero_optimization": {"stage": 2},
    "data_types": {"grad_accum_dtype": "bfloat16"},
    "bf16": {"enabled": True},
    "sparse_attention": SPARSE_LONG,
}
LONG_WARMUP, LONG_STEPS = 2, 5
DENSE_WARMUP, DENSE_STEPS = 1, 2
SPARSE_KERNELS = ("sparse_attention_fwd", "sparse_attention_bwd_dq",
                  "sparse_attention_bwd_dkv")


def long_engine(torch, config):
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import init_gpt_params, make_gpt

    model, cfg = make_gpt("gpt2", dropout_rate=0.0, max_seq_len=SPARSE_SEQ)
    engine, *_ = dtt.initialize(model=model, params=init_gpt_params(
        cfg, seed=0), config=config)
    gas = config["gradient_accumulation_steps"]
    micro = config["train_micro_batch_size_per_gpu"]
    rng = np.random.default_rng(0)
    batches = {"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (gas, micro, SPARSE_SEQ), dtype=np.int32)).cuda()}
    return engine, model, cfg, batches


def check_long_training(torch, card):
    """Full-width GPT-2 at seq 16384 through ``initialize`` ->
    ``train_batch`` with BigBird block-sparse attention: #8-#10 launch 48
    times each per step (12 layers x GAS 4), fused Adam once, the flash
    kernels and every plain version never; the loss falls on a fixed
    batch. Then, for the sparse/dense ratio, the same config with dense
    flash attention."""
    engine, model, cfg, batches = long_engine(torch, LONG_CONFIG)
    if model.cfg.sparse_attention != SPARSE_LONG or \
            any(blk.cfg is not model.cfg for blk in model.h):
        fail("long training: initialize did not route the blocks' "
             "attention through the sparse_attention block")
    gas = LONG_CONFIG["gradient_accumulation_steps"]
    micro = LONG_CONFIG["train_micro_batch_size_per_gpu"]
    per_step = {name: 0 for name in training_counters()}
    per_step.update({name: cfg.num_layers * gas for name in SPARSE_KERNELS})
    per_step["fused_adam"] = 1
    step_ms, losses, launches = counted_steps(
        torch, engine, batches, per_step, "long training", LONG_WARMUP,
        LONG_STEPS)
    med = median(step_ms)
    tokens = gas * micro * SPARSE_SEQ
    long = {
        "model": "gpt2", "seq": SPARSE_SEQ, "micro_batch": micro,
        "gas": gas, "dtype": "bfloat16", "fused_update": True,
        "sparse_attention": SPARSE_LONG, "steps": LONG_STEPS,
        "step_ms_median": med, "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms,
        "tokens_per_s": tokens / (med / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "launches": launches, "card": card}
    print(f"long training bf16 gpt2 seq {SPARSE_SEQ} bigbird "
          f"(initialize -> train_batch): {json.dumps(long)}")
    profile_step(torch, engine, batches, "long training")
    del engine, model, batches
    torch.cuda.empty_cache()

    # the same configuration with dense flash attention, for the ratio
    dense = dict(LONG_CONFIG)
    del dense["sparse_attention"]
    engine, model, cfg, batches = long_engine(torch, dense)
    for _ in range(DENSE_WARMUP):
        engine.train_batch(batches)
    torch.cuda.synchronize()
    dense_ms, dense_losses = timed_steps(torch, engine, batches,
                                         DENSE_STEPS)
    dense_tps = tokens / (median(dense_ms) / 1e3)
    dense_run = {"step_ms": dense_ms, "tokens_per_s": dense_tps,
                 "losses": dense_losses}
    print(f"long training bf16 gpt2 seq {SPARSE_SEQ} dense flash (for the "
          f"ratio): {json.dumps(dense_run)}; sparse/dense tokens/s "
          f"{long['tokens_per_s'] / dense_tps:.4f} (bench.py's "
          f"gpt2_seq16k_sparse_speedup)")
    del engine, model, batches
    torch.cuda.empty_cache()
    return long


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
    only_kernels = sys.argv[1:] == ["--only", "kernels"]
    if sys.argv[1:] and not only_kernels:
        fail(f"unknown arguments {sys.argv[1:]} (none, or --only kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device and build: one nvcc per source, all started together
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    sources = sorted({src for _n, src, _r in KERNELS})
    libs = build.build_all(sources)
    print(f"built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(f"  {os.path.relpath(lib, HERE)}: {ptxas_summary(lib)}")

    # 2. kernels against their plain versions
    reports = {name: {"name": name, "route": "cuda",
                      "source": f"deepspeed_tpu_torch/csrc/{src}.cu",
                      "replaces": rep}
               for name, src, rep in KERNELS}
    check_paged_attention(torch, reports["paged_decode_attention"])
    check_paged_attention_int8(torch, reports["paged_decode_attention_int8"])
    check_chunked_prefill(torch, reports["chunked_prefill_attention"])
    check_flash_attention(torch, {
        "fwd": reports["flash_attention_fwd"],
        "dq": reports["flash_attention_bwd_dq"],
        "dkv": reports["flash_attention_bwd_dkv"]})
    check_fused_adam(torch, reports["fused_adam"])
    check_sparse_attention(torch, {
        "fwd": reports["sparse_attention_fwd"],
        "dq": reports["sparse_attention_bwd_dq"],
        "dkv": reports["sparse_attention_bwd_dkv"]})
    check_fused_ln(torch, {"fwd": reports["fused_ln_matmul_fwd"],
                           "bwd": reports["fused_ln_matmul_bwd"]})
    if only_kernels:
        print(json.dumps({"kernels_checked": [k for k, *_ in KERNELS]}))
        return 0

    # 3. the serving path end to end
    serving = check_serving(torch)
    reports["paged_decode_attention"]["launches"] = \
        serving["bucketed"]["kernel_launches"]
    reports["paged_decode_attention_int8"]["launches"] = \
        serving["int8"]["kernel_launches"]
    reports["chunked_prefill_attention"]["launches"] = \
        serving["chunked"]["kernel_launches"]

    # 4. the training path end to end, and its fp32 comparison
    training = check_training(torch, card)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "fused_adam"):
        reports[name]["launches"] = training["launches"][name]
    check_training_fp32(torch)

    # 5. long-sequence training with block-sparse attention, and its fp32
    # comparison
    long = check_long_training(torch, card)
    for name in SPARSE_KERNELS:
        reports[name]["launches"] = long["launches"][name]
    check_training_fp32(torch, seq=4096, micro=1, sparse=SPARSE_LONG)

    # 6. training with the fused LayerNorm + projection sites, its one-site
    # variants and its fp32 comparison
    fused = check_training(torch, card, fused_ln=True)
    for name in ("fused_ln_matmul_fwd", "fused_ln_matmul_bwd"):
        reports[name]["launches"] = fused["launches"][name]
    base_ms = training["step_ms_median"]
    print(f"fused_ln training: step {fused['step_ms_median']:.2f} ms against "
          f"the unfused {base_ms:.2f} ms of phase 4: ratio "
          f"{fused['step_ms_median'] / base_ms:.4f}; peak memory "
          f"{fused['peak_memory_gb']:.3f} GB against "
          f"{training['peak_memory_gb']:.3f} GB")
    check_fused_ln_sites(torch, card, base_ms)
    check_training_fp32(torch, fused_ln=True)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: reports[n][k] for k in keys}
                                  for n, *_ in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

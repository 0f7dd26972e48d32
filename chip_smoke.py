#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py                  # everything, one card
    python3 chip_smoke.py --only kernels   # stop after phase 2
    python3 chip_smoke.py --only sparse    # the build, then phase 2d only
    python3 chip_smoke.py --only chunked   # the build, then phase 2a'' only
    python3 chip_smoke.py --only spec      # the build, then phase 3b only
    python3 chip_smoke.py --only telemetry # the build, then phase 3c only
    python3 chip_smoke.py --only bert      # the build, then phase 8 only
    python3 chip_smoke.py --only serving   # the build, then phase 3 only
    python3 chip_smoke.py --only ckpt      # the build, then phase 9 only
    python3 chip_smoke.py --only fp32      # the build, the fp32 sparse
                                           # holds, phases 5b, 7b
    python3 chip_smoke.py --only sparse,chunked

1. Device: requires CUDA, prints the card's name and power limit, builds
   every kernel from the sources in this checkout (one ``nvcc`` per
   source, all started together) and prints each ``-Xptxas -v`` report.
2. Kernels against their plain PyTorch versions at the main paths'
   shapes, in fp32 (atol 1e-5) and bf16 (atol 2e-2), each timed as device
   time (:func:`device_ms`: CUDA events around calls the host enqueued
   while a sleep kernel held the device, so the host's pace between
   launches is not counted) beside the plain version (host-paced: CUDA
   events around back-to-back calls), a PyTorch yardstick (device time)
   and its bound:
   - paged decode attention at GPT-2's serving shapes (12 heads, head_dim
     64, block 16, 8 rows, 1 and 5 queries, windows of 1 to 64 blocks,
     table tails on a scratch block filled with NaN), over fp/bf16 pools
     and over int8 pools with fp32 scales (NaN scales on scratch), with
     fp32 and bf16 queries; at a 64-block window also at every split
     count of its key split (1 to 8 blocks per cluster) and on rows whose
     context is shorter than one split's share (bit-equal over two
     launches); timed beside its one-split walk (the first version's) on
     the same inputs, and its split rule timed against every count;
   - ragged chunked-prefill attention at the same shapes, on the route
     ``chunked_prefill._route`` picks (bf16 q over bf16 or int8 pools:
     the run kernels, counted in ``chunked_prefill_attention_tc``; fp32
     q over fp32 or int8 pools: the fp32 run kernels, 3xTF32, counted in
     ``chunked_prefill_attention_tf32``; the first kernel, counted in
     ``chunked_prefill_attention``, also held on the fp32 inputs): a
     256-token mixed step (8 decode rows at positions 100-1000, a
     200-token chunk from 0, a 40-token chunk from 37, pad rows), an
     8-token all-decode step, a 128-token step whose 100-token chunk
     from 37 crosses 64-token boundaries and sees more than 64 keys, and
     8 decode rows over a 1,024-key window (the run kernels also at every
     split count 1-8), fp/bf16 and int8 pools, NaN scratch, pad rows
     excluded, bit-equal over two launches; timed at the mixed step, the
     run kernels of both dtypes (and each kind of item alone) beside the
     first kernel on the same inputs, and the decode rows' split counts
     beside the rule's pick; the first kernel's own route, head dim 256,
     held and timed at the mixed step in bf16 and fp32 q over fp and
     int8 pools;
   - flash attention forward, dq and dk/dv at [16, 512, 12, 64] causal,
     with and without a key mask holding an all-padding row, and at S=5
     and S=300, in fp32 (the 3xTF32 forward, dq and dk/dv of
     ``csrc/flash_attention_tf32.cu``, the FMA forward held on the same
     inputs beside them), bf16 and fp16 (the tensor-core forward, dq and
     dk/dv of ``csrc/flash_attention_tc.cu``), the FMA dq and dk/dv held
     on the same inputs beside either; also at D=128, at D=72 and D=8
     (zero-padded to 80 and 16 in 16 bits) and with Sq < Sk (bottom-right
     causal), and in every dtype at D = 256 and D = 136 (zero-padded to
     144): causal with the key mask, Sq < Sk, and non-causal with a key
     mask holding an all-padding row, at dropout 0 and 0.1 (16 bits: the
     wgmma forward, dq and dk/dv of ``csrc/flash_attention_tc256.cu``,
     each also held to the FMA kernel on the same inputs and bit-equal
     over two launches; fp32: the 3xTF32 forward, dq and dk/dv of
     ``csrc/flash_attention_tf32.cu``, the FMA forward, dq and dk/dv held
     on the same inputs and dq and dk/dv also to the FMA kernels'
     outputs); the
     whole autograd path against the plain
     version's; fp32 within 1e-5 (dO x 0.1), 16-bit within one rounding
     step of its type plus 1e-3 of the reference's RMS (0.15 on the
     autograd path; dO unscaled); dq and dk/dv bit-equal over two
     launches; the
     same at dropout 0.1 with one seed on both sides; timed as device
     time at dropout 0 and 0.1 beside the FMA
     kernels on the same inputs, the plain versions and SDPA with its
     backend pinned and printed (fp32 bounds at FP32_3XTF32_FLOPS), the
     D = 256 kernels in bf16 at [4, 512, 8, 256] beside cuDNN's SDPA and
     the FMA kernels on the same inputs (the ``_d256`` rows; first each
     of them, and the FMA forward, dq and dk/dv, held there to its plain
     version at 1e-3 of the RMS and bit-equal over two launches, on the
     timed inputs and the path's, and in fp16 on one), the fp32 3xTF32
     forward, dq and dk/dv and the FMA forward, dq and dk/dv there beside
     SDPA in fp32 (the ``_d256_fp32`` rows), and two lines of the slice's
     path: forward +
     backward through ``flash_attention()`` at that shape in bf16 and in
     fp32 (device ms, each wrapper's launches, every count set to 0 just
     before; the output and gradient held to the plain path's) beside
     SDPA's forward + backward; and the dropout keep-mask read back out
     of the forward, dq and dk/dv kernels (fp32 [2, 2048, 2, 256] through
     the 3xTF32 forward, dq and dk/dv, bf16 [2, 2048, 2, 256]
     through the wgmma forward, dq and dk/dv, fp32 [2, 2048, 2, 64]
     through the 3xTF32
     forward, dq and dk/dv, bf16 [2, 2048, 2, 64] through the
     tensor-core ones;
     an identity V, K and dO on a D-wide window) against
     ``dropout_keep_mask``, no bit flipped; the non-causal key-padded
     branch (BERT's) the same way in every dtype at dropout 0 and 0.1
     (FLASH_NONCAUSAL_CASES: [4, 128, 16, 64], [2, 512, 16, 64] and Sq <
     Sk, each with an all-padding row), and in bf16 at bench_bert's
     shapes [32, 128, 16, 64] and [8, 512, 16, 64] held to the plain
     versions once more (o, lse, dq, dk/dv, under its all-valid key mask
     and a padded one) and timed under the all-valid mask beside SDPA
     with the bool [B, 1, 1, S] mask (the kernels line's ``_bert128`` /
     ``_bert512`` rows);
   - fused Adam, bit for bit, over GPT-2's 148 parameter tensors (with
     the bf16 copy of the new params that the bf16 training step uses);
   - block-sparse attention forward, dq and dk/dv (kernels #8-#10; all
     three on the route ``sparse_attention._route`` picks) at
     (a) [1, 4096, 12, 64], BigBird block 256, causal, fp32, bf16 and
     fp16, (b) [2, 1024, 12, 64], ``fixed`` block 16, bidirectional, with
     a key mask whose second batch row is all padding (o, dq, dk, dv
     exactly 0 there, lse -1e30), fp32 and bf16, (c) the path's shape [1,
     16384, 12, 64], bf16 and fp16, (d) [2, 2048, 12, 64], BigBird block
     64, bidirectional, with (b)'s key mask, bf16 and fp16, (e) [2, 2048,
     4, 128], BigBird block 128, causal, with the key mask, bf16 and fp16,
     (f) [1, 1024, 4, 72], ``fixed`` block 64, bf16, (g) [2, 1024, 12,
     64], BigBird block 32, causal, with the key mask, bf16, and (h) [2,
     1024, 4, 128], BigBird block 16, causal, with the key mask, bf16,
     fp16 and fp32, and (i) the same at D = 8, fp32; (f) also in fp32;
     (d)-(f) also at the split cap 4 (where the forward, dq and dk/dv
     all split), (b), (g), (h) and (i) at the 16-row lists' cap of 1
     step (the forward, dq and dk/dv split); each kernel on the route
     ``sparse_attention._route`` picks for it (16 bits at blocks of 64
     and more: the tensor-core kernels of
     ``csrc/sparse_attention_tc.cu``; 16 bits at other multiples of 16:
     the 16-row tensor-core forward, dq and dk/dv of
     ``csrc/sparse_attention_tc16.cu``; fp32: the 3xTF32 forward, dq and
     dk/dv of ``csrc/sparse_attention_tf32.cu`` over the 16-row lists;
     each call counted by its route's wrapper only); each kernel and, but
     at (c), the whole autograd path, with flash's tolerances (the fp32
     forward's o to atol 1e-5, the 3xTF32 dq and dk/dv within 1e-5 of
     the reference's largest |value|), lse to 1e-5
     (``SPARSE_LSE_TOL``), every output bit-equal over two launches, the
     all-padding rows o = 0 and lse = -1e30 exactly; timed at (c) in
     bf16, the tensor-core forward, dq and dk/dv beside the FMA kernels
     on the same inputs, the plain versions, SDPA with the
     layout-expanded mask and the bound, the tensor-core pair at every
     split cap of SPARSE_SWEEP_CAPS and the forward at every cap at (d)'s
     shape (items, split tiles, pieces and longest walk printed); then
     at (c)'s shape in fp32 (:func:`time_sparse_fp32`): the 3xTF32
     forward, dq and dk/dv (also at cap 1) and the FMA forward, dq and
     dk/dv (their first versions) held and timed on fp32 inputs beside
     the plain versions, SDPA in fp32 with the mask and the bounds at
     FP32_3XTF32_FLOPS;
   - the fused LayerNorm + projection forward and backward (kernels #6,
     #7) on the route ``fused._route`` picks (bf16 and fp16: the wgmma
     kernels of ``csrc/fused_ln_tc.cu``, the resident panel up to D =
     1664 and above it T(ln) streamed through the product; fp32: the
     3xTF32 wgmma kernels of ``csrc/fused_ln_tf32.cu``; each call counted
     by its route's wrapper only; ``csrc/fused_ln.cu``, the first
     version, on no route, held on the same inputs in fp32 and above D =
     1664) at the training path's two sites (n = 8192 rows, D = 768, F =
     2304 without activation and 3072 with GELU), a tail (n = 300, D =
     136, F = 200), GPT-2 XL's width (D = 1600), D above the panel (2048,
     a ragged 1672 and a decode-sized call at 2048) and the decode size
     (n = 8), fp32, bf16 and fp16, and in bf16 and fp16 both sites'
     shapes at D = 2048 (n 8192, F 6144 and 8192 with GELU), each kernel
     alone and the whole autograd path, as ``FUSED_LN_TOL`` states, y and
     the five gradients bit-equal over two launches; timed at the path's
     sites in bf16, fp16 and fp32, beside ``fused_ln.cu``'s kernels on
     the same inputs, and in bf16 at D = 2048's two sites, beside
     ``fused_ln.cu`` on the same inputs, the plain versions and the
     unfused eager sequence (``F.layer_norm`` -> cast -> ``F.linear`` (->
     GELU) and its autograd backward), with the kernels of one call by
     device time.
3. Serving end to end: ``init_serving`` on full-width GPT-2 (random
   weights from a seed) serves 16 requests in two waves:
   - bucketed bf16 through ``decode_attention: "kernel"`` (kernel #1
     launches == ``kernel_steps * num_layers``), and chunked prefill at
     token budget 256 (kernel #2's run kernels: one call a layer a mixed
     step, ``mixed_steps * num_layers`` calls, each launching one or two
     kernels; the first kernel and kernel #1 none, no plain attention at
     all), its TTFT and mixed step printed beside an earlier reading
     on the first kernel; both timed on their second run; the fp32 chunked runs go
     through the fp32 run kernels, counted the same way (calls ==
     ``mixed_steps * num_layers``; the first kernel 0 over every fp32
     chunked trace, or the run fails);
   - fp32 token identity of "kernel", "gather", chunked prefill at budget
     64 and ``generate``, except at a true tie of the top two logits;
   - the int8 pool: bucketed bf16 through kernel #1's int8 branch (no
     gather); chunked bf16 at budget 256 through kernel #2's int8 branch
     (the run kernels over int8 pools, calls == ``mixed_steps *
     num_layers``, no gather, no plain version; its mixed step and TTFT;
     its tokens against the bucketed run under the bf16 tie rule,
     BF16_TIE_STEPS; then every call held against its plain version on
     the served pools); fp32 "kernel" vs "gather", and chunked fp32 with
     kernel #2 against its plain version swapped in (tie rule on the int8
     model);
   - a prefix trace (8 requests sharing a 512-token head), bucketed and
     chunked with ``prefix_cache``: >= 7 hits, tokens equal to the run
     without the cache (tie rule);
   - a profiled window of 16 decode steps and of 16 chunked mixed steps.
3b. Speculative serving and resilience: the same model and trace with
   ``speculative: {enabled: true, k: 4}`` (the draft: the first 6
   layers), guarded by ``serving.resilience``:
   - kernel #1 at the verify's S = k + 1 and at S = 9 (k = 8: two query
     groups) against its plain version, timed at the path's shapes beside
     SDPA and its bound (the kernels line's ``paged_decode_attention_verify``
     row);
   - bf16 speculative serving beside the same trace without it (each run
     once to warm up, then measured in turn): kernel #1 launches ==
     ``spec_rounds x (k x 6 + 12)`` (S = 1 and S = k + 1 counted
     apart), no gather, no plain version, ``degraded_level`` 0; accept
     rate, tokens per verify, decode tokens/s and TTFT printed;
   - bf16 chunked at budget 256 (kernel #2 from the mixed rounds, #1 from
     the speculative rounds) and the int8 pool, with speculation;
   - fp32 token identity (tie rule) of speculation at k = 4 and k = 8
     (every kernel call of the k = 8 run held against its plain version)
     against plain decode and ``generate``;
   - the same with a draft that agrees more often (the upper 6 layers'
     output projections x 0.2): k = 4 on the trace at an accept rate of
     at least 0.2 with full accepts, and one request run to max_model_len
     at k = 8 whose verify writes past the table land in scratch block 0
     only, with rounds that append several tokens; tokens equal plain
     decode's;
   - an fp32 fault run (``FAULT_PLAN``): a decode fault that exhausts the
     retries (rebuild and replay), then a slow step; the ladder skips
     rung 2 (kernel #1 -> gather) on the card and halves the batch cap,
     and kernel #1 goes on launching; tokens equal the clean run's, no
     plain version runs, no block leaks;
   - a profiled window of speculative rounds.
3c. Serving telemetry: the same model and trace in bf16 on the bucketed,
   chunked 256, int8 and speculative k = 4 (under ``serving.resilience``)
   paths, each with telemetry off and on (JSONL and memory sinks, the
   trace with ``sync_spans``, request records, ``numerics``):
   - tokens and kernel #1/#2 launch counts equal between on and off;
   - 16 finished request records whose categories sum to each lifetime
     within 1 ms, a trace with one ``decode_step`` / ``mixed_step`` /
     ``spec_step`` span per decode step, finite KV error gauges on the
     int8 pool, ``tools/slo_report.py`` exiting 0 on the directory;
   - the decode step and TTFT medians off, on (bucketed: also on without
     sync spans), the overhead printed with the card;
   - a short run with ``trace.jax_profiler_dir`` whose ``torch.profiler``
     trace names kernel #1, stopped by ``close()``.
4. Training end to end: ``initialize`` -> ``train_batch`` on full-width
   GPT-2 with ``bench.py:bench_gpt2``'s configuration plus
   ``optimizer.fused_update``: the tensor-core flash forward, dq and dk/dv
   launch 96 times each and fused Adam once per step, the FMA flash
   kernels never, no plain version runs, the loss falls; step
   time, tokens/s, model TFLOP/s and MFU, and a profiled step. Then, in
   fp32 at 2 layers, the kernels' path against the plain path (first-step
   gradients within 1e-4 of each leaf's norm, losses within 1e-5).
5. Long-sequence training: ``initialize`` -> ``train_batch`` on
   full-width GPT-2 at seq 16384 with ``bench.py:bench_gpt2_long(sparse=
   True)``'s configuration (BigBird block 256 through the
   ``sparse_attention`` block) plus ``optimizer.fused_update``: the
   tensor-core forward, dq and dk/dv launch 48 times each per step, fused
   Adam once, the FMA forward, dq and dk/dv, the flash kernels and every
   plain version never, the loss falls; step time, tokens/s, peak memory
   and a profiled step. Then the same configuration with dense flash
   attention (1 + 2 steps) for the sparse/dense tokens/s ratio, both
   printed beside the same step's reading with the FMA forward,
   and in fp32 at 2 layers and seq 4096 the kernels' path (#8-#10 on
   3xTF32, their FMA kernels never) against the plain path
   (``impl: "xla"``), held as in phase 4.
5b. Long-sequence training in fp32 (``--only fp32`` runs it too;
   :func:`check_long_fp32_training`): phase 5's configuration with no
   ``bf16`` block and no bf16 accumulator on ``make_gpt("gpt2",
   dtype=torch.float32)`` at seq 16384 (DeepSpeed's default precision):
   the 3xTF32 forward (#8), dq and dk/dv launch 48 times each per step,
   the FMA forward, dq and dk/dv never, fused Adam once, no plain
   version, the loss falls; step time, tokens/s, peak memory, the idle
   share and a profiled step's device ms of the sparse kernels and the
   GEMMs. No dense twin.
6. Training with the fused LayerNorm + projection sites: phase 4's
   configuration on ``make_gpt("gpt2", fused_ln=True)``: #6 and #7 launch
   192 times each per step (2 sites x 12 layers x GAS 8) through the
   wgmma route, ``fused_ln.cu``'s never, flash as in phase 4, fused
   Adam once, no plain version, the loss falls; step time, tokens/s, MFU,
   peak memory, a profiled step and the ratio to phase 4's step; the
   "qkv" and "mlp" variants (1 + 2 steps each); then in fp32 at 2 layers
   the fused kernels' path (the 3xTF32 route only, ``fused_ln.cu`` never)
   against the unfused plain path, held as in phase 4; then ``fp16`` (loss scale
   from 2**16) on the fp16 model (1 + 2 steps): #6 and #7 launch 192
   times each per step through the wgmma route's fp16 branch, no plain
   version, finite losses.
6b. Training at GPT-3 XL's width (:func:`check_wide_training`): phase
   4's configuration on ``make_gpt("gpt2", hidden_size=2048,
   num_heads=16, num_layers=4)`` (Brown et al. 2020's d_model 2048 and 16
   heads of 128, cut to 4 of 24 layers so that the run stays under its
   limit), ``fused_ln=True`` then ``False`` in one process, 1 + 2 steps
   each: #6 and #7 launch 64 times each per step (2 sites x 4 layers x
   GAS 8) through the wgmma route's streamed product (D = 2048 is above
   the panel), ``fused_ln.cu``'s and the 3xTF32 wrappers never, each
   flash kernel 32 times, fused Adam once, no plain version, the loss
   falls, the two models' first-step losses within ``WIDE_LOSS_TOL``;
   both step medians, their ratio, tokens/s, peak memory and a profiled
   fused step's device ms of the new kernels.
7. Training at the default dropout: phase 4's configuration on
   ``make_gpt("gpt2")`` as it is (``dropout_rate`` 0.1, hash dropout):
   each flash kernel of phase 4 launches 96 times per step through its
   dropout branch, fused Adam once, no plain version, the loss falls;
   step time, tokens/s, MFU, peak memory, the ratio to phase 4's step and
   a profiled
   step (device ms of the flash kernels and of the hash dropout's
   forward passes). Then in fp32 at 2 layers and dropout 0.1 the kernels'
   path against the plain path (``impl: "xla"``, the same mask function
   and seeds), held as in phase 4.
7b. fp32 training at full width (``--only fp32`` runs it, 5b, every
   fp32 sparse hold of phase 2d and :func:`time_sparse_fp32` at both
   shapes, and the fp32 sparse comparisons of phases 5 and 8;
   :func:`check_fp32_training`): ``make_gpt("gpt2", dtype=torch.float32)``
   (dropout 0.1) through ``initialize`` with phase 4's shape and no bf16
   block, DeepSpeed's default precision: the 3xTF32 forward, dq and dk/dv
   launch 96 times each per step, the FMA forward, dq and dk/dv never,
   fused Adam once, no plain version, the loss falls, matmul TF32 off;
   step time, tokens/s, peak memory, the idle share and a profiled step's
   device ms of #3-#5 and the GEMMs.
7c. fp32 training with the fused sites at full width (``--only fp32``
   runs it after 7b): phase 7b on ``make_gpt("gpt2", dtype=torch.float32,
   fused_ln=True)``, 1 + 2 steps: #6 and #7 launch 192 times each per
   step through ``csrc/fused_ln_tf32.cu`` (3xTF32 on wgmma),
   ``fused_ln.cu``'s and the wgmma route's wrappers never, the 3xTF32
   flash kernels 96 times each, fused Adam once, no plain version, the
   loss falls, matmul TF32 off; step time, its ratio to 7b's, tokens/s,
   peak memory and a profiled step's device ms of the new kernels beside
   the GEMMs.

8. BERT-large pretraining (``--only bert`` runs it alone): ``initialize``
   -> ``train_batch`` on ``make_bert("bert-large")`` with
   ``bench.py:bench_bert``'s configuration (LAMB lr 2e-3, ZeRO 2, bf16, a
   bf16 accumulator, GAS 8) at seq 128 x micro 32 and seq 512 x micro 8:
   the tensor-core flash forward, dq and dk/dv launch 192 times each a
   step (24 layers x GAS 8), every other kernel and every plain version
   never, the loss falls; samples/s, step ms, MFU, peak memory, the idle
   share, a profiled step's top kernels, LAMB's and the whole apply's
   device ms and kernels; at seq 128 the matmuls by shape and a step on
   padded rows. Then seq 512 with the reference's fixed block-16 sparse
   layout (#8-#10 on the 16-row tensor-core route, 192 each a step, the
   FMA forward, dq and dk/dv none; the sparse/dense ratio, the idle
   share and the sparse kernels' device ms in a profiled step; the
   kernels held to their plain versions, also at the 16-row kernels' cap
   of 1 step where the second passes run, and timed at [8, 512, 16, 64]
   beside the FMA forward, dq and dk/dv on the same inputs and SDPA with
   the expanded mask: the ``_tc16`` rows; the same at block 32, printed;
   then fp32 at that shape: the FMA forward, dq and dk/dv and the 3xTF32
   forward, dq and dk/dv, the ``_block16`` and ``_tf32_block16`` rows),
   and the fp32 comparisons at bert-large width and 2 layers, dense
   (flash on 3xTF32) and sparse (#8-#10 on 3xTF32), against the plain
   path.
9. Checkpointing, the dataloader and preemption-safe training (``--only
   ckpt`` runs it alone; :func:`check_ckpt`): full-width, full-depth
   GPT-2 at phase 7's configuration fed by ``initialize(training_data=
   ...)`` over a seeded token dataset through ``RepeatingLoader`` and
   ``PrefetchLoader``: (a) 6 uninterrupted steps with a sync save after
   step 3; (b) a fresh engine loads it (first without the optimizer
   states: masters equal, moments zero) and runs steps 4-6 bit-equal to
   (a) and 3 more under ``resilience`` at interval 1, ``save()`` timed on
   the step path, the writes off it, the last checkpoint corrupted and
   skipped by the restore; (c) ``Supervisor`` over this script's
   ``--ckpt-child`` with ``{"preempt_at_step": 3, "ckpt_write_errors":
   1}``: one restart, steps 1-6 bit-equal to (a), the resumed child's
   #3-#5 at 96 launches a step and #11 at 1, no plain version; (d)
   ``init_serving(checkpoint=...)`` in bf16 gives the live masters'
   tokens with kernel #1 launching; (e) ``remat`` at phase 4's
   configuration: 3 steps bit-equal to ``remat=False``, #3 at 192
   launches a step, #4/#5 at 96, peak memory and step time of both; (f)
   LAMB at bert-large width and 2 layers: a save/load round trip, the
   next loss bit-equal. The kernels line's rows and launch counts are
   the earlier phases'.

Any failure exits non-zero. The last stdout line is
``{"ok": true, "device": {...}}``; before it come the card line and a
``{"kernels": [...]}`` line. The fp32 flash rows (the 3xTF32
``flash_attention_fwd_tf32``, ``flash_attention_bwd_dq_tf32`` and
``flash_attention_bwd_dkv_tf32``, and the FMA ``flash_attention_fwd``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``, their first
versions, timed on the same inputs) are timed in fp32; at dropout 0
their launches count the fp32 comparison of phase 4, their ``_dropout``
twins phase 7b's timed steps (the FMA kernels 0 in both), every count
set to 0 just before it;
the ``_d256`` rows are timed in bf16 at [4, 512, 8, 256]: the wgmma
forward, dq and dk/dv (``flash_attention_fwd_tc256_d256``,
``flash_attention_bwd_dq_tc256_d256``,
``flash_attention_bwd_dkv_tc256_d256``) count phase 2's bf16 forward +
backward through ``flash_attention()`` at that shape, the FMA forward, dq
and dk/dv (their first versions, timed on the same inputs) the FMA
wrappers' launches at D > 128 (``.launches_wide``) over phases 4 and 7,
which train in bf16; the ``_d256_fp32`` rows are timed on fp32 inputs at
that shape: the 3xTF32 forward, dq and dk/dv
(``flash_attention_fwd_tf32_d256_fp32``,
``flash_attention_bwd_dq_tf32_d256_fp32``,
``flash_attention_bwd_dkv_tf32_d256_fp32``) count phase 2's fp32
forward + backward through ``flash_attention()`` there, the FMA forward,
dq and dk/dv (their first versions, timed on the same inputs) the FMA
wrappers' launches at D > 128 over phase 7b, which trains in fp32, every
count set to 0 just before each phase (the run fails unless every
``.launches_wide`` count is 0); the ``_d256`` rows' max |err| is that of
the kernels held on the timed inputs (``hold_flash_d256``), and so is the
``_d256_fp32`` rows' (``hold_flash_d256_fp32``).
The 3xTF32 rows (``fused_ln_matmul_fwd_tf32``, ``fused_ln_matmul_bwd_tf32``)
are fp32's route, counted over phase 7c's timed steps; ``fused_ln.cu``'s
rows (``fused_ln_matmul_fwd``, ``fused_ln_matmul_bwd``) are timed as their
first version on the same fp32 inputs and counted over phase 6's fp32
comparison (0, or the run fails), while the ``_tc`` rows count phase 6
and its fp16 run. The
FMA sparse rows (``sparse_attention_fwd``, ``sparse_attention_bwd_dq``,
``sparse_attention_bwd_dkv``) and the 3xTF32 ones
(``sparse_attention_fwd_tf32``, ``sparse_attention_bwd_dq_tf32``,
``sparse_attention_bwd_dkv_tf32``) count phase 5b's timed steps (the FMA
kernels, the 3xTF32 kernels' first versions, 0) and are timed on fp32
inputs at the path's shape; the
tensor-core rows count phase 5's long steps. The run kernels' rows
count phase 3: ``chunked_prefill_attention_tc`` the bf16 chunked run,
``chunked_prefill_attention_tc_int8`` (bf16 q over int8 pools) the bf16
chunked int8 run, ``chunked_prefill_attention_tf32`` the fp32 chunked@64
run and ``chunked_prefill_attention_tf32_int8`` the fp32 int8 chunked@64
run, each timed at the mixed step on its own inputs. The first chunked-
prefill kernel's row (``chunked_prefill_attention``) counts its launches
over phase 3's fp32 chunked traces (0) and is timed on the fp32 run
kernels' inputs, as their first version; its ``_d256`` rows (bf16 or
fp32 q, ``_int8`` over int8 pools) are its own route, head dim 256, held
and timed at the mixed step, counted by the same counter. The
``fused_ln_matmul_*_tc_d2048`` rows are the wgmma route's streamed product
at D = 2048, timed in bf16 at both sites' shapes, counted over phase 6b's
fused steps; the ``fused_ln_matmul_*_d2048`` rows are ``fused_ln.cu``
(the first version) timed on the same inputs, its launches summed over
the 16-bit training steps of phases 4, 6, 6b and 7 (0, or the run
fails). The verify row (``paged_decode_attention_verify``, kernel #1 at S =
k + 1) counts the S = 5 launches of phase 3b's measured bf16 speculative
run and is timed at S = 5 on the path's shapes. The ``_bert128`` /
``_bert512`` flash rows count phase 8's seq-128 / seq-512 steps; of the
sparse BERT rows, the 16-row forward, dq and dk/dv
(``sparse_attention_fwd_tc16``, ``sparse_attention_bwd_dq_tc16``,
``sparse_attention_bwd_dkv_tc16``) count its sparse steps, and the fp32
rows at that shape (the FMA forward, dq and dk/dv, ``_block16``, and the
3xTF32 forward, dq and dk/dv, ``_tf32_block16``, all timed on fp32
inputs) its sparse fp32 comparison.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_FLOPS = 67e12               # H100 SXM fp32, outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM dense bf16, tensor cores
# fp32-accurate products on the tensor cores: three TF32 products (hi.hi,
# hi.lo, lo.hi) per fp32 product at the 495 TFLOP/s of dense TF32. It is
# the least time the card takes for an fp32 product, so every fp32 row's
# compute bound counts its products at this rate, not at FP32_FLOPS.
FP32_3XTF32_FLOPS = 495e12 / 3
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
# B=2, S=512), so that path is held to 0.15. fp16 is held the same way
# at its own rounding step (2**-11 of the value, not bf16's 2**-8).
FLASH_DOUT_SCALE = {"float32": 0.1, "bfloat16": 1.0, "float16": 1.0}
FLASH_16BIT_RMS_TOL = {"kernel": 1e-3, "autograd": 0.15}
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


def ptxas_summary(lib: str, each: bool = False) -> str:
    """One line from the ``-Xptxas -v`` report kept beside a library (the
    full report is the ``.log`` file): kernels compiled, the register
    range, and the kernels that spill; with ``each``, then every kernel's
    registers and spill-store bytes."""
    import re

    regs, spills, name, per = [], [], None, {}
    with open(lib[:-3] + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                # the kernel's name and template arguments, mangled
                name = re.sub(r"^.*_cu_[0-9a-f]{8}\d+", "", m.group(1))[:52]
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                per.setdefault(name, [None, 0])[1] = int(m.group(1))
                if int(m.group(1)):
                    spills.append(name)
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
                if name:
                    per.setdefault(name, [None, 0])[0] = int(m.group(1))
    if not regs:
        return "no ptxas report"
    out = (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
           f"{len(spills)} spilling" + (f" ({spills})" if spills else ""))
    if each:
        out += "; " + "; ".join(f"{n}: {r} registers, {sp} bytes spilled"
                                for n, (r, sp) in sorted(per.items()))
    return out


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

def paged_case(torch, dtype, b, s, h, d, bs, wb, seed, layers=1,
               lasts=None):
    """Pools, tables and positions as the decode path makes them: each row
    owns distinct blocks for its visible keys, its table tail points at
    scratch block 0, and block 0 holds NaN (it must never be read).
    ``lasts``: each row's last query position (default: row 0 at the
    window's end, the others anywhere in it)."""
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
        last = (lasts[r] if lasts is not None else wb * bs - 1 if r == 0
                else int(torch.randint(s - 1, wb * bs, (1,), generator=g)))
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
    from deepspeed_tpu_torch.ops.transformer.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    h, d, bs, b = 12, 64, 16, 8
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        # S = 9: a speculative verify at k = 8, two query groups of MAX_S
        for s in (1, 5, 9):
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
    check_paged_splits(torch, int8=False)

    timings = {(str(dtype).split(".")[1], s): time_paged(torch, dtype, s)
               for dtype in (torch.bfloat16, torch.float32) for s in (1, 5)}
    main = timings[("bfloat16", 1)]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"],
                  library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                  bound_by="bytes", max_abs_err=max(worst[("bfloat16", 1)],
                                  worst[("bfloat16", 5)]))


def time_paged(torch, dtype, s, seed=None):
    """Kernel #1 timed at the decode path's widest window (64 blocks =
    1024 positions, 8 rows, 12 heads, D 64, block 16) with ``s`` queries a
    row, rotating over 8 layers' pools (200 MB of bf16 K/V, of which the
    visible rows are about 100 MB, twice the 50 MB L2) so that each launch
    finds its pools cold, as a decode step's next layer does: the kernel
    (device time, and host-paced), the first version's one-split walk,
    the plain version (host-paced), SDPA over K/V gathered beforehand
    with the same mask, and the bound."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    h, d, bs, b = 12, 64, 16, 8
    name = str(dtype).split(".")[1]
    rule = pa.paged_decode_splits(64 * bs, h, b)
    q, pools, bt, pos = paged_case(torch, dtype, b, s, h, d, bs, 64,
                                   seed=7 + s if seed is None else seed,
                                   layers=8)
    for kp, vp in pools:       # real keys only: the timing reads no NaN
        kp[0] = 0.0            # into the plain version
        vp[0] = 0.0
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(pools)
        return pools[it["i"]]

    def kern():
        pa.paged_decode_attention(q, *nxt(), None, None, bt, pos,
                                  block_size=bs)

    kernel_ms = device_ms(torch, kern)[0]
    host_ms = cuda_ms(kern)
    # the first version's walk: one block per (head, sequence)
    first_ms = device_ms(torch, lambda: pa._launch(
        q, *nxt(), None, None, bt, pos, bs, None, 1))[0]
    plain_ms = cuda_ms(lambda: pa.paged_decode_attention_reference(
        q, *nxt(), bt, pos, block_size=bs), iters=20)
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

    library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, *gnxt(), attn_mask=mask))[0]
    nbytes, flops = paged_bytes_flops(q, bt, pos, bs)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    print(f"paged_decode_attention timing {name} B={b} S={s} H={h} D={d} "
          f"BS={bs} WB=64 (device time): kernel {kernel_ms:.4f} ms at "
          f"{rule} splits (host-paced {host_ms:.4f} ms; 1 split, the first "
          f"version's walk, {first_ms:.4f} ms), plain {plain_ms:.4f} ms "
          f"(host-paced), SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({nbytes} bytes / 3.35 TB/s)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bytes=nbytes, first_ms=first_ms)


# each row's last query position in the short-context case: a 64-block
# window (8 splits of 128 keys) whose rows but the first see less than
# one split's share, so most blocks of their clusters walk no key
PAGED_SHORT_LASTS = {1: [1023, 0, 3, 15, 16, 64, 65, 127],
                     5: [1023, 4, 7, 20, 63, 64, 100, 127]}


def check_paged_splits(torch, int8):
    """Kernel #1 at every split count (1 to 8, forced through the launch
    helper) at a 64-block window, and through the wrapper's rule on the
    short-context case; fp32 and bf16 q, S = 1 and 5, against the plain
    version (KERNEL_TOL); the wrapper's output bit-equal over two
    launches."""
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    h, d, bs, b, wb = 12, 64, 16, 8, 64
    label = "int8 pools, " if int8 else ""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for s in (1, 5):
            for short in (False, True):
                q, pools, bt, pos = paged_case(
                    torch, dtype, b, s, h, d, bs, wb, seed=900 + s + short,
                    lasts=PAGED_SHORT_LASTS[s] if short else None)
                ops = (int8_pools(torch, pools)[0] if int8 else
                       (*pools[0], None, None))
                want = pa.paged_decode_attention_reference(
                    q, *ops[:2], bt, pos, block_size=bs, k_scale=ops[2],
                    v_scale=ops[3])
                outs = {}
                for n in (range(1, pa.MAX_SPLITS + 1) if not short
                          else ("rule", "rule again")):
                    if isinstance(n, int):
                        outs[n] = pa._launch(q, *ops, bt, pos, bs, None, n)
                    else:
                        outs[n] = pa.paged_decode_attention(
                            q, *ops[:2], ops[2], ops[3], bt, pos,
                            block_size=bs)
                torch.cuda.synchronize()
                for n, got in outs.items():
                    err = (got.float() - want.float()).abs().max().item()
                    if not torch.isfinite(got).all() \
                            or err > KERNEL_TOL[name]:
                        fail(f"paged_decode_attention {label}{name} S={s} "
                             f"splits={n} short={short}: max |err| {err} > "
                             f"{KERNEL_TOL[name]} or non-finite")
                    key = (name, s, "short" if short else "1..8")
                    worst[key] = max(worst.get(key, 0.0), err)
                if short and not torch.equal(outs["rule"],
                                             outs["rule again"]):
                    fail(f"paged_decode_attention {label}{name} S={s}: two "
                         f"launches on one input differ")
    rule = pa.paged_decode_splits(wb * bs, h, b)
    for (name, s, what), err in sorted(worst.items()):
        print(f"paged_decode_attention {label}{name} q S={s} WB=64 "
              + ("at every split count 1..8" if what == "1..8" else
                 f"short contexts (last positions {PAGED_SHORT_LASTS[s]}) "
                 f"at the rule's {rule} splits, bit-equal over two "
                 f"launches")
              + f": max |err| {err:.3g} (atol {KERNEL_TOL[name]})")


def time_paged_splits(torch):
    """The split rule measured: device time of kernel #1 (bf16 pools, S =
    1, 12 heads, D = 64, every row's last query at the window's end) at
    split counts 1 to 8 for batches of 1, 8 and 32 and windows of 8 to 64
    blocks (128 to 1024 keys), beside the count paged_decode_splits
    picks."""
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    h, d, bs = 12, 64, 16
    for b in (1, 8, 32):
        for wb in (8, 16, 32, 64):
            q, pools, bt, pos = paged_case(
                torch, torch.bfloat16, b, 1, h, d, bs, wb, seed=300 + wb,
                layers=2, lasts=[wb * bs - 1] * b)
            for kp, vp in pools:
                kp[0] = 0.0
                vp[0] = 0.0
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(pools)
                return pools[it["i"]]

            row = {}
            for n in range(1, pa.MAX_SPLITS + 1):
                row[n] = device_ms(torch, lambda: pa._launch(
                    q, *nxt(), None, None, bt, pos, bs, None, n))[0]
            rule = pa.paged_decode_splits(wb * bs, h, b)
            best = min(row, key=row.get)
            print(f"paged_decode_attention split rule, bf16 B={b} S=1 H={h} "
                  f"D={d} window {wb * bs} keys (device ms by splits): "
                  + ", ".join(f"{n}: {t:.4f}" for n, t in row.items())
                  + f"; best {best} ({row[best]:.4f}), rule {rule} "
                  f"({row[rule]:.4f}, {row[rule] / row[best]:.3f}x best)")
            del pools


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
    check_paged_splits(torch, int8=True)

    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    rule = pa.paged_decode_splits(64 * bs, h, b)
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

            def first():
                kq, vq, ks, vs = nxt()
                pa._launch(q, kq, vq, ks, vs, bt, pos, bs, None, 1)

            kernel_ms = device_ms(torch, kern)[0]
            host_ms = cuda_ms(kern)
            first_ms = device_ms(torch, first)[0]
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

            library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, *gnxt(), attn_mask=mask))[0]
            ctx = sum(min(64 * bs, int(p) + s) for p in pos.tolist())
            nbytes = int8_bytes(q, ctx, h, d) + bt.numel() * 4 + b * 4
            flops = 4 * s * ctx * h * d
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / FP32_FLOPS) * 1e3
            timings[(name, s)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                      library_ms=library_ms,
                                      bound_ms=bound_ms)
            print(f"paged_decode_attention int8 pools timing, {name} q, "
                  f"B={b} S={s} H={h} D={d} BS={bs} WB=64 (device time): "
                  f"kernel {kernel_ms:.4f} ms at {rule} splits (host-paced "
                  f"{host_ms:.4f} ms; 1 split {first_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms (host-paced), SDPA "
                  f"(pre-dequantized K/V) {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes} bytes / 3.35 TB/s)")
            del gathered, pools
    main = timings[("bfloat16", 1)]
    report.update(ms=main["ms"], plain_ms=main["plain_ms"],
                  library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                  bound_by="bytes", max_abs_err=max(worst[("bfloat16", 1)],
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


# A chunk whose items see more than 64 keys and cross 64-token boundaries
# (100 tokens from position 37: items of 64 and 36 tokens walking 101 and
# 137 keys; 20 more from 130) beside two decode rows; and 8 decode rows
# over a 1,024-key window, shortest to longest, held at every split count.
# the bf16 chunked trace at budget 256 on the first kernel (measured on
# one NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 5)
CHUNKED_FIRST_TTFT_MS, CHUNKED_FIRST_STEP_MS = 95.1, 11.17
CROSS_DECODE_POS = [500, 900]
CROSS_CHUNKS = [(37, 100), (130, 20)]
WINDOW_DECODE_POS = [1023, 1000, 777, 512, 64, 63, 5, 0]
CHUNKED_SHAPES = {"T=256 mixed": (256, MIXED_DECODE_POS, MIXED_CHUNKS),
                  "T=8 all-decode": (8, MIXED_DECODE_POS, []),
                  "T=128 chunks across 64": (128, CROSS_DECODE_POS,
                                             CROSS_CHUNKS),
                  "T=8 window 1024": (8, WINDOW_DECODE_POS, [])}
CHUNKED_NAMES = {"walk": "chunked_prefill_attention",
                 "tc": "chunked_prefill_attention_tc",
                 "tf32": "chunked_prefill_attention_tf32"}
# every kernel #1 / #2 counter summed over every trace serve() ran, each
# run's counts held to its route's there: the first chunked-prefill
# kernel's route (head dims above 128, or neither q dtype of the run
# kernels) reads its launches on the serving path here
SERVED_LAUNCHES = {}


def chunked_wrappers(cp):
    """Each route's counting wrapper: the run kernels' own, and the public
    call for the first kernel (its route's launches count there)."""
    return {r: getattr(cp, n) for r, n in CHUNKED_NAMES.items()}


def check_chunked_prefill(torch, reports):
    """Kernel #2 on the route ``chunked_prefill._route`` picks (bf16 q over
    bf16 or int8 pools: the run kernels; fp32 q over fp32 or int8 pools:
    the fp32 run kernels, 3xTF32; wider heads: the first kernel), each
    call counted by its route's wrapper only, in CHUNKED_SHAPES against
    the plain version (fp32 1e-5, bf16 2e-2, NaN scratch, pad rows
    excluded), every output bit-equal over two launches; the run kernels
    also at every split count of the decode rows (the 1,024-key window);
    the first kernel on the fp32 inputs too (the fp32 route's first
    version). Then timing at the T=256 mixed step: the run kernels, each
    kind of item alone, beside the first kernel on the same inputs (its
    first version), the plain version, SDPA per segment and the bound; the
    decode rows' split counts; and the first kernel's route, head dim 256
    (``check_chunked_d256``). ``reports``: the kernels line's rows, by
    route ("walk", "tc", "tf32"), "tc_int8" and "tf32_int8" for the run
    kernels over int8 pools, and the D = 256 rows by label."""
    import numpy as np
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.transformer import chunked_prefill as cp

    bs, d = 16, 64
    wrappers = chunked_wrappers(cp)
    worst = {}
    for int8 in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            label = f"{'int8 pools, ' if int8 else ''}{name} q"
            route = cp._route(dtype, torch.int8 if int8 else dtype, d)
            for sname, (t, dpos, chunks) in CHUNKED_SHAPES.items():
                q, pools, table, pos, n_real, _blocks = chunked_case(
                    torch, dtype, t, dpos, chunks, seed=t + int8,
                    int8=int8)
                kp, vp, ks, vs = pools[0]
                args = (q, kp, vp, ks, vs, table, pos)
                before = {r: w.launches for r, w in wrappers.items()}
                outs = {"": [cp.chunked_prefill_attention(
                    *args, block_size=bs) for _ in range(2)]}
                grew = {r: w.launches - before[r]
                        for r, w in wrappers.items()}
                if grew != {r: 2 if r == route else 0 for r in wrappers}:
                    fail(f"chunked_prefill {label} {sname}: routed to "
                         f"{route}, launches {grew}")
                if route != "walk" and sname == "T=8 window 1024":
                    for sp_ in range(1, 9):
                        outs[f", {sp_} splits"] = [
                            wrappers[route](*args, block_size=bs,
                                            splits=sp_)
                            for _ in range(2)]
                if route == "tf32":
                    # the first kernel on the same inputs: this route's
                    # first version, held as it is timed
                    outs[", first kernel"] = [
                        cp._launch_walk(*args, bs, None) for _ in range(2)]
                torch.cuda.synchronize()
                want = cp.chunked_prefill_attention_reference(
                    *args, block_size=bs)
                torch.cuda.synchronize()
                for tag, (got, again) in outs.items():
                    if not same_bits(torch, got, again):
                        fail(f"chunked_prefill {label} {sname}{tag}: "
                             f"differs between two launches")
                    real = got[:n_real]
                    err = (real.float() - want[:n_real].float()).abs().max()
                    err = err.item()
                    if not torch.isfinite(real).all() \
                            or err > KERNEL_TOL[name]:
                        fail(f"chunked_prefill_attention {label} {sname}"
                             f"{tag} ({route}): max |err| {err} > "
                             f"{KERNEL_TOL[name]} or non-finite real rows")
                    key = ("walk" if tag == ", first kernel" else route,
                           label, sname + tag)
                    worst[key] = max(worst.get(key, 0.0), err)
    for (route, label, sname), err in sorted(worst.items()):
        print(f"chunked_prefill_attention {label}, {sname} ({route}; H=12 "
              f"D=64 BS=16 WB=64, NaN scratch, pad rows excluded, bit-equal "
              f"over two launches): max |err| {err:.3g} (atol "
              f"{KERNEL_TOL[label.split()[-2]]})")

    # Timing at the mixed step's shape, rotating over 8 layers' pools (no
    # NaN in the timed inputs: pads read a zeroed scratch block); the run
    # list found once, as the serving engine finds it once per step.
    timings = {}
    for int8 in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            label = f"{'int8 pools, ' if int8 else ''}{name} q"
            route = cp._route(dtype, torch.int8 if int8 else dtype, d)
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
            runs = cp.chunked_runs(table.cpu(), pos.cpu(), bs)
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(pools)
                return pools[it["i"]]

            def first():
                cp._launch_walk(q, *nxt(), table, pos, bs, None)

            def runs_call(items):
                return lambda: wrappers[route](
                    q, *nxt(), table, pos, block_size=bs, runs=items)

            # the run kernels, each kernel alone (the chunk items, the
            # decode items), the first kernel on the same inputs
            none = np.zeros((0, 4))
            row = {"ms": device_ms(torch, runs_call(runs))[0],
                   "host_ms": cuda_ms(runs_call(runs)),
                   "chunk_ms": device_ms(torch, runs_call(cp.ChunkedRuns(
                       runs.items[:runs.n_chunk], none)))[0],
                   "decode_ms": device_ms(torch, runs_call(cp.ChunkedRuns(
                       none, runs.items[runs.n_chunk:])))[0],
                   "first_ms": device_ms(torch, first)[0]}
            row["plain_ms"] = cuda_ms(
                lambda: cp.chunked_prefill_attention_reference(
                    q, *nxt(), table, pos, block_size=bs), iters=5, warmup=1)
            qs, kv, mask = segment_sdpa_inputs(torch, q, pools, table, pos,
                                               n_real, bs)
            git = {"i": 0}

            def gnxt():
                git["i"] = (git["i"] + 1) % len(kv)
                return kv[git["i"]]

            row["library_ms"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, *gnxt(), attn_mask=mask))[0]
            nbytes, flops = chunked_bytes_flops(q, table, pos, blocks, bs,
                                                 int8)
            t_bytes = nbytes / HBM_BYTES_PER_S
            # the run kernels' chunk products on the tensor cores; fp32's
            # at the 3xTF32 rate (the first kernel runs them on FMAs)
            peak = (BF16_FLOPS if dtype == torch.bfloat16
                    else FP32_3XTF32_FLOPS)
            t_ops = flops / peak
            row.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            timings[label] = row
            print(f"chunked_prefill_attention timing, {label} ({route}), "
                  f"T=256 mixed (decode rows at {MIXED_DECODE_POS}, chunks "
                  f"(first position, tokens) {MIXED_CHUNKS}, {256 - n_real} "
                  f"pads; device time): run kernels {row['ms']:.4f} ms "
                  f"(host-paced {row['host_ms']:.4f} ms; {runs.n_chunk} "
                  f"chunk items alone {row['chunk_ms']:.4f} ms, "
                  f"{runs.n_decode} decode items at "
                  f"{cp.chunked_decode_splits(runs, 12)} splits alone "
                  f"{row['decode_ms']:.4f} ms), the first kernel on the same "
                  f"inputs {row['first_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms (host-paced), SDPA per segment "
                  f"(pre-gathered) {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes} "
                  f"bytes / 3.35 TB/s, {flops} flops / "
                  f"{peak / 1e12:.0f} TFLOP/s)")
            del pools, kv

    time_chunked_splits(torch, cp, bs)

    # the run kernels' rows: bf16 q ("tc") and fp32 q ("tf32"), each over
    # its own-dtype pools and over int8 pools ("_int8")
    for route, name in (("tc", "bfloat16"), ("tf32", "float32")):
        for int8 in (False, True):
            t = timings[f"{'int8 pools, ' if int8 else ''}{name} q"]
            reports[route + ("_int8" if int8 else "")].update(
                ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], first_ms=t["first_ms"],
                max_abs_err=max(e for (r, lab, _s), e in worst.items()
                                if r == route
                                and lab.startswith("int8") == int8))
    # the first kernel's row: its time on the fp32 route's inputs (the
    # first version of that route), its errors over every hold of it at
    # D = 64 (fp32 q, fp32 and int8 pools)
    main32 = timings["float32 q"]
    reports["walk"].update(
        ms=main32["first_ms"], plain_ms=main32["plain_ms"],
        library_ms=main32["library_ms"], bound_ms=main32["bound_ms"],
        bound_by=main32["bound_by"],
        max_abs_err=max(e for (r, _lab, _s), e in worst.items()
                        if r == "walk"))
    for route, name in (("tc", "bfloat16"), ("tf32", "float32")):
        for int8 in ("", "int8 pools, "):
            t = timings[f"{int8}{name} q"]
            print(f"chunked_prefill_attention at the T=256 mixed step, "
                  f"{int8}{name} q: run kernels {t['ms']:.4f} ms against "
                  f"the first kernel's {t['first_ms']:.4f} "
                  f"({t['first_ms'] / t['ms']:.2f}x), SDPA per segment's "
                  f"{t['library_ms']:.4f} ({t['ms'] / t['library_ms']:.3f}x)"
                  f" and the bound's {t['bound_ms']:.4f} "
                  f"({t['ms'] / t['bound_ms']:.2f}x)")
    check_chunked_d256(torch, cp, reports)


def chunked_d256_row(name, int8):
    """The kernels line's row suffix of the first kernel's route (head
    dims in (128, 256]) for q of dtype ``name``, over int8 pools or not."""
    return ("d256" + ("_fp32" if name == "float32" else "")
            + ("_int8" if int8 else ""))


def check_chunked_d256(torch, cp, reports):
    """The first kernel on its own route, head dim 256, at the T=256 mixed
    step: bf16 and fp32 q over pools of q's dtype and over int8 pools,
    through the public call (counted by ``chunked_prefill_attention``
    only), against the plain version (``KERNEL_TOL``; NaN scratch, pad
    rows excluded), bit-equal over two launches; then timed (8 layers'
    pools in rotation, no NaN) beside the plain version, SDPA per segment
    and the bound. ``reports``: the rows by ``chunked_d256_row``."""
    import torch.nn.functional as F

    bs, d = 16, 256
    wrappers = chunked_wrappers(cp)
    for int8 in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            label = f"{'int8 pools, ' if int8 else ''}{name} q"
            route = cp._route(dtype, torch.int8 if int8 else dtype, d)
            if route != "walk":
                fail(f"chunked_prefill D=256 {label}: routed to {route}")
            q, pools, table, pos, n_real, blocks = chunked_case(
                torch, dtype, 256, MIXED_DECODE_POS, MIXED_CHUNKS,
                seed=21 + int8, layers=8, int8=int8, d=d)
            kp, vp, ks, vs = pools[0]
            args = (q, kp, vp, ks, vs, table, pos)
            before = {r: w.launches for r, w in wrappers.items()}
            got, again = (cp.chunked_prefill_attention(*args, block_size=bs)
                          for _ in range(2))
            grew = {r: w.launches - before[r] for r, w in wrappers.items()}
            if grew != {r: 2 if r == "walk" else 0 for r in wrappers}:
                fail(f"chunked_prefill D=256 {label}: launches {grew}")
            want = cp.chunked_prefill_attention_reference(*args,
                                                          block_size=bs)
            torch.cuda.synchronize()
            if not same_bits(torch, got, again):
                fail(f"chunked_prefill D=256 {label}: differs between two "
                     f"launches")
            real = got[:n_real]
            err = (real.float() - want[:n_real].float()).abs().max().item()
            if not torch.isfinite(real).all() or err > KERNEL_TOL[name]:
                fail(f"chunked_prefill_attention D=256 {label}: max |err| "
                     f"{err} > {KERNEL_TOL[name]} or non-finite real rows")
            del got, again, want, real
            for k, v, ks_, vs_ in pools:
                if int8:
                    ks_[0] = 1.0
                    vs_[0] = 1.0
                else:
                    k[0] = 0.0
                    v[0] = 0.0
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % len(pools)
                return pools[it["i"]]

            row = {"ms": device_ms(torch, lambda: cp._launch_walk(
                q, *nxt(), table, pos, bs, None))[0]}
            row["plain_ms"] = cuda_ms(
                lambda: cp.chunked_prefill_attention_reference(
                    q, *nxt(), table, pos, block_size=bs), iters=3,
                warmup=1)
            qs, kv, mask = segment_sdpa_inputs(torch, q, pools, table, pos,
                                               n_real, bs)
            git = {"i": 0}

            def gnxt():
                git["i"] = (git["i"] + 1) % len(kv)
                return kv[git["i"]]

            row["library_ms"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, *gnxt(), attn_mask=mask))[0]
            nbytes, flops = chunked_bytes_flops(q, table, pos, blocks, bs,
                                                 int8)
            peak = (BF16_FLOPS if dtype == torch.bfloat16
                    else FP32_3XTF32_FLOPS)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
            row.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=err)
            reports[chunked_d256_row(name, int8)].update(row)
            print(f"chunked_prefill_attention D=256, {label} (the first "
                  f"kernel, its route; T=256 mixed, H=12 BS=16 WB=64, NaN "
                  f"scratch, pad rows excluded, bit-equal over two "
                  f"launches): max |err| {err:.3g} (atol "
                  f"{KERNEL_TOL[name]}); device time {row['ms']:.4f} ms, "
                  f"plain {row['plain_ms']:.4f} ms (host-paced), SDPA per "
                  f"segment (pre-gathered) {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes} "
                  f"bytes / 3.35 TB/s, {flops} flops / "
                  f"{peak / 1e12:.0f} TFLOP/s): "
                  f"{row['ms'] / row['bound_ms']:.2f}x the bound, "
                  f"{row['ms'] / row['library_ms']:.2f}x SDPA")
            del pools, kv, qs, mask


def time_chunked_splits(torch, cp, bs):
    """The run kernels' decode rows at every split count (1-8) and the
    rule's pick (``chunked_decode_splits``): 1, 2, 4 and 8 rows (a mixed
    step's decode rows, at most the 8 slots), each at the last position of
    a 256- or 1,024-key window (bf16, 8 layers' pools in rotation; device
    time)."""
    sweep = {}
    for window in (256, 1024):
        for rows in (1, 2, 4, 8):
            q, pools, table, pos, _n, _b = chunked_case(
                torch, torch.bfloat16, rows, [window - 1] * rows, [],
                seed=11 + rows, layers=8, wb=window // bs)
            for k, v, _ks, _vs in pools:
                k[0] = 0.0
                v[0] = 0.0
            runs = cp.chunked_runs(table.cpu(), pos.cpu(), bs)
            it = {"i": 0}

            def call(n):
                it["i"] = (it["i"] + 1) % len(pools)
                cp.chunked_prefill_attention_tc(
                    q, *pools[it["i"]], table, pos, block_size=bs,
                    runs=runs, splits=n)

            ms = {n: device_ms(torch, lambda n=n: call(n))[0]
                  for n in range(1, 9)}
            pick = cp.chunked_decode_splits(runs, 12)
            best = min(ms, key=ms.get)
            sweep[f"{rows}x{window}"] = {
                "ms": {n: round(v, 4) for n, v in ms.items()},
                "fastest": best, "pick": pick,
                "pick_over_fastest": round(ms[pick] / ms[best], 4)}
            del pools
    print(f"chunked_prefill decode rows by split count (rows x window keys,"
          f" bf16, H=12 D=64, device ms): {json.dumps(sweep)}")


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


def round_step(torch, ref, dtype=None):
    """One rounding step (unit in the last place) of ``dtype`` (bf16 by
    default, or fp16) at each element of ``ref``: 2**(e - 8) in bf16 and
    2**(e - 11) in fp16 (at least 2**-24, its subnormal step) for |x| in
    [2**(e-1), 2**e); 0 where ref is 0."""
    r = ref.float()
    exp = torch.frexp(r.abs())[1]
    if dtype == torch.float16:
        step = torch.ldexp(torch.ones_like(r), (exp - 11).clamp_min(-24))
    else:
        step = torch.ldexp(torch.ones_like(r), exp - 8)
    return torch.where(r == 0, torch.zeros_like(r), step)


def flash_bytes_flops(q, mask, which, causal=True):
    """What one kernel must move and compute for these inputs
    (self-attention): each input read once and each output written once;
    per visible (query, key) pair 2*D flops for each of its products (the
    forward has 2, dq 3, dk/dv 4). Causal: the lower triangle; else every
    query sees the keys its row of the [B, S] ``mask`` keeps (all
    without one)."""
    b, s, h, d = q.shape
    es = q.element_size()
    big = b * s * h * d * es               # one [B, S, H, D] tensor
    rows = b * h * s * 4                   # one fp32 [B, H, S] vector
    mbytes = 0 if mask is None else b * s * 4
    if causal:
        pairs = b * h * s * (s + 1) // 2
    else:
        keys = b * s if mask is None else int(mask.sum().item())
        pairs = h * s * keys
    if which == "fwd":                     # q, k, v -> o, lse
        return 4 * big + rows + mbytes, 4 * d * pairs
    if which == "dq":                      # q, k, v, dO, lse, delta -> dq
        return 5 * big + 2 * rows + mbytes, 6 * d * pairs
    return 6 * big + 2 * rows + mbytes, 8 * d * pairs  # -> dk, dv


# Phase 2's flash cases, causal: (B, Sq, Sk, H, D, key mask). Every dtype
# runs FLASH_CASES (the training shape and ragged S, D = 64) and
# FLASH_CASES_16, the tensor-core kernels' other widths (D = 128, D = 72,
# zero-padded to 80 in shared memory in 16 bits, and D = 8, their
# narrowest, padded to 16) and Sq < Sk
# (bottom-right causal): the 16-bit tensor-core forward, dq and dk/dv, and
# in fp32 the 3xTF32 forward, dq and dk/dv. Every dtype also runs
# FLASH_CASES_256 (and FLASH_NONCAUSAL_CASES_256): head dims above 128, D
# = 256 and D = 136 (zero-padded to 144 in 16 bits), where 16 bits take
# the wgmma forward, dq and dk/dv, fp32 the 3xTF32 forward, dq and dk/dv.
# At dropout 0.1 the same split.
FLASH_CASES = ((16, 512, 512, 12, 64, False), (16, 512, 512, 12, 64, True),
               (4, 5, 5, 12, 64, True), (4, 300, 300, 12, 64, False),
               (4, 300, 300, 12, 64, True))
FLASH_CASES_16 = ((4, 300, 300, 4, 128, False), (4, 300, 300, 4, 128, True),
                  (4, 300, 300, 4, 72, True), (4, 5, 5, 4, 72, True),
                  (4, 100, 300, 12, 64, True), (4, 100, 300, 4, 128, False),
                  (4, 37, 300, 4, 72, True), (4, 300, 300, 4, 8, True))
FLASH_DROP_CASES = ((16, 512, 512, 12, 64, False),
                    (16, 512, 512, 12, 64, True))
FLASH_DROP_CASES_16 = ((4, 300, 300, 4, 128, True),
                       (4, 100, 300, 4, 72, True))
FLASH_CASES_256 = ((4, 300, 300, 4, 256, True), (4, 100, 300, 4, 256, False),
                   (4, 300, 300, 4, 136, True), (4, 37, 300, 4, 136, False))
FLASH_DROP_CASES_256 = ((4, 300, 300, 4, 256, True),
                        (4, 100, 300, 4, 136, True))
# non-causal, key-padded with an all-padding batch row, at dropout 0 and
# 0.1
FLASH_NONCAUSAL_CASES_256 = ((4, 128, 128, 4, 256, True),
                             (4, 100, 300, 4, 256, True))
# the _d256 rows' timing shape [B, S, H, D]: bf16, causal, no mask
FLASH_D256_SHAPE = (4, 512, 8, 256)
# The non-causal, key-padded cases (BERT's attention), every dtype at
# dropout 0 and 0.1: bench_bert's head shape at seq 128 and 512 (fewer
# rows) and Sq < Sk; each with an all-padding batch row.
FLASH_NONCAUSAL_CASES = ((4, 128, 128, 16, 64, True),
                         (2, 512, 512, 16, 64, True),
                         (4, 100, 300, 16, 64, True))


def compare_flash_case(torch, fa, dtype, case, worst, rate=0.0, seed=None,
                       causal=True):
    """Kernels #3-#5 and the whole autograd path against their plain
    versions on one ``case`` (B, Sq, Sk, H, D, masked), causal or not, at
    dropout ``rate`` with ``seed``; q is the last Sq rows of the fused
    projection. Where a kernel is not the FMA kernel (the tensor cores in
    16 bits, 3xTF32 in fp32, wgmma above D = 128 in 16 bits), the FMA
    kernel (its first version) is held on the same inputs too, except the
    16-bit forward up to D = 128; the wgmma forward, dq and dk/dv, and the
    3xTF32 dq and dk/dv above D = 128, are also held to the FMA kernel's
    outputs.
    Folds each output's max |err| into ``worst`` and fails beyond the
    tolerances (KERNEL_TOL, FLASH_16BIT_RMS_TOL), if the forward, dq or
    dk/dv differ between two launches on the same inputs, or if an
    all-padding batch row is not exactly zero. Returns the routes of the
    forward, dq and dk/dv (:func:`flash_attention._route`)."""
    b, sq, s, h, d, masked = case
    name = str(dtype).split(".")[1]
    qkv, q, k, v, dout, mask = flash_case(
        torch, dtype, b, s, h, d,
        seed=(s + masked + 1000 * (d != 64) + 7 * (s - sq)
              + 31 * (not causal)), masked=masked,
        dout_scale=FLASH_DOUT_SCALE[name])
    q, dout = q[:, s - sq:], dout[:, s - sq:].contiguous()
    scale = 1.0 / d ** 0.5
    drop = (rate, seed)
    qp, kp, vp, mp = fa._prepare(q, k, v, mask, causal)
    if qp.data_ptr() != q.data_ptr():
        fail("flash_attention copied an aligned strided view")
    routes = tuple(fa._route(dtype, d, w) for w in ("fwd", "dq", "dkv"))
    out, lse = fa.flash_attention_fwd(qp, kp, vp, mp, causal, scale, *drop)
    out2, lse2 = fa.flash_attention_fwd(qp, kp, vp, mp, causal, scale, *drop)
    want = fa.flash_attention_reference(q, k, v, causal=causal,
                                        kv_mask=mask, dropout_rate=rate,
                                        dropout_seed=seed)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    dq = fa.flash_attention_bwd_dq(qp, kp, vp, dout, mp, lse, delta, causal,
                                   scale, *drop)
    dq2 = fa.flash_attention_bwd_dq(qp, kp, vp, dout, mp, lse, delta, causal,
                                    scale, *drop)
    dk, dv = fa.flash_attention_bwd_dkv(qp, kp, vp, dout, mp, lse, delta,
                                        causal, scale, *drop)
    dk2, dv2 = fa.flash_attention_bwd_dkv(qp, kp, vp, dout, mp, lse, delta,
                                          causal, scale, *drop)
    # the FMA kernels (the other routes' first versions) on the same inputs
    dq_fma = (fa._launch_dq("flash_attention", qp, kp, vp, dout, mp, lse,
                            delta, causal, scale, *drop)
              if routes[1] != "fma" else None)
    dkv_fma = (fa._launch_dkv("flash_attention", qp, kp, vp, dout, mp, lse,
                              delta, causal, scale, *drop)
               if routes[2] != "fma" else None)
    fwd_fma = (fa._launch_fwd("flash_attention", qp, kp, vp, mp, causal,
                              scale, *drop)[0]
               if routes[0] in ("tf32", "tc256") else None)
    torch.cuda.synchronize()
    what = (f"{name} B={b} Sq={sq} Sk={s} H={h} D={d} masked={masked} "
            f"causal={causal} dropout={rate} ({'/'.join(routes)})")
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        fail(f"flash fwd {what}: two launches on one input differ")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        fail(f"flash dkv {what}: two launches on one input differ")
    if not torch.equal(dq, dq2):
        fail(f"flash dq {what}: two launches on one input differ")
    dq_w = fa.flash_bwd_dq_reference(q, k, v, dout, mp, lse, delta, causal,
                                     scale, *drop)
    dk_w, dv_w = fa.flash_bwd_dkv_reference(q, k, v, dout, mp, lse, delta,
                                            causal, scale, *drop)
    # the whole autograd path against the reference's autograd
    x1 = qkv.detach().clone().requires_grad_()
    x2 = qkv.detach().clone().requires_grad_()
    outs = []
    for x, fn in ((x1, fa.flash_attention),
                  (x2, fa.flash_attention_reference)):
        qq, kk, vv = (t.reshape(b, s, h, d) for t in x.split(h * d, dim=-1))
        o = fn(qq[:, s - sq:], kk, vv, causal=causal, kv_mask=mask,
               dropout_rate=rate, dropout_seed=seed)
        o.backward(dout)
        outs.append(o)
    torch.cuda.synchronize()
    grad_w = x2.grad
    if rate and name != "float32":
        # the path's delta comes from its 16-bit output
        # (FLASH_16BIT_RMS_TOL): at dropout a row with one visible key
        # outputs (1 / 0.9) v, which bf16 rounds, so the masked case moves
        # dq and dk by 0.59 of the RMS against fp32 autograd (first run on
        # the card). The path is held to the plain backward versions on
        # its own delta instead; fp32 holds it to autograd.
        dq_full = torch.zeros(b, s, h, d, dtype=dtype, device="cuda")
        dq_full[:, s - sq:] = dq_w
        grad_w = torch.cat([t.reshape(b, s, h * d)
                            for t in (dq_full, dk_w, dv_w)], -1)
    pairs = {"fwd": (out, want), "dq": (dq, dq_w), "dk": (dk, dk_w),
             "dv": (dv, dv_w), "autograd out": tuple(outs),
             "autograd dqkv": (x1.grad, grad_w)}
    if dq_fma is not None:
        pairs["dq (FMA kernel, same inputs)"] = (dq_fma, dq_w)
    if dkv_fma is not None:
        pairs["dk (FMA kernel, same inputs)"] = (dkv_fma[0], dk_w)
        pairs["dv (FMA kernel, same inputs)"] = (dkv_fma[1], dv_w)
    if fwd_fma is not None:
        pairs["fwd (FMA kernel, same inputs)"] = (fwd_fma, want)
    if routes[0] == "tc256":
        pairs["fwd against the FMA kernel"] = (out, fwd_fma)
    if routes[1] == "tc256" or (routes[1] == "tf32" and d > 128):
        pairs["dq against the FMA kernel"] = (dq, dq_fma)
    if routes[2] == "tc256" or (routes[2] == "tf32" and d > 128):
        pairs["dk against the FMA kernel"] = (dk, dkv_fma[0])
        pairs["dv against the FMA kernel"] = (dv, dkv_fma[1])
    for key, (got, ref) in pairs.items():
        if not torch.isfinite(got).all():
            fail(f"flash {key} {what}: non-finite output")
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        rms = ref.float().pow(2).mean().sqrt().item()
        peak = ref.float().abs().max().item()
        if name == "float32":
            rel = 0.0
            bad = err > KERNEL_TOL[name]
        else:
            rel = ((diff - round_step(torch, ref, dtype)).clamp_min(0).max()
                   .item() / max(rms, 1e-30))
            bad = rel > FLASH_16BIT_RMS_TOL[
                "autograd" if key.startswith("autograd") and not rate
                else "kernel"]
        if bad:
            fail(f"flash {key} {what}: max |err| {err} (reference RMS "
                 f"{rms}, max |x| {peak}); beyond one rounding step {rel} "
                 f"of the RMS")
        w = worst.get((key, name))
        if w is None or err > w[0]:
            worst[(key, name)] = (err, rms, peak)
        w = worst.get((key, name, "rel"))
        worst[(key, name, "rel")] = max(w or 0.0, rel)
    if masked and b > 1 and any(t[1].abs().max().item() != 0.0
                                for t in (out, dq, dk, dv)):
        fail(f"flash {what}: the all-padding row is not exactly zero")
    return routes


def print_flash_worst(worst, cases, rate=0.0, kind="causal, with/without "
                      "key mask"):
    for key, name in sorted(k for k in worst if len(k) == 2):
        err, rms, peak = worst[(key, name)]
        lim = FLASH_16BIT_RMS_TOL["autograd" if key.startswith("autograd")
                                  and not rate else "kernel"]
        limit = (f"atol {KERNEL_TOL[name]}" if name == "float32" else
                 f"beyond one {name} step: "
                 f"{worst[(key, name, 'rel')]:.3g} of the RMS, limit {lim}")
        print(f"flash_attention {key} {name} {cases}, {kind}, "
              f"dO x {FLASH_DOUT_SCALE[name]}: max |err| "
              f"{err:.3g} where the reference's RMS is {rms:.3g} and its "
              f"max |x| {peak:.3g} ({limit})")


FLASH_DROPOUT = 0.1              # GPTConfig.dropout_rate's default
FLASH_DROPOUT_SEED = -123456789  # any int: the kernels take it as uint32


_SLEEP = {}


def _sleep_cycles_per_ms(torch) -> float:
    """Cycles of ``torch.cuda._sleep`` per device millisecond, timed once."""
    if "rate" not in _SLEEP:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP["rate"] = 20_000_000 / start.elapsed_time(end)
    return _SLEEP["rate"]


def device_ms(torch, fn, iters=20, warmup=3, names=False):
    """Device time of one call of ``fn``: CUDA events around ``iters``
    back-to-back calls that the host enqueues while a sleep kernel holds
    the device, so the device runs them without waiting for the host (the
    host's pace is not counted; the device's own gaps between kernels
    are). The window counts only if the device had not reached its start
    event when the host finished enqueueing it; else the sleep grows and
    it is measured again. With ``names``, one ``torch.profiler`` window
    of 2 calls names the device kernels (not timed by it: its records
    may come late or not at all). Returns (ms, {kernel name: ms per
    call of that window})."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    rate = _sleep_cycles_per_ms(torch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _attempt in range(4):
        torch.cuda._sleep(int(rate * (2.0 * host_ms + 1.0)))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            break
        host_ms *= 4
    else:
        fail("device time not measured: the host could not enqueue the "
             "window before the device reached it")
    kernels = {}
    if names:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                kernels[e.name] = (kernels.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 2 / 1e3)
    return start.elapsed_time(end) / iters, kernels


def flash_wrappers(fa):
    """Each flash kernel's wrappers by route: the forward, dq and dk/dv."""
    return {"fwd": {"tc": fa.flash_attention_fwd_tc,
                    "tf32": fa.flash_attention_fwd_tf32,
                    "tc256": fa.flash_attention_fwd_tc256,
                    "fma": fa.flash_attention_fwd},
            "dq": {"tc": fa.flash_attention_bwd_dq_tc,
                   "tf32": fa.flash_attention_bwd_dq_tf32,
                   "tc256": fa.flash_attention_bwd_dq_tc256,
                   "fma": fa.flash_attention_bwd_dq},
            "dkv": {"tc": fa.flash_attention_bwd_dkv_tc,
                    "tf32": fa.flash_attention_bwd_dkv_tf32,
                    "tc256": fa.flash_attention_bwd_dkv_tc256,
                    "fma": fa.flash_attention_bwd_dkv}}


def flash_wide_launches(fa):
    """The FMA wrappers' launches at D > 128, by kernel."""
    return {"fwd": fa.flash_attention_fwd.launches_wide,
            "dq": fa.flash_attention_bwd_dq.launches_wide,
            "dkv": fa.flash_attention_bwd_dkv.launches_wide}


def take_wide_launches(fa, total=None):
    """``total`` (by kernel; zeros when None) plus the FMA wrappers' launches
    at D > 128 since they were last set to 0; sets them to 0."""
    total = dict(total or dict.fromkeys(("fwd", "dq", "dkv"), 0))
    for key, n in flash_wide_launches(fa).items():
        total[key] += n
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        fn.launches_wide = 0
    return total


def flash_routes_expected(dtype, d):
    """The routes of the forward, dq and dk/dv that phase 2 holds the code
    to: fp32 3xTF32 on the tensor cores up to D = 256; 16-bit the tensor
    cores up to D = 128, the wgmma forward, dq and dk/dv above."""
    import torch

    if dtype == torch.float32:
        return ("tf32",) * 3
    return ("tc256",) * 3 if d > 128 else ("tc",) * 3


def check_flash_attention(torch, reports):
    """#3-#5 against their plain versions in fp32, bf16 and fp16 at dropout
    0 (FLASH_CASES and FLASH_CASES_16) and at dropout 0.1
    (FLASH_DROP_CASES, FLASH_DROP_CASES_16), and above D = 128
    (FLASH_CASES_256, FLASH_DROP_CASES_256, FLASH_NONCAUSAL_CASES_256 at
    dropout 0 and 0.1); each call must launch the kernel of the route
    :func:`flash_routes_expected` names, counted in that route's wrapper
    alone, and none in the FMA wrappers' ``.launches_wide``. Then timed
    by device time (:func:`time_flash`) at the training shape and at
    FLASH_D256_SHAPE (bf16 on its routes, the bf16 kernels first held
    there by :func:`hold_flash_d256`; fp32 on its routes, the 3xTF32
    forward, dq and dk/dv, first held there by
    :func:`hold_flash_d256_fp32`), and the slice's path at that shape in
    bf16 and fp32 (:func:`time_flash_d256_path`). ``reports``: the kernels
    line's rows by name."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    worst, worst_drop, worst_nc, worst_nc_drop = {}, {}, {}, {}
    worst_256 = {}
    wrappers = flash_wrappers(fa)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for cases, sink, rate, causal in (
                (FLASH_CASES + FLASH_CASES_16, worst, 0.0, True),
                (FLASH_DROP_CASES + FLASH_DROP_CASES_16, worst_drop,
                 FLASH_DROPOUT, True),
                (FLASH_NONCAUSAL_CASES, worst_nc, 0.0, False),
                (FLASH_NONCAUSAL_CASES, worst_nc_drop, FLASH_DROPOUT,
                 False),
                (FLASH_CASES_256, worst_256, 0.0, True),
                (FLASH_DROP_CASES_256, worst_256, FLASH_DROPOUT, True),
                (FLASH_NONCAUSAL_CASES_256, worst_256, 0.0, False),
                (FLASH_NONCAUSAL_CASES_256, worst_256, FLASH_DROPOUT,
                 False)):
            for case in cases:
                before = {(k, r): w.launches for k, by in wrappers.items()
                          for r, w in by.items()}
                wide = flash_wide_launches(fa)
                routes = compare_flash_case(
                    torch, fa, dtype, case, sink, rate,
                    FLASH_DROPOUT_SEED if rate else None, causal=causal)
                want = flash_routes_expected(dtype, case[4])
                grew = {k: sorted(r for r, w in by.items()
                                  if w.launches > before[(k, r)])
                        for k, by in wrappers.items()}
                grew_wide = sorted(k for k, n in flash_wide_launches(
                    fa).items() if n > wide[k])
                if routes != want or any(
                        grew[k] != [r] for k, r in zip(wrappers, want)) \
                        or grew_wide:
                    fail(f"flash {dtype} {case} causal={causal}: routed to "
                         f"{routes} (expected {want}), launches grew on "
                         f"{grew}, wide launches on {grew_wide}")
    print_flash_worst(worst, "(B,Sq,Sk,H,D) in FLASH_CASES and "
                      "FLASH_CASES_16")
    print_flash_worst(worst_drop, f"dropout {FLASH_DROPOUT}, "
                      f"FLASH_DROP_CASES and FLASH_DROP_CASES_16",
                      FLASH_DROPOUT)
    nc = "non-causal, key mask with an all-padding row"
    print_flash_worst(worst_nc, "FLASH_NONCAUSAL_CASES", kind=nc)
    print_flash_worst(worst_nc_drop, f"dropout {FLASH_DROPOUT}, "
                      f"FLASH_NONCAUSAL_CASES", FLASH_DROPOUT, kind=nc)
    print_flash_worst(worst_256, f"D = 256 and 136, dropout 0 and "
                      f"{FLASH_DROPOUT}, FLASH_CASES_256, "
                      f"FLASH_DROP_CASES_256 and FLASH_NONCAUSAL_CASES_256",
                      kind="causal with/without key mask, and non-causal "
                      "with an all-padding row")
    time_flash(torch, fa, reports, {0.0: worst, FLASH_DROPOUT: worst_drop})
    # the _d256 rows: bf16 times beside cuDNN's SDPA (SDPA's own pick at D
    # = 256, and the faster of its backends there), their max |err| that
    # of the kernels held at that shape on the timed inputs
    time_flash(torch, fa, reports, {0.0: hold_flash_d256(torch, fa)},
               shape=FLASH_D256_SHAPE, dtypes=(torch.bfloat16,),
               suffix="_d256", backends={"bfloat16": "CUDNN_ATTENTION"})
    # the fp32 kernels at that shape (the 3xTF32 forward, dq and dk/dv),
    # beside the FMA forward, dq and dk/dv and SDPA in fp32 (TF32 off),
    # their max |err| that of the kernels held on the timed inputs
    time_flash(torch, fa, reports, {0.0: hold_flash_d256_fp32(torch, fa)},
               shape=FLASH_D256_SHAPE, dtypes=(torch.float32,),
               suffix="_d256_fp32")
    time_flash_d256_path(torch, fa, reports)
    time_flash_d256_path(torch, fa, reports, torch.float32)
    time_flash_bert(torch, fa, reports)


def hold_flash_d256(torch, fa):
    """The kernels the ``_d256`` rows time, held at FLASH_D256_SHAPE
    (causal, no mask) by :func:`hold_flash`: the wgmma forward, dq and
    dk/dv, and the FMA forward, dq and dk/dv on the same inputs, in bf16
    on the four layers :func:`time_flash` times there (seeds 100-103) and
    on the inputs of :func:`time_flash_d256_path` (seed 321), and in fp16
    on the first layer. Returns the bf16 max |err| by (output, dtype
    name), as :func:`compare_flash_case` folds them, for the rows."""
    b, s, h, d = FLASH_D256_SHAPE
    errs = {}
    for dtype, seed in ((torch.bfloat16, 100), (torch.bfloat16, 101),
                        (torch.bfloat16, 102), (torch.bfloat16, 103),
                        (torch.bfloat16, 321), (torch.float16, 100)):
        _qkv, q, k, v, dout, _m = flash_case(torch, dtype, b, s, h, d,
                                             seed=seed)
        name = str(dtype).split(".")[1]
        one = hold_flash(torch, fa, q, k, v, dout, None, d ** -0.5,
                         f"{name} {list(FLASH_D256_SHAPE)} causal, seed "
                         f"{seed}", causal=True, fma=True)
        if dtype == torch.bfloat16:
            errs = {key: max(errs.get(key, 0.0), e)
                    for key, e in one.items()}
    return {(out, "bfloat16"): (errs[key],) for out, key in (
        ("fwd", "fwd"), ("dq", "dq"), ("dk", "dkv"), ("dv", "dkv"),
        ("fwd (FMA kernel, same inputs)", "fwd fma"),
        ("dq (FMA kernel, same inputs)", "dq fma"),
        ("dk (FMA kernel, same inputs)", "dkv fma"),
        ("dv (FMA kernel, same inputs)", "dkv fma"))}


def hold_flash_d256_fp32(torch, fa):
    """The kernels the ``_d256_fp32`` rows time, held at FLASH_D256_SHAPE
    (fp32, causal, no mask) on the four layers :func:`time_flash` times
    there (seeds 100-103) and on the inputs of :func:`time_flash_d256_path`
    (seed 321): the 3xTF32 forward (o), dq and dk/dv, and the FMA forward,
    dq and dk/dv on the same inputs, each against its plain version within
    KERNEL_TOL of the reference's largest |value| and bit-equal over two
    launches. Returns the max |err| by (output, dtype name), as
    :func:`compare_flash_case` folds them, for the rows."""
    b, s, h, d = FLASH_D256_SHAPE
    scale = d ** -0.5
    tol = KERNEL_TOL["float32"]
    outs = {"fwd": ("fwd",), "dq": ("dq",), "dkv": ("dk", "dv")}
    errs, rels = {}, {}
    for seed in (100, 101, 102, 103, 321):
        _qkv, q, k, v, dout, _m = flash_case(torch, torch.float32, b, s, h,
                                             d, seed=seed)
        q, k, v, mp = fa._prepare(q, k, v, None, True)
        out, lse = fa.flash_attention_fwd(q, k, v, mp, True, scale)
        delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, dout, mp, lse, delta, True, scale)
        calls = {
            "fwd": lambda: fa.flash_attention_fwd(q, k, v, mp, True, scale),
            "dq": lambda: (fa.flash_attention_bwd_dq(*args),),
            "dkv": lambda: fa.flash_attention_bwd_dkv(*args),
            "fwd fma": lambda: fa._launch_fwd("flash_attention", q, k, v, mp,
                                              True, scale, 0.0, None),
            "dq fma": lambda: (fa._launch_dq("flash_attention", *args, 0.0,
                                             None),),
            "dkv fma": lambda: fa._launch_dkv("flash_attention", *args, 0.0,
                                              None)}
        runs = {key: (call(), call()) for key, call in calls.items()}
        torch.cuda.synchronize()
        what = f"float32 {list(FLASH_D256_SHAPE)} causal, seed {seed}"
        for key, (one, two) in runs.items():
            if not all(same_bits(torch, x, y) for x, y in zip(one, two)):
                fail(f"flash {key} {what}: two launches on one input differ")
        refs = {"fwd": (fa.flash_attention_reference(q, k, v, causal=True),),
                "dq": (fa.flash_bwd_dq_reference(*args),),
                "dkv": fa.flash_bwd_dkv_reference(*args)}
        for key, (one, _two) in runs.items():
            kernel, _, first = key.partition(" ")
            for out_name, got, ref in zip(outs[kernel], one, refs[kernel]):
                err = (got - ref).abs().max().item()
                peak = ref.abs().max().item()
                if not torch.isfinite(got).all() or not err <= tol * peak:
                    fail(f"flash {out_name}{' (FMA)' if first else ''} "
                         f"{what}: max |err| {err} beyond {tol} of the "
                         f"reference's max |x| {peak}")
                row = (f"{out_name} (FMA kernel, same inputs)" if first
                       else out_name)
                errs[row] = max(errs.get(row, 0.0), err)
                rels[row] = max(rels.get(row, 0.0), err / peak)
        del runs, refs
    print(f"flash_attention float32 {list(FLASH_D256_SHAPE)} causal, seeds "
          f"100-103 and 321, against the plain versions: max |err| "
          f"{json.dumps(errs)}, of the reference's max |x| "
          f"{json.dumps({k: float(f'{r:.3g}') for k, r in rels.items()})} "
          f"(limit {tol}); each kernel bit-equal over two launches")
    return {(row, "float32"): (err,) for row, err in errs.items()}


def time_flash(torch, fa, reports, worsts, shape=(16, 512, 12, 64),
               dtypes=None, suffix="", backends=None):
    """The flash rows' times at ``shape`` [B, S, H, D] (by default the
    training shape), causal, no mask, rotating over 4 layers' inputs (150
    MB in bf16 at the training shape, three times the 50 MB L2) as the
    step does, at each dropout rate of ``worsts`` (rate: phase 2's max
    |err| by (output, dtype name)), all as device time
    (:func:`device_ms`), in each of ``dtypes`` (bf16 and fp32 by default):
    bf16 on its routes (the tensor-core forward, dq and dk/dv up to D =
    128; above, the wgmma ones) beside the FMA kernels on the same inputs
    (their first versions' route), which fill the FMA rows above D = 128,
    and fp32 on its routes (the 3xTF32 forward, dq and dk/dv up to D =
    256) beside the FMA kernels on the same inputs, which fill the FMA
    rows; each beside its plain version and SDPA with its backend pinned
    (flash for bf16, memory-efficient for fp32, unless ``backends`` names
    another by dtype name). Row names end in ``suffix``. The tensor-core rows also print their host-paced time
    (:func:`cuda_ms`: 50 back-to-back calls between two events), which
    counts the wrapper's host work where it exceeds the device's. fp32
    bounds count the products at FP32_3XTF32_FLOPS."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, h, d = shape
    scale = 1.0 / d ** 0.5
    it = {"i": 0}

    def nxt(items):
        it["i"] = (it["i"] + 1) % len(items)
        return items[it["i"]]

    for dtype in dtypes or (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        backend = getattr(SDPBackend, (backends or {}).get(name) or (
            "FLASH_ATTENTION" if dtype == torch.bfloat16
            else "EFFICIENT_ATTENTION"))
        layers = [flash_case(torch, dtype, b, s, h, d, seed=100 + i)
                  for i in range(4)]
        q0 = layers[0][1]
        for rate, src in worsts.items():
            drop = (rate, FLASH_DROPOUT_SEED if rate else None)
            prepped = []
            for _qkv, q, k, v, dout, _m in layers:
                out, lse = fa.flash_attention_fwd(q, k, v, None, True,
                                                  scale, *drop)
                delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
                prepped.append((q, k, v, dout, lse, delta.contiguous()))

            def bwd(fn):
                def run():
                    q, k, v, dout, lse, delta = nxt(prepped)
                    return fn(q, k, v, dout, None, lse, delta, True, scale,
                              *drop)
                return run

            def fma(which):
                def run():
                    q, k, v, dout, lse, delta = nxt(prepped)
                    if which == "fwd":
                        return fa._launch_fwd("flash_attention", q, k, v,
                                              None, True, scale, *drop)
                    return (fa._launch_dq if which == "dq" else
                            fa._launch_dkv)("flash_attention", q, k, v,
                                            dout, None, lse, delta, True,
                                            scale, *drop)
                return run

            kern = {"fwd": lambda: fa.flash_attention_fwd(
                        *nxt(prepped)[:3], None, True, scale, *drop),
                    "dq": bwd(fa.flash_attention_bwd_dq),
                    "dkv": bwd(fa.flash_attention_bwd_dkv)}
            plain = {
                "fwd": lambda: fa.flash_attention_reference(
                    *nxt(prepped)[:3], causal=True, dropout_rate=rate,
                    dropout_seed=drop[1]),
                "dq": bwd(fa.flash_bwd_dq_reference),
                "dkv": bwd(fa.flash_bwd_dkv_reference)}
            # yardstick: SDPA (causal) on contiguous [B, H, S, D] copies;
            # at 0.1 its own dropout (Philox bits, another mask): the same
            # work, not the same function
            sdpa_in = []
            with sdpa_kernel(backend):
                for _qkv, q, k, v, dout, _m in layers:
                    qt, kt, vt = (t.transpose(1, 2).contiguous()
                                  .requires_grad_() for t in (q, k, v))
                    o = F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, dropout_p=rate)
                    sdpa_in.append((qt, kt, vt, o,
                                    dout.transpose(1, 2).contiguous()))

                def sdpa_fwd():
                    qt, kt, vt, _o, _do = nxt(sdpa_in)
                    with torch.no_grad():
                        F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, dropout_p=rate)

                def sdpa_bwd():
                    qt, kt, vt, o, dot = nxt(sdpa_in)
                    torch.autograd.grad(o, (qt, kt, vt), dot,
                                        retain_graph=True)

                lib = {"fwd": device_ms(torch, sdpa_fwd, names=True),
                       "bwd": device_ms(torch, sdpa_bwd, names=True)}
            pair = {}
            for key in ("fwd", "dq", "dkv"):
                route = fa._route(dtype, d, key)
                base = {"fwd": "flash_attention_fwd", "dq":
                        "flash_attention_bwd_dq", "dkv":
                        "flash_attention_bwd_dkv"}[key]
                tail = "_dropout" if rate else ""
                row = base + ROW_TAGS[route] + tail + suffix
                kernel_ms, kernel_names = device_ms(torch, kern[key],
                                                    names=True)
                plain_ms, _ = device_ms(torch, plain[key], iters=5,
                                        warmup=1)
                library, lib_names = lib["fwd" if key == "fwd" else "bwd"]
                nbytes, flops = flash_bytes_flops(q0, None, key)
                peak = (BF16_FLOPS if dtype == torch.bfloat16
                        else FP32_3XTF32_FLOPS)
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = flops / peak
                outs = {"fwd": ("fwd",), "dq": ("dq",),
                        "dkv": ("dk", "dv")}[key]
                bound = dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations")
                rep = reports[row]
                rep.update(ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library, **bound,
                           max_abs_err=max(src[(k, name)][0] for k in outs))
                pair[key] = kernel_ms
                extra = ""
                if route != "fma":
                    host_ms = cuda_ms(kern[key])
                    first_ms, _ = device_ms(torch, fma(key))
                    rep.update(host_paced_ms=host_ms, fma_ms=first_ms)
                    pair[key + " fma"] = first_ms
                    extra = (f", host-paced {host_ms:.4f} ms (50 calls "
                             f"between two events), the FMA kernel on the "
                             f"same inputs {first_ms:.4f} ms "
                             f"({first_ms / kernel_ms:.2f}x)")
                    if route in ("tf32", "tc256"):
                        # the FMA rows: the first versions of the
                        # forward, dq and dk/dv, on the same inputs
                        reports[base + tail + suffix].update(
                            ms=first_ms, plain_ms=plain_ms,
                            library_ms=library, **bound,
                            max_abs_err=max(
                                src[(f"{k} (FMA kernel, same inputs)",
                                     name)][0] for k in outs))
                lib_top = {k[:60]: round(v, 4) for k, v in lib_names.items()}
                rate_name = ("3xTF32, 495 / 3" if peak == FP32_3XTF32_FLOPS
                             else f"{peak / 1e12:.0f}")
                print(f"flash_attention {key} timing {name} B={b} S={s} "
                      f"H={h} D={d} causal dropout {rate} ({row}, device "
                      f"time): kernel {kernel_ms:.4f} ms "
                      f"{sorted(kernel_names)}{extra}, plain "
                      f"{plain_ms:.4f} ms, SDPA "
                      f"{'fwd' if key == 'fwd' else 'bwd (dq+dk+dv)'} "
                      f"dropout_p={rate} backend {backend.name} "
                      f"{library:.4f} ms {lib_top}, bound "
                      f"{rep['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 "
                      f"TB/s, {flops} flops / {rate_name} TFLOP/s; the "
                      f"hash's integer operations are not counted)")
            bwd = pair["dq"] + pair["dkv"]
            fma_bwd = (pair.get("dq fma", pair["dq"])
                       + pair.get("dkv fma", pair["dkv"]))
            first = (f"; the FMA pair on the same inputs {fma_bwd:.4f} ms"
                     if "dq fma" in pair or "dkv fma" in pair else "")
            print(f"flash_attention backward summary ({name}, dropout "
                  f"{rate}): dq + dk/dv {bwd:.4f} ms = "
                  f"{bwd / lib['bwd'][0]:.3f}x SDPA's whole backward "
                  f"{lib['bwd'][0]:.4f} ms{first}")
            del prepped, sdpa_in
        del layers
        torch.cuda.empty_cache()


ROW_TAGS = {"tc": "_tc", "tf32": "_tf32", "tc256": "_tc256", "fma": ""}


def time_flash_d256_path(torch, fa, reports, dtype=None):
    """The slice's path: forward + backward through ``flash_attention()``
    at FLASH_D256_SHAPE, causal, in ``dtype`` (bf16 by default, or fp32),
    as a model with 256-wide heads calls it (q, k and v views of one fused
    projection that needs its gradient), beside SDPA's forward + backward
    on contiguous [B, H, S, D] copies (cuDNN in bf16, memory-efficient in
    fp32 with TF32 off), both as device time (:func:`device_ms`). The
    result is first held to the plain path's: in bf16 the gradient within
    one bf16 step + FLASH_16BIT_RMS_TOL["autograd"] of the RMS, in fp32
    the output and the gradient within KERNEL_TOL (dO x 0.1). Every flash
    wrapper's count is set to 0 just before the timed drive and read just
    after: each call must launch the kernels of the routes
    :func:`flash_routes_expected` names once each (bf16: the wgmma
    forward, dq and dk/dv; fp32: the 3xTF32 forward, dq and dk/dv) and
    no other flash kernel, the FMA wrappers' ``.launches_wide`` none;
    their ``_d256`` (bf16) or ``_d256_fp32`` rows take the counts."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dtype = dtype or torch.bfloat16
    name = str(dtype).split(".")[1]
    b, s, h, d = FLASH_D256_SHAPE
    qkv, *_rest, dout, _m = flash_case(torch, dtype, b, s, h, d, seed=321,
                                       dout_scale=FLASH_DOUT_SCALE[name])
    x = qkv.detach().clone().requires_grad_()
    calls = {"n": 0}

    def run(fn):
        x.grad = None
        qq, kk, vv = (t.reshape(b, s, h, d) for t in x.split(h * d, dim=-1))
        out = fn(qq, kk, vv, causal=True)
        out.backward(dout)
        calls["n"] += 1
        return out.detach(), x.grad

    got_o, got = (t.clone() for t in run(fa.flash_attention))
    ref_o, ref = run(fa.flash_attention_reference)
    torch.cuda.synchronize()
    rms = ref.float().pow(2).mean().sqrt().item()
    if dtype == torch.float32:
        err = max((got_o - ref_o).abs().max().item(),
                  (got - ref).abs().max().item())
        held = (f"output and gradient max |err| {err:.3g} against the "
                f"plain path's (limit {KERNEL_TOL[name]}, dO x "
                f"{FLASH_DOUT_SCALE[name]})")
        bad = not err <= KERNEL_TOL[name]
    else:
        rel = (((got.float() - ref.float()).abs()
                - round_step(torch, ref)).clamp_min(0).max().item()
               / max(rms, 1e-30))
        held = (f"gradient {rel:.3g} of the RMS beyond one bf16 step of "
                f"the plain path's (limit "
                f"{FLASH_16BIT_RMS_TOL['autograd']})")
        bad = rel > FLASH_16BIT_RMS_TOL["autograd"]
    if bad or not (torch.isfinite(got).all() and torch.isfinite(got_o).all()):
        fail(f"flash_attention() {name} {FLASH_D256_SHAPE}: {held}")
    wrappers = flash_wrappers(fa)
    for by in wrappers.values():
        for w in by.values():
            w.launches = 0
    take_wide_launches(fa)
    calls["n"] = 0
    path_ms, path_names = device_ms(torch, lambda: run(fa.flash_attention),
                                    names=True)
    torch.cuda.synchronize()
    n = calls["n"]
    grew = {f"{k}/{r}": w.launches for k, by in wrappers.items()
            for r, w in by.items() if w.launches}
    wide = take_wide_launches(fa)
    routes = flash_routes_expected(dtype, d)
    want = {f"{k}/{r}": n for k, r in zip(("fwd", "dq", "dkv"), routes)}
    want_wide = dict.fromkeys(("fwd", "dq", "dkv"), 0)
    if grew != want or wide != want_wide:
        fail(f"flash_attention() {name} {FLASH_D256_SHAPE}: {n} calls "
             f"launched {grew}, FMA launches above D = 128 {wide} "
             f"(expected {want}, {want_wide})")
    suffix = "_d256" if dtype == torch.bfloat16 else "_d256_fp32"
    for base, r in zip(FLASH_FMA_NAMES, routes):
        reports[base + ROW_TAGS[r] + suffix]["launches"] = n
    q, k, v = (t.reshape(b, s, h, d).detach() for t in qkv.split(h * d, -1))
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()

    def sdpa():
        for t in (qt, kt, vt):
            t.grad = None
        F.scaled_dot_product_attention(qt, kt, vt,
                                       is_causal=True).backward(dot)

    backend = (SDPBackend.CUDNN_ATTENTION if dtype == torch.bfloat16
               else SDPBackend.EFFICIENT_ATTENTION)
    with sdpa_kernel(backend):
        lib_ms, lib_names = device_ms(torch, sdpa, names=True)
    top = {k[:60]: round(t, 4) for k, t in sorted(
        path_names.items(), key=lambda kv: -kv[1])[:6]}
    lib_top = {k[:60]: round(t, 4) for k, t in lib_names.items()}
    print(f"flash_attention() forward + backward, the slice's path ({name} "
          f"B={b} S={s} H={h} D={d} causal, device time): {path_ms:.4f} ms "
          f"a call; {n} calls launched {grew} (the FMA wrappers' "
          f".launches_wide {wide}); kernels {top}; SDPA forward + "
          f"backward ({backend.name}) {lib_ms:.4f} ms {lib_top}: "
          f"{path_ms / lib_ms:.2f}x; {held}")


# bench_bert's attention shapes ([B, S, H, D], bert-large: 16 heads of 64)
# at seq 128 (micro 32) and seq 512 (micro 8), and the kernels line's rows
FLASH_BERT_SHAPES = (("bert128", 32, 128, 16, 64), ("bert512", 8, 512, 16, 64))
# lse: fp32 scores of 16-bit products summed in another order, as
# SPARSE_LSE_TOL
FLASH_LSE_TOL = 1e-5


def hold_flash(torch, fa, q, k, v, dout, mask, scale, what, causal=False,
               fma=False):
    """The forward (o and lse), dq and dk/dv kernels of the route, causal
    or not, under the key ``mask`` (or none), against their plain versions
    on one 16-bit input: o, dq, dk and dv within one rounding step of the
    dtype + FLASH_16BIT_RMS_TOL["kernel"] of the reference's RMS, lse
    within FLASH_LSE_TOL, each kernel bit-equal over two launches. With
    ``fma``, the FMA forward, dq and dk/dv (their first versions) are held
    the same way on the same inputs. Returns the max |err| by row key
    (fwd: o; dkv: dk and dv; "fwd fma", "dq fma" and "dkv fma" with
    ``fma``)."""
    dtype = q.dtype
    q, k, v, mp = fa._prepare(q, k, v, mask, causal)
    sq, sk = q.shape[1], k.shape[1]
    fwds = [fa.flash_attention_fwd(q, k, v, mp, causal, scale)
            for _ in range(2)]
    out, lse = fwds[0]
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    args = (q, k, v, dout, mp, lse, delta, causal, scale)
    dqs = [fa.flash_attention_bwd_dq(*args) for _ in range(2)]
    dkvs = [fa.flash_attention_bwd_dkv(*args) for _ in range(2)]
    runs = {"fwd": fwds, "dq": [(t,) for t in dqs], "dkv": dkvs}
    if fma:
        runs["fwd fma"] = [fa._launch_fwd("flash_attention", q, k, v, mp,
                                          causal, scale, 0.0, None)
                           for _ in range(2)]
        runs["dq fma"] = [(fa._launch_dq("flash_attention", *args, 0.0,
                                         None),) for _ in range(2)]
        runs["dkv fma"] = [fa._launch_dkv("flash_attention", *args, 0.0,
                                          None) for _ in range(2)]
    torch.cuda.synchronize()
    for key, (one, two) in runs.items():
        if not all(same_bits(torch, a, b) for a, b in zip(one, two)):
            fail(f"flash {key} {what}: two launches on one input differ")
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    vis = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        vis = vis.tril(sk - sq)
    if mask is not None:
        vis = vis & mask[:, None, None, :]
    lse_w = scores.masked_fill(~vis, float("-inf")).logsumexp(-1)
    del scores
    lse_err = max((runs[key][0][1] - lse_w).abs().max().item()
                  for key in runs if key.startswith("fwd"))
    if not lse_err <= FLASH_LSE_TOL:
        fail(f"flash lse {what}: max |err| {lse_err}")
    o_w = fa.flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
    dq_w = fa.flash_bwd_dq_reference(*args)
    dk_w, dv_w = fa.flash_bwd_dkv_reference(*args)
    pairs = {"fwd": [(out, o_w)], "dq": [(dqs[0], dq_w)],
             "dkv": [(dkvs[0][0], dk_w), (dkvs[0][1], dv_w)]}
    if fma:
        pairs["fwd fma"] = [(runs["fwd fma"][0][0], o_w)]
        pairs["dq fma"] = [(runs["dq fma"][0][0], dq_w)]
        pairs["dkv fma"] = [(runs["dkv fma"][0][0], dk_w),
                            (runs["dkv fma"][0][1], dv_w)]
    errs, rels = {}, {}
    for key, both in pairs.items():
        for got, ref in both:
            ref = ref.float()
            diff = (got.float() - ref).abs()
            rms = ref.pow(2).mean().sqrt().item()
            rel = ((diff - round_step(torch, ref, dtype)).clamp_min(0).max()
                   .item() / max(rms, 1e-30))
            err = diff.max().item()
            errs[key] = max(errs.get(key, 0.0), err)
            rels[key] = max(rels.get(key, 0.0), rel)
            if not torch.isfinite(got).all() or \
                    rel > FLASH_16BIT_RMS_TOL["kernel"]:
                fail(f"flash {key} {what}: max |err| {err} (reference "
                     f"RMS {rms}); beyond one rounding step {rel} of the "
                     f"RMS")
    print(f"flash_attention {what} against the plain versions: max |err| "
          f"{json.dumps(errs)}, beyond one rounding step "
          f"{json.dumps({k: float(f'{r:.3g}') for k, r in rels.items()})} "
          f"of the RMS (limit {FLASH_16BIT_RMS_TOL['kernel']}), lse "
          f"{lse_err:.3g} (limit {FLASH_LSE_TOL}); each kernel bit-equal "
          f"over two launches")
    return errs


def time_flash_bert(torch, fa, reports):
    """The flash rows at bench_bert's two shapes, bf16, non-causal under
    bench_bert's key mask (every key valid, as its batches are), rotating
    over 4 layers' inputs, as device time: the tensor-core forward, dq
    and dk/dv beside their plain versions (host-paced), SDPA with the
    boolean [B, 1, 1, S] mask (the memory-efficient backend, the one that
    takes a mask: its forward, and its whole backward for dq and dk/dv)
    and the bound. First each kernel is held to its plain version
    (:func:`hold_flash`) on the first layer's inputs, under that
    mask and under a padded one (lengths drawn in [S / 2, S], as phase
    8's padded batch); each row's max |err| is the larger of the two."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dtype = torch.bfloat16
    for label, b, s, h, d in FLASH_BERT_SHAPES:
        scale = 1.0 / d ** 0.5
        mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
        lens = np.random.default_rng(6).integers(s // 2, s + 1, b)
        padded = torch.from_numpy(np.arange(s)[None] < lens[:, None]).cuda()
        layers = []
        for i in range(4):
            _qkv, q, k, v, dout, _m = flash_case(torch, dtype, b, s, h, d,
                                                 seed=300 + i)
            if i == 0:
                errs = {}
                for tag, m in (("all keys", mask), ("padded", padded)):
                    one = hold_flash(
                        torch, fa, q, k, v, dout, m, scale,
                        f"bf16 [{b}, {s}, {h}, {d}] non-causal, {tag}")
                    errs = {key: max(errs.get(key, 0.0), e)
                            for key, e in one.items()}
            q, k, v, mp = fa._prepare(q, k, v, mask, False)
            out, lse = fa.flash_attention_fwd(q, k, v, mp, False, scale)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            layers.append((q, k, v, dout, mp, lse, delta.contiguous()))
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(layers)
            return layers[it["i"]]

        def bwd(fn):
            def run():
                q, k, v, dout, mp, lse, delta = nxt()
                return fn(q, k, v, dout, mp, lse, delta, False, scale)
            return run

        def fwd(fn):
            def run():
                q, k, v, _dout, mp, _lse, _delta = nxt()
                return fn(q, k, v, mp, False, scale)
            return run

        def plain_fwd():
            q, k, v, *_ = nxt()
            return fa.flash_attention_reference(q, k, v, causal=False,
                                                kv_mask=mask)

        kern = {"fwd": fwd(fa.flash_attention_fwd),
                "dq": bwd(fa.flash_attention_bwd_dq),
                "dkv": bwd(fa.flash_attention_bwd_dkv)}
        plain = {"fwd": plain_fwd, "dq": bwd(fa.flash_bwd_dq_reference),
                 "dkv": bwd(fa.flash_bwd_dkv_reference)}
        am = mask[:, None, None, :]
        sdpa_in = []
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            for q, k, v, dout, *_ in layers:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              .requires_grad_() for t in (q, k, v))
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
                sdpa_in.append((qt, kt, vt, o,
                                dout.transpose(1, 2).contiguous()))
            sit = {"i": 0}

            def snxt():
                sit["i"] = (sit["i"] + 1) % len(sdpa_in)
                return sdpa_in[sit["i"]]

            def sdpa_fwd():
                qt, kt, vt, _o, _do = snxt()
                with torch.no_grad():
                    F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

            def sdpa_bwd():
                qt, kt, vt, o, dot = snxt()
                torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

            lib = {"fwd": device_ms(torch, sdpa_fwd, names=True),
                   "bwd": device_ms(torch, sdpa_bwd, names=True)}
        times = {}
        for key in ("fwd", "dq", "dkv"):
            row = {"fwd": "flash_attention_fwd_tc", "dq":
                   "flash_attention_bwd_dq_tc", "dkv":
                   "flash_attention_bwd_dkv_tc"}[key] + "_" + label
            kernel_ms, kernel_names = device_ms(torch, kern[key], names=True)
            plain_ms, _ = device_ms(torch, plain[key], iters=5, warmup=1)
            library, lib_names = lib["fwd" if key == "fwd" else "bwd"]
            nbytes, flops = flash_bytes_flops(layers[0][0], mask, key,
                                              causal=False)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / BF16_FLOPS
            rep = reports[row]
            rep.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations",
                       max_abs_err=errs[key])
            times[key] = kernel_ms
            lib_top = {k[:60]: round(v, 4) for k, v in lib_names.items()}
            print(f"flash_attention {key} timing bf16 B={b} S={s} H={h} "
                  f"D={d} non-causal, bench_bert's key mask ({row}, device "
                  f"time): kernel {kernel_ms:.4f} ms {sorted(kernel_names)}, "
                  f"plain {plain_ms:.4f} ms, SDPA "
                  f"{'fwd' if key == 'fwd' else 'bwd (dq+dk+dv)'} with the "
                  f"[B, 1, 1, S] bool mask, backend EFFICIENT_ATTENTION "
                  f"{library:.4f} ms {lib_top}, bound "
                  f"{rep['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s, "
                  f"{flops} flops / 989 TFLOP/s)")
        print(f"flash_attention {label} summary (bf16, non-causal, key "
              f"mask): forward {times['fwd']:.4f} ms = "
              f"{times['fwd'] / lib['fwd'][0]:.3f}x SDPA's "
              f"{lib['fwd'][0]:.4f}; dq + dk/dv "
              f"{times['dq'] + times['dkv']:.4f} ms = "
              f"{(times['dq'] + times['dkv']) / lib['bwd'][0]:.3f}x SDPA's "
              f"whole backward {lib['bwd'][0]:.4f}")
        del layers, sdpa_in
        torch.cuda.empty_cache()


def check_flash_dropout_mask(torch, dtype, d):
    """The keep-mask read back out of the forward, dq and dk/dv kernels
    that ``dtype`` and head dim ``d`` route to, bit for bit against
    ``dropout_keep_mask``: non-causal at [2, 2048, 2, d] (fp32 at d = 256:
    the 3xTF32 forward, dq and dk/dv; bf16 at d = 256: the
    wgmma forward, dq and dk/dv; fp32 at d = 64: the 3xTF32 forward, dq
    and dk/dv;
    bf16 at d = 64: the tensor-core kernels). The key
    mask keeps only the last d cols, c0 = 2048 - d onwards, and V is the
    identity on them (V[j, c] = 1 iff j = c0 + c), so o[i, c] != 0 iff
    score (i, c0 + c) was kept; dO is the identity on rows 1024 to 1023 +
    d, so dv[j, c] != 0 iff score (1024 + c, j) was kept, for j in the
    window. For dq, K is the identity on the window too (zero elsewhere),
    dO is all ones and delta 0, so ds[i, j] = p D dp = p D is non-zero on
    the window iff kept, and dq[i, c] = scale ds[i, c0 + c]."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    b, s, h, r0 = 2, 2048, 2, 1024
    c0 = s - d
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k = ((torch.randn(b, s, h, d, generator=g) * 0.5).to("cuda", dtype)
            for _ in range(2))
    eye = torch.eye(d, device="cuda", dtype=dtype)
    v = torch.zeros(b, s, h, d, device="cuda", dtype=dtype)
    v[:, c0:c0 + d] = eye[None, :, None, :]
    dout = torch.zeros(b, s, h, d, device="cuda", dtype=dtype)
    dout[:, r0:r0 + d] = eye[None, :, None, :]
    mask = torch.zeros(b, s, device="cuda")
    mask[:, c0:] = 1.0
    scale = 1.0 / d ** 0.5
    drop = (FLASH_DROPOUT, FLASH_DROPOUT_SEED)
    routes = flash_routes_expected(dtype, d)
    wrappers = flash_wrappers(fa)
    before = {(k, r): w.launches for k, by in wrappers.items()
              for r, w in by.items()}
    qp, kp, vp, mp = fa._prepare(q, k, v, mask, False)
    out, lse = fa.flash_attention_fwd(qp, kp, vp, mp, False, scale, *drop)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    _dk, dv = fa.flash_attention_bwd_dkv(qp, kp, vp, dout, mp, lse,
                                         delta.contiguous(), False, scale,
                                         *drop)
    k_eye = v.clone()                  # the identity on the window
    _o, lse_eye = fa.flash_attention_fwd(qp, k_eye, vp, mp, False, scale,
                                         *drop)
    ones = torch.ones(b, s, h, d, device="cuda", dtype=dtype)
    zeros = torch.zeros(b, h, s, device="cuda")
    dq = fa.flash_attention_bwd_dq(qp, k_eye, vp, ones, mp, lse_eye, zeros,
                                   False, scale, *drop)
    torch.cuda.synchronize()
    grew = {f"{k}/{r}": w.launches - before[(k, r)]
            for k, by in wrappers.items() for r, w in by.items()
            if w.launches > before[(k, r)]}
    want = {f"{k}/{r}": n for k, r, n in zip(wrappers, routes, (2, 1, 1))}
    if grew != want:
        fail(f"flash dropout mask readout ({dtype}, D={d}): launches "
             f"{grew}, expected {want}")
    ar = torch.arange(s, device="cuda")
    cols = torch.arange(c0, c0 + d, device="cuda")
    flips_o = flips_dv = flips_dq = 0
    for bb in range(b):
        for hh in range(h):
            bh = bb * h + hh
            want = fa.dropout_keep_mask(FLASH_DROPOUT_SEED, bh, ar[:, None],
                                        cols[None, :], FLASH_DROPOUT)
            flips_o += int(((out[bb, :, hh] != 0) != want).sum())
            flips_dq += int(((dq[bb, :, hh] != 0) != want).sum())
            want_dv = fa.dropout_keep_mask(
                FLASH_DROPOUT_SEED, bh, torch.arange(r0, r0 + d,
                                                     device="cuda")[None, :],
                cols[:, None], FLASH_DROPOUT)          # [key j, row c]
            flips_dv += int(((dv[bb, c0:, hh] != 0) != want_dv).sum())
    kept = float((out != 0).float().mean())
    name = str(dtype).split(".")[1]
    print(f"flash dropout mask readout ({name}, non-causal, [{b}, {s}, {h}, "
          f"{d}], rate {FLASH_DROPOUT}, {'/'.join(routes)} kernels): "
          f"forward "
          f"{b * h * s * d} scores, {flips_o} differ from dropout_keep_mask;"
          f" dq {b * h * s * d} scores, {flips_dq} differ; dk/dv "
          f"{b * h * d * d} scores, {flips_dv} differ; kept share "
          f"{kept:.4f}")
    if flips_o or flips_dv or flips_dq:
        fail(f"flash dropout ({name}): the kernels' keep-mask differs from "
             "dropout_keep_mask")


# ---------------------------------------------------------------------------
# 2d. block-sparse attention forward and backward against their plain
#     versions
# ---------------------------------------------------------------------------

# bench.py:bench_gpt2_long's layout: BigBird at block 256, causal
SPARSE_LONG = {"mode": "bigbird", "block": 256, "num_random_blocks": 1,
               "num_sliding_window_blocks": 3, "num_global_blocks": 1,
               "attention": "unidirectional"}
SPARSE_SEQ = 16384
# lse: the same fp32 scores summed in another order (the tensor-core
# forward: 16-bit products, exact in fp32, its softmax in base 2, the lse
# converted once); the fp32 forwards' (3xTF32, FMA) are held to the same
# 1e-5
SPARSE_LSE_TOL = 1e-5
# BigBird at block 64, bidirectional: its global rows and columns walk
# every block, so dq and dk/dv both split
SPARSE_BIDIR = {"mode": "bigbird", "block": 64, "num_random_blocks": 1,
                "num_sliding_window_blocks": 3, "num_global_blocks": 1,
                "attention": "bidirectional"}
# (case, B, S, H, D, layout, causal, key mask, dtypes, caps): (a) the
# path's layout at seq 4096, (b) the reference's default block 16,
# bidirectional, with a key mask whose second batch row is all padding
# (rows with no visible key), (c) the path's own shape, (d) SPARSE_BIDIR
# with (b)'s key mask: the tensor-core route's key-mask and non-causal
# branches, (e) and (f) its other head dims: D = 128 (dq reads q and dO
# from shared memory, dk/dv streams 32-query steps) causal with the key
# mask, and D = 72 (zero-padded to 80); (g) BigBird at block 32, causal,
# with the key mask (lists differ inside a 16-row item: the per-warp
# bits at work) and (h) D = 128 at the BigBird block 16, causal, with the
# key mask; (i) D = 8 there, fp32. 16 bits take the tensor-core forward,
# dq and dk/dv: the 64-row kernels at blocks of 64 and more, the 16-row
# kernels at (b), (g) and (h). fp32 ((a), (b), (f), (h), (i): head dims
# 64, 72, 128 and 8, blocks 256, 64 and 16, the all-padding row) takes
# the 3xTF32 forward, dq and dk/dv over the 16-row lists.
# ``caps``: split caps the tensor-core kernels also run at (beside
# SPLIT_CAP): SPARSE_SMALL_CAP tiles of 64 rows on the 64-row route,
# SPARSE_SMALL_CAP16 steps of 64 rows on the 16-row lists (the 3xTF32
# forward, dq and dk/dv at (f) take SPARSE_SMALL_CAP steps).
SPARSE_SMALL_CAP = 4             # every walk longer than 4 tiles splits
SPARSE_SMALL_CAP16 = 1           # every walk longer than 4 blocks splits
SPARSE_CASES = (
    ("a", 1, 4096, 12, 64, SPARSE_LONG, True, False,
     ("float32", "bfloat16", "float16"), ()),
    ("b", 2, 1024, 12, 64, {"mode": "fixed", "block": 16}, False, True,
     ("float32", "bfloat16"), (SPARSE_SMALL_CAP16,)),
    ("c", 1, SPARSE_SEQ, 12, 64, SPARSE_LONG, True, False,
     ("bfloat16", "float16"), ()),
    ("d", 2, 2048, 12, 64, SPARSE_BIDIR, False, True,
     ("bfloat16", "float16"), (SPARSE_SMALL_CAP,)),
    ("e", 2, 2048, 4, 128, dict(SPARSE_LONG, block=128), True, True,
     ("bfloat16", "float16"), (SPARSE_SMALL_CAP,)),
    ("f", 1, 1024, 4, 72, {"mode": "fixed", "block": 64}, False, False,
     ("bfloat16", "float32"), (SPARSE_SMALL_CAP,)),
    ("g", 2, 1024, 12, 64, dict(SPARSE_LONG, block=32), True, True,
     ("bfloat16",), (SPARSE_SMALL_CAP16,)),
    ("h", 2, 1024, 4, 128, dict(SPARSE_LONG, block=16), True, True,
     ("bfloat16", "float16", "float32"), (SPARSE_SMALL_CAP16,)),
    ("i", 2, 1024, 4, 8, dict(SPARSE_LONG, block=16), True, True,
     ("float32",), (SPARSE_SMALL_CAP16,)))
SPARSE_SWEEP_CAPS = (4, 8, 16, 32, 64, 128, None)   # None: no split
SPARSE_TC_NAMES = ("sparse_attention_bwd_dq_tc",
                   "sparse_attention_bwd_dkv_tc")
# the FMA forward, dq and dk/dv: the first versions, on no path
SPARSE_FMA_NAMES = ("sparse_attention_fwd", "sparse_attention_bwd_dq",
                    "sparse_attention_bwd_dkv")
# the fp32 forward, dq and dk/dv (3xTF32 over the 16-row lists)
SPARSE_TF32_NAMES = ("sparse_attention_fwd_tf32",
                     "sparse_attention_bwd_dq_tf32",
                     "sparse_attention_bwd_dkv_tf32")
# the 16-row route's three kernels (the sparse BERT step's)
SPARSE_TC16_NAMES = ("sparse_attention_fwd_tc16",
                     "sparse_attention_bwd_dq_tc16",
                     "sparse_attention_bwd_dkv_tc16")


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


def same_bits(torch, a, b):
    """Bit-equality of two tensors of one floating dtype."""
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


# each output's kernel, whose route it takes ("dq cap 1": dq's)
SPARSE_WHICH = {"fwd": "fwd", "dq": "dq", "dk": "dkv", "dv": "dkv",
                "autograd out": "fwd", "autograd dqkv": "dq"}


def sparse_kernel_of(key):
    return SPARSE_WHICH.get(key) or SPARSE_WHICH[key.split()[0]]


def check_sparse_attention(torch, reports, cases=SPARSE_CASES, timing=True):
    """Kernels #8-#10 against their plain versions in ``cases``: each
    kernel and, but at (c), the whole autograd path, with flash's
    tolerances (the 3xTF32 dq and dk/dv: 1e-5 of the reference's largest
    |value|); each on the route ``sparse_attention._route`` picks for it
    (each call counted by its route's wrapper only), the tensor-core
    kernels also at their small caps; every output bit-equal over two
    launches. Then, with
    ``timing``, timing at (c), the path's shape, and the sweep of the
    split cap (:func:`time_sparse`). ``reports``: the kernels line's rows
    ("fwd", "dq", "dkv" for the FMA kernels, "fwd_tc", "dq_tc",
    "dkv_tc", "fwd_tf32", "dq_tf32", "dkv_tf32")."""
    sp = sparse_module()
    counters = {("fwd", "fma"): sp.sparse_attention_fwd,
                ("fwd", "tc"): sp.sparse_attention_fwd_tc,
                ("fwd", "tc16"): sp.sparse_attention_fwd_tc16,
                ("fwd", "tf32"): sp.sparse_attention_fwd_tf32,
                ("dq", "fma"): sp.sparse_attention_bwd_dq,
                ("dq", "tc"): sp.sparse_attention_bwd_dq_tc,
                ("dq", "tc16"): sp.sparse_attention_bwd_dq_tc16,
                ("dq", "tf32"): sp.sparse_attention_bwd_dq_tf32,
                ("dkv", "fma"): sp.sparse_attention_bwd_dkv,
                ("dkv", "tc"): sp.sparse_attention_bwd_dkv_tc,
                ("dkv", "tc16"): sp.sparse_attention_bwd_dkv_tc16,
                ("dkv", "tf32"): sp.sparse_attention_bwd_dkv_tf32}
    # each route's forward, dq and dk/dv wrappers at a cap
    at_cap = {"tc": (sp.sparse_attention_fwd_tc,
                     sp.sparse_attention_bwd_dq_tc,
                     sp.sparse_attention_bwd_dkv_tc),
              "tc16": (sp.sparse_attention_fwd_tc16,
                       sp.sparse_attention_bwd_dq_tc16,
                       sp.sparse_attention_bwd_dkv_tc16),
              "tf32": (sp.sparse_attention_fwd_tf32,
                       sp.sparse_attention_bwd_dq_tf32,
                       sp.sparse_attention_bwd_dkv_tf32)}
    worst = {}

    def hold(key, case, name, route, got, ref):
        if not torch.isfinite(got).all():
            fail(f"sparse {key} {case} {name}: non-finite output")
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        rms = ref.float().pow(2).mean().sqrt().item()
        if name == "float32":
            # the 3xTF32 dq and dk/dv: 1e-5 of the largest |value|; every
            # forward's o: atol 1e-5
            top = (ref.abs().max().item() if route == "tf32"
                   and sparse_kernel_of(key) != "fwd" else 1.0)
            rel, bad = err / max(top, 1e-30), err > KERNEL_TOL[name] * top
        else:
            step = round_step(torch, ref, getattr(torch, name))
            rel = ((diff - step).clamp_min(0).max().item()
                   / max(rms, 1e-30))
            bad = rel > FLASH_16BIT_RMS_TOL[
                "autograd" if key.startswith("autograd") else "kernel"]
        if bad:
            fail(f"sparse {key} {case} {name} ({route}): max |err| {err} "
                 f"(reference RMS {rms}); {rel} of the largest |value| "
                 f"(fp32) or of the RMS beyond one {name} step")
        w = worst.get((key, name, route))
        if w is None or err > w[0]:
            worst[(key, name, route)] = (err, rms, rel)

    for (case, b, s, h, d, block_cfg, causal, masked, dtypes,
         caps) in cases:
        scale = 1.0 / d ** 0.5
        layout = sparse_layout(block_cfg, h, s)
        block = block_cfg["block"]
        plan = sp.sparse_plan(layout, block)
        for name in dtypes:
            dtype = getattr(torch, name)
            routes = {w: sp._route(dtype, d, block, w)
                      for w in ("fwd", "dq", "dkv")}
            route = routes["dq"]            # the backward's
            qkv, q, k, v, dout, mask = flash_case(
                torch, dtype, b, s, h, d,
                seed=s + masked if d == 64 else s + d, masked=masked,
                dout_scale=FLASH_DOUT_SCALE[name])
            if masked:
                mask[0, s - 100:] = False      # row 1 is all padding
            qp, kp, vp, mp = sp._prepare(q, k, v, mask, plan)
            if qp.data_ptr() != q.data_ptr():
                fail("sparse_attention copied an aligned strided view")
            before = {key: w.launches for key, w in counters.items()}
            out, lse = sp.sparse_attention_fwd(qp, kp, vp, mp, plan, causal,
                                               scale)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            args = (dout, mp, lse, delta.contiguous(), plan, causal, scale)
            dq = sp.sparse_attention_bwd_dq(qp, kp, vp, *args)
            dk, dv = sp.sparse_attention_bwd_dkv(qp, kp, vp, *args)
            grew = {f"{k}/{r}": w.launches - before[(k, r)]
                    for (k, r), w in counters.items()}
            want = {f"{k}/{r}": int(r == routes[k]) for k, r in counters}
            if grew != want:
                fail(f"sparse {case} {name}: routed to {routes}, launches "
                     f"{grew}")
            got = {"fwd": out, "dq": dq, "dk": dk, "dv": dv}
            lses = {"": (lse,)}
            again = dict(zip(("fwd", "lse"), sp.sparse_attention_fwd(
                qp, kp, vp, mp, plan, causal, scale)))
            lses[""] += (again.pop("lse"),)
            again["dq"] = sp.sparse_attention_bwd_dq(qp, kp, vp, *args)
            again["dk"], again["dv"] = sp.sparse_attention_bwd_dkv(
                qp, kp, vp, *args)
            if route in ("tc16", "tf32"):
                w16 = [plan.work16(w, causal) for w in ("dq", "dkv")]
                print(f"sparse_attention {case} {name}: 16-row work lists "
                      f"(the forward and dq, dk/dv): items "
                      f"{[w.n_items for w in w16]}, "
                      f"masked share "
                      f"{[round(w.masked_share, 4) for w in w16]}")
            for cap in caps if route in at_cap else ():
                fwd_c, dq_c, dkv_c = at_cap[route]
                works = plan.work if route == "tc" else plan.work16
                # every walk of the route's kernels splits here
                for which in ("fwd", "dq", "dkv"):
                    if not works(which, causal, cap).n_split:
                        fail(f"sparse {case}: the {which} walks do not "
                             f"split at cap {cap}")
                tag = f" cap {cap}"
                lses[tag] = ()
                for sink in (got, again):
                    sink["fwd" + tag], lse_c = fwd_c(
                        qp, kp, vp, mp, plan, causal, scale, cap=cap)
                    lses[tag] += (lse_c,)
                    sink["dq" + tag] = dq_c(qp, kp, vp, *args, cap=cap)
                    sink["dk" + tag], sink["dv" + tag] = dkv_c(
                        qp, kp, vp, *args, cap=cap)
            torch.cuda.synchronize()
            for tag, (first, second) in lses.items():
                if not same_bits(torch, first, second):
                    fail(f"sparse lse{tag} {case} {name}: differs between "
                         f"launches")
            for key, t in got.items():
                if not same_bits(torch, t, again[key]):
                    fail(f"sparse {key} {case} {name} ("
                         f"{routes[sparse_kernel_of(key)]}): differs "
                         f"between two launches")
            want, want_lse = sp.sparse_fwd_reference(q, k, v, mp, plan,
                                                     causal, scale)
            dq_w = sp.sparse_bwd_dq_reference(q, k, v, *args)
            dk_w, dv_w = sp.sparse_bwd_dkv_reference(q, k, v, *args)
            ref = {"fwd": want, "dq": dq_w, "dk": dk_w, "dv": dv_w}
            pairs = {key: (t, ref[key.split()[0]]) for key, t in got.items()}
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
            for tag, (got_lse, _b) in lses.items():
                if not torch.equal(seen, got_lse > sp.NEG_INF / 2) or \
                        not (got_lse[~seen] == sp.NEG_INF).all():
                    fail(f"sparse lse{tag} {case} {name}: empty rows differ")
                lse_err = (got_lse - want_lse)[seen].abs().max().item()
                if not lse_err <= SPARSE_LSE_TOL:
                    fail(f"sparse lse{tag} {case} {name} ({routes['fwd']}): "
                         f"max |err| {lse_err}")
                key = ("lse", name, routes["fwd"])
                if lse_err >= worst.get(key, (0.0,))[0]:
                    worst[key] = (lse_err, 0.0, 0.0)
            for key, (t, r) in pairs.items():
                hold(key, case, name, routes[sparse_kernel_of(key)], t, r)
            if masked:
                if any(t[1].abs().max().item() != 0.0
                       for t in got.values()):
                    fail(f"sparse {case} {name}: the all-padding batch row "
                         f"is not exactly zero")
                print(f"sparse_attention {case} {name} ({routes}): batch "
                      f"row 1 (all padding): "
                      f"{', '.join(got)} exactly 0, lse -1e30")
            del qkv, q, k, v, dout, out, lse, want, want_lse, dq, dk, dv
            del lses
            del dq_w, dk_w, dv_w, pairs, got, again, ref
            torch.cuda.empty_cache()
    print(f"sparse_attention worst errors over the cases "
          f"{[c[0] for c in cases]} of SPARSE_CASES ((a) [1,4096,12,64] "
          f"bigbird-256 causal, (b) [2,1024,12,64] fixed-16 bidirectional "
          f"with a key mask, (c) [1,16384,12,64] bigbird-256 causal, (d) "
          f"[2,2048,12,64] bigbird-64 bidirectional with a key mask, (e) "
          f"[2,2048,4,128] bigbird-128 causal with a key mask, (f) "
          f"[1,1024,4,72] fixed-64 bidirectional, (g) [2,1024,12,64] "
          f"bigbird-32 causal with a key mask, (h) [2,1024,4,128] "
          f"bigbird-16 causal with a key mask, (i) (h) at D = 8; (d)-(f) "
          f"also at cap {SPARSE_SMALL_CAP}, (b), (g)-(i) at cap "
          f"{SPARSE_SMALL_CAP16}), dO x 0.1 in fp32 and x 1 in 16 bits; "
          f"each output by dtype and route:")
    for key, name, route in sorted(worst):
        err, rms, rel = worst[(key, name, route)]
        path = "autograd" if key.startswith("autograd") else "kernel"
        lim = (f"limit {SPARSE_LSE_TOL}" if key == "lse" else
               f"{rel:.3g} of the largest |value|, limit 1e-5"
               if route == "tf32" and sparse_kernel_of(key) != "fwd" else
               "atol 1e-5" if name == "float32" else
               f"beyond one step {rel:.3g} of the RMS, limit "
               f"{FLASH_16BIT_RMS_TOL[path]}")
        print(f"  {key} {name} ({route}): max |err| {err:.3g}, reference "
              f"RMS {rms:.3g} ({lim})")
    if timing:
        time_sparse(torch, sp, reports, worst)
    return worst


def time_sparse(torch, sp, reports, worst):
    """The tensor-core rows' times at the path's shape [1, 16384, 12, 64]
    bf16, BigBird 256, causal, rotating over 4 layers' inputs (300 MB of
    q/k/v, six times the 50 MB L2) as the step does, as device time: the
    forward, dq and dk/dv beside the FMA kernels (their first versions) on
    the same inputs, the plain versions (host-paced), SDPA with the
    layout-expanded mask (the forward, and its whole backward for the
    pair) and the bound. Then the tensor-core kernels at every cap of
    SPARSE_SWEEP_CAPS: the split's items, split tiles, pieces and longest
    walk, and their device time; the forward's sweep; and the fp32 rows
    at this shape (:func:`time_sparse_fp32`)."""
    import torch.nn.functional as F

    h, d = 12, 64
    scale = 1.0 / d ** 0.5
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

    def call(which, how, cap=None):
        """One call of ``which`` ("fwd", "dq", "dkv") by ``how``: "plain",
        "fma" or "tc" (at ``cap``)."""
        def go():
            a = nxt()
            if which == "fwd":
                fa = (*a[:3], a[4], *a[7:])
                if how == "tc":
                    return sp.sparse_attention_fwd_tc(*fa, cap=cap)
                return (sp.sparse_fwd_reference if how == "plain" else
                        sp._launch_fma_fwd)(*fa)
            if how == "plain":
                return (sp.sparse_bwd_dq_reference if which == "dq" else
                        sp.sparse_bwd_dkv_reference)(*a)
            if how == "fma":
                return sp._launch_fma(which, *a)
            return (sp.sparse_attention_bwd_dq_tc if which == "dq" else
                    sp.sparse_attention_bwd_dkv_tc)(*a, cap=cap)
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

    sdpa_fwd_ms = device_ms(torch, sdpa_fwd, iters=5, warmup=2)[0]
    sdpa_bwd_ms = device_ms(torch, sdpa_bwd, iters=5, warmup=2)[0]
    del sdpa_in
    torch.cuda.empty_cache()
    q0 = layers[0][1]
    npairs = sparse_pairs(layout, block, True)
    plain = {which: cuda_ms(call(which, "plain"), iters=2, warmup=1)
             for which in ("fwd", "dq", "dkv")}
    times = {}
    for row, which, how in (("fwd", "fwd", "fma"), ("dq", "dq", "fma"),
                            ("dkv", "dkv", "fma"), ("fwd_tc", "fwd", "tc"),
                            ("dq_tc", "dq", "tc"), ("dkv_tc", "dkv", "tc")):
        times[row] = device_ms(torch, call(which, how), iters=20,
                               warmup=3)[0]
        if how == "fma":   # beside the tensor-core rows; the FMA rows'
            continue       # own readings are fp32's (time_sparse_fp32)
        lib = sdpa_fwd_ms if which == "fwd" else sdpa_bwd_ms
        nbytes, flops = sparse_bytes_flops(q0, npairs, which)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_FLOPS
        route = "tc" if how == "tc" else "fma"
        keys = {"fwd": ("fwd",), "dq": ("dq",), "dkv": ("dk", "dv")}[which]
        errs = [w[0] for (k, _n, r), w in worst.items()
                if k.split()[0] in keys and r == route]
        rep = reports[row]
        rep.update(ms=times[row], plain_ms=plain[which], library_ms=lib,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(errs))
        fma_ms = times[which]
        rep["fma_ms"] = fma_ms
        extra = (f", the FMA kernel on the same inputs {fma_ms:.4f} ms "
                 f"({fma_ms / times[row]:.2f}x)")
        print(f"sparse_attention {row} timing bf16 B={b} S={s} H={h} D={d} "
              f"bigbird block {block} causal ({npairs} visible pairs, "
              f"{npairs / (h * s * (s + 1) / 2):.4f} of the causal square; "
              f"device time): kernel {times[row]:.4f} ms{extra}, plain "
              f"{plain[which]:.4f} ms (host-paced), SDPA with the mask "
              f"{'fwd' if which == 'fwd' else 'bwd (dq+dk+dv)'} "
              f"{lib:.4f} ms, bound {rep['bound_ms']:.4f} ms ({nbytes} "
              f"bytes / 3.35 TB/s, {flops} flops / 989 TFLOP/s)")
    print(f"sparse_attention forward bf16 at the path's shape: tensor "
          f"cores {times['fwd_tc']:.4f} ms, FMA {times['fwd']:.4f} ms "
          f"({times['fwd'] / times['fwd_tc']:.2f}x), SDPA with the mask "
          f"{sdpa_fwd_ms:.4f} ms ({times['fwd_tc'] / sdpa_fwd_ms:.3f}x)")
    pair = times["dq_tc"] + times["dkv_tc"]
    print(f"sparse_attention backward pair bf16 at the path's shape: "
          f"tensor cores dq + dk/dv {pair:.4f} ms, FMA "
          f"{times['dq'] + times['dkv']:.4f} ms, SDPA's whole backward with "
          f"the mask {sdpa_bwd_ms:.4f} ms ({pair / sdpa_bwd_ms:.3f}x)")

    # the split cap: every cap of the sweep on the same inputs
    sweep = {}
    for cap in SPARSE_SWEEP_CAPS:
        c = cap or s // sp.TC_TILE
        row = {}
        for which in ("dq", "dkv"):
            w = plan.work(which, True, c)
            row[which] = {
                "ms": device_ms(torch, call(which, "tc", c), iters=10,
                                warmup=2)[0],
                "items": w.n_items, "split_tiles": w.n_split,
                "pieces": w.n_slots, "longest_walk": w.longest}
        sweep["none" if cap is None else cap] = row
        print(f"sparse_attention split cap {cap or 'none (no split)'} "
              f"(bf16, the path's shape, device time): "
              f"{json.dumps(row)}")
    best = min(sweep, key=lambda c: sweep[c]["dq"]["ms"]
               + sweep[c]["dkv"]["ms"])
    dkv = plan.work("dkv", True)
    print(f"sparse_attention split cap sweep: fastest dq + dk/dv at cap "
          f"{best} ({sweep[best]['dq']['ms'] + sweep[best]['dkv']['ms']:.4f}"
          f" ms); SPLIT_CAP = {sp.SPLIT_CAP}: {dkv.n_split} split dk/dv "
          f"tiles in {dkv.n_slots} pieces, longest dk/dv walk "
          f"{dkv.longest} tiles, longest dq walk "
          f"{plan.work('dq', True).longest}")
    if dkv.longest > sp.SPLIT_CAP:
        fail("a dk/dv walk is longer than the split cap")
    del layers, prepped
    torch.cuda.empty_cache()
    sweep_sparse_fwd(torch, sp)
    time_sparse_fp32(torch, sp, reports, "the path's shape", b, s, h, d,
                     SPARSE_LONG, True)


def time_sparse_fp32(torch, sp, reports, label, b, s, h, d, block_cfg,
                     causal, lens=None):
    """#8-#10 in fp32 at [b, s, h, d] under ``block_cfg`` (a key mask
    keeping the first ``lens[i]`` keys of batch row i, or none) on 4
    layers' inputs in rotation: the 3xTF32 forward (whose lse the backward
    reads), dq and dk/dv, and the FMA forward, dq and dk/dv (their first
    versions) on the same inputs. Held first, at SPLIT_CAP and at
    SPARSE_SMALL_CAP16 (where the forward's, dq's and dk/dv's walks
    split), every output bit-equal over two launches: the 3xTF32 forward's
    o to atol 1e-5 (KERNEL_TOL) and its lse to SPARSE_LSE_TOL on the rows
    with a visible key (-1e30 exactly on the others), dq and dk/dv within
    1e-5 of the reference's largest |value|; the FMA kernels the same way.
    Then timed as device time beside the plain versions (host-paced), SDPA
    in fp32 with the layout-expanded mask (the forward, and its whole
    backward for dq and dk/dv) and the bound at FP32_3XTF32_FLOPS over the
    visible pairs. Fills ``reports``' rows "fwd", "dq", "dkv",
    "fwd_tf32", "dq_tf32", "dkv_tf32"; returns the device ms by row."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    scale = 1.0 / d ** 0.5
    block = block_cfg["block"]
    layout = sparse_layout(block_cfg, h, s)
    plan = sp.sparse_plan(layout, block)
    if any(sp._route(torch.float32, d, block, w) != "tf32"
           for w in ("fwd", "dq", "dkv")):
        fail(f"sparse fp32 {label}: the forward, dq and dk/dv do not take "
             f"3xTF32")
    mask = None
    if lens is not None:
        mask = torch.from_numpy(np.arange(s)[None] < lens[:, None]).cuda()
    layers = []
    for i in range(4):
        _qkv, q, k, v, dout, _m = flash_case(
            torch, torch.float32, b, s, h, d, seed=500 + i,
            dout_scale=FLASH_DOUT_SCALE["float32"])
        q, k, v, km = sp._prepare(q, k, v, mask, plan)
        out, lse = sp.sparse_attention_fwd_tf32(q, k, v, km, plan, causal,
                                                scale)
        delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
        layers.append((q, k, v, dout, km, lse, delta, plan, causal, scale))
    a = layers[0]
    fwd_args = (*a[:3], a[4], plan, causal, scale)
    small = SPARSE_SMALL_CAP16
    for which in ("fwd", "dq", "dkv"):
        if not plan.work16(which, causal, small).n_split:
            fail(f"sparse fp32 {label}: the {which} walks do not split at "
                 f"cap {small}")

    def dkv(fn, *args, **kw):
        return torch.cat(fn(*args, **kw), -1)

    outs = {"dq": [sp._launch_fma("dq", *a) for _ in range(2)],
            "dkv": [dkv(sp._launch_fma, "dkv", *a) for _ in range(2)]}
    fwds = {"fwd": [sp._launch_fma_fwd(*fwd_args) for _ in range(2)]}
    for cap in (None, small):
        tag = "" if cap is None else f" cap {cap}"
        fwds["fwd_tf32" + tag] = [sp.sparse_attention_fwd_tf32(
            *fwd_args, cap=cap) for _ in range(2)]
        outs["dq_tf32" + tag] = [sp.sparse_attention_bwd_dq_tf32(
            *a, cap=cap) for _ in range(2)]
        outs["dkv_tf32" + tag] = [dkv(sp.sparse_attention_bwd_dkv_tf32, *a,
                                      cap=cap) for _ in range(2)]
    ref_o, ref_lse = sp.sparse_fwd_reference(*fwd_args)
    refs = {"dq": sp.sparse_bwd_dq_reference(*a),
            "dkv": dkv(sp.sparse_bwd_dkv_reference, *a)}
    torch.cuda.synchronize()
    seen = ref_lse > sp.NEG_INF / 2
    errs, lse_errs = {}, {}
    for key, ((o, lse), (o2, lse2)) in fwds.items():
        if not same_bits(torch, o, o2) or not same_bits(torch, lse, lse2):
            fail(f"sparse fp32 {key} {label}: two launches differ")
        if not torch.equal(seen, lse > sp.NEG_INF / 2) or \
                not (lse[~seen] == sp.NEG_INF).all():
            fail(f"sparse fp32 {key} {label}: empty rows differ")
        errs[key] = (o - ref_o).abs().max().item()
        lse_errs[key] = (lse - ref_lse)[seen].abs().max().item()
        if not torch.isfinite(o).all() or \
                not errs[key] <= KERNEL_TOL["float32"] or \
                not lse_errs[key] <= SPARSE_LSE_TOL:
            fail(f"sparse fp32 {key} {label}: o max |err| {errs[key]}, lse "
                 f"{lse_errs[key]}")
    rels = {}
    for key, (got, again) in outs.items():
        ref = refs[key.split("_")[0].split()[0]]
        top = ref.abs().max().item()
        errs[key] = (got - ref).abs().max().item()
        rels[key] = errs[key] / max(top, 1e-30)
        if not same_bits(torch, got, again):
            fail(f"sparse fp32 {key} {label}: two launches differ")
        if not torch.isfinite(got).all() or \
                not rels[key] <= KERNEL_TOL["float32"]:
            fail(f"sparse fp32 {key} {label}: max |err| {errs[key]}, "
                 f"{rels[key]} of the largest |value| {top}")
    fwd_errs = {k: [f"{errs[k]:.3g}", f"{v:.3g}"]
                for k, v in lse_errs.items()}
    print(f"sparse_attention fp32 at {label} [{b}, {s}, {h}, {d}] "
          f"{block_cfg['mode']} block {block}: held, bit-equal over two "
          f"launches; the forwards' o max |err| (atol 1e-5) and lse max "
          f"|err| (limit {SPARSE_LSE_TOL}; {int((~seen).sum())} empty rows "
          f"at -1e30): {json.dumps(fwd_errs)}; dq and dk/dv max |err| over "
          f"the reference's largest |value| (limit 1e-5): "
          f"{json.dumps({k: f'{v:.3g}' for k, v in rels.items()})}")
    del outs, fwds, refs, ref_o, ref_lse, seen
    torch.cuda.empty_cache()
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(layers)
        return layers[it["i"]]

    def call(which, how):
        """One call of ``which`` ("fwd", "dq", "dkv") by ``how``: "plain",
        "fma" or "tf32"."""
        def go():
            a = nxt()
            if which == "fwd":
                fa = (*a[:3], a[4], *a[7:])
                return {"plain": sp.sparse_fwd_reference,
                        "fma": sp._launch_fma_fwd,
                        "tf32": sp.sparse_attention_fwd_tf32}[how](*fa)
            if how == "plain":
                return (sp.sparse_bwd_dq_reference if which == "dq" else
                        sp.sparse_bwd_dkv_reference)(*a)
            if how == "fma":
                return sp._launch_fma(which, *a)
            return (sp.sparse_attention_bwd_dq_tf32 if which == "dq" else
                    sp.sparse_attention_bwd_dkv_tf32)(*a)
        return go

    # yardstick: SDPA in fp32 (the memory-efficient backend, pinned) with
    # the layout-expanded boolean mask (one head's where every head has
    # the same layout) on contiguous [B, H, S, D] copies
    same = bool((layout == layout[:1]).all())
    am = sp._dense_mask(layout[:1] if same else layout, block, "cuda")[None]
    if causal:
        am = am & torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    if mask is not None:
        am = am & mask[:, None, None, :]
    backend = SDPBackend.EFFICIENT_ATTENTION
    sdpa_in = []
    for q, k, v, dout, *_ in layers[:2]:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        with sdpa_kernel(backend):
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        sdpa_in.append((qt, kt, vt, o, dout.transpose(1, 2).contiguous()))
    sit = {"i": 0}

    def snxt():
        sit["i"] = (sit["i"] + 1) % len(sdpa_in)
        return sdpa_in[sit["i"]]

    def sdpa_fwd():
        qt, kt, vt = snxt()[:3]
        with torch.no_grad(), sdpa_kernel(backend):
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

    def sdpa_bwd():
        qt, kt, vt, o, dot = snxt()
        torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

    lib = {"fwd": device_ms(torch, sdpa_fwd, iters=5, warmup=2)[0],
           "bwd": device_ms(torch, sdpa_bwd, iters=5, warmup=2)[0]}
    del sdpa_in, am
    torch.cuda.empty_cache()
    if mask is None:
        pairs = b * sparse_pairs(layout, block, causal)
    else:   # a query row sees its layout row's keys its batch row keeps
        dense = sp._dense_mask(layout, block, "cpu")
        pairs = int(sum(dense[:, :, :int(n)].sum() for n in lens))
    plain = {which: cuda_ms(call(which, "plain"), iters=2, warmup=1)
             for which in ("fwd", "dq", "dkv")}
    card = card_line()
    out = {}
    for row, which, how in (("fwd", "fwd", "fma"), ("dq", "dq", "fma"),
                            ("dkv", "dkv", "fma"),
                            ("fwd_tf32", "fwd", "tf32"),
                            ("dq_tf32", "dq", "tf32"),
                            ("dkv_tf32", "dkv", "tf32")):
        ms = device_ms(torch, call(which, how), iters=10, warmup=2)[0]
        nbytes, flops = sparse_bytes_flops(layers[0][0], pairs / b, which)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / FP32_3XTF32_FLOPS
        library = lib["fwd" if which == "fwd" else "bwd"]
        rep = reports[row]
        rep.update(ms=ms, plain_ms=plain[which], library_ms=library,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(v for k, v in errs.items()
                                   if k.split()[0] == row))
        out[row] = ms
        extra = ""
        if how == "tf32":
            rep["fma_ms"] = out[which]
            extra = (f", the FMA kernel on the same inputs {out[which]:.4f} "
                     f"ms ({out[which] / ms:.2f}x)")
        print(f"sparse_attention {row} ({how}) timing fp32 at {label} "
              f"B={b} S={s} H={h} D={d} {block_cfg['mode']} block {block} "
              f"{'causal' if causal else 'non-causal'}"
              f"{'' if mask is None else ', key mask'} ({pairs} visible "
              f"pairs; device time; {card}): kernel {ms:.4f} ms{extra}, "
              f"plain {plain[which]:.4f} ms (host-paced), SDPA fp32 "
              f"({backend.name}) with the mask "
              f"{'fwd' if which == 'fwd' else 'bwd (dq+dk+dv)'} "
              f"{library:.4f} ms, bound {rep['bound_ms']:.4f} ms ({nbytes} "
              f"bytes / 3.35 TB/s, {flops:.0f} flops / 165 TFLOP/s, "
              f"3xTF32), max |err| {rep['max_abs_err']:.3g}")
    pair = out["dq_tf32"] + out["dkv_tf32"]
    print(f"sparse_attention backward pair fp32 at {label} ({card}): 3xTF32 "
          f"dq + dk/dv {pair:.4f} ms, FMA {out['dq'] + out['dkv']:.4f} ms "
          f"({(out['dq'] + out['dkv']) / pair:.2f}x), SDPA's fp32 whole "
          f"backward with the mask {lib['bwd']:.4f} ms "
          f"({pair / lib['bwd']:.3f}x); 3xTF32 forward "
          f"{out['fwd_tf32']:.4f} ms, FMA {out['fwd']:.4f} ms "
          f"({out['fwd'] / out['fwd_tf32']:.2f}x), SDPA's "
          f"{lib['fwd']:.4f} ms ({out['fwd_tf32'] / lib['fwd']:.3f}x)")
    del layers
    torch.cuda.empty_cache()
    return out


def sweep_sparse_fwd(torch, sp):
    """The tensor-core forward at every cap of SPARSE_SWEEP_CAPS at case
    (d)'s shape ([2, 2048, 12, 64] bf16, BigBird block 64, bidirectional,
    the key mask with an all-padding row), where the global rows walk all
    32 key tiles; 4 layers' inputs in rotation: items, split tiles,
    pieces, the longest walk and device ms at each cap."""
    b, s, h, d = 2, 2048, 12, 64
    layout = sparse_layout(SPARSE_BIDIR, h, s)
    plan = sp.sparse_plan(layout, SPARSE_BIDIR["block"])
    layers = []
    for i in range(4):
        _qkv, q, k, v, _do, mask = flash_case(torch, torch.bfloat16, b, s, h,
                                              d, seed=300 + i, masked=True)
        mask[0, s - 100:] = False
        layers.append(sp._prepare(q, k, v, mask, plan))
    it = {"i": 0}

    def go(cap):
        it["i"] = (it["i"] + 1) % len(layers)
        return sp.sparse_attention_fwd_tc(*layers[it["i"]], plan, False,
                                          d ** -0.5, cap=cap)

    sweep = {}
    for cap in SPARSE_SWEEP_CAPS:
        c = cap or s // sp.TC_TILE
        w = plan.work("fwd", False, c)
        sweep["none" if cap is None else cap] = {
            "ms": device_ms(torch, lambda: go(c), iters=10, warmup=2)[0],
            "items": w.n_items, "split_tiles": w.n_split,
            "pieces": w.n_slots, "longest_walk": w.longest}
    best = min(sweep, key=lambda c: sweep[c]["ms"])
    print(f"sparse_attention forward split cap sweep at (d) (bf16 "
          f"[{b},{s},{h},{d}], bigbird-64 bidirectional, key mask; device "
          f"time): {json.dumps(sweep)}; fastest at cap {best}, SPLIT_CAP = "
          f"{sp.SPLIT_CAP}")
    del layers
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
    kernel_ms = device_ms(torch, lambda: fused_adam_apply(
        opt, g, state, p, cast_dtype=torch.bfloat16, cast_out=casts))[0]
    nocast_ms = device_ms(torch, lambda: fused_adam_apply(opt, g, state,
                                                          p))[0]
    scalars = opt.step_scalars(5, None, "cuda")
    plain_ms = cuda_ms(lambda: fused_adam_reference(
        opt, g, m, v, p, scalars, torch.bfloat16), iters=5, warmup=1)
    leaves = [x.clone().requires_grad_() for x in p]
    for leaf, grad in zip(leaves, g):
        leaf.grad = grad
    lib = torch.optim.Adam(leaves, lr=1e-4, fused=True)
    library_ms, lib_names = device_ms(torch, lib.step, names=True)
    nbytes = 30 * n
    bound_ms = max(nbytes / HBM_BYTES_PER_S, 12 * n / FP32_FLOPS) * 1e3
    report.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by="bytes", max_abs_err=0.0)
    print(f"fused_adam timing, {len(shapes)} tensors, {n} params, fp32 "
          f"grads (device time; plain host-paced): kernel with the bf16 "
          f"cast {kernel_ms:.4f} ms (1 launch; "
          f"bound {bound_ms:.4f} ms, {nbytes} bytes / 3.35 TB/s), without "
          f"the cast {nocast_ms:.4f} ms (bound "
          f"{28 * n / HBM_BYTES_PER_S * 1e3:.4f} ms), plain with the cast "
          f"{plain_ms:.4f} ms, torch.optim.Adam(fused=True) (no cast) "
          f"{library_ms:.4f} ms "
          f"{ {k[:60]: round(v, 4) for k, v in lib_names.items()} }")
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
# D above 1280, where csrc/fused_ln_tc.cu's forward runs one warpgroup 32
# deep (GPT-2 XL's width; F no tile divides); D above the widest resident
# panel (fused.TC_MAX_D), where its 16-bit kernels stream T(ln) through
# the product: 2048, a ragged 1672 (F no tile divides) and a decode-sized
# call at 2048 (phase 6b's qkv site); and decode-sized calls at the path's
# widths (n = the batch's rows in a serving step with a cache)
FUSED_LN_XL = ((300, 1600, 264, "gelu"),)
FUSED_LN_WIDE = ((300, 2048, 256, "gelu"), (300, 1672, 264, "gelu"),
                 (8, 2048, 6144, None))
FUSED_LN_DECODE = ((8, 768, 2304, None), (8, 768, 3072, "gelu"))
# the 16-bit route above that limit at the path's row count: the two sites'
# shapes at D = 2048 (F 3 D and, under GELU, 4 D: phase 6b's); held in
# bf16 and fp16, timed in bf16 beside fused_ln.cu on the same inputs
FUSED_LN_D2048 = ((16 * 512, 2048, 6144, None),
                  (16 * 512, 2048, 8192, "gelu"))
FUSED_LN_CASES = (FUSED_LN_SITES + FUSED_LN_TAIL + FUSED_LN_XL
                  + FUSED_LN_WIDE + FUSED_LN_DECODE)
FUSED_LN_NAMES = ("dx", "dgamma", "dbeta", "dw", "dbias")
# the launch counters of each route's wrappers
FUSED_LN_ROUTES = {"fused_ln_tc": ("fused_ln_matmul_fwd_tc",
                                   "fused_ln_matmul_bwd_tc"),
                   "fused_ln_tf32": ("fused_ln_matmul_fwd_tf32",
                                     "fused_ln_matmul_bwd_tf32"),
                   "fused_ln": ("fused_ln_matmul_fwd",
                                "fused_ln_matmul_bwd")}
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
# shapes (2.9e-3 measured); 1e-2. fp16, beyond one rounding step of the
# output: the same rounding points, where a step is 2**-11 of a value, so
# a boundary case moves a product by up to 2**-11 |ln| |w|, ~5e-4 of the
# RMS: 1e-3.
FUSED_LN_TOL = {"float32": 5e-5, "bfloat16": 1e-2, "float16": 1e-3}
# That premise needs many rows. Over 8 rows (the decode cases) dW[j, k]
# sums 8 products dyc_ij T(ln)_ik, so one element of g = dy gelu'(pre) at
# a rounding boundary, which the two sides' fp32 pre (summed in other
# orders) round to neighbouring 16-bit values, moves that dW element by
# one step of g_ij times |T(ln)_ik|: up to 8e-3 (fp16) or 6e-2 (bf16) of
# dW's RMS at the decode case. There each dW element's difference beyond
# one step of dW is also allowed one such flip in its own column of dyc,
# max over i of 2**-m |g_ij| |T(ln)_ik|, computed from the plain version's
# own values, and what is left is held to the unchanged FUSED_LN_TOL.
FUSED_LN_MANT = {"bfloat16": 7, "float16": 10}   # explicit mantissa bits


def fused_ln_flip_allowance(torch, fz, x, gamma, beta, w, bias, dy, name):
    """Per element of dW [F, D] under GELU: the move from one element of
    its column j of dyc rounded to the neighbouring 16-bit value, max over
    rows i of one step of |g_ij| (2**-m of it) times |T(ln)_ik|."""
    ln, _, _ = fz._layernorm_rows(x.float(), gamma.float(), beta.float(),
                                  1e-5)
    ln_c = ln.to(w.dtype).float()
    g = dy.float() * fz._gelu_tanh_grad(ln_c @ w.float().t()
                                        + bias.float())
    move = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for i in range(x.shape[0]):
        move = torch.maximum(move, g[i].abs()[:, None]
                             * ln_c[i].abs()[None, :])
    return move * 2.0 ** -FUSED_LN_MANT[name]


def fused_ln_case(torch, dtype, n, d, f, seed):
    """x [n, D] (mean 0.5, std 2), gamma ~ 1, beta and bias ~ 0.1, w [F, D]
    with std 1/sqrt(D), dy normal; all in ``dtype`` (the 16-bit training
    steps cast gamma, beta and bias to the compute dtype too)."""
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
    versions, in fp32, bf16 and fp16 at the path's two sites, the tail,
    GPT-2 XL's width, D above the widest resident panel (FUSED_LN_WIDE,
    and in 16 bits FUSED_LN_D2048: the streamed product) and the decode
    size (FUSED_LN_TOL); each call on the route ``fused._route`` names
    (its wrapper counts it, the other routes' do not) and y and the five
    gradients bit-equal over two launches; ``fused_ln.cu`` (the first
    version) held on the same inputs in fp32 and above the panel. Then
    timed at the path's sites, per layer (both sites summed), in bf16 and
    fp16 beside ``fused_ln.cu``'s 16-bit kernels on the same inputs, in
    fp32, and in bf16 at FUSED_LN_D2048 beside ``fused_ln.cu``, and
    beside the plain versions and the unfused eager sequence.
    ``reports``: the rows by (dtype name, "fwd"/"bwd", and "first-*" /
    "*-d2048" for the first version's and D = 2048's)."""
    from deepspeed_tpu_torch.ops.transformer import fused as fz

    counters = {n: getattr(fz, n[len("fused_"):])
                for names in FUSED_LN_ROUTES.values() for n in names}
    worst, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[1]
        cases = FUSED_LN_CASES + (FUSED_LN_D2048 if name != "float32"
                                  else ())
        for i, (n, d, f, act) in enumerate(cases):
            x, gamma, beta, w, bias, dy = fused_ln_case(torch, dtype, n, d,
                                                        f, seed=40 + i)
            kw = dict(eps=1e-5, activation=act)
            args = fz._prepare(x, gamma, beta, w, bias)
            if args[0].data_ptr() != x.data_ptr() or \
                    args[3].data_ptr() != w.data_ptr():
                fail("fused_ln copied a contiguous aligned operand")
            before = {k: c.launches for k, c in counters.items()}
            y = fz.ln_matmul_fwd(*args, **kw)
            grads = fz.ln_matmul_bwd(*args, dy, **kw)
            route = fz._route(dtype, d)
            counted = {k: c.launches - before[k]
                       for k, c in counters.items()}
            want = {k: int(k in FUSED_LN_ROUTES[route]) for k in counters}
            if counted != want:
                fail(f"fused_ln {name} n={n} D={d} F={f}: route {route}, "
                     f"launches {counted}, expected {want}")
            y2 = fz.ln_matmul_fwd(*args, **kw)
            grads2 = fz.ln_matmul_bwd(*args, dy, **kw)
            torch.cuda.synchronize()
            for key, a, b in zip(("y",) + FUSED_LN_NAMES, (y,) + grads,
                                 (y2,) + grads2):
                if not torch.equal(a, b):
                    fail(f"fused_ln {name} n={n} D={d} F={f} {act}: {key} "
                         f"differs between two launches")
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
            flip = (fused_ln_flip_allowance(torch, fz, x, gamma, beta, w,
                                            bias, dy, name)
                    if name != "float32" and act == "gelu" and n < 64
                    else None)
            if flip is not None:
                # a second witness: fused_ln.cu's 16-bit backward (the
                # first version) on the same inputs
                first_dw = fz._launch_bwd("fused_ln", *args, dy, 1e-5,
                                          act)[3]
                pairs.append(("first-version dw", first_dw, grads_w[3]))
            if name == "float32" or d > fz.TC_MAX_D:
                # fused_ln.cu's kernels (the first version, on no path)
                # held on the same inputs
                pairs.append(("first-fwd y", fz._launch_fwd(
                    "fused_ln", *args, 1e-5, act), y_w))
                pairs += [(f"first-bwd {k}", a, b) for k, a, b in zip(
                    FUSED_LN_NAMES, fz._launch_bwd("fused_ln", *args, dy,
                                                   1e-5, act), grads_w)]
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
                if name != "float32":
                    diff = (diff - round_step(torch, ref, ref.dtype)
                            ).clamp_min(0)
                rel = diff.max().item() / max(rms, 1e-30)
                if key.endswith(" dw") and flip is not None:
                    step_only = rel
                    rel = ((diff - flip).clamp_min(0).max().item()
                           / max(rms, 1e-30))
                    print(f"fused_ln {key} {name} n={n} D={d} F={f} {act}: "
                          f"max |err| {err:.3g}; {step_only:.3g} of the "
                          f"plain version's RMS beyond one step, {rel:.3g} "
                          f"beyond one step and one dyc flip in each "
                          f"element's column (a flip is worth up to "
                          f"{flip.max().item() / rms:.3g}; limit "
                          f"{FUSED_LN_TOL[name]})")
                    if key.startswith("first-version"):
                        print(f"fused_ln {key} {name} n={n}: bit-equal to "
                              f"the wgmma kernel's dW: "
                              f"{torch.equal(got, grads[3])}")
                        continue   # a witness, not a check of this route
                if rel > FUSED_LN_TOL[name]:
                    bad.append(f"{key} {name} n={n} D={d} F={f} {act}: max "
                               f"|err| {err}, {rel} of the plain version's "
                               f"RMS {rms}")
                k = (key.split()[0], name)
                w_ = worst.get(k, (0.0, 0.0))
                worst[k] = (max(w_[0], err), max(w_[1], rel))
                if i < len(FUSED_LN_SITES) or i >= len(FUSED_LN_CASES):
                    pk = ("path" if i < len(FUSED_LN_SITES) else "d2048",
                          name, key.split()[0])
                    worst[pk] = max(worst.get(pk, 0.0), err)
            del x, gamma, beta, w, bias, dy, args, y, grads, y_w, grads_w
            del y2, grads2, leaves, x3, y3, pairs
    for (key, name), (err, rel) in sorted(
            (k, v) for k, v in worst.items() if len(k) == 2):
        limit = (f"limit {FUSED_LN_TOL[name]}" if name == "float32" else
                 f"beyond one {name} step; limit {FUSED_LN_TOL[name]}")
        print(f"fused_ln {key} {name} (every case, +-GELU, the decode dW "
              f"under GELU beyond one dyc flip as above; each on its "
              f"route, bit-equal over two launches): max |err| {err:.3g}, "
              f"{rel:.3g} of the plain version's RMS ({limit})")
    if bad:
        fail("fused_ln kernels disagree with their plain versions:\n  "
             + "\n  ".join(bad))
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        name = str(dtype).split(".")[1]
        time_fused_ln(torch, dtype, {
            which: rep for (nm, which), rep in reports.items()
            if nm == name}, {k[2]: err for k, err in worst.items()
                             if k[0] == "path" and k[1] == name})
    # the 16-bit route above fused.TC_MAX_D (the streamed product) at D =
    # 2048, beside fused_ln.cu on the same inputs (the first-* rows)
    time_fused_ln(torch, torch.bfloat16, {
        which: reports[("bfloat16", f"{which}-d2048")]
        for which in ("fwd", "bwd", "first-fwd", "first-bwd")},
        {k[2]: err for k, err in worst.items()
         if k[:2] == ("d2048", "bfloat16")}, sites=FUSED_LN_D2048)


def time_fused_ln(torch, dtype, reports, errs, sites=FUSED_LN_SITES):
    """#6 and #7 timed at ``sites`` (the path's) in ``dtype`` on the route
    ``fused._route`` names, rotating over 2 sets of inputs, beside the
    plain versions, the unfused eager sequence and ``csrc/fused_ln.cu``'s
    kernels on the same inputs, the first version; the kernels of one
    call of each route by device time. Fills the ``fwd`` / ``bwd`` rows
    per layer (both sites summed), and where ``reports`` has them (fp32 at
    the path's sites, bf16 at D = 2048) the first version's rows
    (``first-fwd`` / ``first-bwd``: the same function and inputs)."""
    from deepspeed_tpu_torch.ops.transformer import fused as fz
    from torch.profiler import ProfilerActivity, profile

    name = str(dtype).split(".")[1]
    sets = {site: [fused_ln_case(torch, dtype, *site[:3], seed=60 + j)
                   for j in range(2)]
            for site in sites}
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

        t = {"fwd": device_ms(torch, lambda: fz.ln_matmul_fwd(
                 *nxt()[:5], **kw))[0],
             "bwd": device_ms(torch, lambda: fz.ln_matmul_bwd(
                 *nxt(), **kw))[0],
             "route": fz._route(dtype, d),
             "plain fwd": cuda_ms(lambda: fz.ln_matmul_reference(
                 *nxt()[:5], **kw), iters=10, warmup=2),
             "plain bwd": cuda_ms(lambda: fz.ln_matmul_bwd_reference(
                 *nxt(), **kw), iters=5, warmup=1),
             "library fwd": device_ms(torch, lib_fwd)[0],
             "library bwd": device_ms(torch, lib_bwd)[0]}
        if t["route"] != "fused_ln":
            t["first fwd"] = device_ms(torch, lambda: fz._launch_fwd(
                "fused_ln", *nxt()[:5], 1e-5, act))[0]
            t["first bwd"] = device_ms(torch, lambda: fz._launch_bwd(
                "fused_ln", *nxt(), 1e-5, act))[0]
        # fp32's products at the 3xTF32 rate (fused_ln.cu runs them on FMAs)
        es, peak = (4, FP32_3XTF32_FLOPS) if dtype == torch.float32 else (
            2, BF16_FLOPS)
        for which in ("fwd", "bwd"):
            nbytes, flops = fused_ln_bytes_flops(n, d, f, act, es, which)
            t[f"bound {which}"] = max(nbytes / HBM_BYTES_PER_S,
                                      flops / peak) * 1e3
            t[f"by {which}"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                                >= flops / peak else "operations")
            t[f"tflops {which}"] = flops / (t[which] / 1e3) / 1e12
        # the kernels of one forward and backward call of each route, by
        # device time
        routes = [("routed", None)]
        if t["route"] != "fused_ln":
            routes.append(("first", "fused_ln"))
        for label, lib in routes:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    x, gamma, beta, w, bias, dy = nxt()
                    if lib is None:
                        fz.ln_matmul_fwd(x, gamma, beta, w, bias, **kw)
                        fz.ln_matmul_bwd(x, gamma, beta, w, bias, dy, **kw)
                    else:
                        fz._launch_fwd(lib, x, gamma, beta, w, bias, 1e-5,
                                       act)
                        fz._launch_bwd(lib, x, gamma, beta, w, bias, dy,
                                       1e-5, act)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            t[f"profile per fwd + bwd, {label}"] = kernel_stats(
                prof.events(), 5, wall_us)
        times[site] = t
        print(f"fused_ln timing {name} n={n} D={d} F={f} {act}: "
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
            bound_by=times[sites[0]][f"by {which}"],
            max_abs_err=errs[which])
        first = ""
        if all(f"first {which}" in t for t in times.values()):
            rep["first_ms"] = sum(t[f"first {which}"]
                                  for t in times.values())
            first = (f", fused_ln.cu (the first version) on the same inputs "
                     f"{rep['first_ms']:.4f} ms "
                     f"({rep['first_ms'] / rep['ms']:.2f}x)")
            if f"first-{which}" in reports:
                reports[f"first-{which}"].update(
                    {k: rep[k] for k in ("plain_ms", "library_ms",
                                         "bound_ms", "bound_by")},
                    ms=rep["first_ms"], max_abs_err=errs[f"first-{which}"])
        print(f"fused_ln {which} per layer (both sites, {name}, D="
              f"{sites[0][1]}, {times[sites[0]]['route']}; device time, plain "
              f"host-paced): kernel {rep['ms']:.4f} ms{first}, plain "
              f"{rep['plain_ms']:.4f} ms, unfused eager sequence "
              f"{rep['library_ms']:.4f} ms, bound "
              f"{rep['bound_ms']:.4f} ms ({rep['bound_by']})")


# ---------------------------------------------------------------------------
# 3. serving end to end
# ---------------------------------------------------------------------------

def serving_engine(torch, dtype, mode, params, fault=None, telemetry=None,
                   **serving):
    """Full-width GPT-2 behind ``init_serving``: 8 slots, KV block 16, a
    pool of 8 x 1024 positions (plus the scratch block); ``serving`` adds
    keys of the serving block (chunked prefill, int8 pool, prefix cache,
    speculative decoding, resilience); ``fault``: a
    ``resilience.fault_injection`` plan; ``telemetry``: a telemetry
    block."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import make_gpt

    with torch.device("cuda"):
        model, _cfg = make_gpt("gpt2", dtype=dtype)
    bs = 16
    config = {"serving": {"max_batch_size": 8, "kv_block_size": bs,
                          "kv_num_blocks": 8 * 1024 // bs + 1,
                          "decode_attention": mode, **serving}}
    if fault is not None:
        config["resilience"] = {"fault_injection": fault}
    if telemetry is not None:
        config["telemetry"] = telemetry
    return dtt.init_serving(model, params=params, dtype=dtype,
                            config=config)


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
                lambda *a, runs=None, **k:
                cp.chunked_prefill_attention_reference(*a, **k))
        elif self.attention == "both":
            self.caches[0].update_attend = both_paged
            self.caches[1].update_attend = both_chunked
        return self

    def __exit__(self, *exc):
        self.cp.chunked_prefill_attention = self.kernel
        for cls, method in zip(self.caches, self.methods):
            cls.update_attend = method


def serve(torch, dtype, mode, params, requests, wave1=10,
          second_wave="finish", attention="kernel", telemetry=None,
          **serving):
    """Serve ``requests``: ``wave1`` at once, the rest when the first
    request finishes (backfill), or with ``second_wave="prefill"`` as soon
    as request 0 has its first token (so the rest find its prompt in the
    prefix cache). Checks completion, leaks, backfill, the kernels'
    launch counts and that no plain version ran on the main path.
    ``attention`` (``KernelShims``): "kernel"; "plain", the chunked
    step's kernel replaced by its plain version (nothing launches); or
    "both", every kernel call held against its plain version on the
    same inputs (``max_err`` in the metrics). ``telemetry``: a telemetry
    block for ``init_serving`` (the caller closes the engine)."""
    from deepspeed_tpu_torch.ops.transformer import chunked_prefill
    from deepspeed_tpu_torch.ops.transformer.paged_attention import \
        paged_decode_attention

    srv = serving_engine(torch, dtype, mode, params, telemetry=telemetry,
                         **serving)
    cfg = srv.model_cfg
    chunked = srv.scfg.chunked_prefill
    label = (f"{mode}/{dtype}/{attention}/" + ",".join(
        f"{k}={v}" for k, v in sorted(serving.items())))
    # kernel #2's route: the run kernels for bf16 q (over bf16 or int8
    # pools), the fp32 run kernels for fp32 q (over fp32 or int8 pools)
    cp_route = chunked_prefill._route(
        dtype, torch.int8 if serving.get("int8_kv_cache") else dtype,
        cfg.hidden_size // cfg.num_heads)
    cps = {r: getattr(chunked_prefill, n) for r, n in CHUNKED_NAMES.items()}
    rids = [srv.submit(p, n) for p, n in requests[:wave1]]
    step_ms, decode_tokens = [], 0
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_by_queries = {}
    for w in cps.values():
        w.launches = 0
    swap_plain = attention == "plain"
    shims = KernelShims(attention)
    targets = ([(chunked_prefill, "chunked_prefill_attention_reference")]
               if swap_plain else serving_plain_targets(
                   mode, chunked, srv.prefix_cache is not None))
    with shims, PlainCalls(targets) as plain:
        t0 = time.perf_counter()
        while not srv.idle():
            ts = time.perf_counter()
            before = srv._decode_tokens
            info = srv.step()  # ends in a host fetch: the card is done
            dt = time.perf_counter() - ts
            if info["active"] and (chunked or not info["prefilled"]):
                step_ms.append(dt * 1e3)
                # the tokens the round appended (up to k + 1 a row when
                # speculative)
                decode_tokens += srv._decode_tokens - before
            if len(rids) == wave1 and (
                    info["finished"] if second_wave == "finish"
                    else rids[0] in info["prefilled"]):
                rids += [srv.submit(p, n) for p, n in requests[wave1:]]
        wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                **{CHUNKED_NAMES[r]: w.launches for r, w in cps.items()}}
    by_queries = dict(paged_decode_attention.launches_by_queries)
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
    # kernel #2: one call a layer a mixed step on its route (the run
    # kernels' call launches one or two kernels); #1 one a layer a plain
    # decode step, and a speculative round's k draft steps of dl layers
    # (S = 1) plus its verify of every layer (S = k + 1)
    want = dict.fromkeys(launches, 0)
    n_layers, st = cfg.num_layers, srv.stats
    spec_rounds = st["spec_rounds"] if mode == "kernel" else 0
    want_by_s = {}
    if spec_rounds:
        k, dl = srv.scfg.spec_k, srv._draft_layers
        want_by_s = {1: spec_rounds * k * dl, k + 1:
                     spec_rounds * n_layers}
    if chunked and not swap_plain:
        want[CHUNKED_NAMES[cp_route]] = st["mixed_steps"] * n_layers
    elif not chunked and mode == "kernel":
        plain_rounds = st["kernel_steps"] - spec_rounds
        if plain_rounds:
            want_by_s[1] = want_by_s.get(1, 0) + plain_rounds * n_layers
    want["paged_decode_attention"] = sum(want_by_s.values())
    if launches != want or by_queries != want_by_s or (
            chunked and not swap_plain
            and not want[CHUNKED_NAMES[cp_route]]):
        fail(f"{label}: kernel launches {launches} (by query count "
             f"{by_queries}), expected {want} ({want_by_s})")
    for name, n in launches.items():
        SERVED_LAUNCHES[name] = SERVED_LAUNCHES.get(name, 0) + n
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
        prefix_hits=srv.stats["prefix_hits"], launches_by_queries=by_queries,
        **{n: srv.stats[n] for n in SPEC_STATS})


SPEC_STATS = ("spec_rounds", "spec_proposed", "spec_accepted",
              "spec_new_tokens")


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
    """Top-2 logit gap of the int8 pool's model at a prefix
    (:func:`int8_logits`)."""
    logits = int8_logits(torch, srv, chunked)

    def gap(prefix, prompt_len):
        top = torch.topk(logits(prefix, prompt_len), 2).values
        return float(top[0] - top[1])

    return gap


def int8_logits(torch, srv, chunked):
    """The int8 pool's model's next-token logits (fp32) at a prefix, the
    way the serving path computes them (through the plain gather path, in
    the engine's dtype): chunked, every token attends over pool K/V
    quantized when written; bucketed, the prompt attends over its own
    unquantized dense cache, is packed into the pool quantized, and each
    later token attends over the pool."""
    from deepspeed_tpu_torch.models import init_kv_cache
    from deepspeed_tpu_torch.serving.kv_cache import (PagedLayerCache,
                                                      init_paged_pools,
                                                      pack_prefill)

    cfg, bs = srv.model_cfg, srv.block_size

    def logits_at(prefix, prompt_len):
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
        return logits.float()

    return logits_at


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


def kernel_stats(events, steps, wall_us, annotations=(), pick=()):
    """Device busy time (union of kernel intervals), idle share and the
    top kernels by device time, per step, from profiler events; the
    device-side spans of the ``record_function`` ranges named in
    ``annotations`` are not kernels and are left out. ``pick``: names
    whose kernels' device ms per step (every kernel whose name holds the
    name) are added under ``picked_ms_per_step``."""
    from torch.autograd import DeviceType

    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in annotations]
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
    out = {"steps": steps, "step_ms": wall_us / steps / 1e3,
           "device_busy_ms_per_step": busy / steps / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "kernels_per_step": len(kernels) / steps,
           "top_kernels_ms_per_step": {n[:70]: t / steps / 1e3
                                       for n, t in top}}
    if pick:
        out["picked_ms_per_step"] = {
            p: sum(t for n, t in by_name.items() if p in n) / steps / 1e3
            for p in pick}
    return out


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
    launched = chunked_prefill.chunked_prefill_attention_tc.launches

    def mixed(info):
        if not info["active"]:
            fail(f"chunked profile window ran out of work: {info}")

    out = profile_steps(torch, srv, steps, "chunked mixed steps (bf16, "
                        "budget 256)", mixed)
    n = (chunked_prefill.chunked_prefill_attention_tc.launches - launched)
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
               "kernel_launches":
                   m["launches"]["chunked_prefill_attention_tc"],
               **step_summary(m)}
    print(f"serving bf16 chunked (kernel #2's run kernels: one call, one or "
          f"two launches, a layer a mixed step: calls == mixed_steps x 12; "
          f"the first kernel and kernel #1 0, no plain attention): "
          f"{json.dumps(chunked)}")
    print(f"serving bf16 chunked at budget 256: TTFT median "
          f"{chunked.get('ttft_ms_median', float('nan')):.1f} ms (the "
          f"reading on the first kernel {CHUNKED_FIRST_TTFT_MS}), mixed step "
          f"median {chunked.get('step_ms_median', float('nan')):.2f} ms "
          f"({CHUNKED_FIRST_STEP_MS})")
    out["chunked"] = chunked

    # -- fp32 token identity: kernel #1 vs gather vs generate, and the
    # chunked path (budget 64, the JAX default) against both
    srv_k, toks_k, mk = serve(torch, fp32, "kernel", params, requests)
    _srv_g, toks_g, mg = serve(torch, fp32, "gather", params, requests)
    _srv_c, toks_c, mc = serve(torch, fp32, "kernel", params, requests,
                               chunked_prefill={"token_budget": 64})
    out["chunked_fp32"] = {
        "token_budget": 64, "mixed_steps": mc["mixed_steps"],
        "kernel_launches": mc["launches"]["chunked_prefill_attention_tf32"],
        "first_kernel_launches": mc["launches"]["chunked_prefill_attention"]}
    print(f"serving fp32 chunked@64 (kernel #2's fp32 run kernels: one "
          f"call a layer a mixed step, calls == mixed_steps x 12; the first "
          f"kernel 0): {json.dumps(out['chunked_fp32'])}")
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
    srv_i8b, toks_i8b, m = serve(torch, bf16, "kernel", params, requests,
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
    out["int8_chunked"] = check_int8_chunked_bf16(torch, params, requests,
                                                  srv_i8b, toks_i8b)
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
          f"(atol 1e-5; the fp32 run kernels' calls "
          f"{mic['launches']['chunked_prefill_attention_tf32']})")
    out["int8_chunked_fp32"] = {
        "token_budget": 64, "mixed_steps": mic["mixed_steps"],
        "kernel_launches":
            mic["launches"]["chunked_prefill_attention_tf32"]}
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
    prefix_first = {}
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
        if label == "chunked":
            prefix_first["prefix chunked@256"] = \
                mp["launches"]["chunked_prefill_attention"]
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

    # the first kernel on no fp32 chunked trace (serve() fails a run whose
    # counts are not its route's; this sums them for the kernels line)
    first = {label: m["launches"]["chunked_prefill_attention"]
             for label, m in (("chunked@64", mc), ("int8 chunked@64", mic))}
    first.update(prefix_first)
    if any(first.values()):
        fail(f"the first chunked-prefill kernel launched on fp32 served "
             f"traces: {first}")
    print(f"the first chunked-prefill kernel's launches over the fp32 "
          f"chunked traces: {first}")

    out["decode_profile"] = profile_decode(torch, params, requests)
    out["chunked_profile"] = profile_chunked(torch, params, requests)
    return out


# a first difference between two bf16 int8-pool paths is a tie when each
# served token is its own path's choice between the two, by the plain
# model's logits there, within this many bf16 rounding steps of the top
# logit (the kernel path and the plain gather path round the same sums at
# other places)
BF16_TIE_STEPS = 8


def check_bf16_int8_ties(torch, name, srv_c, srv_b, got, want, plens):
    """The bf16 tie rule between the chunked (``got``, served by ``srv_c``)
    and bucketed (``want``, ``srv_b``) int8-pool paths: the two models
    differ (the bucketed prompt attends over its unquantized dense cache,
    the chunked one over the quantized pool), so rows may diverge, but at
    a request's first difference each served token must be its own
    model's choice between the two tokens (:func:`int8_logits`, the plain
    gather path) within BF16_TIE_STEPS bf16 steps of the top logit.
    Returns (requests differing, worst margin in steps)."""
    lc = int8_logits(torch, srv_c, True)
    lb = int8_logits(torch, srv_b, False)
    differ, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        at = first_diff(a, b)
        if at is None and len(a) == len(b):
            continue
        if at is None or at < plens[i]:
            fail(f"{name}: request {i} differs in length or prompt")
        c_logits, b_logits = lc(a[:at], plens[i]), lb(a[:at], plens[i])
        ta, tb = a[at], b[at]
        step = float(round_step(torch, c_logits.abs().max()))
        # how far each path's plain model prefers the other path's token
        miss = max(float(c_logits[tb] - c_logits[ta]),
                   float(b_logits[ta] - b_logits[tb])) / step
        print(f"{name}: request {i} first differs at position {at} "
              f"(tokens {ta} / {tb}): the chunked model prefers its token by "
              f"{float(c_logits[ta] - c_logits[tb]):.4g}, the bucketed "
              f"model its own by {float(b_logits[tb] - b_logits[ta]):.4g} "
              f"(a bf16 step of the top logit {step:.3g})")
        if miss > BF16_TIE_STEPS:
            fail(f"{name}: request {i} differs at {at} where a path's "
                 f"plain model prefers the other token by {miss:.3g} bf16 "
                 f"steps > {BF16_TIE_STEPS} (not a tie)")
        differ += 1
        worst = max(worst, miss)
    return differ, worst


def check_int8_chunked_bf16(torch, params, requests, srv_b, toks_b):
    """Kernel #2's int8 branch on the served trace: the bf16 trace over the
    int8 pool at ``chunked_prefill: {token_budget: 256}`` (the run kernels
    over int8 pools; measured second): launches == mixed_steps x 12, no
    plain version, no gather, no dense attention; its mixed step and TTFT;
    its tokens against the int8 bucketed bf16 run (``srv_b``, ``toks_b``)
    under the bf16 tie rule (:func:`check_bf16_int8_ties`). Then the same
    trace with every kernel call held against its plain version on the
    served pools (bf16 2e-2)."""
    from deepspeed_tpu_torch.ops.transformer import chunked_prefill

    bf16 = torch.bfloat16
    cfg = {"int8_kv_cache": True, "chunked_prefill": {"token_budget": 256}}
    if chunked_prefill._route(bf16, torch.int8, 64) != "tc":
        fail("bf16 q over int8 pools does not take the run kernels")
    serve(torch, bf16, "kernel", params, requests, **cfg)
    srv, toks, m = serve(torch, bf16, "kernel", params, requests, **cfg)
    plens = [len(p) for p, _ in requests]
    differ, worst = check_bf16_int8_ties(
        torch, "bf16 int8 chunked@256 vs int8 bucketed", srv, srv_b, toks,
        toks_b, plens)
    _srv, _toks, mb = serve(torch, bf16, "kernel", params, requests,
                            attention="both", **cfg)
    row = {"dtype": "bfloat16", "token_budget": 256,
           "mixed_steps": m["mixed_steps"],
           "kernel_launches": m["launches"]["chunked_prefill_attention_tc"],
           **step_summary(m),
           "requests_differing_from_bucketed": differ,
           "worst_tie_margin_bf16_steps": worst,
           "held_calls": mb["checked_calls"],
           "held_max_abs_err": mb["max_err"]}
    print(f"serving bf16 int8 pool chunked at budget 256 (kernel #2's int8 "
          f"branch: the run kernels over int8 pools, calls == mixed_steps x "
          f"12, no gather, no plain version; then each call held against "
          f"its plain version on the served pools, bf16 2e-2): "
          f"{json.dumps(row)}")
    print(f"serving bf16 int8 chunked at budget 256: mixed step median "
          f"{row.get('step_ms_median', float('nan')):.2f} ms, TTFT median "
          f"{row.get('ttft_ms_median', float('nan')):.1f} ms; "
          f"{row['kernel_launches']} run-kernel calls over int8 pools")
    return row


# ---------------------------------------------------------------------------
# 3b. speculative serving and resilience
# ---------------------------------------------------------------------------

SPEC_K = 4
# the clean traces run guarded: a resilience block that must stay at rung 0
RESIL_ON = {"resilience": {"enabled": True}}


def spec_block(k):
    return {"speculative": {"enabled": True, "k": k}}


def check_verify_kernel(torch, report, k):
    """Kernel #1 at the verify's S = k + 1 (and S = 9, k = 8's two query
    groups) against its plain version, bf16 and fp32, at a 4- and a
    64-block window; then timed at the serving path's shapes
    (:func:`time_paged`). Fills the kernels line's verify row."""
    from deepspeed_tpu_torch.ops.transformer.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    h, d, bs, b = 12, 64, 16, 8
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for s in (k + 1, 9):
            for wb in (4, 64):
                q, pools, bt, pos = paged_case(torch, dtype, b, s, h, d, bs,
                                               wb, seed=300 + wb + s)
                kp, vp = pools[0]
                got = paged_decode_attention(q, kp, vp, None, None, bt, pos,
                                             block_size=bs)
                want = paged_decode_attention_reference(q, kp, vp, bt, pos,
                                                        block_size=bs)
                err = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err > KERNEL_TOL[name]:
                    fail(f"verify kernel #1 {name} S={s} WB={wb}: max |err| "
                         f"{err} > {KERNEL_TOL[name]} or non-finite")
                if name == "bfloat16" and s == k + 1:
                    worst = max(worst, err)
    t = time_paged(torch, torch.bfloat16, k + 1, seed=41)
    t9 = time_paged(torch, torch.bfloat16, 9, seed=43)
    print(f"verify kernel #1, bf16, S={k + 1} (k={k}): {t['ms']:.4f} ms, "
          f"SDPA {t['library_ms']:.4f}, bound {t['bound_ms']:.4f}, ratio to "
          f"SDPA {t['ms'] / t['library_ms']:.3f}; S=9 (k=8, grid z=2) "
          f"{t9['ms']:.4f} ms, SDPA {t9['library_ms']:.4f}")
    report.update(ms=t["ms"], plain_ms=t["plain_ms"],
                  library_ms=t["library_ms"], bound_ms=t["bound_ms"],
                  bound_by="bytes", max_abs_err=worst)
    return {"verify_ms": t["ms"], "verify_sdpa_ms": t["library_ms"],
            "verify_bound_ms": t["bound_ms"], "verify_s9_ms": t9["ms"],
            "verify_s9_sdpa_ms": t9["library_ms"]}


def spec_summary(m, k):
    rounds, proposed = m["spec_rounds"], m["spec_proposed"]
    return {"spec_rounds": rounds, "accept_rate":
            m["spec_accepted"] / max(1, proposed),
            "tokens_per_round": m["spec_new_tokens"] / max(1, rounds),
            "tokens_per_row_verify":
                m["spec_new_tokens"] / max(1, proposed / k),
            "launches_by_queries": m["launches_by_queries"]}


def clean_resilience(srv, label):
    """A clean trace ran guarded and never left rung 0."""
    resil = srv._resil
    if resil is None or resil.degraded_level != 0 or any(
            resil.counters.values()):
        fail(f"{label}: resilience manager {resil and resil.counters}, "
             f"degraded level {resil and resil.degraded_level} on a clean "
             f"trace")


def profile_spec(torch, params, requests, steps=6):
    """``steps`` speculative rounds of the bf16 kernel path at k = 4: the
    8 longest requests admitted, no prefill in the window."""
    srv = serving_engine(torch, torch.bfloat16, "kernel", params,
                         **spec_block(SPEC_K))
    for p, n in sorted(requests, key=lambda r: -r[1])[:8]:
        srv.submit(p, n)
    while srv.sched.queue_depth:
        srv.step()
    rounds = srv.stats["spec_rounds"]

    def spec_round(info):
        if info["prefilled"] or not info["active"]:
            fail(f"spec profile window is not speculative decode: {info}")

    out = profile_steps(torch, srv, steps, f"speculative rounds (bf16, "
                        f"k={SPEC_K})", spec_round)
    if srv.stats["spec_rounds"] - rounds != steps:
        fail("spec profile: a step of the window was not a spec round")
    return out


def check_speculative(torch, card, report):
    """Phase 3b on full-width GPT-2 (random weights, seed 0), phase 3's
    16-request trace: bf16 speculative serving at k = 4 (draft = the first
    6 layers) beside the same trace without it, guarded by resilience;
    chunked at budget 256 and the int8 pool with speculation; fp32 token
    identity at k = 4 and 8 against plain decode and ``generate``; the
    same with a draft that agrees more often, and a run to max_model_len
    whose verify writes pass the table; a fault run that recovers and
    climbs the ladder; the verify's S = k + 1 launch of kernel #1
    timed."""
    from deepspeed_tpu_torch.models import GPT_CONFIGS, init_gpt_params

    t_phase = time.perf_counter()
    cfg = GPT_CONFIGS["gpt2"]
    params = init_gpt_params(cfg, seed=0)
    requests = trace(cfg)
    plens = [len(p) for p, _ in requests]
    bf16, fp32 = torch.bfloat16, torch.float32
    k = SPEC_K
    spec = spec_block(k)
    out = {"verify": check_verify_kernel(torch, report, k)}

    # -- bf16 speculative and plain serving, each run once to warm up, then
    # measured in turn
    serve(torch, bf16, "kernel", params, requests, **RESIL_ON)
    serve(torch, bf16, "kernel", params, requests, **spec, **RESIL_ON)
    srv_p, toks_p, mp = serve(torch, bf16, "kernel", params, requests,
                              **RESIL_ON)
    srv_s, toks_s, ms = serve(torch, bf16, "kernel", params, requests,
                              **spec, **RESIL_ON)
    clean_resilience(srv_p, "bf16 plain")
    clean_resilience(srv_s, "bf16 speculative")
    if srv_s._draft_layers != cfg.num_layers // 2 or not ms["spec_rounds"] \
            or ms["kernel_steps"] != ms["spec_rounds"]:
        fail(f"bf16 speculative: draft {srv_s._draft_layers} layers, "
             f"{ms['spec_rounds']} spec rounds of {ms['kernel_steps']}")
    report["launches"] = ms["launches_by_queries"][k + 1]
    rows = {}
    for label, m in (("plain", mp), ("speculative", ms)):
        rows[label] = {
            "decode_tokens_per_s": m["decode_tokens"]
            / (sum(m["step_ms"]) / 1e3),
            "decode_step_ms_median": median(m["step_ms"]),
            "ttft_ms_median": median(m["ttft_ms"]),
            "ttft_ms_p90": quantile(m["ttft_ms"], 0.9),
            "generated_tokens_per_s_over_wall": m["gen_tokens_per_s"],
            "decode_steps": m["decode_steps"], "wall_s": m["wall_s"],
            "kernel1_launches": m["launches"]["paged_decode_attention"]}
    rows["speculative"].update(spec_summary(ms, k))
    diffs = [(i, first_diff(a, b)) for i, (a, b) in
             enumerate(zip(toks_s, toks_p)) if a != b]
    rows["speculative"]["bf16_requests_differing_from_plain"] = len(diffs)
    print(f"serving bf16 speculative k={k} (kernel #1 launches == "
          f"spec_rounds x (k x 6 + 12), no gather, no plain version, "
          f"degraded_level 0) beside the same trace without it: "
          f"{json.dumps(rows)}")
    print(f"bf16 speculative vs plain (information; bf16 logits differ "
          f"near ties): {len(diffs)} of {len(requests)} requests differ, "
          f"(request, first differing position): {diffs}")
    sp, pl = rows["speculative"], rows["plain"]
    print(f"serving bf16 speculative: decode {sp['decode_tokens_per_s']:.1f} "
          f"tokens/s against {pl['decode_tokens_per_s']:.1f} plain (ratio "
          f"{sp['decode_tokens_per_s'] / pl['decode_tokens_per_s']:.4f}), "
          f"TTFT median {sp['ttft_ms_median']:.1f} ms against "
          f"{pl['ttft_ms_median']:.1f}, accept rate {sp['accept_rate']:.4f}"
          f" ({card})")
    out["bf16"] = rows

    # -- chunked at budget 256 and the int8 pool, with speculation
    for label, extra in (("chunked", {"chunked_prefill":
                                      {"token_budget": 256}}),
                         ("int8", {"int8_kv_cache": True})):
        srv, _toks, m = serve(torch, bf16, "kernel", params, requests,
                              **spec, **extra, **RESIL_ON)
        clean_resilience(srv, f"bf16 {label} speculative")
        if not m["spec_rounds"] or (label == "chunked"
                                    and not m["mixed_steps"]):
            fail(f"bf16 {label} speculative: {m['spec_rounds']} spec "
                 f"rounds, {m['mixed_steps']} mixed steps")
        row = {"mixed_steps": m["mixed_steps"], "launches": m["launches"],
               **spec_summary(m, k), **step_summary(m)}
        print(f"serving bf16 {label} + speculative k={k}: {json.dumps(row)}")
        out[label] = row

    # -- fp32 token identity: speculative at k = 4 and k = 8 (every kernel
    # call of the k = 8 run held against its plain version) against plain
    # decode and generate
    srv_f, toks_f, _ = serve(torch, fp32, "kernel", params, requests)
    eng = srv_f.engine
    _srv, toks4, m4 = serve(torch, fp32, "kernel", params, requests, **spec,
                            **RESIL_ON)
    _srv, toks8, m8 = serve(torch, fp32, "kernel", params, requests,
                            attention="both", **spec_block(8), **RESIL_ON)
    ties = check_identity(torch, eng, "fp32 spec k=4 vs plain", toks4,
                          toks_f, plens)
    ties += check_identity(torch, eng, "fp32 spec k=8 vs plain", toks8,
                           toks_f, plens)
    for i in sorted(range(len(requests)), key=lambda i: plens[i])[::5]:
        p, n = requests[i]
        gen = eng.generate([p], max_new_tokens=n)[0].tolist()
        for kk, toks in ((4, toks4), (8, toks8)):
            ties += check_identity(
                torch, eng, f"fp32 spec k={kk} vs generate (request {i})",
                [toks[i]], [gen], [plens[i]])
    print(f"fp32 speculative identity: k=4 {json.dumps(spec_summary(m4, 4))}"
          f", k=8 {json.dumps(spec_summary(m8, 8))}, every kernel #1 call "
          f"of the k=8 run ({m8['checked_calls']}) held against its plain "
          f"version, max |err| {m8['max_err']:.3g} (atol 1e-5); ties "
          f"{ties}")
    out["fp32"] = {"ties": ties, "k4": spec_summary(m4, 4),
                   "k8": spec_summary(m8, 8),
                   "k8_checked_calls": m8["checked_calls"],
                   "k8_max_err": m8["max_err"]}

    # -- fp32 with a draft that agrees more often: multi-token appends, full
    # accepts, and a run that ends at max_model_len at k = 8
    out["accepting"] = check_accepting_spec(torch, params, requests, plens)

    # -- the fault run: a decode fault wide enough to exhaust the retries
    # (rebuild + replay), then a slow step: the ladder climbs past rung 2
    out["fault"] = check_fault_run(torch, params, requests, plens, eng,
                                   toks4)
    out["profile"] = profile_spec(torch, params, requests)
    print(f"phase 3b: {time.perf_counter() - t_phase:.1f} s")
    return out


# The upper layers' output projections are scaled by this in the
# accepting runs, so the first 6 layers' draft agrees with the target on
# most tokens (``tests/test_torch_spec.py`` scales its tiny GPT so).
DRAFT_SCALE = 0.2
# the accept rate the accepting trace must reach (0.283 at full width on
# an H100: a quarter of the drafts, and full accepts, are enough to drive
# multi-token appends and the bonus token)
ACCEPT_MIN = 0.2


def draft_friendly(params, cfg, dl):
    """``params`` with layers ``dl..``'s attention and MLP output
    projections scaled by ``DRAFT_SCALE``."""
    out = dict(params)
    for i in range(dl, cfg.num_layers):
        for site in ("c_proj", "mlp_proj"):
            for leaf in ("weight", "bias"):
                key = f"h.{i}.{site}.{leaf}"
                out[key] = params[key] * DRAFT_SCALE
    return out


class RoundGains:
    """The tokens each row gains in each speculative round while a run
    lasts (``gains``; a full accept with its bonus token gains k + 1)."""

    def __enter__(self):
        from deepspeed_tpu_torch.serving.engine import ServeEngine

        self.cls, self.orig, self.gains = (ServeEngine,
                                           ServeEngine._spec_round, [])
        orig, gains = self.orig, self.gains

        def noted(srv, active, info):
            before = [len(s.tokens) for s in active]
            n = orig(srv, active, info)
            gains.extend(len(s.tokens) - b for s, b in zip(active, before))
            return n

        ServeEngine._spec_round = noted
        return self

    def __exit__(self, *exc):
        self.cls._spec_round = self.orig


def check_accepting_spec(torch, params, requests, plens):
    """fp32 speculation with a draft that agrees more often
    (:func:`draft_friendly`): the 16-request trace at k = 4 equals plain
    decode under the tie rule, with an accept rate of at least
    ``ACCEPT_MIN`` and rows that accept all 4 drafts and take the bonus
    token; then one request whose run ends at max_model_len, at k = 8:
    its last verify chunks write past the row's table, those writes land
    in scratch block 0 (no pool block outside the row's own and block 0
    changes), rounds append several tokens, and its tokens equal plain
    decode's."""
    import numpy as np

    from deepspeed_tpu_torch.models import GPT_CONFIGS

    cfg = GPT_CONFIGS["gpt2"]
    fp32 = torch.float32
    sparams = draft_friendly(params, cfg, cfg.num_layers // 2)
    srv_p, toks_p, mp = serve(torch, fp32, "kernel", sparams, requests)
    eng = srv_p.engine
    with RoundGains() as trace_gains:
        srv_s, toks_s, m = serve(torch, fp32, "kernel", sparams, requests,
                                 **spec_block(SPEC_K), **RESIL_ON)
    clean_resilience(srv_s, "fp32 accepting speculative")
    summary = spec_summary(m, SPEC_K)
    full = trace_gains.gains.count(SPEC_K + 1)
    if summary["accept_rate"] < ACCEPT_MIN or not full:
        fail(f"fp32 accepting speculative: accept rate "
             f"{summary['accept_rate']} < {ACCEPT_MIN}, or no full accept "
             f"({full} of {len(trace_gains.gains)} row rounds)")
    ties = check_identity(torch, eng, "fp32 accepting spec k=4 vs plain",
                          toks_s, toks_p, plens)

    # one request to max_model_len at k = 8, beside plain decode
    k = 8
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, 1000).tolist()
    srv = serving_engine(torch, fp32, "kernel", sparams, **spec_block(k),
                         **RESIL_ON)
    n_new = srv.max_model_len - len(prompt)
    before = [tuple(t.clone() for t in layer if t is not None)
              for layer in srv._pools]
    rid = srv.submit(prompt, n_new)
    row_blocks, clamped = set(), 0
    alloc = srv.pool.alloc

    def alloc_noted(n):          # the row's blocks: all the pool hands out
        got = alloc(n)
        row_blocks.update(got or ())
        return got

    srv.pool.alloc = alloc_noted
    with PlainCalls(serving_plain_targets("kernel", False, False)) as plain, \
            RoundGains() as max_len_gains:
        while not srv.idle():
            # a round from pos writes pos..pos + k; past max_model_len is
            # past the row's table
            seq = next(iter(srv.sched.running.values()), None)
            clamped += seq is not None and seq.pos + k >= srv.max_model_len
            srv.step()
    gains = max_len_gains.gains
    toks = srv.results[rid]["tokens"]
    if srv.results[rid]["status"] != "finished" \
            or len(toks) != srv.max_model_len:
        fail(f"spec to max_model_len: {srv.results[rid]['status']}, "
             f"{len(toks)} tokens")
    if any(plain.calls.values()):
        fail(f"spec to max_model_len: a plain version ran: {plain.calls}")
    if not clamped or max(gains) < 2:
        fail(f"spec to max_model_len: {clamped} rounds wrote past the "
             f"table, tokens per round {gains}")
    others = torch.ones(srv.scfg.kv_num_blocks, dtype=torch.bool,
                        device="cuda")
    others[sorted(row_blocks | {0})] = False
    changed = sum(int((a[others] != b[others]).any())
                  for layer, was in zip(srv._pools, before)
                  for a, b in zip((t for t in layer if t is not None), was))
    if changed or srv.pool.used_blocks:
        fail(f"spec to max_model_len: {changed} pool tensors changed "
             f"outside the row's {len(row_blocks)} blocks and scratch "
             f"block 0; {srv.pool.used_blocks} blocks leaked")
    ref = serving_engine(torch, fp32, "kernel", sparams)
    ref_rid = ref.submit(prompt, n_new)
    want = ref.run_until_complete()[ref_rid]["tokens"]
    ties += check_identity(torch, eng, "fp32 spec k=8 to max_model_len vs "
                           "plain", [toks], [want], [len(prompt)])
    rate = {label: mm["decode_tokens"] / (sum(mm["step_ms"]) / 1e3)
            for label, mm in (("plain", mp), ("speculative", m))}
    row = {"k4": summary, "k4_full_accepts": full,
           "k4_row_rounds": len(trace_gains.gains), "ties": ties,
           "decode_tokens_per_s": rate,
           "decode_ratio": rate["speculative"] / rate["plain"],
           "max_len_k8": {"rounds": len(gains), "tokens_per_round": gains,
                          "rounds_past_the_table": clamped,
                          "row_blocks": len(row_blocks)}}
    print(f"fp32 accepting speculative (upper layers' output projections "
          f"x {DRAFT_SCALE}): {json.dumps(row)}")
    return row


FAULT_PLAN = {"serve_decode_fault_at_step": 6, "serve_decode_fault_count": 3,
              "serve_slow_step_at_step": 20, "serve_slow_step_seconds": 0.5}
FAULT_RESIL = {"max_retries": 2, "retry_base_sec": 0.01, "degrade_after": 1,
               "slow_step_ms": 400.0}


def check_fault_run(torch, params, requests, plens, eng, clean):
    """fp32 speculative k = 4 with ``FAULT_PLAN``: dispatch attempts 6-8
    fail (the first attempt and both retries), so the manager rebuilds the
    pools and replays every live sequence, then the next dispatch runs
    (rung 1: speculation off); attempt 20 is slowed past ``slow_step_ms``,
    and the ladder skips rung 2 (kernel #1 -> gather) on the card for rung
    3 (the batch cap halved). Tokens equal the clean run's (tie rule),
    kernel #1 goes on launching after the climb, no plain version or
    gather runs, no block leaks."""
    from deepspeed_tpu_torch.ops.transformer.paged_attention import \
        paged_decode_attention

    srv = serving_engine(torch, torch.float32, "kernel", params,
                         fault=FAULT_PLAN, **spec_block(SPEC_K),
                         resilience=FAULT_RESIL)
    rids = [srv.submit(p, n) for p, n in requests]
    paged_decode_attention.launches = 0
    at_climb = None
    t0 = time.perf_counter()
    with PlainCalls(serving_plain_targets("kernel", False, False)) as plain:
        while not srv.idle():
            srv.step()
            if at_climb is None and srv._resil.degraded_level >= 2:
                at_climb = paged_decode_attention.launches
    wall = time.perf_counter() - t0
    resil = srv._resil
    res = srv.results
    toks = [res[r]["tokens"] for r in rids]
    if any(res[r]["status"] != "finished" for r in rids):
        fail(f"fault run: statuses {[res[r]['status'] for r in rids]}")
    if resil.counters["recoveries"] < 1 or resil.counters["retries"] < 2:
        fail(f"fault run: counters {resil.counters}")
    if resil.degraded_level != 3 or srv._attn_impl != "kernel" \
            or srv.sched.slot_cap != srv.scfg.max_batch_size // 2 \
            or at_climb is None \
            or paged_decode_attention.launches <= at_climb:
        fail(f"fault run: degraded level {resil.degraded_level}, attention "
             f"{srv._attn_impl}, slot cap {srv.sched.slot_cap}; kernel #1 "
             f"launches {paged_decode_attention.launches}, {at_climb} at "
             f"the climb past rung 1")
    if any(plain.calls.values()):
        fail(f"fault run: a plain version ran: {plain.calls}")
    if srv.pool.used_blocks != 0:
        fail(f"fault run: {srv.pool.used_blocks} KV blocks leaked")
    ties = check_identity(torch, eng, "fp32 fault run vs clean speculative",
                          toks, clean, plens)
    row = {"counters": resil.counters, "anomalies": resil.anomalies,
           "degraded_level": resil.degraded_level,
           "kernel1_launches_at_climb": at_climb,
           "kernel1_launches": paged_decode_attention.launches,
           "spec_rounds": srv.stats["spec_rounds"], "ties": ties,
           "wall_s": wall}
    print(f"fp32 fault run (plan {json.dumps(FAULT_PLAN)}, resilience "
          f"{json.dumps(FAULT_RESIL)}): {json.dumps(row)}")
    return row


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
    ("flash_attention_fwd_dropout", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:160"),
    ("flash_attention_bwd_dq_dropout", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:276"),
    ("flash_attention_bwd_dkv_dropout", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:330"),
    ("fused_ln_matmul_fwd_tc", "fused_ln_tc",
     "deepspeed_tpu/ops/transformer/fused.py:68"),
    ("fused_ln_matmul_bwd_tc", "fused_ln_tc",
     "deepspeed_tpu/ops/transformer/fused.py:81"),
    ("fused_ln_matmul_fwd_tc_fp16", "fused_ln_tc",
     "deepspeed_tpu/ops/transformer/fused.py:68"),
    ("fused_ln_matmul_bwd_tc_fp16", "fused_ln_tc",
     "deepspeed_tpu/ops/transformer/fused.py:81"),
    ("flash_attention_fwd_tc", "flash_attention_tc",
     "deepspeed_tpu/ops/transformer/flash_attention.py:113"),
    ("flash_attention_bwd_dkv_tc", "flash_attention_tc",
     "deepspeed_tpu/ops/transformer/flash_attention.py:287"),
    ("flash_attention_fwd_tc_dropout", "flash_attention_tc",
     "deepspeed_tpu/ops/transformer/flash_attention.py:160"),
    ("flash_attention_bwd_dkv_tc_dropout", "flash_attention_tc",
     "deepspeed_tpu/ops/transformer/flash_attention.py:330"),
    ("flash_attention_bwd_dq_tc", "flash_attention_tc",
     "deepspeed_tpu/ops/transformer/flash_attention.py:231"),
    ("flash_attention_bwd_dq_tc_dropout", "flash_attention_tc",
     "deepspeed_tpu/ops/transformer/flash_attention.py:276"),
    ("sparse_attention_bwd_dq_tc", "sparse_attention_tc",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:147"),
    ("sparse_attention_bwd_dkv_tc", "sparse_attention_tc",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:194"),
    ("sparse_attention_fwd_tc", "sparse_attention_tc",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:88"),
    ("chunked_prefill_attention_tc", "chunked_prefill",
     "deepspeed_tpu/ops/transformer/chunked_prefill.py:65"),
    ("paged_decode_attention_verify", "paged_attention",
     "deepspeed_tpu/ops/transformer/paged_attention.py:69"),
    ("chunked_prefill_attention_tc_int8", "chunked_prefill",
     "deepspeed_tpu/ops/transformer/chunked_prefill.py:65"),
) + tuple(
    (f"{name}_{label}", "flash_attention_tc",
     f"deepspeed_tpu/ops/transformer/flash_attention.py:{line}")
    for label in ("bert128", "bert512")
    for name, line in (("flash_attention_fwd_tc", 113),
                       ("flash_attention_bwd_dq_tc", 231),
                       ("flash_attention_bwd_dkv_tc", 287))) + (
    ("sparse_attention_fwd_block16", "sparse_attention",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:88"),
    ("sparse_attention_bwd_dq_block16", "sparse_attention",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:147"),
    ("sparse_attention_bwd_dkv_block16", "sparse_attention",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:194"),
    ("sparse_attention_bwd_dq_tc16", "sparse_attention_tc16",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:147"),
    ("sparse_attention_bwd_dkv_tc16", "sparse_attention_tc16",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:194"),
    ("sparse_attention_fwd_tc16", "sparse_attention_tc16",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:88"),
    ("flash_attention_fwd_tf32", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:113"),
    ("flash_attention_fwd_tf32_dropout", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:160"),
    ("flash_attention_bwd_dq_tf32", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:231"),
    ("flash_attention_bwd_dkv_tf32", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:287"),
    ("flash_attention_bwd_dq_tf32_dropout", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:276"),
    ("flash_attention_bwd_dkv_tf32_dropout", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:330"),
    ("flash_attention_fwd_d256", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:113"),
    ("flash_attention_bwd_dq_d256", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:231"),
    ("flash_attention_bwd_dkv_d256", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:287"),
    ("flash_attention_fwd_tc256_d256", "flash_attention_tc256",
     "deepspeed_tpu/ops/transformer/flash_attention.py:113"),
    ("flash_attention_bwd_dkv_tc256_d256", "flash_attention_tc256",
     "deepspeed_tpu/ops/transformer/flash_attention.py:287"),
    ("flash_attention_bwd_dq_tc256_d256", "flash_attention_tc256",
     "deepspeed_tpu/ops/transformer/flash_attention.py:231"),
    ("flash_attention_fwd_tf32_d256_fp32", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:113"),
    ("flash_attention_bwd_dq_tf32_d256_fp32", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:231"),
    ("flash_attention_bwd_dkv_tf32_d256_fp32", "flash_attention_tf32",
     "deepspeed_tpu/ops/transformer/flash_attention.py:287"),
    ("flash_attention_fwd_d256_fp32", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:113"),
    ("flash_attention_bwd_dq_d256_fp32", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:231"),
    ("flash_attention_bwd_dkv_d256_fp32", "flash_attention",
     "deepspeed_tpu/ops/transformer/flash_attention.py:287"),
    ("sparse_attention_bwd_dq_tf32", "sparse_attention_tf32",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:147"),
    ("sparse_attention_bwd_dkv_tf32", "sparse_attention_tf32",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:194"),
    ("sparse_attention_bwd_dq_tf32_block16", "sparse_attention_tf32",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:147"),
    ("sparse_attention_bwd_dkv_tf32_block16", "sparse_attention_tf32",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:194"),
    ("sparse_attention_fwd_tf32", "sparse_attention_tf32",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:88"),
    ("sparse_attention_fwd_tf32_block16", "sparse_attention_tf32",
     "deepspeed_tpu/ops/sparse_attention/sparse_attention.py:88"),
    ("fused_ln_matmul_fwd_tf32", "fused_ln_tf32",
     "deepspeed_tpu/ops/transformer/fused.py:68"),
    ("fused_ln_matmul_bwd_tf32", "fused_ln_tf32",
     "deepspeed_tpu/ops/transformer/fused.py:81"),
    ("chunked_prefill_attention_tf32", "chunked_prefill",
     "deepspeed_tpu/ops/transformer/chunked_prefill.py:65"),
    ("chunked_prefill_attention_tf32_int8", "chunked_prefill",
     "deepspeed_tpu/ops/transformer/chunked_prefill.py:65"),
) + tuple(
    ("chunked_prefill_attention_" + chunked_d256_row(name, int8),
     "chunked_prefill", "deepspeed_tpu/ops/transformer/chunked_prefill.py:65")
    for name in ("bfloat16", "float32") for int8 in (False, True)) + (
    ("fused_ln_matmul_fwd_d2048", "fused_ln",
     "deepspeed_tpu/ops/transformer/fused.py:68"),
    ("fused_ln_matmul_bwd_d2048", "fused_ln",
     "deepspeed_tpu/ops/transformer/fused.py:81"),
    ("fused_ln_matmul_fwd_tc_d2048", "fused_ln_tc",
     "deepspeed_tpu/ops/transformer/fused.py:68"),
    ("fused_ln_matmul_bwd_tc_d2048", "fused_ln_tc",
     "deepspeed_tpu/ops/transformer/fused.py:81"),
)
# the flash kernels of the 16-bit training step: the tensor-core forward,
# dq and dk/dv; the FMA kernels take head dims above 128 only
FLASH_NAMES = ("flash_attention_fwd_tc", "flash_attention_bwd_dq_tc",
               "flash_attention_bwd_dkv_tc")
FLASH_FMA_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv")
# the fp32 path's forward, dq and dk/dv (3xTF32)
FLASH_TF32_NAMES = ("flash_attention_fwd_tf32", "flash_attention_bwd_dq_tf32",
                    "flash_attention_bwd_dkv_tf32")
# #6/#7 of the 16-bit steps (wgmma) and of the fp32 ones (3xTF32 on
# wgmma); fused_ln.cu's (the first version, on no path)
FUSED_LN_TC_NAMES = FUSED_LN_ROUTES["fused_ln_tc"]
FUSED_LN_TF32_NAMES = FUSED_LN_ROUTES["fused_ln_tf32"]
FUSED_LN_FIRST_NAMES = FUSED_LN_ROUTES["fused_ln"]
# the sources whose ptxas report is printed kernel by kernel
TC_SOURCES = ("flash_attention_tc", "flash_attention_tc256", "fused_ln_tc",
              "sparse_attention_tc", "sparse_attention_tc16",
              "chunked_prefill",
              "flash_attention_tf32", "sparse_attention_tf32",
              "fused_ln_tf32")


# ---------------------------------------------------------------------------
# 4. training end to end
# ---------------------------------------------------------------------------

# Phase 3c's paths: each served with telemetry on and off
TELEMETRY_PATHS = (
    ("bucketed", {}),
    ("chunked", {"chunked_prefill": {"token_budget": 256}}),
    ("int8", {"int8_kv_cache": True}),
    ("spec", {**spec_block(SPEC_K), **RESIL_ON}),
)
# the spans of a decode round: one per step that had active rows
ROUND_SPANS = ("decode_step", "mixed_step", "spec_step")
# kernel #1's CUDA function, as the profiler names it
KERNEL1_SYMBOL = "paged_decode_kernel"


def telemetry_block(run_dir, sync_spans=True, profiler_dir=None):
    """Everything serving telemetry has: JSONL and memory sinks, the trace,
    the request records, the int8 KV error gauges."""
    trace = {"enabled": True, "sync_spans": sync_spans}
    if profiler_dir is not None:
        trace["jax_profiler_dir"] = profiler_dir
    return {"enabled": True, "dir": run_dir,
            "metrics": {"sinks": ["jsonl", "memory"]}, "trace": trace,
            "requests": {"enabled": True}, "numerics": {"enabled": True}}


def check_telemetry_files(srv, label, run_dir, n_requests, int8):
    """Close the engine, then hold its telemetry: one finished record per
    request whose categories sum to its lifetime within 1 ms, a trace
    that parses with one round span per decode step and one prefill span
    per cold prefill, finite KV error gauges (two per cold prefill on the
    int8 pool, none otherwise), and ``tools/slo_report.py`` exiting 0 on
    the directory. Returns the span counts."""
    import collections

    sink = next(s for s in srv.telemetry.registry.sinks
                if type(s).__name__ == "InMemorySink")
    srv.close()
    with open(os.path.join(run_dir, "requests.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if len(records) != n_requests \
            or any(r["status"] != "finished" for r in records):
        fail(f"telemetry {label}: {len(records)} records, statuses "
             f"{sorted({r['status'] for r in records})}")
    worst = max(abs(sum(r["categories"].values()) - r["lifetime_sec"])
                for r in records)
    if worst > 1e-3:
        fail(f"telemetry {label}: categories miss a lifetime by {worst} s")
    with open(os.path.join(run_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = collections.Counter(e["name"] for e in events if e["ph"] == "X")
    rounds = sum(spans[n] for n in ROUND_SPANS)
    prefills = 0 if srv.scfg.chunked_prefill else n_requests
    if rounds != srv.stats["decode_steps"] or spans["prefill"] != prefills:
        fail(f"telemetry {label}: spans {dict(spans)} for "
             f"{srv.stats['decode_steps']} decode steps, {prefills} cold "
             f"prefills")
    kv = [r["value"] for r in sink.rows if r["tag"].startswith("numerics/")]
    if len(kv) != (2 * n_requests if int8 else 0) or not all(
            v == v and abs(v) != float("inf") for v in kv):
        fail(f"telemetry {label}: KV error gauges {kv}")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "slo_report.py"),
         run_dir], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"telemetry {label}: tools/slo_report.py exited "
             f"{out.returncode}: {out.stderr[-2000:]}")
    return dict(spans), (max(kv) if kv else None), worst


def check_telemetry(torch, card):
    """Phase 3c: serving telemetry on full-width GPT-2 (random weights,
    seed 0) over phase 3's 16-request trace in bf16, on the bucketed,
    chunked 256, int8 and speculative k = 4 (under ``serving.resilience``)
    paths, each with telemetry off and on (``telemetry_block``, sync
    spans): the same tokens and #1/#2 launch counts on and off, the files
    as ``check_telemetry_files`` holds them; the bucketed path also with a
    trace without sync spans, and in turns, for the overhead; then a
    short run with
    ``trace.jax_profiler_dir``, whose torch.profiler trace must name
    kernel #1."""
    from deepspeed_tpu_torch.models import GPT_CONFIGS, init_gpt_params

    t_phase = time.perf_counter()
    cfg = GPT_CONFIGS["gpt2"]
    params = init_gpt_params(cfg, seed=0)
    requests = trace(cfg)
    bf16 = torch.bfloat16
    root = os.path.join(HERE, "build", "telemetry")
    shutil.rmtree(root, ignore_errors=True)
    serve(torch, bf16, "kernel", params, requests)          # warm-up
    out = {}
    for label, extra in TELEMETRY_PATHS:
        # the bucketed path measures the overhead in turns (off, on,
        # synced, synced, on, off); the others run off, then synced
        order = (("off", "on", "on_sync", "on_sync", "on", "off")
                 if label == "bucketed" else ("off", "on_sync"))
        got = {}
        for i, name in enumerate(order):
            tel = None if name == "off" else telemetry_block(
                os.path.join(root, f"{label}_{name}_{i}"),
                sync_spans=name == "on_sync")
            srv, toks, m = serve(torch, bf16, "kernel", params, requests,
                                 telemetry=tel, **extra)
            row = got.setdefault(name, {
                "tokens": toks, "step_ms": [], "ttft_ms": [],
                "launches": m["launches"],
                "launches_by_queries": m["launches_by_queries"]})
            row["step_ms"] += m["step_ms"]
            row["ttft_ms"] += m["ttft_ms"]
            if toks != got["off"]["tokens"] \
                    or m["launches"] != got["off"]["launches"] \
                    or m["launches_by_queries"] != \
                    got["off"]["launches_by_queries"]:
                fail(f"telemetry {label}/{name}: tokens or launches differ "
                     f"from the run without telemetry: {m['launches']} "
                     f"{m['launches_by_queries']} against "
                     f"{got['off']['launches']} "
                     f"{got['off']['launches_by_queries']}")
            if tel is not None:
                spans, kv_max, worst = check_telemetry_files(
                    srv, f"{label}/{name}", tel["dir"], len(requests),
                    label == "int8")
                row.update(spans=spans, kv_rel_err_max=kv_max,
                           categories_worst_s=worst)
        out[label] = {name: {
            "step_ms_median": median(row["step_ms"]),
            "ttft_ms_median": median(row["ttft_ms"]),
            **{k: v for k, v in row.items()
               if k not in ("tokens", "step_ms", "ttft_ms")}}
            for name, row in got.items()}
        print(f"telemetry {label}: decode step ms median / TTFT ms median "
              + ", ".join(f"{name} {row['step_ms_median']:.3f} / "
                          f"{row['ttft_ms_median']:.1f}"
                          for name, row in out[label].items())
              + f" ({card}); {json.dumps(out[label])}")

    # the torch.profiler capture: 4 requests of 8 tokens
    short = [(p, 8) for p, _n in requests[:4]]
    run_dir = os.path.join(root, "profiler")
    prof_dir = os.path.join(run_dir, "prof")
    srv, _toks, m = serve(torch, bf16, "kernel", params, short, wave1=4,
                          second_wave="prefill", telemetry=telemetry_block(
                              run_dir, profiler_dir=prof_dir))
    if not srv.telemetry.tracer.profiler_active:
        fail("telemetry: trace.jax_profiler_dir started no torch.profiler "
             "capture")
    check_telemetry_files(srv, "profiler", run_dir, len(short), False)
    if srv.telemetry.tracer.profiler_active:
        fail("telemetry: close() left the torch.profiler capture running")
    from deepspeed_tpu_torch.telemetry.tracer import PROFILER_TRACE_FILE

    path = os.path.join(prof_dir, PROFILER_TRACE_FILE)
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    hits = sorted(n for n in names if KERNEL1_SYMBOL in n)
    if not hits:
        fail(f"telemetry: the torch.profiler trace {path} names no "
             f"{KERNEL1_SYMBOL} ({len(names)} event names)")
    out["profiler"] = {"trace_mb": os.path.getsize(path) / 2**20,
                       "kernel1_names": hits[:2],
                       "kernel1_launches": m["launches"][
                           "paged_decode_attention"]}
    print(f"telemetry profiler capture: {json.dumps(out['profiler'])}")
    b = out["bucketed"]
    for name in ("on", "on_sync"):
        print(f"telemetry overhead, bucketed bf16, {name} against off: "
              f"decode step {b[name]['step_ms_median']:.3f} / "
              f"{b['off']['step_ms_median']:.3f} ms (ratio "
              f"{b[name]['step_ms_median'] / b['off']['step_ms_median']:.4f})"
              f", TTFT {b[name]['ttft_ms_median']:.1f} / "
              f"{b['off']['ttft_ms_median']:.1f} ms (ratio "
              f"{b[name]['ttft_ms_median'] / b['off']['ttft_ms_median']:.4f})"
              f" ({card})")
    print(f"phase 3c: {time.perf_counter() - t_phase:.1f} s")
    return out


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
            "flash_attention_fwd_tc": fa.flash_attention_fwd_tc,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dq_tc": fa.flash_attention_bwd_dq_tc,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "flash_attention_bwd_dkv_tc": fa.flash_attention_bwd_dkv_tc,
            "flash_attention_fwd_tf32": fa.flash_attention_fwd_tf32,
            "flash_attention_bwd_dq_tf32": fa.flash_attention_bwd_dq_tf32,
            "flash_attention_bwd_dkv_tf32": fa.flash_attention_bwd_dkv_tf32,
            "sparse_attention_fwd": sp.sparse_attention_fwd,
            "sparse_attention_fwd_tc": sp.sparse_attention_fwd_tc,
            "sparse_attention_fwd_tc16": sp.sparse_attention_fwd_tc16,
            "sparse_attention_bwd_dq": sp.sparse_attention_bwd_dq,
            "sparse_attention_bwd_dkv": sp.sparse_attention_bwd_dkv,
            "sparse_attention_bwd_dq_tc": sp.sparse_attention_bwd_dq_tc,
            "sparse_attention_bwd_dkv_tc": sp.sparse_attention_bwd_dkv_tc,
            "sparse_attention_bwd_dq_tc16": sp.sparse_attention_bwd_dq_tc16,
            "sparse_attention_bwd_dkv_tc16":
                sp.sparse_attention_bwd_dkv_tc16,
            "sparse_attention_fwd_tf32": sp.sparse_attention_fwd_tf32,
            "sparse_attention_bwd_dq_tf32": sp.sparse_attention_bwd_dq_tf32,
            "sparse_attention_bwd_dkv_tf32":
                sp.sparse_attention_bwd_dkv_tf32,
            "fused_adam": fused_adam_apply,
            "fused_ln_matmul_fwd": fused.ln_matmul_fwd,
            "fused_ln_matmul_bwd": fused.ln_matmul_bwd,
            "fused_ln_matmul_fwd_tc": fused.ln_matmul_fwd_tc,
            "fused_ln_matmul_bwd_tc": fused.ln_matmul_bwd_tc,
            "fused_ln_matmul_fwd_tf32": fused.ln_matmul_fwd_tf32,
            "fused_ln_matmul_bwd_tf32": fused.ln_matmul_bwd_tf32}


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


def profile_step(torch, engine, batches, what, pick=()):
    """Device busy share and device time by kernel of one profiled
    ``train_batch`` (``pick``: as :func:`kernel_stats`); returns the
    stats, or None without device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batches)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    stats = kernel_stats(prof.events(), 1, wall_us, pick=pick)
    if stats is None:
        print(f"{what} profile: the profiler recorded no device events; "
              f"device busy share not measured")
    else:
        print(f"{what} profile (one train_batch under torch.profiler): "
              f"{json.dumps(stats)}")
    return stats


def profile_dropout_step(torch, engine, batches):
    """One profiled ``train_batch`` at dropout: device busy share and top
    kernels, the device ms of the flash kernels by kernel, and of the hash
    dropout's forward passes (every ``hash_dropout`` call inside a
    ``record_function`` range; the backward's masked multiply runs in
    autograd, outside the ranges, and is not in that sum)."""
    from deepspeed_tpu_torch.ops import dropout as drop_mod
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    orig = drop_mod.hash_dropout

    def ranged(*a, **k):
        with record_function("hash_dropout"):
            return orig(*a, **k)

    drop_mod.hash_dropout = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.train_batch(batches)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        drop_mod.hash_dropout = orig
    events = prof.events()
    stats = kernel_stats(events, 1, wall_us, annotations=("hash_dropout",))
    if stats is None:
        print("dropout training profile: the profiler recorded no device "
              "events; device times not measured")
        return None
    flash = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and "flash_" in e.name:
            key = e.name.split("<")[0].split()[-1]
            flash[key] = flash.get(key, 0.0) + e.time_range.elapsed_us()
    ranges = [e for e in events if e.name == "hash_dropout"
              and e.device_type == DeviceType.CPU]
    dev = sum(getattr(e, "device_time_total", 0.0) for e in ranges)
    stats.update(
        flash_ms_per_step={k: v / 1e3 for k, v in flash.items()},
        hash_dropout_calls_per_step=len(ranges),
        hash_dropout_forward_device_ms_per_step=dev / 1e3,
        hash_dropout_share_of_busy=dev / 1e3 / stats[
            "device_busy_ms_per_step"])
    print(f"dropout training profile (one train_batch under "
          f"torch.profiler): {json.dumps(stats)}")
    return stats


def check_fused_ln_fp16(torch, card):
    """``fp16: {enabled: true, initial_scale_power: 16}`` (dynamic loss
    scale from 2**16, DeepSpeed's documented setting; the default 2**32
    overflows every step here) on ``make_gpt("gpt2", fused_ln=True)`` in
    fp16, phase 4's batch shape, 1 + 2 steps: #6 and #7 launch 192 times
    each per step through the wgmma route's fp16 branch (``fused_ln.cu``'s
    never), flash 96, no plain version runs and the losses are finite
    (fused Adam runs only on the steps the loss scaler does not skip)."""
    import numpy as np

    config = {k: v for k, v in TRAIN_CONFIG.items()
              if k not in ("bf16", "data_types")}
    config["fp16"] = {"enabled": True, "initial_scale_power": 16}
    engine, model, _cfg, batches, per_step, _n = train_engine(
        torch, True, config=config, dtype=torch.float16)
    counters = training_counters()
    engine.train_batch(batches)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with PlainCalls() as plain:
        step_ms, losses = timed_steps(torch, engine, batches, 2)
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in per_step.items():
        if name != "fused_adam" and launches[name] != 2 * n:
            fail(f"fp16 fused_ln training: {name} launched "
                 f"{launches[name]} times in 2 steps, expected {2 * n}")
    if any(plain.calls.values()) or not np.all(np.isfinite(losses)):
        fail(f"fp16 fused_ln training: plain calls {plain.calls}, losses "
             f"{losses}")
    out = {"step_ms": step_ms, "losses": losses, "launches": launches,
           "skipped_steps": engine.skipped_steps,
           "loss_scale": engine.loss_scale(), "card": card}
    print(f"fp16 fused_ln training gpt2 (1 + 2 steps): {json.dumps(out)}")
    del engine, model, batches
    torch.cuda.empty_cache()
    return out


# Phase 6b's model: GPT-3 XL's width (Brown et al. 2020, Table 2.1:
# d_model 2048, 16 heads of 128), its one cut 4 layers of 24, so that the
# whole run stays under its 1200 s; its sites' D = 2048 is above
# fused.TC_MAX_D, so #6 and #7 take csrc/fused_ln_tc.cu's streamed product
WIDE_MODEL = {"hidden_size": 2048, "num_heads": 16, "num_layers": 4}
WIDE_WARMUP, WIDE_STEPS = 1, 2
# the fused step's kernels of csrc/fused_ln_tc.cu above TC_MAX_D, by device
# ms in one profiled step
FUSED_LN_WIDE_PICK = ("stream_gemm_kernel", "ln_rows_kernel",
                      "bwd_gemm_kernel", "ln_rows_bwd_kernel",
                      "col_partial_kernel")
# The first step's loss of the fused and the unfused model (the same
# weights and batch), relative: the two paths round the same fp32
# LayerNorm to bf16 and sum the same bf16 products in fp32 in other
# orders, so logits differ by bf16 rounding noise (2**-8 of a value at
# most, of either sign); the mean over 65,536 tokens' losses moves far
# less. 2e-3, half a bf16 step, catches a wrong site, not noise.
WIDE_LOSS_TOL = 2e-3


def train_engine(torch, fused_ln, dropout=False, config=TRAIN_CONFIG,
                 **over):
    """bench_gpt2's engine (TRAIN_CONFIG) on full-width GPT-2 with the
    given ``fused_ln``, its fixed batch, and the launches each kernel
    makes per step. ``dropout``: the model as ``make_gpt("gpt2")`` makes
    it, at its default dropout 0.1; else dropout 0. ``over``: further
    GPTConfig fields."""
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import gpt, init_gpt_params, make_gpt

    if not dropout:
        over["dropout_rate"] = 0.0
    model, cfg = make_gpt("gpt2", fused_ln=fused_ln, **over)
    sd = init_gpt_params(cfg, seed=0)
    engine, _opt, _loader, _sched = dtt.initialize(model=model, params=sd,
                                                   config=config)
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    rng = np.random.default_rng(0)
    batches = {"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (gas, micro, TRAIN_SEQ), dtype=np.int32)).cuda()}
    per_layer = cfg.num_layers * gas
    sites = len(gpt._fused_ln_sites(fused_ln))
    per_step = {name: 0 for name in training_counters()}
    per_step.update({name: per_layer for name in FLASH_NAMES})
    # the 16-bit model's sites take the wgmma route; fused_ln.cu's 0
    per_step.update({"fused_adam": 1,
                     "fused_ln_matmul_fwd_tc": sites * per_layer,
                     "fused_ln_matmul_bwd_tc": sites * per_layer})
    n_params = sum(int(np.prod(v.shape)) for v in sd.values())
    return engine, model, cfg, batches, per_step, n_params


def check_training(torch, card, fused_ln=False, dropout=False):
    """Phase 4 (unfused), 6 (``fused_ln=True``) or 7 (``dropout``, the
    default 0.1): the counted, timed and profiled training steps."""
    engine, model, cfg, batches, per_step, n_params = train_engine(
        torch, fused_ln, dropout)
    if dropout and cfg.dropout_rate != 0.1:
        fail(f"make_gpt('gpt2') has dropout_rate {cfg.dropout_rate}")
    what = ("dropout training" if dropout else
            "fused_ln training" if fused_ln else "training")
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
        "fused_update": True, "fused_ln": fused_ln,
        "dropout_rate": cfg.dropout_rate, "steps": TRAIN_STEPS,
        "step_ms_median": med, "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms": step_ms,
        "tokens_per_s": tokens / (med / 1e3),
        "model_tflops_per_s": flops / (med / 1e3) / 1e12,
        "mfu_vs_989_tflops_dense_bf16": flops / (med / 1e3) / BF16_FLOPS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "launches": launches, "card": card}
    print(f"{what} bf16 gpt2 (initialize -> train_batch): "
          f"{json.dumps(training)}")

    if dropout:
        training["profile"] = profile_dropout_step(torch, engine, batches)
    elif profile_step(torch, engine, batches, what) is not None:
        profile_matmuls(torch, engine, batches, what)
    del engine, model
    torch.cuda.empty_cache()
    return training


def profile_matmuls(torch, engine, batches, what):
    """A second profiled step with the operands' shapes recorded (which
    costs host time, so the idle share comes from the first): the matmuls
    by shape, i.e. which products take the GEMM time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        engine.train_batch(batches)
        torch.cuda.synchronize()

    def dev_us(a):
        return getattr(a, "self_device_time_total",
                       getattr(a, "self_cuda_time_total", 0.0))

    ops = [a for a in prof.key_averages(group_by_input_shape=True)
           if a.key in ("aten::mm", "aten::addmm", "aten::bmm")]
    ops.sort(key=lambda a: -dev_us(a))
    print(f"{what} profile, matmuls by input shape (op, shapes, device ms "
          "per step, calls): " + json.dumps(
              [[a.key, str(a.input_shapes)[:90], dev_us(a) / 1e3, a.count]
               for a in ops[:10]]))


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
                     "fused_ln_matmul_fwd_tc":
                         launches["fused_ln_matmul_fwd_tc"],
                     "step_ratio_vs_unfused": median(step_ms) / base_ms}
        del engine, model, batches
        torch.cuda.empty_cache()
    print(f"fused_ln one-site variants (1 + 2 steps each; unfused step "
          f"{base_ms:.2f} ms, {card}): {json.dumps(out)}")
    return out


def check_wide_training(torch, card):
    """Phase 6b: TRAIN_CONFIG (bf16, micro 16 x seq 512, GAS 8, Adam with
    ``fused_update``, ZeRO 2) on GPT-3 XL's width, ``train_engine(torch,
    fused_ln, **WIDE_MODEL)``: d_model 2048, 16 heads of 128, cut to 4
    layers of 24 (the one cut, so that the whole run stays under 1200 s).
    ``fused_ln=True``, then ``False``, in one process, WIDE_WARMUP +
    WIDE_STEPS counted steps each. Fused: #6 and #7 launch 2 sites x 4
    layers x 8 = 64 times a step each through the ``_tc`` wrappers (the
    streamed product: D = 2048 is above ``fused.TC_MAX_D``),
    ``fused_ln.cu``'s and the ``_tf32`` wrappers never; both runs: each
    flash kernel 32 times a step, fused Adam once, no plain version, the
    loss falls. The first step's losses of the two models (the same
    weights and batch) agree within WIDE_LOSS_TOL. Prints both step
    medians, their ratio, tokens/s, peak GB and, from one profiled fused
    step, the device ms of FUSED_LN_WIDE_PICK. Returns the two runs'
    records by ``fused_ln``."""
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    tokens = gas * micro * TRAIN_SEQ
    runs = {}
    for fused_ln in (True, False):
        what = f"wide training (fused_ln={fused_ln})"
        engine, model, cfg, batches, per_step, n_params = train_engine(
            torch, fused_ln, **WIDE_MODEL)
        step_ms, losses, launches = counted_steps(
            torch, engine, batches, per_step, what, WIDE_WARMUP, WIDE_STEPS)
        med = median(step_ms)
        flops = train_flops_per_step(n_params, gas * micro, TRAIN_SEQ,
                                     cfg.hidden_size, cfg.num_layers)
        rec = {"hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
               "num_layers": cfg.num_layers, "params": n_params,
               "micro_batch": micro, "gas": gas, "seq": TRAIN_SEQ,
               "dtype": "bfloat16", "fused_ln": fused_ln,
               "steps": WIDE_STEPS, "step_ms": step_ms,
               "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3),
               "mfu_vs_989_tflops_dense_bf16":
                   flops / (med / 1e3) / BF16_FLOPS,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "losses": losses,
               "launches": {n: c for n, c in launches.items() if c},
               "card": card}
        if fused_ln:
            stats = profile_step(torch, engine, batches, what,
                                 pick=FUSED_LN_WIDE_PICK)
            if stats is not None:
                rec.update(device_busy_ms=stats["device_busy_ms_per_step"],
                           device_ms_per_step=stats["picked_ms_per_step"])
        print(f"{what} bf16, GPT-3 XL width at 4 layers (initialize -> "
              f"train_batch): {json.dumps(rec)}")
        runs[fused_ln] = rec
        del engine, model, batches
        torch.cuda.empty_cache()
    fused, unfused = runs[True], runs[False]
    rel = (abs(fused["losses"][0] - unfused["losses"][0])
           / abs(unfused["losses"][0]))
    ratio = fused["step_ms_median"] / unfused["step_ms_median"]
    fused["step_ratio_vs_unfused"] = ratio
    print(f"wide training (d_model 2048, 16 heads, 4 layers, micro 16 x "
          f"512, GAS 8; {card}): fused step {fused['step_ms_median']:.2f} "
          f"ms, unfused {unfused['step_ms_median']:.2f} ms, ratio "
          f"{ratio:.4f}; {fused['tokens_per_s']:.1f} / "
          f"{unfused['tokens_per_s']:.1f} tokens/s; peak "
          f"{fused['peak_memory_gb']:.3f} / {unfused['peak_memory_gb']:.3f} "
          f"GB; first-step losses {fused['losses'][0]} / "
          f"{unfused['losses'][0]}, relative difference {rel:.3g} (limit "
          f"{WIDE_LOSS_TOL}); the fused step's device ms "
          f"{json.dumps(fused.get('device_ms_per_step'))}")
    if not rel <= WIDE_LOSS_TOL:
        fail(f"wide training: the fused and unfused models' first-step "
             f"losses differ by {rel} relative")
    return runs


def check_training_fp32(torch, seq=512, micro=4, sparse=None,
                        fused_ln=False, dropout=0.0):
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
    runs the unfused model. At ``dropout`` both models drop out at that
    rate with the engines' seeds (one ``rng_seed``, so the same seeds):
    the same masks on both paths (the plain attention uses the kernels'
    mask function). The kernels' run must launch the 3xTF32 forward, dq
    and dk/dv (flash, or with ``sparse`` the block-sparse ones) and never
    the FMA ones. Returns the
    kernels' run's launches, every count set to 0 just before it (the
    fp32 path's rows of the kernels line)."""
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import init_gpt_params, make_gpt
    from deepspeed_tpu_torch.runtime.utils import global_norm

    counters = training_counters()
    counter = counters["sparse_attention_fwd_tf32" if sparse else
                       "flash_attention_fwd_tf32"]
    ln_counter = counters["fused_ln_matmul_bwd_tf32"]
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
        model, cfg = make_gpt("gpt2", dropout_rate=dropout, num_layers=2,
                              dtype=torch.float32, **over)
        engine, *_ = dtt.initialize(model=model,
                                    params=init_gpt_params(cfg, seed=1),
                                    config=conf)
        if label == "kernels":
            for fn in counters.values():
                fn.launches = 0
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
        if label == "kernels":
            launches = {n: fn.launches for n, fn in counters.items()}
            if any(launches[n] for n in FLASH_NAMES + FUSED_LN_TC_NAMES
                   + SPARSE_TC_NAMES):
                fail(f"fp32 comparison: the kernels' run launched a 16-bit "
                     f"route (tensor-core flash or sparse, wgmma "
                     f"fused_ln): {launches}")
            if any(launches[n] for n in FUSED_LN_FIRST_NAMES):
                fail(f"fp32 comparison: the kernels' run launched "
                     f"fused_ln.cu, which no fp32 path takes: {launches}")
            if not sparse and (
                    not all(launches[n] for n in FLASH_TF32_NAMES)
                    or any(launches[n] for n in FLASH_FMA_NAMES)):
                fail(f"fp32 comparison: the forward, dq and dk/dv did not "
                     f"take the 3xTF32 kernels alone: {launches}")
            if sparse and (
                    not all(launches[n] for n in SPARSE_TF32_NAMES)
                    or any(launches[n] for n in SPARSE_FMA_NAMES)):
                fail(f"fp32 comparison: the sparse forward, dq and dk/dv did "
                     f"not take the 3xTF32 kernels alone: {launches}")
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
              else f", fused_ln={fused_ln!r}" if fused_ln
              else f", dropout {dropout}" if dropout else "")
    print(f"training fp32 gpt2-width 2 layers, micro {micro} x {seq}, GAS "
          f"2{layout}: kernels vs plain path: first-step grad |diff|/|grad| "
          f"per leaf: worst {worst} {rel[worst]:.3g} (limit 1e-4); "
          f"{'fused sites' if fused_ln else 'attention'} leaves "
          f"{json.dumps(attn)}; whole tree {whole:.3g}; "
          f"losses {lk} vs {lp}, max rel diff {loss_rel:.3g} (limit 1e-5)")
    if not rel[worst] <= 1e-4 or not loss_rel <= 1e-5:
        fail(f"training fp32{layout}: the kernels' path disagrees with the "
             f"plain path")
    return launches


# ---------------------------------------------------------------------------
# 7b. fp32 training at full width: DeepSpeed's default precision
# ---------------------------------------------------------------------------

# bench_gpt2's shape (micro 16 x seq 512, GAS 8, Adam with the fused
# update, ZeRO 2) with no bf16 / fp16 block: the engine keeps fp32
FP32_TRAIN_CONFIG = {k: v for k, v in TRAIN_CONFIG.items()
                     if k not in ("bf16", "data_types")}
# the profiled step's device ms: the 3xTF32 forward, dq and dk/dv, and
# every GEMM kernel (cuBLAS's names hold "gemm")
FP32_PICK = ("flash_fwd_tf32_kernel", "flash_bwd_dq_tf32_kernel",
             "flash_bwd_dkv_tf32_kernel", "gemm")
# phase 7c's too: csrc/fused_ln_tf32.cu's products, prologues and row pass
FUSED_LN_TF32_PICK = ("ln_mm_tf32_kernel", "ln_prologue_tf32_kernel",
                      "ln_rows_bwd_kernel")
# phase 7c's counted steps after its warm-up (a bring-up check, not a
# benchmark: 7b's five give its median)
FUSED32_WARMUP, FUSED32_STEPS = 1, 2


def check_fp32_training(torch, card, fused_ln=False, base_ms=None):
    """Phase 7b (``--only fp32`` runs it, 7c and 5b): full-width GPT-2 trained in
    fp32, DeepSpeed's default precision: ``make_gpt("gpt2",
    dtype=torch.float32)`` (12 layers, width 768, its default dropout 0.1;
    the model's compute dtype is its own field, bf16 by default, as in
    the JAX model) through ``initialize`` with FP32_TRAIN_CONFIG, so
    attention runs fp32 through the 3xTF32 forward, dq and dk/dv. Prints
    the TF32 flags and fails if matmuls may use TF32 (the plain fp32 path
    is full fp32). Held: the forward, dq and dk/dv launch 12 layers x 8
    micro-batches = 96 times a step each (the dropout branch), the FMA
    forward, dq and dk/dv and every 16-bit kernel never, Adam
    once, no plain version, the loss falls. Printed: step ms (median of 5
    after 2 warm-up), tokens/s, peak GB, one profiled step's busy ms, the
    idle share against it, kernels a step and the device ms a step of
    FP32_PICK.

    Phase 7c, ``fused_ln=True``: the same on ``make_gpt("gpt2",
    dtype=torch.float32, fused_ln=True)``, 1 + 2 steps: #6 and #7 launch
    2 sites x 12 layers x 8 = 192 times a step each through the 3xTF32
    wrappers of ``csrc/fused_ln_tf32.cu``, ``fused_ln.cu``'s and the wgmma
    route's never; the step's ratio to ``base_ms`` (7b's median from the
    same run) and the device ms of the new kernels beside the GEMMs'."""
    flags = {"torch.backends.cuda.matmul.allow_tf32":
             torch.backends.cuda.matmul.allow_tf32,
             "torch.backends.cudnn.allow_tf32":
             torch.backends.cudnn.allow_tf32,
             "float32_matmul_precision":
             torch.get_float32_matmul_precision()}
    print(f"fp32 training: {json.dumps(flags)}")
    if flags["torch.backends.cuda.matmul.allow_tf32"] or \
            flags["float32_matmul_precision"] != "highest":
        fail("fp32 training: matmuls may use TF32; the plain fp32 path must "
             "be full fp32")
    what = "fp32 fused_ln training" if fused_ln else "fp32 training"
    engine, model, cfg, batches, per_step, n_params = train_engine(
        torch, fused_ln, dropout=True, config=FP32_TRAIN_CONFIG,
        dtype=torch.float32)
    if engine.precision.dtype != torch.float32 or cfg.dropout_rate != 0.1:
        fail(f"{what}: precision {engine.precision.name}, dropout "
             f"{cfg.dropout_rate}")
    per_layer = cfg.num_layers * TRAIN_CONFIG["gradient_accumulation_steps"]
    per_step.update({name: 0 for name in FLASH_NAMES})
    per_step.update({name: per_layer for name in FLASH_TF32_NAMES})
    # the fp32 model's sites take the 3xTF32 route; the wgmma and
    # fused_ln.cu's wrappers 0
    for tc, tf32 in zip(FUSED_LN_TC_NAMES, FUSED_LN_TF32_NAMES):
        per_step[tf32], per_step[tc] = per_step[tc], 0
    warmup, steps = ((FUSED32_WARMUP, FUSED32_STEPS) if fused_ln
                     else (TRAIN_WARMUP, TRAIN_STEPS))
    step_ms, losses, launches = counted_steps(
        torch, engine, batches, per_step, what, warmup, steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = median(step_ms)
    gas = TRAIN_CONFIG["gradient_accumulation_steps"]
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    tokens = gas * micro * TRAIN_SEQ
    flops = train_flops_per_step(n_params, gas * micro, TRAIN_SEQ,
                                 cfg.hidden_size, cfg.num_layers)
    rec = {"model": "gpt2", "params": n_params, "micro_batch": micro,
           "gas": gas, "seq": TRAIN_SEQ, "dtype": "float32",
           "precision": engine.precision.name, "fused_update": True,
           "fused_ln": fused_ln, "dropout_rate": cfg.dropout_rate,
           "steps": steps,
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "step_ms": step_ms,
           "tokens_per_s": tokens / (med / 1e3),
           "model_tflops_per_s": flops / (med / 1e3) / 1e12,
           "peak_memory_gb": peak_gb, "losses": losses,
           "launches": {n: c for n, c in launches.items() if c},
           "flags": flags, "card": card}
    if base_ms:
        rec["step_ratio_vs_unfused"] = med / base_ms
    stats = profile_step(torch, engine, batches, what, pick=FP32_PICK + (
        FUSED_LN_TF32_PICK if fused_ln else ()))
    if stats is not None:
        busy = stats["device_busy_ms_per_step"]
        rec.update(device_busy_ms=busy,
                   device_idle_share=1.0 - busy / med,
                   profiled_idle_share=stats["device_idle_share"],
                   kernels_per_step=stats["kernels_per_step"],
                   device_ms_per_step=stats["picked_ms_per_step"])
    print(f"{what} gpt2 (initialize -> train_batch, no bf16 block): "
          f"{json.dumps(rec)}")
    ratio = (f" ({rec['step_ratio_vs_unfused']:.4f}x phase 7b's "
             f"{base_ms:.2f} ms)" if base_ms else "")
    print(f"{what} ({card}): step {med:.2f} ms{ratio}, "
          f"{rec['tokens_per_s']:.1f} tokens/s, peak {peak_gb:.3f} GB; "
          f"device busy {rec.get('device_busy_ms')} ms, idle share "
          f"{rec.get('device_idle_share')}; device ms a step "
          f"{json.dumps(rec.get('device_ms_per_step'))}")
    del engine, model, batches
    torch.cuda.empty_cache()
    return rec


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
# the long step's sparse kernels: the tensor-core forward, dq and dk/dv
SPARSE_KERNELS = ("sparse_attention_fwd_tc",) + SPARSE_TC_NAMES
# the same configuration's step and ratio with the forward #8 on FMAs
# (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §5)
LONG_FMA_STEP_MS, LONG_FMA_RATIO = 583.05, 1.6777


def long_engine(torch, config, **over):
    """bench_gpt2_long's engine (dropout 0) with ``config``, its fixed
    batch; ``over``: further GPTConfig fields."""
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import init_gpt_params, make_gpt

    model, cfg = make_gpt("gpt2", dropout_rate=0.0, max_seq_len=SPARSE_SEQ,
                          **over)
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
    ``train_batch`` with BigBird block-sparse attention: the tensor-core
    forward (#8), dq and dk/dv launch 48 times each per step (12 layers x
    GAS 4), fused Adam once, the FMA forward, dq and dk/dv, the flash
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
    long["sparse_dense_ratio"] = long["tokens_per_s"] / dense_tps
    print(f"long training bf16 gpt2 seq {SPARSE_SEQ} dense flash (for the "
          f"ratio): {json.dumps(dense_run)}; sparse/dense tokens/s "
          f"{long['sparse_dense_ratio']:.4f} (bench.py's "
          f"gpt2_seq16k_sparse_speedup)")
    print(f"long training summary ({card}): step {long['step_ms_median']:.2f}"
          f" ms (with the FMA forward {LONG_FMA_STEP_MS:.2f}), "
          f"{long['tokens_per_s']:.1f} tokens/s, peak memory "
          f"{long['peak_memory_gb']:.3f} GB, dense twin "
          f"{median(dense_ms):.2f} ms, sparse/dense "
          f"{long['sparse_dense_ratio']:.4f} (with the FMA forward "
          f"{LONG_FMA_RATIO})")
    del engine, model, batches
    torch.cuda.empty_cache()
    return long


# ---------------------------------------------------------------------------
# 5b. long-sequence training in fp32: DeepSpeed's default precision
# ---------------------------------------------------------------------------

# LONG_CONFIG with no bf16 block and no bf16 accumulator: the engine keeps
# fp32 and the model computes in fp32
LONG_FP32_CONFIG = {k: v for k, v in LONG_CONFIG.items()
                    if k not in ("bf16", "data_types")}
# the profiled step's device ms: the 3xTF32 forward, dq and dk/dv and
# their second passes, the FMA forward, dq and dk/dv (none should run) and
# every GEMM kernel (cuBLAS's names hold "gemm")
LONG_FP32_PICK = ("sparse_fwd_tf32_kernel", "sparse_fwd_combine_tf32_kernel",
                  "sparse_dq_tf32_kernel", "sparse_dkv_tf32_kernel",
                  "sparse_reduce_tf32_kernel", "sparse_fwd_kernel",
                  "sparse_bwd_dq_kernel", "sparse_bwd_dkv_kernel", "gemm")


def check_long_fp32_training(torch, card):
    """Phase 5b (``--only fp32`` runs it too): full-width GPT-2 at seq
    16384 in fp32, ``make_gpt("gpt2", dtype=torch.float32)`` at
    bench_gpt2_long's dropout 0 through ``initialize`` with
    LONG_FP32_CONFIG: the 3xTF32 forward (#8), dq and dk/dv launch 48
    times each a step (12 layers x GAS 4), the FMA forward, dq and dk/dv,
    every other attention kernel and every plain version never, fused
    Adam once, the loss falls. Prints step ms (median of 5 after 2
    warm-up), tokens/s, peak GB, one profiled step's busy ms, the idle
    share against it and the device ms a step of LONG_FP32_PICK."""
    engine, model, cfg, batches = long_engine(torch, LONG_FP32_CONFIG,
                                              dtype=torch.float32)
    if engine.precision.dtype != torch.float32 or \
            model.cfg.sparse_attention != SPARSE_LONG:
        fail(f"long fp32 training: precision {engine.precision.name}, "
             f"sparse_attention {model.cfg.sparse_attention}")
    gas = LONG_CONFIG["gradient_accumulation_steps"]
    micro = LONG_CONFIG["train_micro_batch_size_per_gpu"]
    per_step = {name: 0 for name in training_counters()}
    per_step.update({name: cfg.num_layers * gas
                     for name in SPARSE_TF32_NAMES})
    per_step["fused_adam"] = 1
    step_ms, losses, launches = counted_steps(
        torch, engine, batches, per_step, "long fp32 training", LONG_WARMUP,
        LONG_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = median(step_ms)
    tokens = gas * micro * SPARSE_SEQ
    rec = {"model": "gpt2", "seq": SPARSE_SEQ, "micro_batch": micro,
           "gas": gas, "dtype": "float32",
           "precision": engine.precision.name, "fused_update": True,
           "sparse_attention": SPARSE_LONG, "steps": LONG_STEPS,
           "step_ms_median": med, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "step_ms": step_ms,
           "tokens_per_s": tokens / (med / 1e3), "peak_memory_gb": peak_gb,
           "losses": losses,
           "launches": {n: c for n, c in launches.items() if c},
           "card": card}
    stats = profile_step(torch, engine, batches, "long fp32 training",
                         pick=LONG_FP32_PICK)
    if stats is not None:
        busy = stats["device_busy_ms_per_step"]
        rec.update(device_busy_ms=busy, device_idle_share=1.0 - busy / med,
                   profiled_idle_share=stats["device_idle_share"],
                   kernels_per_step=stats["kernels_per_step"],
                   device_ms_per_step=stats["picked_ms_per_step"])
    print(f"long fp32 training gpt2 seq {SPARSE_SEQ} bigbird "
          f"(initialize -> train_batch, no bf16 block): {json.dumps(rec)}")
    print(f"long fp32 training ({card}): step {med:.2f} ms, "
          f"{rec['tokens_per_s']:.1f} tokens/s, peak {peak_gb:.3f} GB; "
          f"device busy {rec.get('device_busy_ms')} ms, idle share "
          f"{rec.get('device_idle_share')}; device ms a step "
          f"{json.dumps(rec.get('device_ms_per_step'))}")
    rec["launches"] = launches
    del engine, model, batches
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# 8. BERT-large pretraining
# ---------------------------------------------------------------------------

BERT_CONFIG = {                   # bench.py:bench_bert's
    "train_micro_batch_size_per_gpu": 32,
    "gradient_accumulation_steps": 8,
    "optimizer": {"type": "Lamb", "params": {"lr": 2e-3}},
    "zero_optimization": {"stage": 2},
    "data_types": {"grad_accum_dtype": "bfloat16"},
    "bf16": {"enabled": True},
}
BERT_RUNS = ((128, 32), (512, 8))          # bench_bert's (seq, micro)
BERT_WARMUP, BERT_STEPS = 2, 5
# The sparse-attention example of the reference DeepSpeed's configuration
# documentation (docs/_pages/config-json.md, "Sparse Attention"): the
# reference's default block of 16, so #8-#10 take the 16-row tensor-core
# kernels
BERT_SPARSE = {"mode": "fixed", "block": 16,
               "different_layout_per_head": True, "num_local_blocks": 4,
               "num_global_blocks": 1, "attention": "bidirectional",
               "horizontal_global_attention": False,
               "num_different_global_patterns": 4}
# the sparse BERT step's kernels by CUDA function name (profiler names
# hold them): #8-#10 on the 16-row tensor-core kernels and their second
# passes; the FMA kernels (their first versions) should not appear
SPARSE_PROFILE_KERNELS = ("sparse_fwd_tc16_kernel",
                          "sparse_fwd_combine16_kernel",
                          "sparse_dq_tc16_kernel", "sparse_dkv_tc16_kernel",
                          "sparse_reduce16_kernel", "sparse_fwd_kernel",
                          "sparse_bwd_dq_kernel", "sparse_bwd_dkv_kernel")
SPARSE_BLOCK16_ROWS = {"fwd_tc16": "sparse_attention_fwd_tc16",
                       "dq_tc16": "sparse_attention_bwd_dq_tc16",
                       "dkv_tc16": "sparse_attention_bwd_dkv_tc16"}
# fp32 at that shape: the FMA forward, dq and dk/dv (the first versions)
# and the 3xTF32 forward, dq and dk/dv
SPARSE_FP32_BLOCK16_ROWS = {
    "fwd": "sparse_attention_fwd_block16",
    "dq": "sparse_attention_bwd_dq_block16",
    "dkv": "sparse_attention_bwd_dkv_block16",
    "fwd_tf32": "sparse_attention_fwd_tf32_block16",
    "dq_tf32": "sparse_attention_bwd_dq_tf32_block16",
    "dkv_tf32": "sparse_attention_bwd_dkv_tf32_block16"}


def bert_batches(torch, cfg, gas, micro, seq, padded=False):
    """bench_bert's batches (``bench.py:129-135``: ids, MLM labels at 15%
    of the positions, an all-ones key mask) from seed 0; ``padded``: rows
    of lengths drawn in [seq / 2, seq], padding masked, pad ids 0, no
    labels there."""
    import numpy as np

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (gas, micro, seq), dtype=np.int32)
    labels = np.where(rng.random((gas, micro, seq)) < 0.15, ids, -100)
    mask = np.ones((gas, micro, seq), np.int32)
    if padded:
        lens = rng.integers(seq // 2, seq + 1, (gas, micro))
        mask = (np.arange(seq) < lens[..., None]).astype(np.int32)
        ids = ids * mask
        labels = np.where(mask == 1, labels, -100)
    return {"input_ids": torch.from_numpy(ids).cuda(),
            "attention_mask": torch.from_numpy(mask).cuda(),
            "labels": torch.from_numpy(labels.astype(np.int32)).cuda()}


def bert_engine(torch, seq, micro, sd, sparse=None):
    """bench_bert's engine on ``make_bert("bert-large")`` at dropout 0 and
    ``max_seq_len = max(seq, 128)``, weights ``sd`` (drawn at 512
    positions: the first ``max_seq_len`` rows of ``wpe``), with
    ``sparse`` as the config's ``sparse_attention``."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import make_bert

    model, cfg = make_bert("bert-large", dropout_rate=0.0,
                           max_seq_len=max(seq, 128))
    sd = dict(sd, wpe=sd["wpe"][:cfg.max_seq_len])
    config = dict(BERT_CONFIG, train_micro_batch_size_per_gpu=micro)
    if sparse:
        config["sparse_attention"] = sparse
    engine, *_ = dtt.initialize(model=model, params=sd, config=config)
    return engine, model, cfg


def profiled_kernels(torch, fn):
    """Device kernels of one call of ``fn`` under ``torch.profiler``: their
    count and the sum of their durations (ms; one stream, so their busy
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us()
                             for e in kernels) / 1e3


def apply_cost(torch, engine):
    """LAMB's update on the engine's own state and gradients (the result
    dropped): its device kernels and their device ms (profiled), and its
    host-paced time (:func:`cuda_ms`, 3 back-to-back calls); then one
    whole apply (``engine._apply_step``: the fp32 gradient copies, the
    global norm, LAMB, the copy back, the zeroing) profiled the same way.
    The apply takes a real step on the accumulator it finds (zero after
    a ``train_batch``)."""
    opt, st = engine.optimizer, engine.state

    def lamb():
        opt.update(engine._grads32, st.opt_state, st.params, lr=opt.lr)

    lamb()
    lamb_n, lamb_ms = profiled_kernels(torch, lamb)
    host_ms = cuda_ms(lamb, iters=3, warmup=1)
    apply_n, apply_ms = profiled_kernels(
        torch, lambda: engine._apply_step(opt.lr))
    return {"lamb_device_ms": lamb_ms, "lamb_kernels": lamb_n,
            "lamb_host_paced_ms": host_ms, "apply_device_ms": apply_ms,
            "apply_kernels": apply_n}


def bert_run(torch, card, seq, micro, sd, sparse=None):
    """One bench_bert configuration: BERT_WARMUP, then BERT_STEPS counted
    and timed steps (:func:`counted_steps`: flash #3-#5 on the
    tensor-core route, or with ``sparse`` #8-#10 on the 16-row
    tensor-core route, 24 layers x GAS 8 = 192 launches each a step;
    every other kernel, the FMA forward, dq and dk/dv included, and every
    plain version none; the loss falls), a profiled step (with
    ``sparse``, the sparse kernels' device ms in it), LAMB's cost, and at
    seq 128 the matmuls by shape and one step on padded
    rows (the key mask at work: 192 launches each, no plain version, a
    finite loss). ``sd``: the weights (:func:`bert_engine`). Returns the
    run's record."""
    t0 = time.perf_counter()
    engine, model, cfg = bert_engine(torch, seq, micro, sd, sparse)
    setup_s = time.perf_counter() - t0
    if sparse and (model.cfg.sparse_attention != sparse or any(
            layer.cfg is not model.cfg for layer in model.layer)):
        fail("BERT: initialize did not route the layers' attention through "
             "the sparse_attention block")
    gas = BERT_CONFIG["gradient_accumulation_steps"]
    batches = bert_batches(torch, cfg, gas, micro, seq)
    kernels = SPARSE_TC16_NAMES if sparse else FLASH_NAMES
    per_step = {name: 0 for name in training_counters()}
    per_step.update({name: cfg.num_layers * gas for name in kernels})
    what = f"bert-large seq {seq}" + (" sparse" if sparse else "")
    t0 = time.perf_counter()
    step_ms, losses, launches = counted_steps(
        torch, engine, batches, per_step, what, BERT_WARMUP, BERT_STEPS)
    steps_s = time.perf_counter() - t0
    med = median(step_ms)
    n_params = sum(p.numel() for p in model.parameters())
    samples = gas * micro
    flops = train_flops_per_step(n_params, samples, seq, cfg.hidden_size,
                                 cfg.num_layers)
    rec = {
        "model": "bert-large", "params": n_params, "seq": seq,
        "micro_batch": micro, "gas": gas, "dtype": "bfloat16",
        "optimizer": "Lamb", "sparse_attention": sparse,
        "steps": BERT_STEPS, "step_ms_median": med,
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "step_ms": step_ms, "samples_per_s": samples / (med / 1e3),
        "tokens_per_s": samples * seq / (med / 1e3),
        "model_tflops_per_s": flops / (med / 1e3) / 1e12,
        "mfu_vs_989_tflops_dense_bf16": flops / (med / 1e3) / BF16_FLOPS,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "launches": launches, "card": card,
        "setup_s": setup_s, "steps_s": steps_s}
    print(f"{what} (initialize -> train_batch, bench_bert's config): "
          f"{json.dumps(rec)}")
    t0 = time.perf_counter()
    stats = profile_step(torch, engine, batches, what,
                         pick=SPARSE_PROFILE_KERNELS if sparse else ())
    if stats is None:
        fail(f"{what}: the profiler recorded no device events")
    busy = stats["device_busy_ms_per_step"]
    if sparse:
        rec["sparse_kernels_device_ms"] = stats["picked_ms_per_step"]
    rec.update(apply_cost(torch, engine), device_busy_ms=busy,
               profiled_idle_share=stats["device_idle_share"],
               kernels_per_step=stats["kernels_per_step"],
               # the unprofiled step against the profiled step's busy time
               device_idle_share=1.0 - busy / med)
    rec["lamb_share_of_busy"] = rec["lamb_device_ms"] / busy
    if sparse:
        print(f"{what} ({card}): the sparse kernels' device ms in the "
              f"profiled step: "
              f"{json.dumps(rec['sparse_kernels_device_ms'])} (busy "
              f"{busy:.2f} ms)")
    print(f"{what} ({card}): device busy {busy:.2f} ms of the median step "
          f"{med:.2f} ms: idle share {rec['device_idle_share']:.4f} "
          f"({rec['profiled_idle_share']:.4f} under the profiler), "
          f"{rec['kernels_per_step']:.0f} kernels a step; LAMB "
          f"{rec['lamb_device_ms']:.3f} device ms and {rec['lamb_kernels']} "
          f"kernels a step ({len(engine.state.params)} tensors; "
          f"{rec['lamb_share_of_busy']:.4f} of busy; host-paced "
          f"{rec['lamb_host_paced_ms']:.3f} ms); the whole apply "
          f"{rec['apply_device_ms']:.3f} device ms, {rec['apply_kernels']} "
          f"kernels")
    if seq == BERT_RUNS[0][0] and not sparse:
        profile_matmuls(torch, engine, batches, what)
        padded = bert_batches(torch, cfg, gas, micro, seq, padded=True)
        counters = training_counters()
        for fn in counters.values():
            fn.launches = 0
        with PlainCalls() as plain:
            loss = float(engine.train_batch(padded))
        got = {n: counters[n].launches for n in kernels}
        if any(plain.calls.values()) or not math.isfinite(loss) or \
                set(got.values()) != {cfg.num_layers * gas}:
            fail(f"{what} padded batch: loss {loss}, launches {got}, plain "
                 f"calls {plain.calls}")
        print(f"{what}: one step on padded rows (lengths "
              f"{int(padded['attention_mask'].sum(-1).min())}-"
              f"{int(padded['attention_mask'].sum(-1).max())}): loss {loss}, "
              f"launches {got}, no plain version")
    # the profiled step, LAMB's cost and the seq-128 extras
    rec["profile_s"] = time.perf_counter() - t0
    del engine, model, batches
    torch.cuda.empty_cache()
    return rec


def time_sparse_block16(torch, reports, block=16):
    """#8-#10 at the sparse BERT shape [8, 512, 16, 64] bf16 with
    BERT_SPARSE's layout (a pattern per head) at ``block`` (16, its own;
    32 for the 16-row kernels' block-32 reading), non-causal under a key
    mask (rows padded from lengths in [256, 512]): the forward, dq and
    dk/dv on their 16-row tensor-core route and, on the same inputs, on
    the FMA kernels (their first versions). Each held to its plain version
    (one bf16 rounding step + 1e-3 of the reference's RMS, the forward's
    lse to SPARSE_LSE_TOL, bit-equal over two launches), the 16-row
    kernels also at SPARSE_SMALL_CAP16 (split items combined or summed by
    the second passes); then timed as device time over 4 layers' inputs
    beside the plain version (host-paced), SDPA with the layout-expanded
    mask (the forward, and its whole backward for dq and dk/dv) and the
    bound (pairs counted from the layout and the mask). Prints each
    16-row work list's items, longest walk, split items and masked share
    (the forward walks dq's). Fills the kernels line's 16-row rows in
    ``reports`` (None: print only); with ``reports``, then the fp32
    readings at this shape (:func:`time_sparse_fp32_block16`: the FMA
    forward, dq and dk/dv rows and the 3xTF32 forward, dq and dk/dv
    rows). Returns the device ms by row."""
    import numpy as np
    import torch.nn.functional as F

    sp = sparse_module()
    b, s, h, d = 8, 512, 16, 64
    scale = 1.0 / d ** 0.5
    cfg = dict(BERT_SPARSE, block=block)
    layout = sparse_layout(cfg, h, s)
    plan = sp.sparse_plan(layout, block)
    if sp._route(torch.bfloat16, d, block) != "tc16":
        fail(f"sparse BERT: block {block} does not take the 16-row "
             f"tensor-core forward and backward")
    lens = sparse_bert_lens(b, s)
    mask = torch.from_numpy(np.arange(s)[None] < lens[:, None]).cuda()
    layers = []
    for i in range(4):
        _qkv, q, k, v, dout, _m = flash_case(torch, torch.bfloat16, b, s, h,
                                             d, seed=400 + i)
        q, k, v, km = sp._prepare(q, k, v, mask, plan)
        out, lse = sp.sparse_attention_fwd(q, k, v, km, plan, False, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        layers.append((q, k, v, dout, km, lse, delta.contiguous(), plan,
                       False, scale))
    a = layers[0]
    fwd_args = (*a[:3], a[4], plan, False, scale)
    small = SPARSE_SMALL_CAP16
    for which in ("dq", "dkv"):
        for cap in (None, small):
            w = plan.work16(which, False, cap)
            print(f"sparse_attention {which} 16-row work list at the sparse "
                  f"BERT layout, block {block}, cap {cap or sp.SPLIT_CAP}: "
                  f"{w.n_items} "
                  f"items, longest walk {w.longest} steps of 64 rows, "
                  f"{w.n_split} split items in {w.n_slots} pieces, masked "
                  f"share {w.masked_share:.4f}, warps owning a block "
                  f"{w.fill:.4f}")
        if (block == 16 and plan.work16(which, False).masked_share) or \
                not plan.work16(which, False, small).n_split:
            fail(f"sparse BERT {which}: the 16-row work list masks warps "
                 f"or does not split at cap {small}")
    if plan.work16("fwd", False) is not plan.work16("dq", False):
        fail("sparse BERT: the forward does not walk dq's 16-row list")

    def dkv(fn, *args, **kw):
        return torch.cat(fn(*args, **kw), -1)

    # the 16-row forward's o and lse, at the default cap and at cap 1
    fwd16 = {"fwd_tc16": [sp.sparse_attention_fwd_tc16(*fwd_args)
                          for _ in range(2)],
             f"fwd_tc16 cap {small}": [sp.sparse_attention_fwd_tc16(
                 *fwd_args, cap=small) for _ in range(2)]}
    outs = {"fwd": [sp._launch_fma_fwd(*fwd_args)[0] for _ in range(2)],
            "dq": [sp._launch_fma("dq", *a) for _ in range(2)],
            "dkv": [dkv(sp._launch_fma, "dkv", *a) for _ in range(2)],
            "dq_tc16": [sp.sparse_attention_bwd_dq_tc16(*a)
                        for _ in range(2)],
            "dkv_tc16": [dkv(sp.sparse_attention_bwd_dkv_tc16, *a)
                         for _ in range(2)],
            f"dq_tc16 cap {small}": [sp.sparse_attention_bwd_dq_tc16(
                *a, cap=small) for _ in range(2)],
            f"dkv_tc16 cap {small}": [dkv(sp.sparse_attention_bwd_dkv_tc16,
                                          *a, cap=small) for _ in range(2)]}
    outs.update({key: [o for o, _l in pair] for key, pair in fwd16.items()})
    ref_o, ref_lse = sp.sparse_fwd_reference(*fwd_args)
    refs = {"fwd": ref_o,
            "dq": sp.sparse_bwd_dq_reference(*a),
            "dkv": dkv(sp.sparse_bwd_dkv_reference, *a)}
    torch.cuda.synchronize()
    seen = ref_lse > sp.NEG_INF / 2
    for key, ((_o, lse1), (_o2, lse2)) in fwd16.items():
        if not same_bits(torch, lse1, lse2):
            fail(f"sparse {key} lse block {block}: two launches on one "
                 f"input differ")
        if not torch.equal(seen, lse1 > sp.NEG_INF / 2) or \
                not (lse1[~seen] == sp.NEG_INF).all():
            fail(f"sparse {key} lse block {block}: empty rows differ")
        lse_err = (lse1 - ref_lse)[seen].abs().max().item()
        print(f"sparse_attention {key} block {block} bf16 [8, 512, 16, 64]: "
              f"lse max |err| {lse_err:.3g} (limit {SPARSE_LSE_TOL}), "
              f"{int((~seen).sum())} empty rows at -1e30, bit-equal over "
              f"two launches")
        if not lse_err <= SPARSE_LSE_TOL:
            fail(f"sparse {key} lse block {block}: max |err| {lse_err}")
    del fwd16, ref_lse, seen
    errs = {}
    for key, (got, again) in outs.items():
        ref = refs[key.split("_")[0]].float()
        if not same_bits(torch, got, again):
            fail(f"sparse {key} block {block}: two launches on one input "
                 f"differ")
        diff = (got.float() - ref).abs()
        rms = ref.pow(2).mean().sqrt().item()
        rel = ((diff - round_step(torch, ref)).clamp_min(0).max().item()
               / max(rms, 1e-30))
        errs[key] = diff.max().item()
        print(f"sparse_attention {key} block {block} bf16 [8, 512, 16, "
              f"64]: max |err| {errs[key]:.3g}, {rel:.3g} of the RMS beyond "
              f"one step "
              f"(limit {FLASH_16BIT_RMS_TOL['kernel']}), bit-equal over two "
              f"launches")
        if not torch.isfinite(got).all() or \
                rel > FLASH_16BIT_RMS_TOL["kernel"]:
            fail(f"sparse {key} block {block} bf16 [8, 512, 16, 64]: max |err| "
                 f"{errs[key]}, {rel} of the RMS beyond one step")
    del outs, refs
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(layers)
        return layers[it["i"]]

    def call(which, how):
        """One call of ``which`` ("fwd", "dq", "dkv") by ``how``: "plain",
        "fma" or "tc16"."""
        def go():
            a = nxt()
            if which == "fwd":
                fa = (*a[:3], *a[4:5], *a[7:])
                return {"plain": sp.sparse_fwd_reference,
                        "fma": sp._launch_fma_fwd,
                        "tc16": sp.sparse_attention_fwd_tc16}[how](*fa)
            if how == "plain":
                return (sp.sparse_bwd_dq_reference if which == "dq" else
                        sp.sparse_bwd_dkv_reference)(*a)
            if how == "fma":
                return sp._launch_fma(which, *a)
            return (sp.sparse_attention_bwd_dq_tc16 if which == "dq" else
                    sp.sparse_attention_bwd_dkv_tc16)(*a)
        return go

    am = sp._dense_mask(layout, block, "cuda")[None] & mask[:, None, None, :]
    sdpa_in = []
    for q, k, v, dout, *_ in layers[:2]:
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

    lib = {"fwd": device_ms(torch, sdpa_fwd, iters=10, warmup=2)[0],
           "bwd": device_ms(torch, sdpa_bwd, iters=10, warmup=2)[0]}
    dense = sp._dense_mask(layout, block, "cpu")
    keys = mask.sum(-1).cpu()
    # visible pairs: a query row sees its layout row's keys that its
    # batch row keeps
    pairs = int(sum((dense[:, :, :int(n)].sum() for n in keys), 0))
    q0 = layers[0][0]
    plain = {which: cuda_ms(call(which, "plain"), iters=2, warmup=1)
             for which in ("fwd", "dq", "dkv")}
    out = {}
    for row, which, how in (("fwd", "fwd", "fma"), ("dq", "dq", "fma"),
                            ("dkv", "dkv", "fma"),
                            ("fwd_tc16", "fwd", "tc16"),
                            ("dq_tc16", "dq", "tc16"),
                            ("dkv_tc16", "dkv", "tc16")):
        ms = device_ms(torch, call(which, how), iters=20, warmup=3)[0]
        nbytes, flops = sparse_bytes_flops(q0, pairs / b, which)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_FLOPS
        library = lib["fwd" if which == "fwd" else "bwd"]
        # the FMA kernels' rows take their fp32 readings (below)
        rep = ({} if reports is None or how == "fma" else
               reports[SPARSE_BLOCK16_ROWS[row]])
        err = max(v for key, v in errs.items() if key.split()[0] == row)
        rep.update(ms=ms, plain_ms=plain[which], library_ms=library,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(err, rep.get("max_abs_err") or 0.0))
        out[row] = ms
        extra = ""
        if how == "tc16":
            rep["fma_ms"] = out[which]
            extra = (f", the FMA kernel on the same inputs {out[which]:.4f} "
                     f"ms ({out[which] / ms:.2f}x)")
        print(f"sparse_attention {row} ({how}, block {block}) timing bf16 "
              f"B={b} "
              f"S={s} H={h} D={d} {BERT_SPARSE['mode']} non-causal, key "
              f"mask ({pairs} visible pairs, {pairs / (b * h * s * s):.4f} "
              f"of the square; device time): kernel {ms:.4f} ms{extra}, "
              f"plain {plain[which]:.4f} ms (host-paced), SDPA with the "
              f"expanded mask {'fwd' if which == 'fwd' else 'bwd (dq+dk+dv)'}"
              f" {library:.4f} ms, bound {rep['bound_ms']:.4f} ms ({nbytes} "
              f"bytes / 3.35 TB/s, {flops:.0f} flops / 989 TFLOP/s), max "
              f"|err| {rep['max_abs_err']:.3g}")
    print(f"sparse_attention forward bf16 at the sparse BERT shape, block "
          f"{block}: 16-row tensor cores {out['fwd_tc16']:.4f} ms, FMA "
          f"{out['fwd']:.4f} ms ({out['fwd'] / out['fwd_tc16']:.2f}x), SDPA "
          f"with the expanded mask {lib['fwd']:.4f} ms "
          f"({out['fwd_tc16'] / lib['fwd']:.3f}x)")
    pair = out["dq_tc16"] + out["dkv_tc16"]
    print(f"sparse_attention backward pair bf16 at the sparse BERT shape, "
          f"block {block}: "
          f"16-row tensor cores dq + dk/dv {pair:.4f} ms, FMA "
          f"{out['dq'] + out['dkv']:.4f} ms, SDPA's whole backward with the "
          f"expanded mask {lib['bwd']:.4f} ms ({pair / lib['bwd']:.3f}x)")
    del layers, sdpa_in
    torch.cuda.empty_cache()
    if reports is not None:
        fp32 = time_sparse_fp32_block16(torch, sp, reports)
        out.update({f"{k} fp32": ms for k, ms in fp32.items()})
    return out


def sparse_bert_lens(b, s):
    """The sparse BERT readings' key mask: batch row i keeps its first
    lens[i] keys, drawn in [s / 2, s] from seed 5."""
    import numpy as np

    return np.random.default_rng(5).integers(s // 2, s + 1, b)


def time_sparse_fp32_block16(torch, sp, reports):
    """:func:`time_sparse_fp32` at the sparse BERT shape [8, 512, 16, 64]
    with BERT_SPARSE's layout and key mask, non-causal: the kernels line's
    ``_block16`` and ``_tf32_block16`` rows."""
    b, s, h, d = 8, 512, 16, 64
    rows = {k: reports[n] for k, n in SPARSE_FP32_BLOCK16_ROWS.items()}
    return time_sparse_fp32(torch, sp, rows, "the sparse BERT shape", b, s,
                            h, d, BERT_SPARSE, False, sparse_bert_lens(b, s))


def check_bert_fp32(torch, seq, micro, sparse=None):
    """fp32 on the card, bert-large width at 2 layers, GAS 2, padded rows:
    the kernels' path (flash #3-#5 on 3xTF32, or with ``sparse`` #8-#10
    on 3xTF32, never their FMA kernels) against
    the plain path (``attention_impl="xla"``,
    or the sparse block's ``impl: "xla"``), both with LAMB: the first
    step's accumulated gradients leaf by leaf to 1e-4 of the leaf's norm,
    the 3 losses to 1e-5 relative, as :func:`check_training_fp32` holds
    the GPT.
    Returns the kernels run's launches by counter."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import init_bert_params, make_bert
    from deepspeed_tpu_torch.runtime.utils import global_norm

    counters = training_counters()
    counter = counters["sparse_attention_fwd_tf32" if sparse else
                       "flash_attention_fwd_tf32"]
    gas = 2
    runs = {}
    sd = None
    for label, impl in (("kernels", "auto"), ("plain", "xla")):
        conf = {"train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": gas,
                "optimizer": {"type": "Lamb", "params": {"lr": 2e-3}},
                "zero_optimization": {"stage": 2}}
        over = {}
        if sparse:
            conf["sparse_attention"] = dict(sparse, impl=impl)
        else:
            over["attention_impl"] = impl
        model, cfg = make_bert("bert-large", dropout_rate=0.0, num_layers=2,
                               dtype=torch.float32,
                               max_seq_len=max(seq, 128), **over)
        if sd is None:          # one set of weights for both paths
            sd = init_bert_params(cfg, seed=1)
        engine, *_ = dtt.initialize(model=model, params=sd, config=conf)
        batches = [bert_batches(torch, cfg, gas, micro, seq, padded=True)]
        batches += [{k: v.roll(i, dims=1) for k, v in batches[0].items()}
                    for i in (1, 2)]
        before = counter.launches
        counts = {n: c.launches for n, c in counters.items()}
        first = []
        for j in range(gas):
            first.append(engine.forward({k: v[j] for k, v in
                                         batches[0].items()}))
            engine.backward(first[-1])
        grads = [g.clone() for g in engine.state.grad_acc]
        engine.step()
        losses = [float(torch.stack(first).mean())]
        losses += [float(engine.train_batch(b)) for b in batches[1:]]
        launched = counter.launches - before
        if (launched > 0) != (label == "kernels"):
            fail(f"BERT fp32 comparison: the {label} run launched the "
                 f"attention forward {launched} times")
        if label == "kernels":
            launches = {n: c.launches - counts[n]
                        for n, c in counters.items()}
            if sparse and (
                    not all(launches[n] for n in SPARSE_TF32_NAMES)
                    or any(launches[n] for n in SPARSE_FMA_NAMES)):
                fail(f"BERT fp32 comparison: the sparse forward, dq and "
                     f"dk/dv did not take the 3xTF32 kernels alone: "
                     f"{launches}")
        runs[label] = (grads, losses)
        names = engine.param_names
        del engine, model
        torch.cuda.empty_cache()
    (gk, lk), (gp, lp) = runs["kernels"], runs["plain"]
    rel = {n: float(global_norm([a - b])) / float(global_norm([b]))
           for n, a, b in zip(names, gk, gp)}
    worst = max(rel, key=rel.get)
    attn = {n: f"{e:.3g}" for n, e in rel.items()
            if "c_attn" in n or "c_proj" in n}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    layout = f", {sparse['mode']} block {sparse['block']}" if sparse else ""
    print(f"BERT fp32 bert-large width 2 layers, micro {micro} x {seq} "
          f"padded, GAS 2{layout}: kernels vs plain path: first-step grad "
          f"|diff|/|grad| per leaf: worst {worst} {rel[worst]:.3g} (limit "
          f"1e-4); attention leaves {json.dumps(attn)}; losses {lk} vs "
          f"{lp}, max rel diff {loss_rel:.3g} (limit 1e-5)")
    if not rel[worst] <= 1e-4 or not loss_rel <= 1e-5:
        fail(f"BERT fp32{layout}: the kernels' path disagrees with the "
             f"plain path")
    return launches


def check_bert(torch, card, reports):
    """Phase 8: BERT-large pretraining at bench_bert's two configurations,
    then seq 512 with BERT_SPARSE (#8-#10 on the 16-row tensor-core route
    at block 16; the step's sparse/dense ratio, idle share and sparse
    kernels' device ms, and the kernels at this shape), then the fp32
    comparisons. Fills the kernels line's BERT rows' launches (each
    run's, every count set to 0 just before it; the FMA forward, dq and
    dk/dv ``_block16`` rows and the 3xTF32 dq and dk/dv ``_tf32_block16``
    rows count the sparse fp32 comparison)."""
    from deepspeed_tpu_torch.models import BERT_CONFIGS, init_bert_params

    t0 = time.perf_counter()
    # one draw for every run, at bert-large's 512 positions
    sd = init_bert_params(BERT_CONFIGS["bert-large"], seed=0)
    print(f"BERT: bert-large weights drawn in {time.perf_counter() - t0:.1f}"
          f" s")
    recs = {}
    for seq, micro in BERT_RUNS:
        rec = bert_run(torch, card, seq, micro, sd)
        recs[f"bert{seq}"] = rec
        for name in FLASH_NAMES:
            reports[f"{name}_bert{seq}"]["launches"] = rec["launches"][name]
    seq, micro = BERT_RUNS[1]
    rec = bert_run(torch, card, seq, micro, sd, sparse=BERT_SPARSE)
    del sd
    recs["sparse512"] = rec
    for name in SPARSE_TC16_NAMES:
        reports[name]["launches"] = rec["launches"][name]
    ratio = rec["samples_per_s"] / recs["bert512"]["samples_per_s"]
    t1 = time.perf_counter()
    kern = time_sparse_block16(torch, reports)
    # the 16-row kernels' block-32 reading: the same shape and pattern
    kern32 = time_sparse_block16(torch, None, block=32)
    t2 = time.perf_counter()
    print(f"sparse BERT seq 512 ({card}): step "
          f"{rec['step_ms_median']:.2f} ms against the dense step "
          f"{recs['bert512']['step_ms_median']:.2f}: sparse/dense "
          f"samples/s {ratio:.4f} ({rec['samples_per_s']:.2f} against "
          f"{recs['bert512']['samples_per_s']:.2f}); idle share "
          f"{rec['device_idle_share']:.4f} (dense "
          f"{recs['bert512']['device_idle_share']:.4f}); the sparse "
          f"kernels' device ms a step "
          f"{json.dumps(rec['sparse_kernels_device_ms'])}; "
          f"per call (ms, #8-#10 on the 16-row tensor cores and their FMA "
          f"first versions) {json.dumps(kern)}; at block 32 "
          f"{json.dumps(kern32)}")
    check_bert_fp32(torch, 128, 8)
    fp32 = check_bert_fp32(torch, 512, 2, sparse=BERT_SPARSE)
    # the fp32 rows at block 16: the FMA forward, dq and dk/dv (0: the
    # first versions) and the 3xTF32 forward, dq and dk/dv
    for key, name in zip(("fwd", "dq", "dkv", "fwd_tf32", "dq_tf32",
                          "dkv_tf32"), SPARSE_FMA_NAMES + SPARSE_TF32_NAMES):
        reports[SPARSE_FP32_BLOCK16_ROWS[key]]["launches"] = fp32[name]
    print(f"BERT phase times: the sparse kernels' holds and timings "
          f"{t2 - t1:.1f} s, the fp32 comparisons "
          f"{time.perf_counter() - t2:.1f} s")
    summary = {k: {f: r[f] for f in (
        "samples_per_s", "step_ms_median", "mfu_vs_989_tflops_dense_bf16",
        "peak_memory_gb", "device_idle_share", "kernels_per_step",
        "lamb_device_ms", "lamb_kernels", "lamb_share_of_busy",
        "setup_s", "steps_s", "profile_s")}
        for k, r in recs.items()}
    print(f"BERT summary ({card}; phase 8 took "
          f"{time.perf_counter() - t0:.1f} s): {json.dumps(summary)}")
    return recs


# ---------------------------------------------------------------------------
# 9. checkpointing, the dataloader and preemption-safe training
# ---------------------------------------------------------------------------

CKPT_STEPS, CKPT_AT = 6, 3         # steps of (a); the sync save's step
CKPT_EXTRA = 3                     # (b)'s steps past (a)'s, saves reused
CKPT_SAMPLES = 1000                # the synthetic token dataset
CKPT_FAULT_PLAN = {"preempt_at_step": 3, "ckpt_write_errors": 1}
CKPT_CONFIG = dict(TRAIN_CONFIG, steps_per_print=1000)
CKPT_DIR = os.path.join(HERE, "build", "ckpt_smoke")   # .gitignore lists it


def ckpt_dataset(vocab):
    """A seeded synthetic token dataset at phase 7's sequence length, drawn
    in bulk."""
    import numpy as np

    ids = np.random.default_rng(0).integers(
        0, vocab, (CKPT_SAMPLES, TRAIN_SEQ), dtype=np.int32)
    return [{"input_ids": row} for row in ids]


def ckpt_engine(torch, sd, resilience=None, remat=False, dropout=True):
    """Phase 7's engine (make_gpt("gpt2") at its dropout 0.1, bench_gpt2's
    configuration with fused Adam, a bf16 accumulator) fed by
    ``initialize(training_data=...)`` over ``ckpt_dataset``;
    ``resilience``: the config's block. Returns (engine, model, loader)."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import make_gpt

    over = {} if dropout else {"dropout_rate": 0.0}
    model, cfg = make_gpt("gpt2", remat=remat, **over)
    config = dict(CKPT_CONFIG)
    if resilience is not None:
        config["resilience"] = resilience
    engine, _opt, loader, _sched = dtt.initialize(
        model=model, params=sd, config=config,
        training_data=ckpt_dataset(cfg.vocab_size))
    return engine, model, loader


def ckpt_stream(torch, engine, loader, state=None):
    """Each step's [GAS, micro, S] batch from ``RepeatingLoader`` (resumed
    at ``state``) through ``PrefetchLoader`` over ``engine.put_batch``,
    with the loader's position after that batch: the prefetch reads ahead
    of the steps, so the position a checkpoint keeps is the one of the
    batches the steps consumed."""
    from deepspeed_tpu_torch.runtime.dataloader import (PrefetchLoader,
                                                        RepeatingLoader)

    gas = CKPT_CONFIG["gradient_accumulation_steps"]
    rep = RepeatingLoader(loader)
    if state:
        rep.load_state_dict(state)

    def groups():
        while True:
            micro = [next(rep) for _ in range(gas)]
            yield rep.state_dict(), {"input_ids": torch.stack(
                [m["input_ids"] for m in micro])}

    return iter(PrefetchLoader(groups(), lambda sb: (
        sb[0], engine.put_batch(sb[1], leading_gas_dim=True))))


def ckpt_steps(torch, engine, stream, n, consumed=None):
    """``n`` steps: (loss reprs, step ms); ``consumed`` takes the loader
    position of each step's batch."""
    losses, step_ms = [], []
    for _ in range(n):
        pos, batch = next(stream)
        if consumed is not None:
            # before the step: its checkpoint is taken inside train_batch
            consumed.update(pos)
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(repr(loss))
    return losses, step_ms


def dir_gb(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _d, files in os.walk(path) for f in files) / 1e9


def ckpt_per_step(cfg, remat=False):
    """Launches a step of #3-#5 and #11 on phase 7's path; under remat
    the forward (#3) runs again in the backward."""
    per_layer = cfg.num_layers * CKPT_CONFIG["gradient_accumulation_steps"]
    per_step = {name: 0 for name in training_counters()}
    per_step.update({name: per_layer for name in FLASH_NAMES})
    per_step["fused_adam"] = 1
    if remat:
        per_step["flash_attention_fwd_tc"] = 2 * per_layer
    return per_step


def check_launches(counts, per_step, steps, what):
    for name, n in per_step.items():
        if counts[name] != steps * n:
            fail(f"{what}: {name} launched {counts[name]} times in {steps} "
                 f"steps, expected {steps * n}")


def ckpt_child(torch, ckpt_dir, out):
    """The supervised child of phase 9 (c): phase 7's engine with
    ``resilience`` at interval 1, ``auto_resume``, the loader's position
    as its client state, steps to CKPT_STEPS (while the fault plan is
    armed, each step's write drained before the next, so the injected
    preemption after step 3 tears that step's write only). Each loss goes to ``out`` as a line; the
    incarnation that ends writes its launch counts, plain calls and the
    step it resumed from."""
    from deepspeed_tpu_torch.models import GPT_CONFIGS, init_gpt_params
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.resilience import RESUME_ATTEMPT_ENV

    missing = [s for s in {src for _n, src, _r in KERNELS}
               if not os.path.exists(build.library_path(s))]
    if missing:
        fail(f"supervised child: kernels {sorted(missing)} are not built; "
             f"a child never rebuilds")
    t0 = time.perf_counter()
    sd = init_gpt_params(GPT_CONFIGS["gpt2"], seed=0)
    engine, model, loader = ckpt_engine(torch, sd, resilience={
        "enabled": True, "checkpoint": {"dir": ckpt_dir, "interval": 1,
                                        "keep_last": 2,
                                        "backoff_seconds": 0.05}})
    del sd
    consumed = {}
    engine.register_client_state_fn(lambda: {"loader": dict(consumed)})
    t1 = time.perf_counter()
    path, client = engine.auto_resume()
    restore_s = time.perf_counter() - t1
    start = engine.global_steps
    stream = ckpt_stream(torch, engine, loader,
                         client.get("loader") if client else None)
    counters = training_counters()
    for fn in counters.values():
        fn.launches = 0
    with open(out, "a", buffering=1) as f, PlainCalls() as plain:
        for step in range(start, CKPT_STEPS):
            losses, step_ms = ckpt_steps(torch, engine, stream, 1, consumed)
            f.write(json.dumps({"step": step + 1, "loss": losses[0],
                                "ms": step_ms[0]}) + "\n")
            if engine.fault_plan is not None:
                engine.ckpt_manager.wait()
    mgr = engine.ckpt_manager
    mgr.close()
    summary = {"attempt": int(os.environ.get(RESUME_ATTEMPT_ENV, "0")),
               "resumed_from": path, "start": start, "restore_s": restore_s,
               "setup_s": t1 - t0,
               "launches": {n: fn.launches for n, fn in counters.items()},
               "plain": plain.calls, "stats": mgr.stats}
    with open(out, "a") as f:
        f.write(json.dumps({"summary": summary}) + "\n")
    return 0


def check_ckpt(torch, card):
    """Phase 9 (``--only ckpt`` runs it alone), on full-width, full-depth
    GPT-2 at phase 7's configuration, data from ``initialize(training_data
    =...)`` through ``RepeatingLoader`` and ``PrefetchLoader``:
    (a) CKPT_STEPS uninterrupted steps, with a sync save after step 3;
    (b) a fresh engine loads it without the optimizer states (masters
    equal, moments zero), then whole, and runs steps 4-6 bit-equal to (a)
    and CKPT_EXTRA more under ``resilience`` at interval 1 (save() timed
    on the step path), the last step's checkpoint corrupted (the restore
    falls back past it), beside (d) serving from the checkpoint; (c) ``Supervisor`` over a child preempted after step 3
    with one injected write error: one restart, steps 1-6 bit-equal to
    (a), the resumed child's #3-#5 at 96 a step and #11 at 1, no plain
    version; (e) ``remat`` at phase 4's configuration: 3 steps bit-equal
    to ``remat=False``, #3 at 192 a step; (f) LAMB at bert-large width, 2
    layers: a save/load round trip, the next loss bit-equal."""
    import numpy as np

    from deepspeed_tpu_torch.models import GPT_CONFIGS, init_gpt_params
    from deepspeed_tpu_torch.resilience import (Supervisor, find_restorable,
                                                list_checkpoints)
    from deepspeed_tpu_torch.resilience.checkpoint import (METRICS_FILE,
                                                           MetricsJSONL)
    from deepspeed_tpu_torch.runtime.checkpointing import consolidate_to_fp32

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    rec = {"card": card}
    sd = init_gpt_params(GPT_CONFIGS["gpt2"], seed=0)

    # (a) uninterrupted, with the sync save after step 3
    sync_dir = os.path.join(CKPT_DIR, "sync")
    engine, model, loader = ckpt_engine(torch, sd)
    stream = ckpt_stream(torch, engine, loader)
    consumed = {}
    want, a_ms = ckpt_steps(torch, engine, stream, CKPT_AT, consumed)
    t0 = time.perf_counter()
    engine.save_checkpoint(sync_dir, client_state={"loader": dict(consumed)})
    rec["sync_save_s"] = time.perf_counter() - t0
    rec["sync_save_gb"] = dir_gb(sync_dir)
    more, ms = ckpt_steps(torch, engine, stream, CKPT_STEPS - CKPT_AT)
    want += more
    a_ms += ms
    rec["losses"], rec["uninterrupted_step_ms"] = want, a_ms
    if not all(np.isfinite([float(x) for x in want])):
        fail(f"phase 9 (a): losses not finite: {want}")
    del engine, model, stream
    torch.cuda.empty_cache()

    # (b) a fresh engine: the load without optimizer states, then whole
    auto_dir = os.path.join(CKPT_DIR, "auto")
    last = CKPT_STEPS + CKPT_EXTRA
    engine, model, loader = ckpt_engine(torch, sd, resilience={
        "enabled": True, "checkpoint": {"dir": auto_dir, "interval": 1,
                                        "keep_last": 2},
        "fault_injection": {"corrupt_shard_at_step": last}})
    engine.load_checkpoint(sync_dir, load_optimizer_states=False)
    saved = consolidate_to_fp32(sync_dir)
    live = {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}
    if set(saved) != set(live) or not all(
            np.array_equal(saved[k], live[k]) for k in saved):
        fail("phase 9 (b): load_optimizer_states=False did not restore "
             "the masters")
    st = engine.state
    if st.opt_state.step != 0 or any(bool(t.any()) for t in (
            st.opt_state.exp_avg + st.opt_state.exp_avg_sq)):
        fail("phase 9 (b): load_optimizer_states=False kept moments")
    t0 = time.perf_counter()
    _path, client = engine.load_checkpoint(sync_dir)
    torch.cuda.synchronize()
    rec["sync_load_s"] = time.perf_counter() - t0
    if engine.global_steps != CKPT_AT:
        fail(f"phase 9 (b): restored global step {engine.global_steps}")

    # (d) serving from the checkpoint beside the live masters
    rec["serving"] = ckpt_serving(torch, sync_dir, {
        k: v.detach().clone() for k, v in model.state_dict().items()})

    mgr = engine.ckpt_manager
    save_ms = []
    orig_save = mgr.save

    def timed_save(*a, **k):
        t = time.perf_counter()
        orig_save(*a, **k)
        save_ms.append((time.perf_counter() - t) * 1e3)

    mgr.save = timed_save
    stream = ckpt_stream(torch, engine, loader, client["loader"])
    got, b_ms = ckpt_steps(torch, engine, stream, last - CKPT_AT)
    t0 = time.perf_counter()
    mgr.wait()
    rec["drain_after_steps_s"] = time.perf_counter() - t0
    if got[:CKPT_STEPS - CKPT_AT] != want[CKPT_AT:]:
        fail(f"phase 9 (b): steps 4-6 after the load {got} differ from "
             f"the uninterrupted {want[CKPT_AT:]}")
    rows = MetricsJSONL(os.path.join(auto_dir, METRICS_FILE)).read()
    committed = [s for s, _ in list_checkpoints(auto_dir)]
    found = find_restorable(auto_dir)
    if last not in committed or found is None or \
            found[1]["step"] != max(s for s in committed if s < last):
        fail(f"phase 9 (b): the corrupt step-{last} checkpoint did "
             f"not fall back: committed {committed}, restorable "
             f"{found and found[1]['step']}")
    rec["resilience"] = {
        "save_ms_on_step_path": save_ms,
        "write_s": [r["value"] for r in rows
                    if r["tag"] == "Train/Checkpoint/write_latency_sec"],
        "superseded": mgr.stats["dropped"], "stats": dict(mgr.stats),
        "pinned_buffer_sets": mgr._pool.allocated,
        "step_ms": b_ms,
        "step_ratio_vs_none": median(b_ms) / median(a_ms[CKPT_AT:]),
        # the last steps, once the three pinned buffer sets exist
        "step_ratio_steady": median(b_ms[-CKPT_EXTRA:])
        / median(a_ms[CKPT_AT:]),
        "committed": committed, "fell_back_to": found[1]["step"]}
    mgr.close()
    del engine, model, stream, saved, live
    torch.cuda.empty_cache()

    # (c) the supervised, preempted child
    rec["supervised"] = ckpt_supervised(torch, want)

    # (e) remat at phase 4's configuration, and (f) BERT with LAMB
    rec["remat"] = ckpt_remat(torch, sd)
    del sd
    rec["bert_lamb"] = ckpt_bert(torch)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    r = rec["resilience"]
    print(f"phase 9 checkpointing ({card}): save() on the step path "
          f"{json.dumps([round(x, 3) for x in r['save_ms_on_step_path']])}"
          f" ms, the writes off it {json.dumps(r['write_s'])} s, "
          f"{r['superseded']} snapshots superseded, step time with "
          f"resilience at interval 1 / without {r['step_ratio_vs_none']:.4f}"
          f" ({r['step_ratio_steady']:.4f} over the last {CKPT_EXTRA} "
          f"steps, the pinned buffers allocated); sync save {rec['sync_save_s']:.2f} s for "
          f"{rec['sync_save_gb']:.3f} GB, load {rec['sync_load_s']:.2f} s; "
          f"remat peak {rec['remat']['peak_gb']} GB, step ms "
          f"{rec['remat']['step_ms_median']}; phase {rec['phase_s']:.1f} s")
    print(f"phase 9 record: {json.dumps(rec)}")
    return rec


def ckpt_serving(torch, sync_dir, live_sd):
    """(d): bf16 ``init_serving(checkpoint=...)`` and the same from the
    live masters, ``decode_attention: "kernel"``: equal tokens, #1
    launching."""
    import numpy as np

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import make_gpt
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    config = {"serving": {"max_batch_size": 8, "kv_block_size": 16,
                          "kv_num_blocks": 8 * 1024 // 16 + 1,
                          "decode_attention": "kernel"}}
    prompts = np.random.default_rng(1).integers(0, 50257, (4, 32)).tolist()
    out = {}
    for name, kw in (("checkpoint", {"checkpoint": sync_dir}),
                     ("live", {"params": live_sd})):
        with torch.device("cuda"):
            model, _ = make_gpt("gpt2", dtype=torch.bfloat16)
        srv = dtt.init_serving(model, dtype=torch.bfloat16, config=config,
                               **kw)
        pa.paged_decode_attention.launches = 0
        rids = [srv.submit(p, 16) for p in prompts]
        res = srv.run_until_complete()
        out[name] = ([res[r]["tokens"] for r in rids],
                     pa.paged_decode_attention.launches)
        srv.close()
        del srv, model
    if out["checkpoint"][0] != out["live"][0]:
        fail("phase 9 (d): tokens served from the checkpoint differ from "
             "the live masters'")
    if out["checkpoint"][1] == 0:
        fail("phase 9 (d): kernel #1 never launched")
    torch.cuda.empty_cache()
    return {"requests": len(prompts), "new_tokens": 16,
            "kernel_launches": out["checkpoint"][1], "tokens_equal": True}


def ckpt_supervised(torch, want):
    """(c): ``Supervisor`` over ``chip_smoke.py --ckpt-child`` with
    CKPT_FAULT_PLAN: one restart; steps 1-6 bit-equal to (a); the resumed
    child resumed from step 2 and launched #3-#5 96 times a step and #11
    once, no plain version."""
    from deepspeed_tpu_torch.models import GPT_CONFIGS
    from deepspeed_tpu_torch.resilience import FAULT_PLAN_ENV, Supervisor

    run_dir = os.path.join(CKPT_DIR, "supervised")
    os.makedirs(run_dir)
    out = os.path.join(run_dir, "losses.jsonl")
    t0 = time.perf_counter()
    sup = Supervisor([sys.executable, os.path.abspath(__file__),
                      "--ckpt-child", os.path.join(run_dir, "ckpt"), out],
                     max_restarts=2, backoff=0.05,
                     env={FAULT_PLAN_ENV: json.dumps(CKPT_FAULT_PLAN)})
    rc = sup.run()
    wall = time.perf_counter() - t0
    rows = ([json.loads(line) for line in open(out)]
            if os.path.exists(out) else [])
    losses = {r["step"]: r["loss"] for r in rows if "step" in r}
    summary = [r["summary"] for r in rows if "summary" in r]
    if rc != 0 or sup.restarts != 1 or len(summary) != 1:
        fail(f"phase 9 (c): supervisor rc {rc}, exit codes "
             f"{sup.exit_codes}, {len(summary)} finished incarnations")
    s = summary[0]
    got = [losses.get(i) for i in range(1, CKPT_STEPS + 1)]
    if got != want:
        fail(f"phase 9 (c): the supervised trajectory {got} differs from "
             f"the uninterrupted {want}")
    if s["attempt"] != 1 or s["start"] != CKPT_AT - 1:
        fail(f"phase 9 (c): the resumed child (attempt {s['attempt']}) "
             f"started at step {s['start']}, expected {CKPT_AT - 1}")
    steps = CKPT_STEPS - s["start"]
    check_launches(s["launches"], ckpt_per_step(GPT_CONFIGS["gpt2"]), steps,
                   "phase 9 (c) resumed child")
    if any(s["plain"].values()):
        fail(f"phase 9 (c): a plain version ran: {s['plain']}")
    return {"exit_codes": sup.exit_codes, "restarts": sup.restarts,
            "resumed_from": s["resumed_from"], "start": s["start"],
            "restore_s": s["restore_s"], "child_setup_s": s["setup_s"],
            "launches": {k: v for k, v in s["launches"].items() if v},
            "writer_stats": s["stats"], "wall_s": wall,
            "step_ms": [r["ms"] for r in rows if "step" in r]}


def ckpt_remat(torch, sd):
    """(e): phase 4's configuration (dropout 0) with and without
    ``remat``, 3 steps each on the same data: the losses bit-equal, #3 at
    192 launches a step under remat and #4/#5 at 96; peak memory and step
    time of each."""
    from deepspeed_tpu_torch.models import GPT_CONFIGS

    runs = {}
    for remat in (False, True):
        engine, model, loader = ckpt_engine(torch, sd, remat=remat,
                                            dropout=False)
        stream = ckpt_stream(torch, engine, loader)
        ckpt_steps(torch, engine, stream, 1)          # warm up
        counters = training_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with PlainCalls() as plain:
            losses, step_ms = ckpt_steps(torch, engine, stream, 3)
        launches = {n: fn.launches for n, fn in counters.items()}
        check_launches(launches, ckpt_per_step(GPT_CONFIGS["gpt2"], remat),
                       3, f"phase 9 (e) remat={remat}")
        if any(plain.calls.values()):
            fail(f"phase 9 (e): a plain version ran: {plain.calls}")
        runs[remat] = {"losses": losses, "step_ms": step_ms,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del engine, model, stream
        torch.cuda.empty_cache()
    if runs[True]["losses"] != runs[False]["losses"]:
        fail(f"phase 9 (e): remat losses {runs[True]['losses']} differ "
             f"from {runs[False]['losses']}")
    return {"losses": runs[False]["losses"],
            "peak_gb": {"remat": runs[True]["peak_gb"],
                        "no_remat": runs[False]["peak_gb"]},
            "step_ms_median": {"remat": median(runs[True]["step_ms"]),
                               "no_remat": median(runs[False]["step_ms"])}}


def ckpt_bert(torch):
    """(f): bench_bert's configuration (LAMB, bf16, GAS 8) on bert-large
    width and 2 layers at seq 128: 2 steps, a sync save, a third step; a
    fresh engine loads and its step's loss is bit-equal to the third;
    #3-#5 launch 16 times each in it (2 layers x GAS 8), no plain
    version."""
    from dataclasses import replace

    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models import (BERT_CONFIGS, init_bert_params,
                                            make_bert)

    seq, micro = BERT_RUNS[0]
    cfg = replace(BERT_CONFIGS["bert-large"], num_layers=2,
                  max_seq_len=seq)
    sd = init_bert_params(cfg, seed=0)
    batches = bert_batches(torch, cfg, BERT_CONFIG[
        "gradient_accumulation_steps"], micro, seq)
    bert_dir = os.path.join(CKPT_DIR, "bert")

    def engine():
        model, _ = make_bert(cfg)
        config = dict(BERT_CONFIG, train_micro_batch_size_per_gpu=micro)
        return dtt.initialize(model=model, params=sd, config=config)[0]

    e1 = engine()
    for _ in range(2):
        e1.train_batch(batches)
    t0 = time.perf_counter()
    e1.save_checkpoint(bert_dir)
    save_s = time.perf_counter() - t0
    want = repr(float(e1.train_batch(batches)))
    del e1
    e2 = engine()
    t0 = time.perf_counter()
    e2.load_checkpoint(bert_dir)
    load_s = time.perf_counter() - t0
    counters = training_counters()
    for fn in counters.values():
        fn.launches = 0
    with PlainCalls() as plain:
        got = repr(float(e2.train_batch(batches)))
    if got != want:
        fail(f"phase 9 (f): BERT's loss after the load {got} differs from "
             f"{want}")
    per_step = {name: 0 for name in counters}
    per_step.update({name: cfg.num_layers * BERT_CONFIG[
        "gradient_accumulation_steps"] for name in FLASH_NAMES})
    check_launches({n: fn.launches for n, fn in counters.items()}, per_step,
                   1, "phase 9 (f)")
    if any(plain.calls.values()):
        fail(f"phase 9 (f): a plain version ran: {plain.calls}")
    gb = dir_gb(bert_dir)
    del e2
    torch.cuda.empty_cache()
    return {"loss": got, "save_s": save_s, "load_s": load_s, "gb": gb}


def main() -> int:
    import torch

    t_run = time.perf_counter()
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
    args = sys.argv[1:]
    if args[:1] == ["--ckpt-child"] and len(args) == 3:
        return ckpt_child(torch, args[1], args[2])   # phase 9 (c)'s child
    only = (set(args[1].split(",")) if len(args) == 2
            and args[0] == "--only" else None)
    if args and (not only
                 or not only <= {"kernels", "sparse", "chunked", "spec",
                                 "telemetry", "bert", "ckpt", "serving",
                                 "fp32"}
                 or ("kernels" in only and len(only) > 1)):
        fail(f"unknown arguments {args} (none, --only kernels, or --only "
             f"with sparse, chunked, serving, spec, telemetry, bert, ckpt, "
             f"fp32 or several, comma-separated)")
    part = only is not None and "kernels" not in only
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
    for src, lib in zip(sources, libs):
        print(f"  {os.path.relpath(lib, HERE)}: "
              f"{ptxas_summary(lib, each=src in TC_SOURCES)}")

    # 2. kernels against their plain versions
    reports = {name: {"name": name, "route": "cuda",
                      "source": f"deepspeed_tpu_torch/csrc/{src}.cu",
                      "replaces": rep}
               for name, src, rep in KERNELS}
    if not part:
        check_paged_attention(torch, reports["paged_decode_attention"])
        check_paged_attention_int8(torch,
                                   reports["paged_decode_attention_int8"])
        time_paged_splits(torch)
    if not part or "chunked" in only:
        check_chunked_prefill(torch, dict(
            {r: reports[n] for r, n in CHUNKED_NAMES.items()},
            tc_int8=reports["chunked_prefill_attention_tc_int8"],
            tf32_int8=reports["chunked_prefill_attention_tf32_int8"],
            **{chunked_d256_row(nm, i8):
               reports["chunked_prefill_attention_" + chunked_d256_row(
                   nm, i8)]
               for nm in ("bfloat16", "float32") for i8 in (False, True)}))
    if not part:
        check_flash_attention(torch, reports)
        check_flash_dropout_mask(torch, torch.float32, 256)
        check_flash_dropout_mask(torch, torch.bfloat16, 256)
        check_flash_dropout_mask(torch, torch.float32, 64)
        check_flash_dropout_mask(torch, torch.bfloat16, 64)
        check_fused_adam(torch, reports["fused_adam"])
    if not part or "sparse" in only:
        worst = check_sparse_attention(torch, {
            "fwd": reports["sparse_attention_fwd"],
            "fwd_tc": reports["sparse_attention_fwd_tc"],
            "dq": reports["sparse_attention_bwd_dq"],
            "dkv": reports["sparse_attention_bwd_dkv"],
            "dq_tc": reports["sparse_attention_bwd_dq_tc"],
            "dkv_tc": reports["sparse_attention_bwd_dkv_tc"],
            "fwd_tf32": reports["sparse_attention_fwd_tf32"],
            "dq_tf32": reports["sparse_attention_bwd_dq_tf32"],
            "dkv_tf32": reports["sparse_attention_bwd_dkv_tf32"]})
        # the 16-row rows' errors over phase 2d's cases; phase 8 adds the
        # sparse BERT shape's and times them
        for name, keys in zip(SPARSE_TC16_NAMES,
                              (("fwd",), ("dq",), ("dk", "dv"))):
            reports[name]["max_abs_err"] = max(
                w[0] for (k, _n, r), w in worst.items()
                if r == "tc16" and k.split()[0] in keys)
    if part:
        if "serving" in only:
            check_serving(torch)
        if "spec" in only:
            check_speculative(torch, card,
                              reports["paged_decode_attention_verify"])
        if "telemetry" in only:
            check_telemetry(torch, card)
        if "bert" in only:
            check_bert(torch, card, reports)
        if "ckpt" in only:
            check_ckpt(torch, card)
        if "fp32" in only:
            # every fp32 sparse hold and timing, the fp32 sparse
            # comparisons of phases 5 and 8, then phases 5b and 7b
            sp = sparse_module()
            check_sparse_attention(torch, reports, cases=tuple(
                c[:8] + (("float32",), c[9]) for c in SPARSE_CASES
                if "float32" in c[8]), timing=False)
            time_sparse_fp32(torch, sp, {
                "fwd": reports["sparse_attention_fwd"],
                "dq": reports["sparse_attention_bwd_dq"],
                "dkv": reports["sparse_attention_bwd_dkv"],
                "fwd_tf32": reports["sparse_attention_fwd_tf32"],
                "dq_tf32": reports["sparse_attention_bwd_dq_tf32"],
                "dkv_tf32": reports["sparse_attention_bwd_dkv_tf32"]},
                "the path's shape", 1, SPARSE_SEQ, 12, 64, SPARSE_LONG, True)
            time_sparse_fp32_block16(torch, sp, reports)
            check_training_fp32(torch, seq=4096, micro=1, sparse=SPARSE_LONG)
            check_bert_fp32(torch, 512, 2, sparse=BERT_SPARSE)
            check_long_fp32_training(torch, card)
            fp32 = check_fp32_training(torch, card)
            check_fp32_training(torch, card, fused_ln=True,
                                base_ms=fp32["step_ms_median"])
        return 0
    check_fused_ln(torch, {
        ("bfloat16", "fwd"): reports["fused_ln_matmul_fwd_tc"],
        ("bfloat16", "bwd"): reports["fused_ln_matmul_bwd_tc"],
        ("float16", "fwd"): reports["fused_ln_matmul_fwd_tc_fp16"],
        ("float16", "bwd"): reports["fused_ln_matmul_bwd_tc_fp16"],
        ("float32", "fwd"): reports["fused_ln_matmul_fwd_tf32"],
        ("float32", "bwd"): reports["fused_ln_matmul_bwd_tf32"],
        ("float32", "first-fwd"): reports["fused_ln_matmul_fwd"],
        ("float32", "first-bwd"): reports["fused_ln_matmul_bwd"],
        ("bfloat16", "first-fwd-d2048"):
            reports["fused_ln_matmul_fwd_d2048"],
        ("bfloat16", "first-bwd-d2048"):
            reports["fused_ln_matmul_bwd_d2048"],
        ("bfloat16", "fwd-d2048"): reports["fused_ln_matmul_fwd_tc_d2048"],
        ("bfloat16", "bwd-d2048"):
            reports["fused_ln_matmul_bwd_tc_d2048"]})
    if only:
        print(json.dumps({"kernels_checked": [k for k, *_ in KERNELS]}))
        return 0

    # 3. the serving path end to end
    serving = check_serving(torch)
    reports["paged_decode_attention"]["launches"] = \
        serving["bucketed"]["kernel_launches"]
    reports["paged_decode_attention_int8"]["launches"] = \
        serving["int8"]["kernel_launches"]
    reports["chunked_prefill_attention_tc"]["launches"] = \
        serving["chunked"]["kernel_launches"]
    reports["chunked_prefill_attention_tf32"]["launches"] = \
        serving["chunked_fp32"]["kernel_launches"]
    reports["chunked_prefill_attention_tf32_int8"]["launches"] = \
        serving["int8_chunked_fp32"]["kernel_launches"]
    reports["chunked_prefill_attention_tc_int8"]["launches"] = \
        serving["int8_chunked"]["kernel_launches"]

    # 3b. speculative serving and resilience (fills the verify row)
    check_speculative(torch, card, reports["paged_decode_attention_verify"])

    # 3c. serving telemetry: on and off give the same tokens and launches
    check_telemetry(torch, card)
    # the first kernel, at D = 64 (timed as the first version) and on its
    # own route (the _d256 rows): its launches over every served trace of
    # phases 3-3c, bf16 and fp32 (0: no served model has a head dim above
    # 128, and serve() holds each run to its route)
    first = SERVED_LAUNCHES.get("chunked_prefill_attention", 0)
    reports["chunked_prefill_attention"]["launches"] = first
    for name in ("bfloat16", "float32"):
        for int8 in (False, True):
            reports["chunked_prefill_attention_" + chunked_d256_row(
                name, int8)]["launches"] = first

    # 4. the training path end to end, and its fp32 comparison; the FMA
    # kernels' launches at D > 128 are counted over phases 4 and 7 (bf16,
    # the _d256 rows) and 7b (fp32, the _d256_fp32 rows)
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    take_wide_launches(fa)
    training = check_training(torch, card)
    wide = take_wide_launches(fa)
    for name in FLASH_NAMES + ("fused_adam",):
        reports[name]["launches"] = training["launches"][name]
    fp32 = check_training_fp32(torch)
    for name in FLASH_FMA_NAMES + FLASH_TF32_NAMES:
        reports[name]["launches"] = fp32[name]

    # 5. long-sequence training with block-sparse attention, and its fp32
    # comparison
    long = check_long_training(torch, card)
    for name in SPARSE_KERNELS:
        reports[name]["launches"] = long["launches"][name]
    check_training_fp32(torch, seq=4096, micro=1, sparse=SPARSE_LONG)

    # 5b. long-sequence training in fp32: the fp32 sparse rows count its
    # timed steps (the FMA forward, dq and dk/dv 0)
    long32 = check_long_fp32_training(torch, card)
    for name in SPARSE_FMA_NAMES + SPARSE_TF32_NAMES:
        reports[name]["launches"] = long32["launches"][name]

    # 6. training with the fused LayerNorm + projection sites, its one-site
    # variants and its fp32 comparison (the 3xTF32 route; fused_ln.cu's
    # fp32 rows count 0 there)
    fused = check_training(torch, card, fused_ln=True)
    for name in FUSED_LN_TC_NAMES:
        reports[name]["launches"] = fused["launches"][name]
    base_ms = training["step_ms_median"]
    print(f"fused_ln training: step {fused['step_ms_median']:.2f} ms against "
          f"the unfused {base_ms:.2f} ms of phase 4: ratio "
          f"{fused['step_ms_median'] / base_ms:.4f}; peak memory "
          f"{fused['peak_memory_gb']:.3f} GB against "
          f"{training['peak_memory_gb']:.3f} GB")
    check_fused_ln_sites(torch, card, base_ms)
    fp32 = check_training_fp32(torch, fused_ln=True)
    for name in FUSED_LN_FIRST_NAMES:
        reports[name]["launches"] = fp32[name]
    fp16 = check_fused_ln_fp16(torch, card)
    for name in FUSED_LN_TC_NAMES:
        reports[name + "_fp16"]["launches"] = fp16["launches"][name]

    # 6b. training at GPT-3 XL's width (4 layers): #6 / #7 above
    # fused.TC_MAX_D on the wgmma route's streamed product (the _tc_d2048
    # rows count its fused steps)
    wide_runs = check_wide_training(torch, card)
    for name in FUSED_LN_TC_NAMES:
        reports[name + "_d2048"]["launches"] = \
            wide_runs[True]["launches"].get(name, 0)

    # 7. training at the default dropout 0.1 (make_gpt("gpt2") as it is),
    # and its fp32 comparison at that rate
    take_wide_launches(fa)
    drop = check_training(torch, card, dropout=True)
    wide = take_wide_launches(fa, wide)
    for name in FLASH_NAMES:
        reports[name + "_dropout"]["launches"] = drop["launches"][name]
    # fused_ln.cu (the first version, on no route): its counters over the
    # 16-bit training steps of phases 4, 6 (bf16 and fp16), 6b and 7; the
    # run fails unless they read 0
    for name in FUSED_LN_FIRST_NAMES:
        reports[name + "_d2048"]["launches"] = sum(
            run["launches"].get(name, 0) for run in (
                training, fused, fp16, drop, *wide_runs.values()))
        if reports[name + "_d2048"]["launches"]:
            fail(f"fused_ln.cu's {name} launched on a 16-bit training "
                 f"path: {reports[name + '_d2048']['launches']} times over "
                 f"phases 4, 6, 6b and 7")
    prof = drop.get("profile") or {}
    print(f"dropout training: step {drop['step_ms_median']:.2f} ms (min "
          f"{drop['step_ms_min']:.2f}, max {drop['step_ms_max']:.2f}) "
          f"against phase 4's {base_ms:.2f} ms at dropout 0: ratio "
          f"{drop['step_ms_median'] / base_ms:.4f}; "
          f"{drop['tokens_per_s']:.1f} tokens/s, MFU "
          f"{drop['mfu_vs_989_tflops_dense_bf16']:.4f}; peak memory "
          f"{drop['peak_memory_gb']:.3f} GB against "
          f"{training['peak_memory_gb']:.3f} GB; hash dropout forward "
          f"{prof.get('hash_dropout_forward_device_ms_per_step')} device "
          f"ms per step, flash {prof.get('flash_ms_per_step')} ({card})")
    check_training_fp32(torch, dropout=FLASH_DROPOUT)

    # 7b. fp32 training at full width (DeepSpeed's default precision): the
    # fp32 rows at dropout count its timed steps
    take_wide_launches(fa)
    fp32 = check_fp32_training(torch, card)
    wide32 = take_wide_launches(fa)
    for name in FLASH_FMA_NAMES + FLASH_TF32_NAMES:
        reports[name + "_dropout"]["launches"] = fp32["launches"].get(name,
                                                                      0)
    for name, key in zip(FLASH_FMA_NAMES, ("fwd", "dq", "dkv")):
        reports[name + "_d256"]["launches"] = wide[key]
        reports[name + "_d256_fp32"]["launches"] = wide32[key]
    if any(wide.values()) or any(wide32.values()):
        fail(f"the FMA flash kernels launched at D > 128 on a training "
             f"path: {wide} over phases 4 and 7, {wide32} over phase 7b")

    # 7c. fp32 training with the fused LayerNorm + projection sites at full
    # width: the 3xTF32 #6 / #7 rows count its timed steps
    fused32 = check_fp32_training(torch, card, fused_ln=True,
                                  base_ms=fp32["step_ms_median"])
    for name in FUSED_LN_TF32_NAMES:
        reports[name]["launches"] = fused32["launches"][name]

    # 8. BERT-large pretraining (bench_bert's configurations, then sparse
    # BERT at block 16), and its fp32 comparisons
    check_bert(torch, card, reports)

    # 9. checkpointing, the dataloader and preemption-safe training
    check_ckpt(torch, card)

    print(f"chip_smoke: the whole run took {time.perf_counter() - t_run:.1f}"
          f" s ({card})")
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

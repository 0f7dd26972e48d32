"""ServeEngine: continuous batching over the inference engine.

The port of ``deepspeed_tpu/serving/engine.py``. Each ``step()``:

- **admits** up to ``max_prefills_per_step`` waiting requests. On the
  bucketed path (the default) each admitted prompt is prefilled at once:
  right-padded to a power-of-two bucket of whole blocks, it runs the
  dense-cache forward, its first token is sampled, and its K/V are packed
  into the paged pools; a prompt whose head was adopted from the prefix
  cache prefills only its tail, through the paged cache. Under
  ``serving.chunked_prefill`` admission only allocates: the prompt enters
  the mixed step in chunks;
- **decodes** one token for every running sequence: the whole slot batch
  goes through the paged cache with per-row positions, and inactive slots
  point at the scratch block. Under chunked prefill this is the **mixed
  step** instead: one ragged token batch of every decoding sequence's
  token plus prompt chunks (FCFS, up to ``token_budget`` tokens), padded
  to the budget, through the chunked-prefill kernel; a prompt whose last
  chunk lands takes its first token from that chunk's last row;
- samples greedily (or with temperature/top-k from a seeded generator; the
  chunked path and speculative decoding are greedy only).

Under ``serving.speculative`` a decode round is **speculative**: a draft
model, the target's first ``draft_layers`` layers over the target's own
embeddings, final LN and head (the same Parameter objects), proposes ``k``
tokens in ``k`` single-token steps that read and write the target's pools
for its layers (no second KV cache), and one target pass verifies the
chunk ``[t0, d_1..d_k]`` at positions ``pos..pos+k`` (kernel #1 with
``k + 1`` queries a row on the kernel path). The reference's scan runs
``k + 1`` draft steps; the last one's token is dropped and its K/V write
at ``pos + k`` is rewritten by the verify before anything reads it, so
the port leaves it out. The greedy accept rule keeps
the output token-identical to plain decode: a draft token stays iff it is
the target's greedy choice there, and the first disagreement is replaced
by the target's token. The chunk's writes are clamped
(``PagedLayerCache.clamp_writes``): lookahead past a row's blocks lands in
scratch block 0. Under chunked prefill a round with a prompt chunk in
flight is a mixed step, the others are speculative.

Under ``serving.resilience`` (``serving/resilience.py``) each step first
resolves deadlines and cancellations, ``submit`` may shed a request at
the admission gate, and the decode round is guarded: retry, then rebuild
and replay, then one final dispatch. A ``FaultPlan``
(``resilience.fault_injection``) injects decode faults, slow steps and
request storms, with or without the manager.

Scheduling between steps is host Python (``serving/scheduler.py``). Where
the JAX package compiles one program per prompt bucket and per decode
window, the port runs eagerly, and the pools are written in place.

``decode_attention``: "gather" gathers the full table window each step;
"kernel" caps the window at the longest active row (a power-of-two block
count) and attends through the paged decode-attention kernel; "auto" is
"kernel" on a CUDA device (raising where the kernel does not take the
pool) and "gather" on the CPU. ``int8_kv_cache`` stores the pools as int8
with per-(token, head) scales on every path.

Telemetry (``telemetry/``) rides the reference's contract. Metrics go
through the ``MetricsRegistry`` (no sinks: no-ops), spans through the
``StepTracer`` (``prefill``, ``decode_step``, ``mixed_step``,
``spec_step``; disabled: a reusable null span and zero device syncs), and
the optional ``RequestAccountant`` keeps the per-request SLO ledger and
the engine's serving-time partition, whose ``compile`` bucket takes a
dispatch at a call signature the engine had not run before (the JAX
engine's "a jit cache grew"). Each group of step gauges is emitted only
when its feature is on, so the tag set of an engine with a feature off is
unchanged. With the int8 pool and ``telemetry.numerics`` on, each cold
prefill measures the round-trip error of the K/V it quantized, on the
device, fetched in one transfer.

The decode, mixed and speculative spans end in the host fetch of the
sampled tokens, so they cover the device work even without
``sync_spans``; the prefill span ends in the first token's fetch, except
on a replay, which fetches nothing.
"""

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm.quantize import roundtrip_error
from deepspeed_tpu_torch.config.config import ServingConfig
from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  bucket_length,
                                                  sample_logits)
from deepspeed_tpu_torch.models.gpt import init_kv_cache
from deepspeed_tpu_torch.ops.transformer.chunked_prefill import chunked_runs
from deepspeed_tpu_torch.ops.transformer.paged_attention import \
    paged_decode_ok
from deepspeed_tpu_torch.serving.kv_cache import (BlockPool,
                                                  ChunkedLayerCache,
                                                  PagedLayerCache,
                                                  init_paged_pools,
                                                  pack_prefill)
from deepspeed_tpu_torch.serving.resilience import ResilienceManager
from deepspeed_tpu_torch.serving.scheduler import (PrefixCache, Scheduler,
                                                   Sequence)
from deepspeed_tpu_torch.telemetry import null_telemetry
from deepspeed_tpu_torch.utils.logging import log_dist

# Every metric tag the serving engine can emit.
SERVING_METRIC_TAGS = frozenset({
    "serving/ttft_ms",
    "serving/tokens_per_sec",
    # with the request accountant on
    "serving/tokens_per_sec_window",
    "serving/batch_occupancy",
    "serving/kv_blocks_in_use",
    "serving/queue_depth",
    "serving/preempted_seqs",
    "serving/requests_completed",
    # with decode_attention "auto" or "kernel"
    "serving/decode_attn_kernel",
    # with the prefix cache on
    "serving/prefix_hits",
    "serving/prefix_blocks_reused",
    # with speculative decoding on
    "serving/spec_accept_rate",
    "serving/spec_tokens_per_verify",
    # with serving.resilience on
    "serving/shed_requests",
    "serving/deadline_expired",
    "serving/cancelled",
    "serving/recoveries",
    "serving/retries",
    "serving/degraded_level",
    # with chunked prefill on
    "serving/chunked_tokens_per_step",
    "serving/prefill_chunks_in_flight",
})


def _check_kernel_takes(what: str, head_dim: int, dtype: torch.dtype,
                        pool_dtype: Optional[torch.dtype]) -> None:
    if not paged_decode_ok(head_dim, dtype, pool_dtype):
        raise ValueError(
            f"{what}: the CUDA kernel takes float32 or bfloat16 queries, "
            f"pools of their dtype or int8, and head_dim a multiple of 8 "
            f"up to 256, not {dtype} over {pool_dtype or dtype} pools / "
            f"{head_dim}")


def resolve_decode_attention(mode: str, device_type: str, head_dim: int,
                             dtype: torch.dtype,
                             pool_dtype: Optional[torch.dtype] = None
                             ) -> str:
    """The decode attention impl for ``serving.decode_attention``.

    ``dtype``: the queries' dtype at the kernel; ``pool_dtype``: the
    pools' (None: the same; int8 for the int8 pool). On a CUDA device
    "auto" is "kernel", and operands the kernel does not take raise: the
    decode never drops to the gather path behind the caller's back. On
    the CPU "auto" is "gather"."""
    if mode == "auto":
        mode = "kernel" if device_type == "cuda" else "gather"
    if mode == "kernel" and device_type == "cuda":
        _check_kernel_takes("serving.decode_attention='kernel'", head_dim,
                            dtype, pool_dtype)
    return mode


class ServeEngine:
    """Continuous-batching serving engine over an :class:`InferenceEngine`.

    ``engine``: an InferenceEngine wrapping the port's GPT. ``config``: a
    ``ServingConfig`` (None for defaults). ``telemetry``: the run's
    ``Telemetry`` facade (None or a disabled one: no telemetry work beyond
    host float arithmetic). ``measure_kv_quant_error``: with the int8 pool
    and telemetry on, the per-prefill KV round-trip error gauges.
    ``request_accountant``: a ``RequestAccountant`` (None: off).
    ``fault_plan``: a ``resilience.FaultPlan`` whose serving hooks inject
    chaos (None: none). Drive it with ``submit()`` and ``step()`` /
    ``run_until_complete()``; ``close()`` ends it.
    """

    def __init__(self, engine: InferenceEngine,
                 config: Optional[ServingConfig] = None, telemetry=None,
                 measure_kv_quant_error: bool = False,
                 request_accountant=None, fault_plan=None):
        self.engine = engine
        self.module = engine.module
        self.model_cfg = engine.model_cfg
        self.device = engine.device
        self.scfg = config if config is not None else ServingConfig()
        self.telemetry = telemetry if telemetry is not None \
            else null_telemetry()

        model_max = int(self.model_cfg.max_seq_len)
        self.max_model_len = min(self.scfg.max_model_len or model_max,
                                 model_max)
        bs = self.scfg.kv_block_size
        self.block_size = bs
        self.max_blocks = -(-self.max_model_len // bs)   # ceil
        # Prompt buckets are whole blocks whose positions exist in the
        # model (wpe rows) and in the block table.
        self.bucket_cap = min(self.max_blocks * bs, (model_max // bs) * bs)
        if self.bucket_cap < bs:
            raise ValueError(
                f"serving.kv_block_size={bs} exceeds the usable context "
                f"({model_max}): no prompt bucket fits")

        self.pool = BlockPool(self.scfg.kv_num_blocks)
        self.prefix_cache = (PrefixCache(self.pool, bs)
                             if self.scfg.prefix_cache else None)
        self.sched = Scheduler(self.scfg.max_batch_size, self.pool, bs,
                               prefix_cache=self.prefix_cache)
        self._dtype = engine.dtype
        int8 = self.scfg.int8_kv_cache
        # What the kernels see: an fp pool gets q cast to its dtype, an
        # int8 pool q in the model's compute dtype.
        pool_dtype = torch.int8 if int8 else self._dtype
        q_dtype = self.model_cfg.dtype if int8 else self._dtype
        self._fast_path = self.scfg.decode_attention != "gather"
        self._attn_impl = resolve_decode_attention(
            self.scfg.decode_attention, self.device.type,
            self.model_cfg.head_dim, q_dtype, pool_dtype)
        # Chunked prefill: every token of a mixed step goes through the
        # chunked-prefill kernel on CUDA (no head_dim % 128 gate: that is
        # the TPU's lane tiling).
        self._chunked = self.scfg.chunked_prefill
        self._chunk_budget = self.scfg.chunked_token_budget
        if self._chunked and self.device.type == "cuda":
            _check_kernel_takes("serving.chunked_prefill",
                                self.model_cfg.head_dim, q_dtype,
                                pool_dtype)
        self._generator = None
        if self.scfg.temperature > 0.0:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.scfg.seed)
        self._spec_k = 0
        if self.scfg.spec_decode:
            self._init_speculative()
        # The call signatures each site has run (a prompt bucket, a decode
        # window): a dispatch at a new one is filed under "compile" in the
        # engine partition, where the JAX engine's jit caches grow.
        self._signatures: Dict[str, set] = {
            "prefill": set(), "prefill_tail": set(), "decode": set(),
            "spec": set(), "mixed": set()}
        # The request accountant: None keeps every hook one attribute
        # check and the emitted tag set unchanged.
        self._req_acc = request_accountant
        if self._req_acc is not None:
            self._req_acc.spec_k = self._spec_k
            self.sched.accountant = self._req_acc
        # With the int8 pool, the numerics opt-in and telemetry on, each
        # cold prefill measures the round-trip error of the K/V it
        # quantizes into the pool.
        self._measure_kv = (bool(measure_kv_quant_error)
                            and bool(int8) and self.telemetry.enabled)
        # Chaos is independent of the manager: a serve fault with
        # resilience off crashes the loop.
        self._fault = fault_plan
        self._dispatch_attempts = 0      # decode dispatches, fault-keyed
        self._storm_template = None      # last submit's arguments
        self._resil = (ResilienceManager(self) if self.scfg.resilience
                       else None)
        if self._resil is not None and self.device.type == "cuda":
            # Build (or load) the path's kernels now: a build failure
            # raises here, never inside a guarded dispatch's retries.
            from deepspeed_tpu_torch.ops.transformer import (
                chunked_prefill, paged_attention)

            if self._attn_impl == "kernel":
                paged_attention._kernel()
            if self._chunked:
                chunked_prefill._kernel()
        self._pools = init_paged_pools(self.model_cfg,
                                       self.scfg.kv_num_blocks, bs,
                                       int8=int8, dtype=self._dtype,
                                       device=self.device)
        self._step_count = 0
        # The cumulative decode rate (tokens over the decode rounds' wall
        # seconds): the admission gate's projected wait reads it.
        self._decode_tokens = 0
        self._decode_sec = 0.0
        self.results: Dict[int, Dict[str, Any]] = {}
        # ``gathered_positions``: key positions the decode steps covered
        # per row (window width x steps); ``full_positions``: the same for
        # an uncapped window. ``mixed_steps``: chunked mixed dispatches;
        # ``chunk_tokens_last``: real tokens in the last one. ``spec_*``:
        # speculative rounds, draft tokens proposed and accepted, tokens
        # appended by the rounds.
        self.stats = {"decode_steps": 0,
                      "slot_assignments": {}, "kernel_steps": 0,
                      "gathered_positions": 0, "full_positions": 0,
                      "prefix_hits": 0, "mixed_steps": 0,
                      "chunk_tokens_last": 0, "spec_rounds": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_new_tokens": 0}
        admission = (f"chunked prefill, token budget {self._chunk_budget}"
                     if self._chunked else "bucketed prefill")
        log_dist(
            f"serving: {self.scfg.max_batch_size} slots, KV pool "
            f"{self.pool.capacity}x{bs} positions "
            f"({'int8' if int8 else self._dtype}) on {self.device}, "
            f"{admission}, decode attention {self._attn_impl}, prefix "
            f"cache {'on' if self.prefix_cache else 'off'}, speculative "
            f"k {self._spec_k}, resilience "
            f"{'on' if self._resil else 'off'}, max_model_len "
            f"{self.max_model_len}", ranks=[0])

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        """Queue one request; returns its request id. Admission happens at
        the next ``step()`` boundary.

        ``deadline_ms`` (needs ``serving.resilience``): a wall-clock budget
        from submission; past it the request is aborted at the next step
        boundary with status ``deadline_expired`` and the tokens it has.
        With resilience on, the admission gate may refuse the request:
        the returned rid then has a terminal ``shed`` record."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) > self.bucket_cap:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds the largest prefill "
                f"bucket ({self.bucket_cap})")
        if len(prompt) + int(max_new_tokens) > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})")
        vocab = self.model_cfg.vocab_size
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        bs = self.block_size
        # Lifetime KV need: the LAST sampled token's KV is never written,
        # so the highest write position is prompt + max_new_tokens - 2.
        need = max(self._bucket_of(len(prompt)) // bs,
                   -(-(len(prompt) + int(max_new_tokens) - 1) // bs))
        if need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} KV blocks but the pool holds "
                f"{self.pool.capacity}: it could never be admitted; raise "
                f"serving.kv_num_blocks")
        if deadline_ms is not None:
            if self._resil is None:
                raise ValueError("deadline_ms requires serving.resilience")
            if deadline_ms <= 0:
                raise ValueError(
                    f"deadline_ms must be > 0, got {deadline_ms}")
        eos = eos_token_id if eos_token_id is not None \
            else self.scfg.eos_token_id
        if self._fault is not None:
            self._storm_template = (list(prompt), int(max_new_tokens),
                                    eos_token_id, deadline_ms)
        if self._resil is not None:
            reason = self._resil.admission_gate(prompt, int(max_new_tokens))
            if reason is not None:
                return self._resil.shed(prompt, int(max_new_tokens), eos,
                                        reason)
        rid = self.sched.submit(prompt, int(max_new_tokens), eos)
        req = self.sched.waiting[-1]
        if self._resil is not None:
            dl = (deadline_ms if deadline_ms is not None
                  else self.scfg.resil_default_deadline_ms)
            if dl is not None:
                req.deadline = req.arrival + dl / 1e3
        if self._req_acc is not None:
            self._req_acc.on_submit(req)
        return rid

    def cancel(self, rid: int) -> bool:
        """Flag a submitted request for cancellation, resolved at the next
        step boundary: dropped from the queue, or aborted with its partial
        output and status ``cancelled``. False when the rid is unknown or
        already terminal. Needs ``serving.resilience``."""
        if self._resil is None:
            raise RuntimeError("cancel() requires serving.resilience")
        return self._resil.request_cancel(rid)

    def idle(self) -> bool:
        return self.sched.idle()

    # ------------------------------------------------------------------
    # the serving step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> Dict[str, Any]:
        """One engine iteration: resolve deadlines and cancellations (with
        resilience on) and any scheduled request storm, admit (+ prefill on
        the bucketed path, bounded), then advance the whole decode batch
        (one token, a speculative round, or under chunked prefill a mixed
        step). Returns a step report (``finished`` / ``prefilled`` request
        ids, ``active`` count)."""
        info: Dict[str, Any] = {"step": self._step_count, "prefilled": [],
                                "finished": [], "active": 0}
        # The engine partition: the accountant's one cursor advances at
        # each phase boundary, so the step's wall clock lands in exactly
        # one category.
        acc = self._req_acc
        if acc is not None:
            acc.engine_mark("host_idle")    # since the previous step
        if self._resil is not None:
            self._resil.process_boundary()
        if self._fault is not None \
                and self._fault.should_serve_storm(self._step_count):
            self._inject_storm()
        for _ in range(self.scfg.max_prefills_per_step):
            seq = self.sched.try_admit(self._bucket_of, self._step_count)
            if seq is None:
                break
            self.stats["slot_assignments"].setdefault(seq.slot, 0)
            self.stats["slot_assignments"][seq.slot] += 1
            if acc is not None:
                acc.engine_mark("scheduler_admission")
            if self._chunked:
                # No prefill here: the prompt enters the mixed step in
                # chunks from its adopted head; its first token and prefix
                # registration come with its last chunk (_mixed_round).
                seq.pos = seq.prefilled = seq.shared_len
                continue
            n_sigs = self._n_signatures("prefill", "prefill_tail")
            self._prefill(seq)
            if acc is not None:
                grew = self._n_signatures("prefill", "prefill_tail") > n_sigs
                acc.engine_mark("compile" if grew else "prefill")
                acc.on_prefilled(seq)
            self.sched.register_prefix(seq, self._step_count)
            info["prefilled"].append(seq.request.rid)
            if seq.finished():      # max_new_tokens == 1 / instant EOS
                self._finish(seq, info)

        # a speculative round writes k + 1 positions: capacity is ensured
        # with that lookahead, capped at each row's lifetime
        for seq in self.sched.active:
            if self.sched.running.get(seq.slot) is seq:
                self.sched.ensure_capacity(seq, lookahead=self._spec_k)
        active = self.sched.active          # preemption may have evicted
        info["active"] = len(active)
        if acc is not None:
            acc.engine_mark("scheduler_admission")
        dt = 0.0
        n_tokens = 0
        if active:
            n_sigs = self._n_signatures("decode", "spec", "mixed")
            if self._resil is not None:
                n_tokens, dt, active = self._resil.run_decode(active, info)
                self._resil.note_step(dt)
            else:
                n_tokens, dt = self._decode_round(active, info)
            if acc is not None:
                grew = self._n_signatures("decode", "spec", "mixed") > n_sigs
                acc.engine_mark("compile" if grew else "decode")
                acc.on_decode_step(
                    [s for s in active if self.sched.running.get(s.slot)
                     is s], dt, self._step_count)
            self.stats["decode_steps"] += 1
            if n_tokens and dt > 0:
                self._decode_tokens += n_tokens
                self._decode_sec += dt
        if self.prefix_cache is not None:
            self.stats["prefix_hits"] = self.prefix_cache.hits
        # the gauges carry this step's index, as its TTFT and completion
        # rows do
        self._emit_step_metrics(len(active), dt, n_tokens)
        self._step_count += 1
        return info

    def run_until_complete(self, max_steps: int = 100_000,
                           timeout_sec: Optional[float] = None
                           ) -> Dict[int, Any]:
        """Drive ``step()`` until every submitted request has finished;
        returns the results map (rid -> record). ``timeout_sec``: a
        wall-clock bound; a wedged loop raises with the queue and the
        running rids."""
        steps = 0
        t0 = time.monotonic()
        while not self.idle():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serving did not drain in {max_steps} steps "
                    f"(queue={self.sched.queue_depth}, "
                    f"running={len(self.sched.running)})")
            if timeout_sec is not None \
                    and time.monotonic() - t0 > timeout_sec:
                waiting = [r.rid for r in self.sched.waiting]
                running = {s.slot: s.request.rid
                           for s in self.sched.running.values()}
                raise RuntimeError(
                    f"serving wall-clock timeout: not drained after "
                    f"{timeout_sec:.3f}s ({steps} steps, "
                    f"queue={self.sched.queue_depth} rids={waiting[:8]}, "
                    f"running={running})")
        return self.results

    def close(self) -> None:
        """Give every request still running or queued a terminal
        ``aborted`` record (its slot and blocks released; the accountant
        writes its record too): every submitted rid resolves through
        ``results``. Then close the request records and the telemetry
        this engine drives (sink files, the trace, a profiler capture),
        even when a step raised before."""
        acc = self._req_acc
        try:
            for seq in list(self.sched.running.values()):
                rid = seq.request.rid
                self.sched.abort(seq)
                self.results[rid] = self._result_record(seq, "aborted")
                if acc is not None:
                    slo = acc.on_finish(seq, self._step_count,
                                        status="aborted")
                    if slo is not None:
                        self.results[rid]["slo"] = slo
            while self.sched.waiting:
                req = self.sched.waiting.popleft()
                self.results[req.rid] = self._queue_record(req, "aborted")
                if acc is not None:
                    acc.on_drop(req, "aborted", self._step_count)
        finally:
            try:
                if acc is not None:
                    acc.close()
            finally:
                self.telemetry.close()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _bucket_of(self, t: int) -> int:
        if self._chunked:
            # Exact whole blocks: the ragged mixed step takes any length,
            # so neither KV blocks nor prefill compute pay pow2 rounding.
            return min(-(-t // self.block_size) * self.block_size,
                       self.bucket_cap)
        b = bucket_length(t, cap=self.bucket_cap)
        b = -(-b // self.block_size) * self.block_size   # whole blocks
        return min(max(b, -(-t // self.block_size) * self.block_size),
                   self.bucket_cap)

    def _result_record(self, seq: Sequence, status: str) -> Dict[str, Any]:
        """Terminal record of an admitted sequence: ``finished``, or a
        resilience terminal (``deadline_expired``, ``cancelled``,
        ``aborted``) with the partial output."""
        req = seq.request
        now = time.monotonic()
        return {
            "tokens": list(seq.tokens),
            "prompt_len": len(req.prompt),
            "status": status,
            "slot": seq.slot,
            "finish_step": self._step_count,
            "ttft_ms": (req.first_token_time - req.arrival) * 1e3
            if req.first_token_time else None,
            "finish_time": now,
            "e2e_ms": (now - req.arrival) * 1e3,
            "queue_wait_ms": (req.admitted_time - req.arrival) * 1e3
            if req.admitted_time is not None else None,
            "preempted_count": req.preempted_count,
        }

    def _queue_record(self, req, status: str,
                      reason: Optional[str] = None) -> Dict[str, Any]:
        """Terminal record of a request never admitted (shed, cancelled or
        expired in the queue, aborted): ``tokens`` is the prompt."""
        now = time.monotonic()
        rec = {
            "tokens": list(req.prompt),
            "prompt_len": len(req.prompt),
            "status": status,
            "slot": None,
            "finish_step": self._step_count,
            "ttft_ms": None,
            "finish_time": now,
            "e2e_ms": (now - req.arrival) * 1e3,
            "queue_wait_ms": None,
            "preempted_count": req.preempted_count,
        }
        if reason is not None:
            rec["shed_reason"] = reason
        return rec

    def _finish(self, seq: Sequence, info: Dict[str, Any]) -> None:
        rid = seq.request.rid
        self.sched.finish(seq)
        self.results[rid] = self._result_record(seq, "finished")
        info["finished"].append(rid)
        if self.telemetry.enabled:
            self.telemetry.registry.counter("serving/requests_completed").inc(
                step=self._step_count)
        if self._req_acc is not None:
            slo = self._req_acc.on_finish(seq, self._step_count)
            if slo is not None:
                self.results[rid]["slo"] = slo

    def _n_signatures(self, *sites: str) -> int:
        return sum(len(self._signatures[s]) for s in sites)

    def _check_signature(self, site: str, name: str, *inputs) -> None:
        """The recompile detector's check at a dispatch site, and the
        engine's own record of the signatures each site has run (``name``
        carries the bucket or window, which fixes the inputs' shapes)."""
        self.engine.recompile_detector.check(name, *inputs)
        self._signatures[site].add(name)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self.scfg.temperature,
                             self.scfg.top_k, self._generator)

    # -- prefill --------------------------------------------------------
    def _prefill(self, seq: Sequence) -> None:
        self._record_first_token(seq, self._prefill_tokens(
            seq, seq.request.prompt))

    def _prefill_tokens(self, seq: Sequence, tokens: List[int],
                        replay: bool = False) -> Optional[int]:
        """Write ``tokens``' K/V at positions ``[0, len(tokens))`` of
        ``seq``'s blocks and return the token sampled after them (a host
        fetch; None on a ``replay``, which drops it). A prefix-cache hit
        (``shared_len``) computes only the tail: the adopted blocks
        already hold ``[0, shared_len)``."""
        if seq.shared_len:
            return self._prefill_tail(seq, tokens, replay)
        t = len(tokens)
        bucket = seq.bucket
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :t] = torch.tensor(tokens)        # right-pad: causal
        ids = ids.to(self.device)
        # one signature per bucket: a retrace under this name is a bug
        self._check_signature("prefill", f"serving.prefill_b{bucket}", ids,
                              t)
        args = {"replay": 1} if replay else {}
        with self.telemetry.span("prefill", rid=seq.request.rid,
                                 bucket=bucket, prompt_len=t, **args):
            tok, k_stack, v_stack = self._prefill_impl(ids, t)
            if self._measure_kv and not replay:
                self._emit_kv_quant_error(k_stack, v_stack, t, bucket)
            blocks = torch.tensor(seq.block_table, dtype=torch.long,
                                  device=self.device)
            pack_prefill(self._pools, blocks, k_stack, v_stack)
            if replay:
                return None
            return int(tok)                      # host fetch: first token

    def _prefill_tail(self, seq: Sequence, tokens: List[int],
                      replay: bool = False) -> Optional[int]:
        """Prefill only the unshared tail of ``tokens``: the tail,
        right-padded to a block-multiple bucket, runs one multi-token
        paged forward at position ``shared_len`` through the gather path
        (as the JAX package's tail prefill does). Writes land past the
        adopted head blocks; pad positions past the allocated blocks hit
        zero table entries (scratch). The bucket is capped so no write
        index runs past the table. The KV error gauge is not measured
        here: the adopted head was measured at its cold prefill."""
        t = len(tokens)
        sl = seq.shared_len
        tail = t - sl                           # >= 1 (match is capped)
        tb = min(self._bucket_of(tail),
                 self.max_blocks * self.block_size - sl)
        ids = torch.zeros((1, tb), dtype=torch.long)
        ids[0, :tail] = torch.tensor(tokens[sl:])
        bt = torch.zeros((1, self.max_blocks), dtype=torch.int32)
        bt[0, :len(seq.block_table)] = torch.tensor(seq.block_table)
        dev = self.device
        ids, bt = ids.to(dev), bt.to(dev)
        start = torch.tensor([sl], dtype=torch.int32, device=dev)
        self._check_signature("prefill_tail", f"serving.prefill_tail_b{tb}",
                              ids, bt, start, tail)
        args = {"replay": 1} if replay else {"shared_len": sl}
        with self.telemetry.span("prefill", rid=seq.request.rid, bucket=tb,
                                 prompt_len=t, **args):
            cache = [PagedLayerCache(*self._pools[i], bt, start,
                                     self.block_size, "gather",
                                     dtype=self._dtype)
                     for i in range(self.model_cfg.num_layers)]
            pos_ids = torch.clamp(start.long()[:, None] + torch.arange(
                tb, device=dev), max=self.model_cfg.max_seq_len - 1)
            out = self.module(ids, position_ids=pos_ids, cache=cache)
            if replay:
                return None
            last = out["logits"][:, tail - 1].float()            # [1, V]
            return int(self._sample(last)[0])    # host fetch: first token

    def _record_first_token(self, seq: Sequence, first: int) -> None:
        """Append the prefill's sampled token; TTFT is stamped (and
        observed) at the request's first prefill only, not on a
        preemption restart."""
        now = time.monotonic()
        seq.tokens.append(first)
        if seq.request.first_token_time is None:
            seq.request.first_token_time = now
            if self.telemetry.enabled:
                self.telemetry.registry.histogram("serving/ttft_ms").observe(
                    (now - seq.request.arrival) * 1e3, step=self._step_count)

    def _replay_prefill(self, seq: Sequence, replay: List[int]) -> None:
        """Recovery replay (``serving/resilience.py``): rebuild ``seq``'s
        K/V ``[0, pos)`` in the fresh pools from its recorded
        ``tokens[:-1]`` through the same prefill paths as an admission.
        The sampled token is dropped: under greedy it is the recorded
        ``tokens[-1]``, whose K/V the next decode round writes. No TTFT,
        no token appended."""
        if self._chunked:
            self._replay_chunked(seq, replay)
        else:
            self._prefill_tokens(seq, replay, replay=True)

    def _replay_chunked(self, seq: Sequence, replay: List[int]) -> None:
        """Chunked replay: ``[shared_len, len(replay))`` through the mixed
        step in budget-sized chunks (resilience routes only fully
        prefilled sequences here); the samples are dropped."""
        t0, total = seq.shared_len, len(replay)
        while t0 < total:
            c = min(self._chunk_budget, total - t0)
            with self.telemetry.span("prefill", rid=seq.request.rid,
                                     bucket=seq.bucket, prompt_len=total,
                                     replay=1):
                self._mixed_dispatch(
                    [seq], [(seq.slot, replay[t0 + i], t0 + i)
                            for i in range(c)], 1)
            t0 += c

    def _prefill_impl(self, ids: torch.Tensor, length: int):
        cache = init_kv_cache(self.model_cfg, 1, ids.shape[1],
                              dtype=self._dtype, device=self.device)
        out = self.module(ids, cache=cache, pos=0)
        # Right-padded prompt: causality alone keeps pad positions out of
        # every real token's attention, so the last REAL position's logits
        # are exact; pad-position K/V are garbage the position mask hides.
        last = out["logits"][:, length - 1].float()              # [1, V]
        tok = self._sample(last)[0]
        k_stack = torch.stack([c[0][0] for c in out["cache"]])  # [L,Tb,H,D]
        v_stack = torch.stack([c[1][0] for c in out["cache"]])
        return tok, k_stack, v_stack

    # -- decode ---------------------------------------------------------
    def _decode_round(self, active: List[Sequence], info: Dict[str, Any]):
        """One decode round for the batch: a mixed step (chunked prefill,
        with speculation only while a prompt chunk is in flight), a
        speculative round, or one token a row. Appends the tokens and
        finishes rows; returns ``(n_tokens, seconds)``. The resilience
        manager guards this boundary."""
        t_dec = time.perf_counter()
        if self._chunked and (not self._spec_k or any(
                s.prefilled < len(s.request.prompt) for s in active)):
            n_tokens = self._mixed_round(active, info)
        elif self._spec_k:
            n_tokens = self._spec_round(active, info)
        else:
            toks = self._decode(active)
            n_tokens = len(active)
            for seq, tok in zip(active, toks):
                seq.tokens.append(tok)
                seq.pos += 1
                if seq.finished():
                    self._finish(seq, info)
        return n_tokens, time.perf_counter() - t_dec

    def _inject_storm(self) -> None:
        """FaultPlan request storm: duplicates of the last submitted
        request through ``submit()`` (and so through the shed gate)."""
        if self._storm_template is None:
            return
        prompt, max_new, eos, dl = self._storm_template
        n = self._fault.serve_storm_requests
        log_dist(f"serving: FaultPlan request storm, {n} submissions at "
                 f"step {self._step_count}", ranks=[0])
        for _ in range(n):
            if self._resil is not None:
                self.submit(prompt, max_new, eos, deadline_ms=dl)
            else:
                self.submit(prompt, max_new, eos)

    def _fault_hook(self) -> None:
        """Serving chaos, keyed on the decode dispatch-attempt count
        (monotonic across steps and retries). It runs before a round's
        first pool write, so a raise here changes no pool."""
        if self._fault is None:
            return
        self._dispatch_attempts += 1
        if self._fault.should_serve_decode_fault(self._dispatch_attempts):
            self._fault.serve_decode_fault(self._dispatch_attempts)
        if self._fault.should_serve_slow_step(self._dispatch_attempts):
            self._fault.serve_slow_step()

    def _batch_inputs(self, active: List[Sequence]):
        """Host-side decode batch matrices (inactive rows -> scratch)."""
        nb, mb = self.scfg.max_batch_size, self.max_blocks
        bt = np.zeros((nb, mb), np.int32)
        pos = np.zeros((nb,), np.int32)
        toks = np.zeros((nb,), np.int64)
        for seq in active:
            s = seq.slot
            bt[s, :len(seq.block_table)] = seq.block_table
            pos[s] = seq.pos
            toks[s] = seq.tokens[-1]
        return bt, pos, toks

    def _window_blocks(self, active: List[Sequence], chunk: int) -> int:
        """Capped key window: enough table columns for the longest active
        row's reads and this round's ``chunk`` writes (1, or ``k + 1`` for
        a speculative round), ceiled to a power of two."""
        need_pos = max(seq.pos for seq in active) + chunk
        need = -(-need_pos // self.block_size)
        wb = 1
        while wb < need:
            wb *= 2
        return min(wb, self.max_blocks)

    def _dispatch_batch(self, active: List[Sequence], chunk: int,
                        site: str):
        """Decode batch tensors on the device, the window cut under the
        fast path, and the attention impl; keeps the window accounting and
        checks the signature (one per window: ``site`` "decode" or
        "spec"). Shared by the plain and the speculative round, after the
        fault hook."""
        self._fault_hook()
        mb = self.max_blocks
        bt, pos, toks = self._batch_inputs(active)
        name = f"serving.{site}_step"
        if self._fast_path:
            wb, impl = self._window_blocks(active, chunk), self._attn_impl
            bt = np.ascontiguousarray(bt[:, :wb])
            name = f"{name}_w{wb}"
        else:
            wb, impl = mb, "gather"
        self.stats["gathered_positions"] += wb * self.block_size
        self.stats["full_positions"] += mb * self.block_size
        if impl == "kernel":
            self.stats["kernel_steps"] += 1
        dev = self.device
        bt, pos, toks = (torch.from_numpy(bt).to(dev),
                         torch.from_numpy(pos).to(dev),
                         torch.from_numpy(toks).to(dev))
        self._check_signature(site, name, toks, pos, bt)
        return bt, pos, toks, impl

    def _decode(self, active: List[Sequence]) -> List[int]:
        bt, pos, toks, impl = self._dispatch_batch(active, 1, "decode")
        with self.telemetry.span("decode_step", active=len(active)):
            logits = self._decode_impl(bt, pos, toks, impl)
            tok_host = self._sample(logits).cpu().numpy()   # host fetch
        return [int(tok_host[s.slot]) for s in active]

    def _decode_impl(self, bt, pos, toks, impl: str) -> torch.Tensor:
        cache = [PagedLayerCache(*self._pools[i], bt, pos, self.block_size,
                                 impl, dtype=self._dtype)
                 for i in range(self.model_cfg.num_layers)]
        out = self.module(toks[:, None], position_ids=pos.long()[:, None],
                          cache=cache)
        return out["logits"][:, -1].float()

    # -- chunked prefill: the mixed ragged step -------------------------
    def _mixed_round(self, active: List[Sequence],
                     info: Dict[str, Any]) -> int:
        """One mixed step: every decoding sequence advances one token and
        prompts being prefilled advance one chunk, all in one ragged
        batch. Rows: decode tokens first (the budget is >= the slot
        count), then chunks FCFS by ``(admitted_step, rid)`` until the
        budget is full. A prompt whose last chunk lands samples its first
        token from that chunk's last row: the logits the bucketed prefill
        samples from. Returns the number of tokens appended."""
        self._fault_hook()   # live rounds only: a replay never injects
        plen = [len(s.request.prompt) for s in active]
        decoding = [s for s, n in zip(active, plen) if s.prefilled >= n]
        prefilling = sorted(
            (s for s, n in zip(active, plen) if s.prefilled < n),
            key=lambda s: (s.admitted_step, s.request.rid))
        rows = [(s.slot, s.tokens[-1], s.pos) for s in decoding]
        chunks = []                              # (seq, first_row, count)
        for s in prefilling:
            if len(rows) >= self._chunk_budget:
                break
            t0 = s.prefilled
            c = min(len(s.request.prompt) - t0,
                    self._chunk_budget - len(rows))
            chunks.append((s, len(rows), c))
            rows.extend((s.slot, s.request.prompt[t0 + i], t0 + i)
                        for i in range(c))
        tok_host = self._mixed_dispatch(active, rows, len(active))
        self.stats["chunk_tokens_last"] = len(rows)
        appended = len(decoding)
        for r, seq in enumerate(decoding):
            seq.tokens.append(int(tok_host[r]))
            seq.pos += 1
            if seq.finished():
                self._finish(seq, info)
        for seq, r0, c in chunks:
            seq.prefilled += c
            seq.pos = seq.prefilled
            if seq.prefilled == len(seq.request.prompt):
                self._record_first_token(seq, int(tok_host[r0 + c - 1]))
                appended += 1
                if self._req_acc is not None:
                    self._req_acc.on_prefilled(seq)
                self.sched.register_prefix(seq, self._step_count)
                info["prefilled"].append(seq.request.rid)
                if seq.finished():   # max_new_tokens == 1 / instant EOS
                    self._finish(seq, info)
        return appended

    def _mixed_dispatch(self, table_seqs: List[Sequence], rows,
                        n_active: int):
        """Run one ragged token batch. ``rows``: ``(slot, token,
        position)`` triples, padded to the token budget with pad rows of
        slot ``max_batch_size``, the spare all-scratch table row (their
        writes land in scratch block 0, their reads see only it). One
        signature ever, whatever the decode/prefill mix."""
        nb, mb, budget = (self.scfg.max_batch_size, self.max_blocks,
                          self._chunk_budget)
        bt = np.zeros((nb + 1, mb), np.int32)    # row nb: pad/scratch row
        toks = np.zeros((budget,), np.int64)
        pos = np.zeros((budget,), np.int32)
        slots = np.full((budget,), nb, np.int32)
        for seq in table_seqs:
            bt[seq.slot, :len(seq.block_table)] = seq.block_table
        for r, (sl, tk, p) in enumerate(rows):
            slots[r], toks[r], pos[r] = sl, tk, p
        dev = self.device
        # the step's runs of one sequence, found once for every layer and
        # copied with the step's other inputs, before any kernel runs
        runs = chunked_runs(bt[slots], pos, self.block_size)
        runs.on(dev)
        bt, pos, slots, toks = (torch.from_numpy(bt).to(dev),
                                torch.from_numpy(pos).to(dev),
                                torch.from_numpy(slots).to(dev),
                                torch.from_numpy(toks).to(dev))
        self._check_signature("mixed", "serving.mixed_step", toks, pos,
                              slots, bt)
        with self.telemetry.span("mixed_step", active=n_active,
                                 tokens=len(rows)):
            logits = self._mixed_impl(bt, pos, slots, toks, runs)
            tok_host = self._sample(logits).cpu().numpy()   # host fetch
        self.stats["mixed_steps"] += 1
        return tok_host

    def _mixed_impl(self, bt, pos, slots, toks, runs) -> torch.Tensor:
        cache = [ChunkedLayerCache(*self._pools[i], bt, slots, pos,
                                   self.block_size, runs)
                 for i in range(self.model_cfg.num_layers)]
        pos_ids = torch.clamp(pos.long(), max=self.model_cfg.max_seq_len - 1)
        out = self.module(toks[None, :], position_ids=pos_ids[None, :],
                          cache=cache)
        return out["logits"][0].float()                          # [T, V]

    # -- speculative decoding -------------------------------------------
    def _init_speculative(self) -> None:
        """The draft: a GPT of the target's first ``draft_layers`` layers
        whose embeddings, blocks, final LN (and untied head) are the
        target's own modules, so it shares their Parameter objects and
        copies no weight. Its layers' K/V equal the target's for the same
        inputs, so it reads and writes the target's pools for layers
        ``< draft_layers``: no second KV cache, no draft prefill."""
        cfg = self.model_cfg
        if self.scfg.temperature != 0.0:
            raise ValueError("speculative decoding requires greedy "
                             "sampling (serving.temperature == 0)")
        dl = (self.scfg.spec_draft_layers
              if self.scfg.spec_draft_layers is not None
              else max(1, cfg.num_layers // 2))
        if not 1 <= dl < cfg.num_layers:
            raise ValueError(
                f"serving.speculative.draft_layers must be in "
                f"[1, {cfg.num_layers - 1}] for a {cfg.num_layers}-layer "
                f"target, got {dl}")
        target = self.module
        with torch.device("meta"):       # no weights of its own
            draft = type(target)(dataclasses.replace(cfg, num_layers=dl))
        draft.wte, draft.wpe, draft.ln_f = target.wte, target.wpe, \
            target.ln_f
        draft.h = torch.nn.ModuleList(target.h[:dl])
        draft.lm_head = target.lm_head
        draft.drop = target.drop
        self._draft = draft.eval()
        self._draft_layers = dl
        self._spec_k = int(self.scfg.spec_k)
        log_dist(f"serving: speculative decoding on, draft = first {dl}/"
                 f"{cfg.num_layers} layers, k={self._spec_k}", ranks=[0])

    def _spec_round(self, active: List[Sequence],
                    info: Dict[str, Any]) -> int:
        """One speculative round for the batch: the draft proposes ``k``
        tokens, one target pass scores all ``k + 1`` positions, and the
        greedy accept rule appends what plain greedy decode would: the
        draft tokens up to the first disagreement, then the target's own
        token there (or the bonus token after a full accept). Rejected
        positions stay behind ``seq.pos``: masked now, overwritten by the
        next round. Returns the number of tokens appended."""
        k = self._spec_k
        bt, pos, toks, impl = self._dispatch_batch(active, k + 1, "spec")
        with self.telemetry.span("spec_step", active=len(active), k=k):
            chunk, greedy = self._spec_impl(bt, pos, toks, k, impl)
        appended = 0
        for seq in active:
            s = seq.slot
            drafted = chunk[s, 1:]               # d_1..d_k
            target = greedy[s]                   # g_1..g_{k+1}
            accept = 0
            while accept < k and int(drafted[accept]) == int(target[accept]):
                accept += 1
            self.stats["spec_proposed"] += k
            self.stats["spec_accepted"] += accept
            for tok in list(drafted[:accept]) + [target[accept]]:
                seq.tokens.append(int(tok))
                seq.pos += 1
                appended += 1
                if seq.finished():
                    self._finish(seq, info)
                    break
        self.stats["spec_rounds"] += 1
        self.stats["spec_new_tokens"] += appended
        return appended

    def _spec_impl(self, bt, pos, toks, k: int, impl: str):
        """``k`` single-token draft steps, each writing at ``pos + j``,
        then one target verification of the chunk ``[t0, d_1..d_k]`` at
        ``pos..pos+k``, which writes every layer there (the draft's too)
        before it attends. Writes are clamped: lookahead past a row's
        blocks lands in scratch. Returns the chunk and the target's greedy
        tokens, [B, k + 1] each, on the host."""
        dl, nl = self._draft_layers, self.model_cfg.num_layers
        bs, max_pos = self.block_size, self.model_cfg.max_seq_len - 1
        cur, inputs = toks, [toks]
        for j in range(k):
            pj = pos + j
            cache = [PagedLayerCache(*self._pools[i], bt, pj, bs, impl,
                                     dtype=self._dtype, clamp_writes=True)
                     for i in range(dl)]
            out = self._draft(cur[:, None], position_ids=torch.clamp(
                pj.long(), max=max_pos)[:, None], cache=cache)
            cur = torch.argmax(out["logits"][:, -1].float(), dim=-1)
            inputs.append(cur)
        chunk = torch.stack(inputs, dim=1)                    # [B, k + 1]
        pos_ids = torch.clamp(pos.long()[:, None] + torch.arange(
            k + 1, device=pos.device), max=max_pos)
        cache = [PagedLayerCache(*self._pools[i], bt, pos, bs, impl,
                                 dtype=self._dtype, clamp_writes=True)
                 for i in range(nl)]
        out = self.module(chunk, position_ids=pos_ids, cache=cache)
        greedy = torch.argmax(out["logits"].float(), dim=-1)   # [B, k + 1]
        return chunk.cpu().numpy(), greedy.cpu().numpy()   # host fetch

    # -- telemetry ------------------------------------------------------
    def _emit_kv_quant_error(self, k_stack: torch.Tensor,
                             v_stack: torch.Tensor, length: int,
                             bucket: int) -> None:
        """``numerics/kv_quant_rel_err`` / ``_max_abs_err``: the round-trip
        error of the per-(token, head) int8 quantization the pool stores
        (block = head_dim, half to even), over the prompt's real positions
        (``[L, bucket, H, D]`` stacks cut to ``length``: a pad position's
        zero block would round-trip exactly, as the reference's mask makes
        it). Measured on the device; both scalars come back in one
        transfer."""
        ks = k_stack[:, :length].float()
        vs = v_stack[:, :length].float()
        head_dim = ks.shape[-1]
        rk, mk = roundtrip_error(ks, 8, head_dim)
        rv, mv = roundtrip_error(vs, 8, head_dim)
        rel, mab = torch.stack([torch.maximum(rk, rv),
                                torch.maximum(mk, mv)]).tolist()
        reg = self.telemetry.registry
        reg.gauge("numerics/kv_quant_rel_err").set(
            rel, step=self._step_count, bucket=bucket)
        reg.gauge("numerics/kv_quant_max_abs_err").set(
            mab, step=self._step_count, bucket=bucket)

    def _emit_step_metrics(self, n_active: int, dt_decode: float,
                           n_tokens: int) -> None:
        """The step's gauges and counters. ``dt_decode``: wall seconds of
        the decode round only, so the throughput gauge means decode
        tokens/s; ``n_tokens``: tokens appended this step. Each group
        beyond the base set is emitted only while its feature is on."""
        tel = self.telemetry
        if not tel.enabled:
            return
        reg = tel.registry
        step = self._step_count
        reg.gauge("serving/batch_occupancy").set(
            n_active / self.scfg.max_batch_size, step=step)
        reg.gauge("serving/kv_blocks_in_use").set(self.pool.used_blocks,
                                                  step=step)
        reg.gauge("serving/queue_depth").set(self.sched.queue_depth,
                                             step=step)
        if n_tokens and dt_decode > 0:
            reg.gauge("serving/tokens_per_sec").set(
                self._decode_tokens / self._decode_sec, step=step)
        acc = self._req_acc
        if acc is not None:
            # the rolling window, and the requests/* gauges
            if n_tokens and dt_decode > 0:
                acc.rolling_add(n_tokens, dt_decode)
            rate = acc.rolling_rate()
            if rate is not None:
                reg.gauge("serving/tokens_per_sec_window").set(rate,
                                                               step=step)
            acc.emit(step)

        def advance(tag: str, total: float) -> None:
            ctr = reg.counter(tag)
            if total > ctr.total:
                ctr.inc(total - ctr.total, step=step)

        advance("serving/preempted_seqs", self.sched.preempted_total)
        if self._fast_path and n_active:
            reg.gauge("serving/decode_attn_kernel").set(
                1.0 if self._attn_impl == "kernel" else 0.0, step=step)
        if self.prefix_cache is not None:
            advance("serving/prefix_hits", self.prefix_cache.hits)
            advance("serving/prefix_blocks_reused",
                    self.prefix_cache.blocks_reused)
        if self._spec_k and self.stats["spec_rounds"]:
            reg.gauge("serving/spec_accept_rate").set(
                self.stats["spec_accepted"]
                / max(1, self.stats["spec_proposed"]), step=step)
            reg.gauge("serving/spec_tokens_per_verify").set(
                self.stats["spec_new_tokens"] / self.stats["spec_rounds"],
                step=step)
        if self._resil is not None:
            reg.gauge("serving/degraded_level").set(
                self._resil.degraded_level, step=step)
            for name, total in self._resil.counters.items():
                advance(f"serving/{name}", total)
        if self._chunked:
            reg.gauge("serving/chunked_tokens_per_step").set(
                self.stats["chunk_tokens_last"], step=step)
            reg.gauge("serving/prefill_chunks_in_flight").set(
                sum(1 for s in self.sched.running.values()
                    if s.prefilled < len(s.request.prompt)), step=step)

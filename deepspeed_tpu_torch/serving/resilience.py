"""Serving resilience: deadlines, admission control, in-flight recovery.

The port of ``deepspeed_tpu/serving/resilience.py``. The ServeEngine owns
one :class:`ResilienceManager` (or None: ``serving.resilience`` off, every
hook a single attribute check). Four pieces, all driven at step
boundaries:

- **Deadlines and cancellation**: ``submit(deadline_ms=...)`` stamps an
  absolute monotonic deadline on the request; ``cancel(rid)`` flags one.
  Both resolve at the next step boundary: a queued request is dropped
  without admission, a running sequence is aborted with its partial
  output kept and its KV blocks released exactly once
  (``Scheduler.abort``; the pool's refcounts raise on a double free).
  Terminal statuses ``deadline_expired`` / ``cancelled``.
- **Admission control and load shedding**: at submit the projected queue
  wait (pending decode tokens over the request accountant's rolling-window
  decode rate when the accountant is on, else over the engine's cumulative
  rate) is held against ``max_queue_wait_ms``, and ``max_queue_depth`` is
  the backstop. A shed request gets a real rid and a terminal ``shed``
  record, never a queue slot.
- **Recovery from a failed decode dispatch**: retry through
  ``guardrails/retry.py``'s backoff, then rebuild in place (a fresh
  BlockPool, fresh pools, a fresh prefix cache) and replay every live
  sequence from its recorded tokens through the same prefill and mixed
  paths, then one final unguarded dispatch: a fault that persists
  propagates, so recovery never loops. The port writes the pools in place
  where the JAX package donates them; the fault hook runs before the
  first pool write, and a retry rewrites the same positions with the same
  values. Where the reference recovers from any exception, the port
  recovers only from :data:`RECOVERABLE` faults: an injected one, or a
  failed allocation. A kernel's own error (a launch that failed, operands
  it does not take) and a CUDA error that leaves the context unusable
  propagate out of ``step()`` untouched.
- **Degradation ladder**: every anomaly (a recovery, or a decode step
  slower than ``slow_step_ms``) feeds a ladder, one rung per
  ``degrade_after`` anomalies: (1) speculative decoding off, (2) decode
  attention kernel -> gather, (3) the admission batch cap halved. Rungs
  never un-climb; ``degraded_level`` is the operator's signal. On a CUDA
  engine rung 2 is skipped (the ladder goes from 1 to 3): tensors on the
  card never take the plain gather path in place of kernel #1.

Chaos comes from ``resilience/fault.py``'s ``FaultPlan``; injection is
independent of this manager (a fault with resilience off crashes the
loop). The engine emits ``counters`` and ``degraded_level`` as the
``serving/*`` resilience metrics, and every terminal request this manager
resolves (shed, expired, cancelled) reaches the request accountant.
"""

import collections
import time
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch.guardrails.retry import retry_call
from deepspeed_tpu_torch.resilience.fault import InjectedFault
from deepspeed_tpu_torch.serving.kv_cache import BlockPool, init_paged_pools
from deepspeed_tpu_torch.serving.scheduler import (PrefixCache, Request,
                                                   Sequence)
from deepspeed_tpu_torch.utils.logging import logger

# Terminal statuses a request record can carry ("finished" is the happy
# path, stamped by the engine).
TERMINAL_STATUSES = ("finished", "shed", "deadline_expired", "cancelled",
                     "aborted")

# The faults a decode round is retried and rebuilt on; anything else
# propagates out of ``step()``.
RECOVERABLE = (InjectedFault, torch.OutOfMemoryError)


class ResilienceManager:
    """Per-engine serving resilience policy: host-side Python only. The one
    device-facing action is the rebuild, which replays live sequences
    through the engine's own prefill paths."""

    def __init__(self, engine):
        self.engine = engine
        self.cfg = engine.scfg
        self.counters: Dict[str, int] = {
            "shed_requests": 0, "deadline_expired": 0, "cancelled": 0,
            "recoveries": 0, "retries": 0,
        }
        self.degraded_level = 0
        self.anomalies = 0
        self._cancel_pending: set = set()

    # -- admission control / load shedding ------------------------------
    def _projected_wait_ms(self) -> Optional[float]:
        """Pending decode tokens over the measured decode rate: the
        accountant's rolling window when it is on (it follows a changing
        load), else the engine's cumulative rate. None before any decode
        evidence (a cold engine never sheds on projection)."""
        eng = self.engine
        rate = None
        if eng._req_acc is not None:
            rate = eng._req_acc.rolling_rate()
        if rate is None and eng._decode_sec > 0:
            rate = eng._decode_tokens / eng._decode_sec
        if not rate or rate <= 0:
            return None
        sched = eng.sched
        pending = sum(r.max_new_tokens for r in sched.waiting)
        pending += sum(max(0, s.request.max_new_tokens - s.generated)
                       for s in sched.running.values())
        return pending / rate * 1e3

    def admission_gate(self, prompt: List[int],
                       max_new_tokens: int) -> Optional[str]:
        """A shed reason, or None to queue the request."""
        depth = self.cfg.resil_max_queue_depth
        if depth is not None and self.engine.sched.queue_depth >= depth:
            return (f"queue depth {self.engine.sched.queue_depth} >= "
                    f"max_queue_depth {depth}")
        wait_ms = self.cfg.resil_max_queue_wait_ms
        if wait_ms is not None:
            projected = self._projected_wait_ms()
            if projected is not None and projected > wait_ms:
                return (f"projected queue wait {projected:.0f}ms > "
                        f"max_queue_wait_ms {wait_ms:.0f}ms")
        return None

    def shed(self, prompt: List[int], max_new_tokens: int,
             eos_token_id: Optional[int], reason: str) -> int:
        """Terminal-record a request without queueing it; it still draws a
        real rid, so every submission resolves through ``results``."""
        eng = self.engine
        rid = eng.sched.reserve_rid()
        req = Request(rid, list(prompt), int(max_new_tokens), eos_token_id)
        self.counters["shed_requests"] += 1
        eng.results[rid] = eng._queue_record(req, "shed", reason=reason)
        if eng._req_acc is not None:
            eng._req_acc.on_drop(req, "shed", eng._step_count)
        logger.warning("serving: shed request %d (%s)", rid, reason)
        return rid

    # -- deadlines + cancellation (step-boundary resolution) ------------
    def request_cancel(self, rid: int) -> bool:
        eng = self.engine
        if rid in eng.results:
            return False
        known = any(r.rid == rid for r in eng.sched.waiting) or any(
            s.request.rid == rid for s in eng.sched.running.values())
        if not known:
            return False
        self._cancel_pending.add(rid)
        return True

    def process_boundary(self) -> None:
        """Resolve pending cancellations and expired deadlines at the top
        of ``step()``: the queue first (a queued drop never touches the
        pool), then running sequences (aborted with partial output)."""
        eng = self.engine
        sched = eng.sched
        # a cancel that raced a natural finish is already terminal
        self._cancel_pending -= set(eng.results)
        if not self._cancel_pending and not any(
                r.deadline is not None for r in sched.waiting) and not any(
                s.request.deadline is not None
                for s in sched.running.values()):
            return
        now = time.monotonic()
        if sched.waiting:
            keep: collections.deque = collections.deque()
            for req in sched.waiting:
                if req.rid in self._cancel_pending:
                    self._cancel_pending.discard(req.rid)
                    self._drop_queued(req, "cancelled")
                elif req.deadline is not None and now >= req.deadline:
                    self._drop_queued(req, "deadline_expired")
                else:
                    keep.append(req)
            sched.waiting = keep
        for seq in list(sched.running.values()):
            rid = seq.request.rid
            if rid in self._cancel_pending:
                self._cancel_pending.discard(rid)
                self._abort(seq, "cancelled")
            elif (seq.request.deadline is not None
                  and now >= seq.request.deadline):
                self._abort(seq, "deadline_expired")

    def _drop_queued(self, req: Request, status: str) -> None:
        eng = self.engine
        self.counters[status] += 1
        eng.results[req.rid] = eng._queue_record(req, status)
        if eng._req_acc is not None:
            eng._req_acc.on_drop(req, status, eng._step_count)

    def _abort(self, seq: Sequence, status: str) -> None:
        """Terminal-abort a running sequence: slot and KV blocks released
        exactly once, partial output kept in the record."""
        eng = self.engine
        eng.sched.abort(seq)
        self.counters[status] += 1
        eng.results[seq.request.rid] = eng._result_record(seq, status)
        if eng._req_acc is not None:
            slo = eng._req_acc.on_finish(seq, eng._step_count,
                                         status=status)
            if slo is not None:
                eng.results[seq.request.rid]["slo"] = slo

    # -- decode recovery + degradation ladder ---------------------------
    def run_decode(self, active: List[Sequence], info: Dict[str, Any]):
        """The guarded decode round: dispatch; on failure retry, then
        rebuild and replay, then one final unguarded dispatch (a fault
        that persists propagates). Returns ``(n_tokens, dt_decode,
        active)``: recovery can shrink the live set (cold requeues)."""
        eng = self.engine
        try:
            n_tokens, dt = eng._decode_round(active, info)
            return n_tokens, dt, active
        except RECOVERABLE as e:
            logger.warning("serving: decode dispatch failed (%s); "
                           "entering recovery", e)

        if self.cfg.resil_max_retries > 0:
            def _attempt():
                self.counters["retries"] += 1
                return eng._decode_round(active, info)

            try:
                n_tokens, dt = retry_call(
                    _attempt, max_retries=self.cfg.resil_max_retries - 1,
                    base=self.cfg.resil_retry_base_sec, jitter=0.0,
                    retry_on=RECOVERABLE,
                    describe="serving decode dispatch")
                self.note_anomaly()
                return n_tokens, dt, active
            except RECOVERABLE:     # exhausted: rebuild next
                logger.warning(
                    "serving: decode retries exhausted (%d); rebuilding "
                    "decode state in-process", self.cfg.resil_max_retries)

        self.counters["recoveries"] += 1
        self.note_anomaly()
        self._rebuild_and_replay()
        # the step boundary's capacity pass against the fresh block tables
        # (a replay bucket may end exactly at the next write position),
        # then one unguarded dispatch
        sched = eng.sched
        for seq in list(sched.active):
            if sched.running.get(seq.slot) is seq:
                sched.ensure_capacity(seq, lookahead=eng._spec_k)
        active = sched.active
        if not active:
            return 0, 0.0, active
        n_tokens, dt = eng._decode_round(active, info)
        return n_tokens, dt, active

    def note_step(self, dt_decode: float) -> None:
        """Slow-step anomaly: a decode dispatch past ``slow_step_ms``."""
        th = self.cfg.resil_slow_step_ms
        if th is not None and dt_decode * 1e3 > th:
            logger.warning("serving: slow decode step (%.1fms > %.1fms)",
                           dt_decode * 1e3, th)
            self.note_anomaly()

    def note_anomaly(self) -> None:
        self.anomalies += 1
        while (self.degraded_level < 3
               and self.anomalies >= self.cfg.resil_degrade_after
               * (self.degraded_level + 1)):
            self._escalate()

    def _escalate(self) -> None:
        """One ladder rung: trade a throughput feature for stability.
        Rungs never un-climb."""
        eng = self.engine
        self.degraded_level += 1
        if self.degraded_level == 2 and eng.device.type == "cuda":
            logger.warning("serving: degradation rung 2 (decode attention "
                           "kernel -> gather) skipped on a CUDA engine")
            self.degraded_level = 3
        lvl = self.degraded_level
        if lvl == 1:
            eng._spec_k = 0
            if eng._req_acc is not None:
                eng._req_acc.spec_k = 0
            action = "speculative decoding off"
        elif lvl == 2:
            eng._attn_impl = "gather"
            # the decode sites run new signatures from here (the JAX
            # engine drops its decode programs)
            eng._signatures["decode"].clear()
            eng._signatures["spec"].clear()
            action = "decode attention kernel -> gather"
        else:
            eng.sched.slot_cap = max(1, eng.scfg.max_batch_size // 2)
            action = f"admission batch cap -> {eng.sched.slot_cap} slots"
        logger.warning("serving: degradation ladder -> level %d (%s) "
                       "after %d anomalies", lvl, action, self.anomalies)

    # -- rebuild + replay -----------------------------------------------
    def _rebuild_and_replay(self) -> None:
        """Rebuild the KV substrate and replay live sequences. Every block
        reference is dropped and a fresh BlockPool, pools and prefix cache
        replace them; sequences replay oldest first, so the fresh prefix
        cache warms later replays of a shared head."""
        eng = self.engine
        sched = eng.sched
        live = sorted(sched.running.values(),
                      key=lambda s: (s.admitted_step, s.request.rid))
        for seq in live:
            seq.block_table = []
        pool = BlockPool(eng.scfg.kv_num_blocks)
        eng.pool = pool
        sched.pool = pool
        if eng.prefix_cache is not None:
            eng.prefix_cache = PrefixCache(pool, eng.block_size)
            sched.prefix_cache = eng.prefix_cache
        eng._pools = init_paged_pools(
            eng.model_cfg, eng.scfg.kv_num_blocks, eng.block_size,
            int8=eng.scfg.int8_kv_cache, dtype=eng._dtype, device=eng.device)
        replayed = requeued = 0
        for seq in live:
            if self._replay(seq):
                replayed += 1
            else:
                # cold requeue through the preemption path: restart from
                # the prompt (greedy regenerates the same tokens)
                sched.preempt(seq)
                requeued += 1
        logger.warning(
            "serving: rebuilt KV pools in-process (%d sequences replayed, "
            "%d requeued cold)", replayed, requeued)

    def _replay(self, seq: Sequence) -> bool:
        """Rebuild ``seq``'s KV ``[0, pos)`` in the fresh pools by
        prefilling its recorded ``tokens[:-1]`` (the last sampled token's
        KV was never written), warm through the fresh prefix cache where
        the head matches an earlier replay. False: the caller requeues
        it cold."""
        eng = self.engine
        sched = eng.sched
        replay = seq.tokens[:-1]
        if not replay or len(replay) > eng.bucket_cap:
            return False
        if eng._chunked and seq.prefilled < len(seq.request.prompt):
            # mid-prefill: nothing sampled yet, so tokens[:-1] cannot
            # express it; a cold requeue restarts the prompt
            return False
        bucket = eng._bucket_of(len(replay))
        shared: List[int] = []
        if sched.prefix_cache is not None:
            shared = sched.prefix_cache.match(replay, eng._step_count)
        n_shared = len(shared)
        blocks = eng.pool.alloc(bucket // eng.block_size - n_shared)
        if blocks is None:
            if shared:
                eng.pool.release(shared)
            return False
        if sched.prefix_cache is not None:
            sched.prefix_cache.commit_hit(n_shared)
        seq.bucket = bucket
        seq.block_table = shared + blocks
        seq.shared_len = n_shared * eng.block_size
        eng._replay_prefill(seq, replay)
        if sched.prefix_cache is not None:
            sched.prefix_cache.insert(replay, seq.block_table,
                                      eng._step_count)
        return True

"""Request observatory: per-request SLO accounting for the serve engine.

The port of ``deepspeed_tpu/telemetry/requests.py`` (host Python, copied
whole). The :class:`RequestAccountant` partitions every serving request's
lifetime, arrival to finish, into

    queue_wait / prefill / decode_active / preempted_requeue /
    spec_overhead / finish_other

with monotonic marks the ServeEngine and the Scheduler place at
submission, admission, prefill completion, every decode step the row is
active in, preemption and finish. Each mark attributes ``now - cursor``
and advances the cursor, so the categories sum to the measured lifetime by
construction.

Beside the per-request ledger it keeps the **engine's serving-time
partition** (prefill / decode / scheduler_admission / host_idle /
compile) over the engine's own wall clock. The JAX engine files a
dispatch under ``compile`` when a jit cache grew; the port files it there
when the dispatch ran at a call signature the engine had not run before
(a new prompt bucket or decode window), which is the same steps on the
same trace.

Everything here is host-side ``time.monotonic`` arithmetic: no device
sync and no host fetch. ``build_requests`` returns None unless
``telemetry.requests.enabled``; every engine hook gates on ``is None``,
and with the accountant off the engine's emitted tag set is unchanged.

Outputs: registry metrics under ``requests/`` (:data:`REQUEST_METRIC_TAGS`),
one JSONL record per terminal request in ``requests.jsonl``
(host-scoped across processes; ``tools/slo_report.py`` reads them), and
async request tracks in the step tracer's trace.
"""

import json
import os
import time
from collections import deque
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

# The exact partition of one request's lifetime. ``finish_other`` absorbs
# host-side residue (dispatch bookkeeping, the slice of a step a row spent
# waiting on batch-mates, the final finish mark) so the sum is always the
# measured lifetime — nothing is dropped on the floor.
REQUEST_CATEGORIES = (
    "queue_wait",          # submitted, waiting for a slot + blocks
    "prefill",             # admission -> first token (cold or warm tail)
    "decode_active",       # decode steps producing accepted tokens
    "preempted_requeue",   # evicted for KV pressure, waiting to re-admit
    "spec_overhead",       # speculative decode time on rejected drafts
    "finish_other",        # host residue: dispatch, batch skew, finish
)

# The engine-side serving-time partition (one cursor over the engine's own
# wall clock, marked inside ``ServeEngine.step``).
ENGINE_CATEGORIES = (
    "prefill",             # prefill dispatch + first-token fetch
    "decode",              # decode/spec dispatch + token fetch
    "scheduler_admission", # host scheduling: admit, growth, preemption
    "host_idle",           # between steps (caller think time, idle loop)
    "compile",             # dispatches at a signature new to the engine
)

# Every metric tag this module can emit.
REQUEST_METRIC_TAGS = frozenset(
    {f"requests/{c}_sec" for c in REQUEST_CATEGORIES}
    | {f"requests/engine_{c}_sec" for c in ENGINE_CATEGORIES}
    | {
        "requests/engine_wall_sec",
        "requests/tpot_ms",
        "requests/e2e_ms",
        "requests/queue_wait_ms",
        "requests/prefix_tokens_saved",
        "requests/preemptions",
    })

RECORD_FORMAT = 1


class _ReqState:
    """Per-request mark cursor + partition ledger."""

    __slots__ = ("rid", "last", "totals", "phase", "requeued", "span",
                 "last_token", "last_generated", "tpot_sum_ms", "tpot_n",
                 "prefix_tokens")

    def __init__(self, rid: int, arrival: float):
        self.rid = rid
        self.last = arrival            # the mark cursor (monotonic)
        self.totals = {c: 0.0 for c in REQUEST_CATEGORIES}
        self.phase = "queue"
        self.requeued = False
        self.span: Optional[str] = None   # open async-track span name
        self.last_token: Optional[float] = None
        self.last_generated = 0
        self.tpot_sum_ms = 0.0
        self.tpot_n = 0
        self.prefix_tokens = 0


class RequestAccountant:
    """Mark-based per-request SLO ledger + engine serving-time partition.

    The engine owns exactly one accountant (or ``None``); the scheduler
    holds a back-reference so admission/preemption mark without the
    engine relaying. All hooks are pure host float arithmetic on
    ``time.monotonic`` — no device work, ever.
    """

    def __init__(self, registry=None, tracer=None,
                 run_dir: Optional[str] = None,
                 file: str = "requests.jsonl",
                 window_sec: float = 10.0,
                 host: Optional[str] = None):
        from deepspeed_tpu_torch.telemetry.fleet import (
            default_host, host_scoped_path, telemetry_host_component)
        self.registry = registry
        self.tracer = tracer if (tracer is not None
                                 and getattr(tracer, "enabled", False)) \
            else None
        self.window_sec = float(window_sec)
        self.host = host if host is not None else default_host()
        # monotonic -> wall-clock anchor, persisted per record so
        # slo_report can order records across hosts.
        self._wall_offset = time.time() - time.monotonic()
        self.spec_k = 0                # engine sets when spec decode is on
        self._states: Dict[int, _ReqState] = {}
        # Cumulative category seconds over FINISHED requests (the
        # ``requests/<cat>_sec`` gauges).
        self._cat_totals = {c: 0.0 for c in REQUEST_CATEGORIES}
        now = time.monotonic()
        self._eng_totals = {c: 0.0 for c in ENGINE_CATEGORIES}
        self._eng_start = now
        self._eng_last = now
        # Rolling decode-throughput window: (t, tokens, decode_sec).
        self._window: deque = deque()
        self.completed = 0
        self.path: Optional[str] = None
        self._fh = None
        self._write_failed = False
        if run_dir:
            part = telemetry_host_component()
            self.path = os.path.join(run_dir,
                                     host_scoped_path(file, part))

    # -- request lifecycle marks ---------------------------------------
    def _mark(self, st: _ReqState, cat: str, now: float) -> None:
        st.totals[cat] += now - st.last
        st.last = now

    def _trace_to(self, st: _ReqState, name: Optional[str]) -> None:
        tr = self.tracer
        if tr is None:
            return
        if st.span is not None:
            tr.async_end(st.span, st.rid)
        if name is not None:
            tr.async_begin(name, st.rid, rid=st.rid)
        st.span = name

    def on_submit(self, request) -> None:
        """The request entered the waiting queue (cursor = its arrival)."""
        st = _ReqState(request.rid, request.arrival)
        self._states[request.rid] = st
        self._trace_to(st, "req/queue")

    def on_admit(self, seq) -> None:
        """Scheduler granted a slot + blocks; prefill is next. Time since
        the cursor is queue wait — or requeue wait after a preemption."""
        st = self._states.get(seq.request.rid)
        if st is None:
            return
        now = time.monotonic()
        self._mark(st, "preempted_requeue" if st.requeued else "queue_wait",
                   now)
        st.requeued = False
        # The winning admission's adopted head (a warm restart may adopt
        # more than the cold first admission did).
        st.prefix_tokens = seq.shared_len
        st.phase = "prefill"
        self._trace_to(st, "req/prefill")

    def on_prefilled(self, seq) -> None:
        """Prefill (cold or warm-tail) produced the first token."""
        st = self._states.get(seq.request.rid)
        if st is None:
            return
        now = time.monotonic()
        self._mark(st, "prefill", now)
        # TPOT baseline: inter-token intervals start at the first token.
        st.last_token = now
        st.last_generated = seq.generated
        st.phase = "decode"
        self._trace_to(st, "req/decode")

    def _useful_frac(self, appended: int) -> float:
        """Fraction of a decode slice that produced accepted tokens: a
        speculative round runs k+1 positions per row regardless of how
        many survive the accept rule; non-speculative decode is all
        useful."""
        if not self.spec_k:
            return 1.0
        return min(1.0, appended / float(self.spec_k + 1))

    def _observe_tpot(self, st: _ReqState, seq, now: float,
                      step: int) -> int:
        """Attribute inter-token intervals for tokens appended since the
        last mark; returns how many were appended."""
        appended = seq.generated - st.last_generated
        if appended > 0 and st.last_token is not None:
            interval_ms = (now - st.last_token) / appended * 1e3
            st.tpot_sum_ms += interval_ms * appended
            st.tpot_n += appended
            if self.registry is not None:
                hist = self.registry.histogram("requests/tpot_ms")
                for _ in range(appended):
                    hist.observe(interval_ms, step=step)
        if appended > 0:
            st.last_token = now
        st.last_generated = seq.generated
        return appended

    def on_decode_step(self, seqs, dt_decode: float, step: int) -> None:
        """One decode (or speculative) step advanced ``seqs`` (the rows
        still running after the step — finished rows went through
        :meth:`on_finish` already). Per row: the slice since its cursor
        splits into host residue (anything beyond the measured decode
        dispatch) and decode time, the latter apportioned between
        ``decode_active`` and ``spec_overhead`` by the row's accepted
        fraction."""
        now = time.monotonic()
        for seq in seqs:
            st = self._states.get(seq.request.rid)
            if st is None:
                continue
            appended = self._observe_tpot(st, seq, now, step)
            elapsed = now - st.last
            other = max(0.0, elapsed - dt_decode)
            dec = elapsed - other
            frac = self._useful_frac(appended)
            st.totals["decode_active"] += dec * frac
            st.totals["spec_overhead"] += dec * (1.0 - frac)
            st.totals["finish_other"] += other
            st.last = now

    def on_preempt(self, seq) -> None:
        """Evicted for KV pressure: the slice since the cursor is host
        residue; the wait until re-admission becomes
        ``preempted_requeue`` (marked at the next :meth:`on_admit`)."""
        st = self._states.get(seq.request.rid)
        if st is None:
            return
        now = time.monotonic()
        self._mark(st, "finish_other", now)
        st.requeued = True
        st.last_token = None           # restart resets the TPOT baseline
        st.phase = "queue"
        self._trace_to(st, "req/preempted")

    def on_finish(self, seq, step: int,
                  status: str = "finished") -> Optional[Dict[str, Any]]:
        """Close the ledger: final TPOT slice, tail mark, aggregate into
        the cumulative gauges/counters, persist the JSONL record.
        Returns the SLO dict the engine nests into ``results[rid]``.
        ``status`` is the terminal status (``finished`` or a resilience
        terminal: ``deadline_expired`` / ``cancelled`` / ``aborted``) —
        an admitted request reaches this hook whichever way it ends."""
        st = self._states.pop(seq.request.rid, None)
        if st is None:
            return None
        req = seq.request
        now = time.monotonic()
        appended = self._observe_tpot(st, seq, now, step)
        elapsed = now - st.last
        if st.phase == "decode" and appended > 0:
            # Finished mid-decode: the tail slice is that step's decode
            # work for this row (bounded by one step).
            frac = self._useful_frac(appended)
            st.totals["decode_active"] += elapsed * frac
            st.totals["spec_overhead"] += elapsed * (1.0 - frac)
        else:
            st.totals["finish_other"] += elapsed
        st.last = now
        lifetime = now - req.arrival
        self._trace_to(st, None)

        for c in REQUEST_CATEGORIES:
            self._cat_totals[c] += st.totals[c]
        self.completed += 1
        reg = self.registry
        if reg is not None:
            reg.histogram("requests/e2e_ms").observe(lifetime * 1e3,
                                                     step=step)
            reg.histogram("requests/queue_wait_ms").observe(
                st.totals["queue_wait"] * 1e3, step=step)
            if req.preempted_count:
                reg.counter("requests/preemptions").inc(
                    req.preempted_count, step=step)
            if st.prefix_tokens:
                reg.counter("requests/prefix_tokens_saved").inc(
                    st.prefix_tokens, step=step)

        slo = {
            "lifetime_sec": lifetime,
            "tpot_mean_ms": (st.tpot_sum_ms / st.tpot_n
                             if st.tpot_n else None),
            "tpot_obs": st.tpot_n,
            "prefix_tokens_saved": st.prefix_tokens,
            "categories": {c: st.totals[c] for c in REQUEST_CATEGORIES},
        }
        rec = {
            "format": RECORD_FORMAT,
            "rid": req.rid,
            "host": self.host,
            "status": status,
            "admitted": True,
            "prompt_len": len(req.prompt),
            "new_tokens": seq.generated,
            "finish_step": step,
            "arrival_unix": req.arrival + self._wall_offset,
            "e2e_ms": lifetime * 1e3,
            "ttft_ms": ((req.first_token_time - req.arrival) * 1e3
                        if req.first_token_time is not None else None),
            "queue_wait_ms": st.totals["queue_wait"] * 1e3,
            "preempted_count": req.preempted_count,
            **slo,
        }
        self._write(rec)
        return slo

    def on_drop(self, request, status: str, step: int) -> None:
        """A request left the system WITHOUT ever being admitted — shed
        at submit time, cancelled/expired in the queue, or torn down with
        the engine. It still gets a terminal JSONL record (every
        submitted rid reaches one), but contributes NO registry metrics:
        the ``requests/`` tag set must stay byte-identical whether or not
        resilience is on, and never-admitted requests have no latency to
        partition. Shed requests never pass :meth:`on_submit`, so a
        missing state is expected."""
        st = self._states.pop(request.rid, None)
        now = time.monotonic()
        if st is not None:
            self._mark(st, "preempted_requeue" if st.requeued
                       else "queue_wait", now)
            self._trace_to(st, None)
        queue_wait = (st.totals["queue_wait"] if st is not None
                      else 0.0)
        rec = {
            "format": RECORD_FORMAT,
            "rid": request.rid,
            "host": self.host,
            "status": status,
            "admitted": False,
            "prompt_len": len(request.prompt),
            "new_tokens": 0,
            "finish_step": step,
            "arrival_unix": request.arrival + self._wall_offset,
            "e2e_ms": (now - request.arrival) * 1e3,
            "ttft_ms": None,
            "queue_wait_ms": queue_wait * 1e3,
            "preempted_count": request.preempted_count,
        }
        self._write(rec)

    # -- engine serving-time partition ---------------------------------
    def engine_mark(self, cat: str) -> None:
        """Attribute the engine wall clock since the last mark to one
        ``ENGINE_CATEGORIES`` bucket and advance the engine cursor."""
        now = time.monotonic()
        self._eng_totals[cat] += now - self._eng_last
        self._eng_last = now

    # -- rolling decode throughput -------------------------------------
    def rolling_add(self, n_tokens: int, dt_decode: float) -> None:
        now = time.monotonic()
        self._window.append((now, int(n_tokens), float(dt_decode)))
        cutoff = now - self.window_sec
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()

    def rolling_rate(self) -> Optional[float]:
        """Token-weighted decode tokens/s over the window (None before
        any decode work lands in it)."""
        cutoff = time.monotonic() - self.window_sec
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()
        tok = sum(n for _, n, _ in self._window)
        sec = sum(s for _, _, s in self._window)
        return tok / sec if sec > 0 else None

    # -- emission / persistence ----------------------------------------
    def emit(self, step: int) -> None:
        """Per-step gauges: cumulative per-category seconds over finished
        requests plus the engine partition. Host floats only."""
        reg = self.registry
        if reg is None:
            return
        for c in REQUEST_CATEGORIES:
            reg.gauge(f"requests/{c}_sec").set(self._cat_totals[c],
                                               step=step)
        for c in ENGINE_CATEGORIES:
            reg.gauge(f"requests/engine_{c}_sec").set(
                self._eng_totals[c], step=step)
        reg.gauge("requests/engine_wall_sec").set(
            time.monotonic() - self._eng_start, step=step)

    def _write(self, rec: Dict[str, Any]) -> None:
        if self.path is None or self._write_failed:
            return
        try:
            if self._fh is None:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        except OSError as e:  # noqa: BLE001 — records must never take
            # down the serving loop they observe
            self._write_failed = True
            logger.warning("request records disabled (%s): %s",
                           self.path, e)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def build_requests(tcfg, telemetry=None) -> Optional[RequestAccountant]:
    """Factory honoring the zero-overhead off-contract: returns ``None``
    unless telemetry AND ``telemetry.requests`` are enabled, so every
    engine hook stays a single ``is None`` check."""
    if tcfg is None or not getattr(tcfg, "enabled", False):
        return None
    rcfg = getattr(tcfg, "requests", None)
    if rcfg is None or not rcfg.enabled:
        return None
    return RequestAccountant(
        registry=telemetry.registry if telemetry is not None else None,
        tracer=telemetry.tracer if telemetry is not None else None,
        run_dir=tcfg.dir,
        file=rcfg.file,
        window_sec=rcfg.window_sec)

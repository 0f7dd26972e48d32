"""Port parity: serving telemetry through ``init_serving`` in both
packages, fp32 on the CPU, tiny GPT (2 layers; the second layer's output
projections scaled by 0.2 so the one-layer speculative draft is accepted
often, as in tests/test_torch_spec.py).

One trace goes through the JAX package's and the port's ``init_serving``
with a ``telemetry`` block on (JSONL and memory sinks, the trace, the
request accountant) in six configurations: plain (with preemption),
chunked prefill, the prefix cache, the int8 pool with ``numerics``,
speculative decoding at k = 4, and resilience under a ``FaultPlan``. Each
asserts the same tokens, the same tag set and emission count per name,
the same counter totals, the same request records (times aside), the same
span names and counts, the same steps filed under "compile", KV error
gauges within 1e-6, and that ``tools/slo_report.py`` and
``tools/serving_report.py`` report the same rows on both directories.
The JAX engine runs ``decode_attention: "kernel"`` through the Pallas
interpreter; the port's wrappers take their plain versions on CPU
tensors.

Then the port alone: zero calls of the sync primitive with telemetry off
and with only the accountant on, two a span with ``sync_spans``; the
reference's off-contract, resilience-rows and terminal-completeness
cases; and the admission gate's projected wait from the accountant's
rolling rate, with the cumulative rate as its fallback.
"""

import collections
import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import TRACE, _prompts, _run
from test_torch_serving_chunked import PREFIX_TRACE, _prefix_prompts

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu_torch.models import (gpt_params_from_flax,
                                        init_flax_gpt_params, make_gpt)
from deepspeed_tpu.serving.engine import \
    SERVING_METRIC_TAGS as JAX_SERVING_METRIC_TAGS
from deepspeed_tpu_torch.serving import TERMINAL_STATUSES
from deepspeed_tpu_torch.serving.engine import SERVING_METRIC_TAGS
from deepspeed_tpu_torch.telemetry import InMemorySink, REQUEST_METRIC_TAGS
from deepspeed_tpu_torch.utils import timer as port_timer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAFT_SCALE = 0.2
SERVE = {"max_batch_size": 2, "kv_block_size": 4, "kv_num_blocks": 64,
         "max_model_len": 48, "decode_attention": "kernel"}
# a window longer than any run: every step after the first decode has a
# rolling rate in both packages
TELEMETRY = {"enabled": True, "metrics": {"sinks": ["jsonl", "memory"]},
             "trace": {"enabled": True},
             "requests": {"enabled": True, "window_sec": 1000.0}}
FAULT = {"serve_decode_fault_at_step": 3, "serve_decode_fault_count": 3}
# two long requests in 11 usable blocks: the youngest is evicted and
# restarted (tests/test_torch_serving.py's preemption trace)
PREEMPT_TRACE = [(10, 24), (9, 24), (4, 6)]
CASES = {
    "plain": ({"kv_num_blocks": 12}, {}, {}),
    "chunked": ({"chunked_prefill": {"token_budget": 16}}, {}, {}),
    "prefix": ({"prefix_cache": True}, {}, {}),
    "int8": ({"int8_kv_cache": True}, {"numerics": {"enabled": True}}, {}),
    "spec": ({"speculative": {"enabled": True, "k": 4}}, {}, {}),
    "resilience": ({"resilience": {"max_retries": 2,
                                   "retry_base_sec": 0.01}}, {},
                   {"resilience": {"fault_injection": FAULT}}),
}
# request-record fields that are not times
RECORD_KEYS = ("format", "rid", "status", "admitted", "prompt_len",
               "new_tokens", "finish_step", "preempted_count", "tpot_obs",
               "prefix_tokens_saved")
BASELINE_SIMPLE_TAGS = {
    "serving/ttft_ms", "serving/batch_occupancy",
    "serving/kv_blocks_in_use", "serving/queue_depth",
    "serving/tokens_per_sec", "serving/requests_completed",
}
KV_TAGS = {"numerics/kv_quant_rel_err", "numerics/kv_quant_max_abs_err"}
RESIL_TAGS = {
    "serving/shed_requests", "serving/deadline_expired",
    "serving/cancelled", "serving/recoveries", "serving/retries",
    "serving/degraded_level",
}


@pytest.fixture(scope="module")
def tiny():
    jm, cfg = jax_make_gpt("tiny", dropout_rate=0.0, max_seq_len=64,
                           dtype=jnp.float32)
    tree = init_flax_gpt_params(make_gpt("tiny", max_seq_len=64)[1], seed=0)
    for site in ("c_proj", "mlp_proj"):
        for leaf in ("kernel", "bias"):
            tree["h_1"][site][leaf] = tree["h_1"][site][leaf] * DRAFT_SCALE
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jm, cfg, params, gpt_params_from_flax(tree)


def _port_serve(sd, config, **kw):
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    return deepspeed_tpu_torch.init_serving(
        model, config=config, params=sd, dtype=torch.float32, device="cpu",
        **kw)


def _config(case, run_dir):
    serving, telemetry, top = CASES[case]
    return {"serving": {**SERVE, **serving},
            "telemetry": {**TELEMETRY, **telemetry, "dir": str(run_dir)},
            **top}


def _memory_sink(srv):
    """The in-memory sink of either package's registry."""
    return next(s for s in srv.telemetry.registry.sinks
                if type(s).__name__ == InMemorySink.__name__)


def _record_compiles(srv):
    """The steps whose dispatch the engine partition files under
    "compile"."""
    steps = []
    acc = srv._req_acc
    mark = acc.engine_mark

    def recording(cat):
        if cat == "compile":
            steps.append(srv._step_count)
        mark(cat)

    acc.engine_mark = recording
    return steps


def _trace(case, vocab):
    if case == "prefix":
        return _prefix_prompts(vocab), PREFIX_TRACE
    trace = PREEMPT_TRACE if case == "plain" else TRACE
    return _prompts(trace, vocab), trace


def _drive(srv, case, vocab):
    compiles = _record_compiles(srv)
    prompts, trace = _trace(case, vocab)
    tokens = _run(srv, prompts, trace)
    sink = _memory_sink(srv)
    srv.close()
    return tokens, sink.rows, compiles


def _tag_keys(rows):
    return {(r["tag"], frozenset(set(r) - {"kind", "tag", "value", "step"}))
            for r in rows}


def _counter_totals(rows):
    return {r["tag"]: r["value"] for r in rows if r["kind"] == "counter"}


def _records(run_dir):
    with open(os.path.join(run_dir, "requests.jsonl")) as f:
        return sorted((json.loads(line) for line in f if line.strip()),
                      key=lambda r: r["rid"])


def _trace_counts(run_dir):
    with open(os.path.join(run_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter((e["ph"], e["name"]) for e in events
                               if e["ph"] != "M")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report(tool, run_dir, *flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool.main([str(run_dir), *flags]) == 0
    return out.getvalue()


def _shape(x):
    """A report's structure: keys, list lengths, which values are None."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return len(x)
    return None if x is None else type(x).__name__


def _words(text):
    """The rows of a rendered report without their numbers."""
    return [[w for w in line.split() if not any(c.isdigit() for c in w)]
            for line in text.splitlines()]


# counts in the reports, equal between the packages (everything else is a
# time or a rate)
SLO_COUNTS = ("n_requests", "n_admitted", "status_counts", "preemptions",
              "prefix_tokens_saved", "requests_preempted",
              "requests_with_prefix_hit", "shed_frac")
SERVING_COUNTS = ("n_rows", "kv_blocks_in_use_peak", "preempted_seqs",
                  "prefix_hits", "prefix_blocks_reused", "requests_completed",
                  "requests_with_ttft", "decode_attn_kernel_frac",
                  "spec_accept_rate", "spec_tokens_per_verify",
                  "queue_depth", "batch_occupancy")


@pytest.mark.parametrize("case", list(CASES))
def test_serving_telemetry_matches_jax(tiny, case, tmp_path, monkeypatch):
    jm, cfg, params, sd = tiny
    monkeypatch.delenv("DSTPU_FAULT_PLAN", raising=False)
    monkeypatch.delenv("DSTPU_TELEMETRY_HOST", raising=False)
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    srv = _port_serve(sd, _config(case, pdir))
    jsrv = deepspeed_tpu.init_serving(jm, config=_config(case, jdir),
                                      params=params, dtype=jnp.float32)
    got, rows, compiles = _drive(srv, case, cfg.vocab_size)
    want, jrows, jcompiles = _drive(jsrv, case, cfg.vocab_size)

    assert got == want
    assert _tag_keys(rows) == _tag_keys(jrows)
    assert {r["tag"] for r in rows} <= (
        SERVING_METRIC_TAGS | REQUEST_METRIC_TAGS | KV_TAGS)
    assert collections.Counter(r["tag"] for r in rows) == \
        collections.Counter(r["tag"] for r in jrows)
    assert _counter_totals(rows) == _counter_totals(jrows)
    assert compiles == jcompiles and compiles

    records, jrecords = _records(pdir), _records(jdir)
    assert [[r.get(k) for k in RECORD_KEYS] for r in records] == \
        [[r.get(k) for k in RECORD_KEYS] for r in jrecords]
    assert len(records) == len(_trace(case, cfg.vocab_size)[1])
    for rec in records:
        assert rec["status"] == "finished"
        assert set(rec["categories"]) == set(jrecords[0]["categories"])
        assert sum(rec["categories"].values()) == pytest.approx(
            rec["lifetime_sec"], abs=1e-6)
    assert _trace_counts(pdir) == _trace_counts(jdir)

    kv = [(r["tag"], r["bucket"], r["value"]) for r in rows
          if r["tag"].startswith("numerics/")]
    jkv = [(r["tag"], r["bucket"], r["value"]) for r in jrows
           if r["tag"].startswith("numerics/")]
    assert [k[:2] for k in kv] == [k[:2] for k in jkv]
    np.testing.assert_allclose([k[2] for k in kv], [k[2] for k in jkv],
                               rtol=0, atol=1e-6)
    assert bool(kv) == (case == "int8")

    for name, counts in (("slo_report", SLO_COUNTS),
                         ("serving_report", SERVING_COUNTS)):
        tool = _tool(name)
        rep = json.loads(_report(tool, pdir, "--json"))
        jrep = json.loads(_report(tool, jdir, "--json"))
        assert _shape(rep) == _shape(jrep)
        assert {k: rep[k] for k in counts} == {k: jrep[k] for k in counts}
        assert _words(_report(tool, pdir)) == _words(_report(tool, jdir))

    if case == "plain":
        assert srv.sched.preempted_total >= 1
    if case == "resilience":
        assert srv._resil.counters["recoveries"] >= 1


# ---------------------------------------------------------------------------
# The port alone: syncs, the off-contract, terminal records, the gate
# ---------------------------------------------------------------------------

def _count_syncs(monkeypatch):
    calls = []
    monkeypatch.setattr(port_timer, "_device_synchronize", calls.append)
    return calls


@pytest.mark.parametrize("telemetry,syncs", [
    (None, "none"),
    ({"enabled": True, "metrics": {"sinks": ["memory"]},
      "trace": {"enabled": False}, "requests": {"enabled": True}}, "none"),
    ({"enabled": True, "metrics": {"sinks": ["memory"]},
      "trace": {"enabled": True, "sync_spans": False}}, "none"),
    ({"enabled": True, "metrics": {"sinks": ["memory"]},
      "trace": {"enabled": True, "sync_spans": True}}, "two per span"),
], ids=["off", "accountant-only", "trace-unsynced", "sync-spans"])
def test_sync_primitive_calls(tiny, telemetry, syncs, tmp_path,
                              monkeypatch):
    """Telemetry off, or on with only the accountant (no trace), or a trace
    without ``sync_spans``: the serving loop never calls the sync
    primitive. With ``sync_spans`` every span calls it on entry and exit,
    with the engine's device."""
    _jm, cfg, _params, sd = tiny
    config = {"serving": SERVE}
    if telemetry is not None:
        config["telemetry"] = {**telemetry, "dir": str(tmp_path)}
    srv = _port_serve(sd, config)
    calls = _count_syncs(monkeypatch)
    _run(srv, _prompts(TRACE, cfg.vocab_size), TRACE)
    spans = [e for e in srv.telemetry.tracer.events if e["ph"] == "X"]
    srv.close()
    if syncs == "none":
        assert calls == []
    else:
        assert len(spans) > 0 and len(calls) == 2 * len(spans)
        assert set(calls) == {srv.device}


def test_off_contract_tag_set(tiny, tmp_path, monkeypatch):
    """Telemetry on (memory sink, no trace) with resilience, the accountant
    and every serving feature off: exactly the reference's baseline tag
    set and no sync; with resilience on, its rows appear."""
    _jm, cfg, _params, sd = tiny
    tel = {"enabled": True, "dir": str(tmp_path),
           "metrics": {"sinks": ["memory"]}, "trace": {"enabled": False}}
    srv = _port_serve(sd, {"serving": {**SERVE, "decode_attention":
                                       "gather"}, "telemetry": tel})
    calls = _count_syncs(monkeypatch)
    rng = np.random.default_rng(17)
    for i in range(3):
        srv.submit(rng.integers(0, cfg.vocab_size, (4 + i,)).tolist(), 6)
    srv.run_until_complete(timeout_sec=120.0)
    assert calls == []
    assert _memory_sink(srv).tags() == BASELINE_SIMPLE_TAGS
    # the gather path's one decode signature, never a retrace
    det = srv.engine.recompile_detector
    assert det.compiles("serving.decode_step") == 1
    assert det.retraces() == 0

    srv = _port_serve(sd, {"serving": {**SERVE, "resilience": {
        "max_queue_depth": 1}}, "telemetry": tel})
    for _ in range(5):
        srv.submit(rng.integers(0, cfg.vocab_size, (5,)).tolist(), 6)
    srv.run_until_complete(timeout_sec=120.0)
    tags = _memory_sink(srv).tags()
    assert {"serving/degraded_level", "serving/shed_requests"} <= tags
    assert BASELINE_SIMPLE_TAGS <= tags
    assert tags & RESIL_TAGS == {"serving/degraded_level",
                                 "serving/shed_requests"}


def test_every_rid_terminal_in_results_and_records(tiny, tmp_path):
    """Finished, shed, cancelled in the queue and torn down with the
    engine: every rid lands in ``results`` and in ``requests.jsonl`` with
    its terminal status; never-admitted records carry no tokens or TTFT,
    and an admitted one's categories sum to its lifetime."""
    _jm, cfg, _params, sd = tiny
    srv = _port_serve(sd, {
        "serving": {**SERVE, "resilience": {"max_queue_depth": 3}},
        "telemetry": {"enabled": True, "dir": str(tmp_path),
                      "requests": {"enabled": True}}})
    rng = np.random.default_rng(23)
    r_fin = srv.submit(rng.integers(0, cfg.vocab_size, (5,)).tolist(), 6)
    srv.run_until_complete(timeout_sec=120.0)
    burst = [srv.submit(rng.integers(0, cfg.vocab_size, (5,)).tolist(), 20)
             for _ in range(6)]
    rids = [r_fin] + burst
    shed = [r for r in burst if r in srv.results]
    live = [r for r in burst if r not in srv.results]
    assert shed and len(live) == 3
    assert srv.cancel(live[-1])             # still queued (2 slots)
    srv.step()
    srv.step()
    srv.close()                             # tears down what is in flight
    assert set(srv.results) == set(rids)
    statuses = {r: srv.results[r]["status"] for r in rids}
    assert set(statuses.values()) <= set(TERMINAL_STATUSES)
    assert statuses[r_fin] == "finished"
    assert statuses[live[-1]] == "cancelled"
    assert all(statuses[r] == "shed" for r in shed)
    assert "aborted" in statuses.values()
    records = _records(tmp_path)
    assert [r["rid"] for r in records] == sorted(rids)
    for rec in records:
        assert rec["status"] == statuses[rec["rid"]]
        if rec["admitted"]:
            assert sum(rec["categories"].values()) == pytest.approx(
                rec["lifetime_sec"], abs=1e-6)
        else:
            assert rec["new_tokens"] == 0 and rec["ttft_ms"] is None
    assert sum(r["status"] == "shed" for r in records) == len(shed)
    assert "slo" in srv.results[r_fin]


@pytest.mark.parametrize("rate,shed", [
    (None, True), (1e-3, True), (1e12, False)],
    ids=["cumulative-fallback", "slow-window", "fast-window"])
def test_projected_wait_reads_the_rolling_rate(tiny, rate, shed, tmp_path,
                                               monkeypatch):
    """With the accountant on, the gate projects the queue wait from its
    rolling-window rate: a window that says the engine is fast admits what
    the cumulative rate would shed, a slow one sheds; an empty window
    (None) falls back to the cumulative rate. The JAX engine gives the
    same verdicts on the same trace."""
    jm, cfg, params, sd = tiny
    p = _prompts([(5, 0), (6, 0), (7, 0)], cfg.vocab_size)
    serving = {**SERVE, "resilience": {"max_queue_wait_ms": 0.01}}
    verdicts = []
    for serve in (
            lambda c: _port_serve(sd, c),
            lambda c: deepspeed_tpu.init_serving(
                jm, config=c, params=params, dtype=jnp.float32)):
        srv = serve({"serving": serving, "telemetry": {
            "enabled": True, "dir": str(tmp_path),
            "metrics": {"sinks": ["memory"]}, "trace": {"enabled": False},
            "requests": {"enabled": True}}})
        r0 = srv.submit(p[0], 8)            # cold: no rate evidence
        srv.run_until_complete(timeout_sec=120.0)
        assert srv.results[r0]["status"] == "finished"
        assert srv._req_acc.rolling_rate() > 0
        monkeypatch.setattr(srv._req_acc, "rolling_rate", lambda: rate)
        r1 = srv.submit(p[1], 30)
        r2 = srv.submit(p[2], 30)
        verdicts.append([r1 in srv.results, r2 in srv.results])
        srv.run_until_complete(timeout_sec=120.0)
        assert srv.results[r1]["status"] == "finished"
        srv.close()
    assert verdicts[0] == verdicts[1] == [False, shed]


def test_serving_tag_set_is_the_reference():
    """The engine's declared tags are the reference's."""
    assert SERVING_METRIC_TAGS == JAX_SERVING_METRIC_TAGS

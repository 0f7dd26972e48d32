"""Port parity: the telemetry core (deepspeed_tpu_torch/telemetry/) against
the JAX package's on the same call sequences, on the CPU.

- the metrics registry: the same rows (kind, name, value, step, tags) in
  the memory and JSONL sinks, and the same histogram percentiles;
- the step tracer: the same trace events apart from times and process
  ids, the same saved document, the sync primitive called twice a span
  only with ``sync_spans``, and the ``torch.profiler`` capture that
  ``jax_profiler_dir`` starts, stopped by ``close()``;
- the recompile detector: the same verdicts, statistics, counter rows and
  trace instants for JAX arrays and torch tensors of the same shapes and
  dtypes;
- the request accountant: the same records, metrics and trace tracks on
  the same call sequence under one fake clock;
- the config: the same parse, or the same ``ConfigError``, for the same
  ``telemetry`` dicts, and the port's "not yet ported" refusals by name;
- the sync primitive (a no-op on the CPU, and it raises what
  ``torch.cuda.synchronize`` raises), the host-scoping helpers and the
  round-trip error gauges.
"""

import dataclasses
import itertools
import json
import os
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import quantize as jq
from deepspeed_tpu.config.config import ConfigError as JaxConfigError
from deepspeed_tpu.config.config import TelemetryConfig as JaxTelemetryConfig
from deepspeed_tpu.telemetry import fleet as jfleet
from deepspeed_tpu.telemetry import recompile as jrecompile
from deepspeed_tpu.telemetry import registry as jregistry
from deepspeed_tpu.telemetry import requests as jrequests
from deepspeed_tpu.telemetry import tracer as jtracer
from deepspeed_tpu_torch.comm import quantize as pq
from deepspeed_tpu_torch.config import ConfigError, TelemetryConfig
from deepspeed_tpu_torch.telemetry import fleet as pfleet
from deepspeed_tpu_torch.telemetry import recompile as precompile
from deepspeed_tpu_torch.telemetry import registry as pregistry
from deepspeed_tpu_torch.telemetry import requests as prequests
from deepspeed_tpu_torch.telemetry import tracer as ptracer
from deepspeed_tpu_torch.telemetry import build_telemetry, null_telemetry
from deepspeed_tpu_torch.telemetry.tracer import PROFILER_TRACE_FILE
from deepspeed_tpu_torch.utils import timer as ptimer

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def _registry_calls(reg):
    """One call sequence: counters, gauges and histograms with tags, the
    default step, and the monitor-compatible ``add_scalar``."""
    reg.counter("requests").inc(step=1, route="train")
    reg.counter("requests").inc(2, step=2, route="eval")
    reg.gauge("hbm").set(123.0, step=2, device=0)
    reg.set_step(7)
    reg.gauge("hbm").set(5)
    lat = reg.histogram("lat")
    for v in (0.5, 3.0, 1.25, 9.0, 0.125, 4.0):
        lat.observe(v, step=3)
    reg.counter("tagged", tags={"fixed": "a"}).inc(3, step=4, extra=1)
    reg.add_scalar("legacy", 2.5, 8, attempt=2)
    return lat


@pytest.mark.parametrize("sink", ["memory", "jsonl"])
def test_registry_rows_match_jax(sink, tmp_path):
    rows = []
    for mod, name in ((jregistry, "jax"), (pregistry, "port")):
        if sink == "memory":
            s = mod.InMemorySink()
        else:
            s = mod.JSONLSink(str(tmp_path / f"{name}.jsonl"))
        reg = mod.MetricsRegistry([s])
        lat = _registry_calls(reg)
        reg.flush()
        if sink == "memory":
            rows.append(s.rows)
        else:
            reg.close()
            with open(tmp_path / f"{name}.jsonl") as f:
                rows.append([json.loads(line) for line in f])
        rows[-1].append(lat.percentiles((0, 10, 50, 90, 99, 100)))
    assert rows[0] == rows[1]
    assert len(rows[0]) == 13


def test_registry_without_sinks_and_with_a_broken_sink():
    """No sink: an emit does nothing. A sink that raises is logged and
    the others still get the row, as in the reference."""
    reg = pregistry.MetricsRegistry()
    reg.counter("x").inc()
    assert reg.counter("x").total == 1.0

    class Broken(pregistry.Sink):
        def emit(self, *a):
            raise RuntimeError("disk full")

    good = pregistry.InMemorySink()
    reg = pregistry.MetricsRegistry([Broken(), good])
    reg.gauge("g").set(1.0, step=0)
    assert good.values("g") == [1.0]


def test_histogram_reservoir_and_reset():
    for mod in (jregistry, pregistry):
        h = mod.MetricsRegistry().histogram("h", max_samples=3)
        with pytest.raises(ValueError, match="no observations"):
            h.percentile(50)
        for v in (5.0, 1.0, 3.0, 2.0):
            h.observe(v)
        assert (h.count, h.percentiles((0, 50, 100))) == (4, (1.0, 3.0, 5.0))
        h.reset()
        assert h.count == 0


# ---------------------------------------------------------------------------
# Step tracer
# ---------------------------------------------------------------------------

def _tracer_calls(tr):
    with tr.span("prefill", rid=3, bucket=8) as sp:
        pass
    tr.instant("recompile", fn="f", changed=["a"])
    tr.counter("queue", 4)
    tr.async_begin("req/queue", 3, rid=3)
    tr.async_end("req/queue", 3)
    with tr.span("decode_step", active=2):
        pass
    tr.span("unused")                    # a span never entered: no event
    return sp


def _untimed(events):
    """Events without their times and ids; the process-name metadata
    names each package."""
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items()
              if k not in ("ts", "dur", "pid", "tid")}
        if ev["ph"] == "M":
            ev["args"] = sorted(ev["args"])
        out.append(ev)
    return out


def test_tracer_events_and_file_match_jax(tmp_path):
    docs, events = [], []
    for mod, name in ((jtracer, "jax"), (ptracer, "port")):
        path = str(tmp_path / f"{name}.json")
        tr = mod.StepTracer(path=path, sync_spans=False, host="h0")
        sp = _tracer_calls(tr)
        assert sp.duration >= 0.0
        events.append(_untimed(tr.events))
        assert tr.span_names() == {"prefill", "decode_step"}
        tr.close()
        with open(path) as f:
            doc = json.load(f)
        docs.append((sorted(doc), doc["displayTimeUnit"],
                     sorted(doc["metadata"]), doc["metadata"]["host"],
                     _untimed(doc["traceEvents"])))
    assert events[0] == events[1]
    assert docs[0] == docs[1]


def test_tracer_ring_and_dirty_skip(tmp_path):
    for mod in (jtracer, ptracer):
        path = str(tmp_path / f"{mod.__name__}.json")
        tr = mod.StepTracer(path=path, sync_spans=False, max_events=4)
        for i in range(10):
            tr.instant(f"e{i}")
        assert tr.dropped_events == 7       # the metadata event counts
        assert tr.save() == path
        mtime = os.stat(path).st_mtime_ns
        assert tr.save() == path            # nothing new: no rewrite
        assert os.stat(path).st_mtime_ns == mtime
        with open(path) as f:
            doc = json.load(f)
        assert [e["name"] for e in doc["traceEvents"]] == \
            ["e6", "e7", "e8", "e9"]
        assert doc["metadata"]["dropped_events"] == 7


def test_disabled_tracer_is_a_null_span(monkeypatch):
    calls = []
    monkeypatch.setattr(ptimer, "_device_synchronize", calls.append)
    tr = ptracer.StepTracer(enabled=False, sync_spans=True)
    assert not tr.sync_spans
    assert tr.span("a") is tr.span("b")
    with tr.span("a"):
        pass
    tr.instant("x")
    tr.async_begin("r", 1)
    assert tr.events == [] and calls == [] and tr.save() is None
    tel = null_telemetry()
    assert not tel.enabled and tel.span("x") is tr.span("y")


@pytest.mark.parametrize("sync", [False, True])
def test_sync_spans_call_the_primitive(sync, monkeypatch):
    """``sync_spans``: the primitive runs at each span's entry and exit,
    with the tracer's device; without it, never."""
    calls = []
    monkeypatch.setattr(ptimer, "_device_synchronize", calls.append)
    tr = ptracer.StepTracer(enabled=True, sync_spans=sync, device="cpu")
    for _ in range(3):
        with tr.span("s"):
            pass
    assert calls == (["cpu"] * 6 if sync else [])


def test_sync_primitive_raises_on_cuda(monkeypatch):
    """A no-op on the CPU; on a CUDA device it is
    ``torch.cuda.synchronize``, whose error leaves the span (the
    reference swallows it)."""
    ptimer._device_synchronize(None)
    ptimer._device_synchronize(torch.device("cpu"))
    seen = []

    def failing(device):
        seen.append(device)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch.cuda, "synchronize", failing)
    ptimer._device_synchronize("cpu")
    assert seen == []
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ptimer._device_synchronize(torch.device("cuda", 0))
    tr = ptracer.StepTracer(enabled=True, device="cuda:0")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with tr.span("decode_step"):
            pass
    assert seen == [torch.device("cuda", 0)] * 2


def test_profiler_capture_stops_at_close(tmp_path):
    """``jax_profiler_dir`` starts a torch.profiler capture (CPU activity
    here); ``close()`` stops it and exports a Chrome trace into the
    directory, also after the traced work raised."""
    prof_dir = tmp_path / "prof"
    tr = ptracer.StepTracer(path=str(tmp_path / "trace.json"),
                            jax_profiler_dir=str(prof_dir), device="cpu")
    assert tr.profiler_active
    assert tr.start_profiler() is None           # one capture at a time
    with pytest.raises(ValueError):
        with tr.span("decode_step"):
            torch.ones(4) @ torch.ones(4)
            raise ValueError("step failed")
    tr.close()
    assert not tr.profiler_active
    with open(prof_dir / PROFILER_TRACE_FILE) as f:
        assert json.load(f)["traceEvents"]
    assert tr.stop_profiler() is None            # idempotent
    assert os.path.exists(tmp_path / "trace.json")


# ---------------------------------------------------------------------------
# Recompile detector
# ---------------------------------------------------------------------------

# (name, shapes/dtypes of the inputs, a static string or None)
DETECTOR_CALLS = [
    ("step", [((2, 8), "int32"), ((), "int32")], None),
    ("step", [((2, 8), "int32"), ((), "int32")], None),
    ("step", [((3, 8), "int32"), ((), "int32")], None),     # shape
    ("step", [((3, 8), "float32"), ((), "int32")], None),   # dtype
    ("step", [((2, 8), "int32"), ((), "int32")], None),     # revisit
    ("other", [((4,), "float32")], "k=1"),
    ("other", [((4,), "float32")], "k=1"),
    ("other", [((4,), "float32")], "k=2"),                  # static value
    ("other", [((4,), "float32"), ((1,), "float32")], "k=2"),   # new leaf
    ("step", [((2, 8), "int32")], None),                    # leaf removed
]


def _detector_inputs(arrays, shapes, static):
    leaves = [arrays(np.zeros(s, d)) for s, d in shapes]
    tree = {"b": leaves[0], "a": leaves[1:], "n": 3}
    return (tree, {"static": static}) if static else (tree,)


def test_detector_verdicts_match_jax():
    out = []
    for mod, rmod, tmod, arrays in (
            (jrecompile, jregistry, jtracer, jnp.asarray),
            (precompile, pregistry, ptracer, torch.from_numpy)):
        sink = rmod.InMemorySink()
        reg = rmod.MetricsRegistry([sink])
        tr = tmod.StepTracer(enabled=True, sync_spans=False)
        det = mod.RecompileDetector(registry=reg, tracer=tr, warn=False)
        verdicts = [det.check(name, *_detector_inputs(arrays, shapes, st),
                              step=i)
                    for i, (name, shapes, st) in enumerate(DETECTOR_CALLS)]
        instants = [(e["name"], e["args"]["fn"], len(e["args"]["changed"]))
                    for e in tr.events if e["ph"] == "i"]
        out.append((verdicts, det.stats, det.retraces(), sink.rows,
                    instants))
    assert out[0] == out[1]
    assert out[1][0] == ["compile", "hit", "retrace", "retrace", "hit",
                         "compile", "hit", "retrace", "retrace", "retrace"]


def test_detector_signature_names_and_off_switch():
    sig = precompile.tree_signature(
        {"x": torch.zeros(2, 3, dtype=torch.bfloat16), "s": "a"}, [1.5])
    assert sig == (("arg0.s", "static", "a", "-"),
                   ("arg0.x", "(2, 3)", "bfloat16", "cpu"),
                   ("arg1.0", "scalar", "float", "-"))
    det = precompile.RecompileDetector(enabled=False)
    assert det.check("f", torch.zeros(1)) == "hit"
    det = precompile.RecompileDetector(warn=False)
    assert det.check("f", torch.zeros(1)) == "compile"
    det.forget("f")                  # the statistics stay
    assert det.check("f", torch.zeros(2)) == "compile"
    assert det.compiles("f") == 2 and det.retraces("f") == 0


# ---------------------------------------------------------------------------
# Request accountant
# ---------------------------------------------------------------------------

def _req(rid, t, plen=5, max_new=4):
    return types.SimpleNamespace(rid=rid, arrival=t, prompt=[1] * plen,
                                 max_new_tokens=max_new,
                                 first_token_time=None, preempted_count=0)


def _seq(req):
    return types.SimpleNamespace(request=req, shared_len=0, generated=0)


def _accountant_calls(mod, rmod, tmod, clock, run_dir):
    """One request life of each kind under a fake clock: decoded to the
    end, preempted and resumed with a warm head, cancelled in the queue,
    shed; plus the engine partition and the rolling window."""
    sink = rmod.InMemorySink()
    reg = rmod.MetricsRegistry([sink])
    tr = tmod.StepTracer(enabled=True, sync_spans=False)
    acc = mod.RequestAccountant(registry=reg, tracer=tr, run_dir=run_dir,
                                window_sec=5.0, host="h0")
    acc.spec_k = 2
    r0, r1 = _req(0, clock.now), _req(1, clock.now, plen=9)
    s0, s1 = _seq(r0), _seq(r1)
    acc.on_submit(r0)
    acc.on_submit(r1)
    rates = []
    for step in range(6):
        clock.tick(0.25)
        acc.engine_mark("host_idle")
        if step == 0:
            acc.on_admit(s0)
            clock.tick(0.5)
            acc.engine_mark("compile")
            s0.generated = 1
            r0.first_token_time = clock.now
            acc.on_prefilled(s0)
        if step == 1:
            acc.on_admit(s1)
            s1.shared_len = 0
            clock.tick(0.25)
            acc.engine_mark("prefill")
            s1.generated = 1
            acc.on_prefilled(s1)
        if step == 3:
            acc.on_preempt(s1)
            r1.preempted_count += 1
            s1.generated = 0
        if step == 4:
            s1.shared_len = 4
            acc.on_admit(s1)
            clock.tick(0.125)
            s1.generated = 1
            acc.on_prefilled(s1)
        clock.tick(0.5)
        acc.engine_mark("decode")
        s0.generated += 2 if step % 2 else 1
        live = [s for s in (s0, s1) if s.generated and
                not (step == 3 and s is s1)]
        acc.on_decode_step(live, 0.375, step)
        acc.rolling_add(len(live), 0.375)
        rates.append(acc.rolling_rate())
        acc.emit(step)
    slos = [acc.on_finish(s0, 6), acc.on_finish(s1, 6, status="aborted")]
    r2, r3 = _req(2, clock.now), _req(3, clock.now)
    acc.on_submit(r2)
    clock.tick(1.0)
    acc.on_drop(r2, "cancelled", 7)
    acc.on_drop(r3, "shed", 7)
    acc.close()
    with open(acc.path) as f:
        records = [json.loads(line) for line in f]
    for rec in records:
        rec.pop("arrival_unix")
    events = [(e["ph"], e["name"], e.get("id")) for e in tr.events
              if e["ph"] in "be"]
    return sink.rows, slos, records, events, rates, acc.completed


class _Clock:
    def __init__(self):
        self.now = 100.0

    def tick(self, dt):
        self.now += dt

    def __call__(self):
        return self.now


def test_request_accountant_matches_jax(tmp_path, monkeypatch):
    out = []
    for mod, rmod, tmod in ((jrequests, jregistry, jtracer),
                            (prequests, pregistry, ptracer)):
        clock = _Clock()
        monkeypatch.setattr(time, "monotonic", clock)
        run_dir = str(tmp_path / mod.__name__)
        out.append(_accountant_calls(mod, rmod, tmod, clock, run_dir))
    assert out[0] == out[1]
    rows, slos, records, events, rates, completed = out[1]
    assert [r["status"] for r in records] == ["finished", "aborted",
                                              "cancelled", "shed"]
    for slo, rec in zip(slos, records):
        assert sum(slo["categories"].values()) == pytest.approx(
            slo["lifetime_sec"], abs=1e-12)
        assert rec["categories"] == slo["categories"]
    assert slos[1]["categories"]["preempted_requeue"] > 0
    assert {r["tag"] for r in rows} <= prequests.REQUEST_METRIC_TAGS
    assert prequests.ENGINE_CATEGORIES == jrequests.ENGINE_CATEGORIES
    assert prequests.REQUEST_CATEGORIES == jrequests.REQUEST_CATEGORIES
    assert prequests.REQUEST_METRIC_TAGS == jrequests.REQUEST_METRIC_TAGS
    assert completed == 2 and all(r is not None for r in rates)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

CONFIGS = [
    None, {}, False, {"dir": "run"}, {"enabled": True},
    {"enabled": True, "dir": "run"}, {"enabled": True, "dir": ""},
    {"enabled": False, "dir": ""},
    {"enabled": True, "dir": "run", "trace": {"enabled": False,
                                              "file": "t.json"}},
    {"enabled": True, "trace": {"sync_spans": False,
                                "jax_profiler_dir": "prof"}},
    {"enabled": 1, "metrics": {"sinks": ["jsonl", "memory"],
                               "file": "m.jsonl"}},
    {"enabled": True, "metrics": {"sinks": ["parquet"]}},
    {"enabled": True, "metrics": {"sinks": []}},
    {"enabled": True, "recompile_detection": False, "goodput": False},
    {"enabled": True, "requests": {"enabled": True, "file":
                                   "requests.replica0.jsonl",
                                   "window_sec": 2.5}},
    {"requests": {"file": "slo.jsonl"}},
    {"requests": {"file": "requests.txt"}},
    {"requests": {"window_sec": 0}},
    {"enabled": True, "numerics": {"enabled": True, "max_groups": 4}},
    {"numerics": {"max_groups": 0}}, {"numerics": {"max_spike_dumps": -1}},
    {"fleet": {"window": 2, "min_window": 3}}, {"fleet": {"zscore": 0}},
    {"fleet": {"persist": 0}}, {"fleet": {"breakdown_file": "f.json"}},
    {"fleet": {"enabled": True}, "goodput": False},
    {"fleet": {"enabled": True}},
    {"memory": {"headroom_warn_frac": 2}}, {"memory": {"oom_exit_code": 0}},
    {"memory": {"hbm_limit_gb": -1}}, {"memory": {"plan_file": "p.json"}},
    {"memory": {"enabled": True, "hbm_limit_gb": 80}},
    {"devicetime": {"capture_steps": 0}},
    {"devicetime": {"every_steps": 3, "capture_steps": 3}},
    {"devicetime": {"keep_last": 0}}, {"devicetime": {"top_k": 0}},
    {"devicetime": {"divergence_warn": 0}}, {"devicetime": {"hbm_gbps": 0}},
    {"devicetime": {"enabled": True}, "trace": {"jax_profiler_dir": "p"}},
    {"devicetime": {"enabled": True, "every_steps": 50}},
    {"trace": None, "metrics": None, "requests": None, "numerics": {}},
]
# refused by the port while telemetry is on; parsed while it is off
UNPORTED = {
    "telemetry.fleet": {"enabled": True, "fleet": {"enabled": True}},
    "telemetry.memory": {"enabled": True, "memory": {"enabled": True}},
    "telemetry.devicetime": {"enabled": True,
                             "devicetime": {"enabled": True}},
    "'tensorboard' sink": {"enabled": True,
                           "metrics": {"sinks": ["jsonl", "tensorboard"]}},
}


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["metrics"]["sinks"] = tuple(d["metrics"]["sinks"])
    return d


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_config_parses_as_the_reference(i):
    """The same fields, or a ``ConfigError`` in both; a block that is on
    and not ported yet raises by name in the port alone."""
    d = CONFIGS[i]
    try:
        want = JaxTelemetryConfig.from_dict(d)
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as exc:
            TelemetryConfig.from_dict(d)
        key = str(e).split()[0].rstrip(":")
        assert key in str(exc.value), (str(e), str(exc.value))
        return
    if want.enabled and any(
            getattr(want, k).enabled for k in ("fleet", "memory",
                                               "devicetime")):
        with pytest.raises(ConfigError, match="not yet ported"):
            TelemetryConfig.from_dict(d)
        return
    assert _fields(TelemetryConfig.from_dict(d)) == _fields(want)


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_telemetry_blocks_raise_by_name(name):
    d = UNPORTED[name]
    JaxTelemetryConfig.from_dict(d)
    with pytest.raises(ConfigError, match="not yet ported") as exc:
        TelemetryConfig.from_dict(d)
    assert name in str(exc.value)
    off = {**d, "enabled": False}
    assert _fields(TelemetryConfig.from_dict(off)) == \
        _fields(JaxTelemetryConfig.from_dict(off))


@pytest.mark.parametrize("d", [
    {"enabled": True, "tracing": {}}, {"trace": {"sync": True}},
    {"requests": {"window": 2}}, {"metrics": {"sink": ["jsonl"]}},
    {"trace": 3}])
def test_unknown_telemetry_keys_raise(d):
    """The port's wall: a key it does not know raises, where the
    reference ignores it."""
    with pytest.raises(ConfigError, match="unknown|must be a dict"):
        TelemetryConfig.from_dict(d)


def test_build_telemetry_files_and_off_state(tmp_path, monkeypatch):
    monkeypatch.delenv(pfleet.TELEMETRY_HOST_ENV, raising=False)
    tel = build_telemetry(TelemetryConfig.from_dict({"enabled": False}))
    assert not tel.enabled and tel.registry.sinks == []
    tcfg = TelemetryConfig.from_dict({
        "enabled": True, "dir": str(tmp_path), "recompile_detection": False,
        "metrics": {"sinks": ["jsonl", "memory"]}})
    tel = build_telemetry(tcfg, device=torch.device("cpu"))
    assert tel.metrics_path == str(tmp_path / "metrics.jsonl")
    assert tel.tracer.path == str(tmp_path / "trace.json")
    assert tel.tracer.sync_spans and tel.tracer.device.type == "cpu"
    assert not tel.recompile.enabled
    with tel.span("x"):
        tel.registry.gauge("g").set(1.0, step=0)
    tel.close()
    assert os.path.exists(tmp_path / "trace.json")
    monkeypatch.setenv(pfleet.TELEMETRY_HOST_ENV, "workerZ")
    tel = build_telemetry(tcfg)
    assert tel.metrics_path == str(tmp_path / "metrics.workerZ.jsonl")
    assert tel.tracer.path == str(tmp_path / "trace.workerZ.json")
    tel.close()


@pytest.mark.parametrize("forced", [None, "workerZ"])
def test_host_scoping_matches_jax(forced, monkeypatch):
    if forced is None:
        monkeypatch.delenv(pfleet.TELEMETRY_HOST_ENV, raising=False)
    else:
        monkeypatch.setenv(pfleet.TELEMETRY_HOST_ENV, forced)
    assert pfleet.TELEMETRY_HOST_ENV == "DSTPU_TELEMETRY_HOST"
    assert pfleet.telemetry_host_component() == \
        jfleet.telemetry_host_component()
    assert pfleet.default_host() == jfleet.default_host()
    for name, host in itertools.product(
            ("metrics.jsonl", "trace.json", "requests", "a.b.json"),
            (None, "", "h1")):
        assert pfleet.host_scoped_path(name, host) == \
            jfleet.host_scoped_path(name, host)


# ---------------------------------------------------------------------------
# Round-trip error gauges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16, 32])
@pytest.mark.parametrize("case", ["normal", "zeros", "nonfinite"])
def test_roundtrip_error_matches_jax(bits, case):
    x = np.random.default_rng(bits).standard_normal(
        (2, 12, 4, 16)).astype(np.float32) * 3
    if case == "zeros":
        x[:] = 0
    elif case == "nonfinite":
        x[1, 3, 2, 5] = np.inf
    want = [float(v) for v in jq.roundtrip_error(jnp.asarray(x), bits, 16)]
    got = [float(v) for v in pq.roundtrip_error(torch.from_numpy(x), bits,
                                                16)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    parts = pq.roundtrip_error_parts(torch.from_numpy(x), bits, 16)
    jparts = jq.roundtrip_error_parts(jnp.asarray(x), bits, 16)
    np.testing.assert_allclose([float(p) for p in parts],
                               [float(p) for p in jparts], rtol=1e-5)

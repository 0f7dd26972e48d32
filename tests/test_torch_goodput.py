"""Port parity: goodput accounting of training
(``deepspeed_tpu_torch/telemetry/goodput.py``) against the JAX package's
``GoodputAccountant``, on the CPU.

- the same events (marks, step marks of each category, measured
  intervals, time pending around them, attributed seconds) on an injected
  clock give the JAX accountant's category totals, wall time, mean step
  time, MFU and ``goodput/*`` gauges; the port's MFU comes from the FLOPs
  and the card's peak the engine feeds it (the table: 989 TFLOP/s bf16 and
  fp16 on an H100, 67 fp32, none elsewhere);
- ``classify_exit`` and ``finalize_attempt_manifests`` (a stamped
  manifest, a stub for an attempt that left none) as the JAX functions
  give them;
- the engine: ``telemetry.goodput`` on the tiny GPT writes a run manifest
  whose categories sum to its wall time, with every step booked, and
  ``tools/goodput_report.py`` reads the port's manifests unchanged; the
  supervisor's ``run_dir`` stamps each attempt.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.telemetry import goodput as jax_goodput
from deepspeed_tpu.telemetry.registry import InMemorySink as JaxSink
from deepspeed_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from deepspeed_tpu_torch.models import init_gpt_params, make_gpt
from deepspeed_tpu_torch.resilience import Supervisor
from deepspeed_tpu_torch.telemetry import goodput as port_goodput
from deepspeed_tpu_torch.telemetry.registry import InMemorySink, \
    MetricsRegistry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _report_tool():
    spec = importlib.util.spec_from_file_location(
        "goodput_report", os.path.join(REPO, "tools", "goodput_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive(mod, registry, clock, wall, run_dir):
    """One script of events on an accountant of ``mod``."""
    env = {"DSTPU_RESUME_ATTEMPT": "2",
           mod.ATTEMPT_START_WALL_ENV: repr(wall[0] - 3.5)}
    acc = mod.GoodputAccountant(registry=registry, run_dir=run_dir,
                                run_id="r", host="h", cfg_hash="c",
                                clock=lambda: clock[0],
                                wall_clock=lambda: wall[0], env=env)

    def tick(dt):
        clock[0] += dt
        wall[0] += dt

    tick(1.25)
    acc.mark_gap()                                   # init_restore
    tick(0.5)
    acc.mark("data_stall")
    tick(4.0)
    acc.step_mark("recompile", 1)
    for step in (2, 3, 4):
        tick(0.25)
        acc.mark_gap()                               # idle_other
        tick(0.125)
        acc.mark("data_stall")
        tick(1.0 + 0.0625 * step)
        acc.step_mark("productive_step", step)
    tick(0.5)                                        # pending before it
    with acc.measure("rollback_restore"):
        tick(0.75)
        acc.mark("idle_other")                       # inside: clamps
        tick(0.25)
    tick(0.375)
    acc.step_mark("rollback_replay", 3)
    with acc.measure("ckpt_write_stall"):
        tick(2.0)
    acc.attribute("ckpt_snapshot", 0.3)
    tick(0.1)
    acc.set_flops(2e12, peak_tflops_per_chip=100.0)
    return acc


def test_accountant_matches_jax(tmp_path):
    out = {}
    for name, mod, reg, sink in (
            ("jax", jax_goodput, JaxRegistry(), JaxSink()),
            ("port", port_goodput, MetricsRegistry(), InMemorySink())):
        reg.add_sink(sink)
        clock, wall = [100.0], [5000.0]
        acc = _drive(mod, reg, clock, wall, str(tmp_path / name))
        acc.emit(4)
        out[name] = (acc, acc.totals(), sink.rows)
    (jacc, jt, jrows), (pacc, pt, prows) = out["jax"], out["port"]
    assert port_goodput.CATEGORIES == jax_goodput.CATEGORIES
    assert pt == jt
    # a mark inside a measured interval and a bare attribute() overlap
    # the partition by their seconds, in both packages
    assert abs(sum(v for k, v in pt.items() if k != "wall_sec")
               - pt["wall_sec"] - (0.75 + 0.3)) < 1e-9
    assert pt["init_restore"] == 3.5 + 1.25 and pt["rollback_replay"] > 0
    assert pacc.mean_step_time() == jacc.mean_step_time()
    assert pacc.mfu() == jacc.mfu() and pacc.mfu() > 0
    assert pacc.attempt == jacc.attempt == 2

    def rows(rs):
        return sorted((r["tag"], r["value"], r["step"], r.get("attempt"))
                      for r in rs)
    assert rows(prows) == rows(jrows)
    pm = pacc.manifest(final=True)
    jm = jacc.manifest(final=True)
    for key in ("attempt", "run_id", "host", "config_hash", "start_wall",
                "categories", "first_step", "steps_committed",
                "mean_step_time_sec", "mfu", "flops_per_step", "wall_sec"):
        assert pm[key] == jm[key], key
    assert pm["peak_tflops_per_chip"] == 100.0


def test_peak_table():
    assert port_goodput.peak_tflops("NVIDIA H100 80GB HBM3",
                                    "bfloat16") == 989.0
    assert port_goodput.peak_tflops("NVIDIA H100 80GB HBM3",
                                    "float16") == 989.0
    assert port_goodput.peak_tflops("NVIDIA H100 80GB HBM3",
                                    "float32") == 67.0
    assert port_goodput.peak_tflops("cpu", "bfloat16") is None
    assert port_goodput.card_info("cpu") == "cpu"
    acc = port_goodput.GoodputAccountant(clock=lambda: 0.0, env={})
    acc.set_flops(1e12)                    # no peak: no MFU
    assert acc.mfu() is None


@pytest.mark.parametrize("rc", [0, 113, 114, 115, -15, 143, 137, 1, 2])
def test_classify_exit_matches_jax(rc):
    args = ({113}, {114}, {115})
    assert port_goodput.classify_exit(rc, *args) == \
        jax_goodput.classify_exit(rc, *args)


def test_finalize_attempt_manifests_matches_jax(tmp_path):
    for name, mod in (("jax", jax_goodput), ("port", port_goodput)):
        run = tmp_path / name
        acc = mod.GoodputAccountant(run_dir=str(run), run_id="r",
                                    host="h", clock=lambda: 10.0,
                                    wall_clock=lambda: 50.0,
                                    env={"DSTPU_RESUME_ATTEMPT": "0"})
        acc.write_manifest()
        assert mod.finalize_attempt_manifests(str(run), 0, 113, "watchdog",
                                              50.0, 80.0) == 1
        assert mod.finalize_attempt_manifests(str(run), 1, -9,
                                              "preemption", 81.0,
                                              82.0) == 1
    for f in ("run_manifest.a0000.h.json", "run_manifest.a0001.unknown.json"):
        jd = json.load(open(tmp_path / "jax" / f))
        pd = json.load(open(tmp_path / "port" / f))
        for key in ("exit_rc", "restart_cause", "end_wall", "wall_sec",
                    "attempt", "categories"):
            assert pd[key] == jd[key], (f, key)


def _train(run_dir, steps, **extra):
    model, cfg = make_gpt("tiny", dtype=torch.float32)
    engine = deepspeed_tpu_torch.initialize(
        model=model, params=init_gpt_params(cfg, seed=0), device="cpu",
        config={"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "steps_per_print": 2,
                "telemetry": {"enabled": True, "dir": str(run_dir),
                              "trace": {"sync_spans": False}}, **extra})[0]
    rng = np.random.default_rng(0)
    for _ in range(steps):
        engine.train_batch({"input_ids": rng.integers(
            0, 512, (2, 2, 16), dtype=np.int32)})
    engine.close()
    return engine


def test_engine_manifest_read_by_goodput_report(tmp_path):
    engine = _train(tmp_path, 5)
    g = engine.goodput
    assert g is not None and g.card == "cpu"
    (name,) = [f for f in os.listdir(tmp_path)
               if f.startswith("run_manifest.")]
    doc = json.load(open(tmp_path / name))
    cats = doc["categories"]
    assert set(cats) == set(port_goodput.CATEGORIES)
    assert abs(sum(cats.values()) - doc["wall_sec"]) < 1e-6
    assert cats["recompile"] > 0 and cats["productive_step"] > 0
    assert cats["data_stall"] > 0
    assert doc["steps_committed"] == 5 and doc["first_step"] == 1
    # the flops are known (a GPT batch), the CPU has no peak: no MFU
    assert doc["flops_per_step"] > 0 and doc["mfu"] is None
    assert doc["card"] == "cpu" and doc["end_wall"] is not None
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert {f"goodput/{c}_sec" for c in port_goodput.CATEGORIES} <= {
        r["tag"] for r in rows}
    assert "Train/Samples/train_loss" in {r["tag"] for r in rows}
    tool = _report_tool()
    report = tool.merge_run(str(tmp_path))
    assert report["n_attempts"] == 1 and report["steps_committed"] == 5
    assert abs(sum(report["categories"].values())
               + report["unaccounted_sec"] - report["wall_sec"]) < 1e-3
    assert "productive_step" in tool.render(report)
    assert tool.main([str(tmp_path), "--json"]) == 0


def test_supervisor_run_dir_stamps_attempts(tmp_path):
    """A child that dies with 113 then exits 0: the supervisor restarts it
    at once and stamps both attempts' manifests (the first child wrote
    none: a stub); the report merges them."""
    marker = tmp_path / "marker"
    script = (f"import os, sys\n"
              f"if not os.path.exists({str(marker)!r}):\n"
              f"    open({str(marker)!r}, 'w').close(); sys.exit(113)\n")
    sup = Supervisor([sys.executable, "-c", script], max_restarts=2,
                     backoff=30.0, run_dir=str(tmp_path))
    assert sup.run() == 0
    assert sup.exit_codes == [113, 0] and sup.immediate_restarts == 1
    docs = sorted((json.load(open(tmp_path / f)) for f in os.listdir(
        tmp_path) if f.startswith("run_manifest.")),
        key=lambda d: d["attempt"])
    assert [(d["attempt"], d["exit_rc"], d["restart_cause"])
            for d in docs] == [(0, 113, "watchdog"), (1, 0, "clean")]
    report = _report_tool().merge_run(str(tmp_path))
    assert report["n_attempts"] == 2 and report["n_restarts"] == 1

"""Port parity: serving resilience (deadlines, cancellation, shedding,
recovery, the degradation ladder) in the port's ServeEngine, fp32 on the
CPU, tiny GPT, case by case as ``tests/test_serving_resilience.py`` holds
the JAX engine; the chaos run is token-identical to the JAX engine's run
under the same ``FaultPlan``. Also ``FaultPlan`` and the retry helper
against the JAX package's.
"""

import dataclasses
import json
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import SERVE

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.guardrails import retry as jax_retry
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.resilience import FaultPlan as JaxFaultPlan
from deepspeed_tpu.serving import ServeEngine as JaxServeEngine
from deepspeed_tpu_torch.config import ConfigError, ServingConfig
from deepspeed_tpu_torch.guardrails import backoff_delay, retry_call
from deepspeed_tpu_torch.models import (gpt_params_from_flax,
                                        init_flax_gpt_params, make_gpt)
from deepspeed_tpu_torch.resilience import FaultPlan
from deepspeed_tpu_torch.serving import ServeEngine
from deepspeed_tpu_torch.serving.resilience import TERMINAL_STATUSES

# One intra-op thread: the tests run in several worker processes at once.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    jm, cfg = jax_make_gpt("tiny", dropout_rate=0.0, max_seq_len=64,
                           dtype=jnp.float32)
    tree = init_flax_gpt_params(make_gpt("tiny", max_seq_len=64)[1], seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jm, cfg, params, gpt_params_from_flax(tree)


def _serve(sd, fault=None, **overrides):
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    eng = deepspeed_tpu_torch.init_inference(
        model, params=sd, dtype=torch.float32, device="cpu")
    plan = FaultPlan.resolve(fault, env={}) if fault else None
    return ServeEngine(eng, config=ServingConfig(**{**SERVE, **overrides}),
                       fault_plan=plan)


def _jax_serve(jm, params, fault=None, **overrides):
    eng = deepspeed_tpu.init_inference(jm, params=params, dtype=jnp.float32)
    plan = JaxFaultPlan.resolve(fault, env={}) if fault else None
    return JaxServeEngine(eng, config=JaxServingConfig(**{**SERVE,
                                                          **overrides}),
                          fault_plan=plan)


def _prompts(cfg, n=3, seed=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (4 + i,)).tolist()
            for i in range(n)]


# ---------------------------------------------------------------------------
# Deadlines + cancellation
# ---------------------------------------------------------------------------

def test_deadline_expiry_keeps_partial_output(tiny):
    """A running sequence whose deadline passes is aborted at the next
    step boundary with its partial output, and its blocks are freed."""
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True)
    prompt = _prompts(cfg, n=1)[0]
    rid = srv.submit(prompt, 30, deadline_ms=60_000.0)
    req = srv.sched.waiting[0]
    assert req.deadline == pytest.approx(req.arrival + 60.0, abs=1e-6)
    for _ in range(3):
        srv.step()
    seq = next(iter(srv.sched.running.values()))
    assert len(seq.tokens) > len(prompt)
    seq.request.deadline = time.monotonic() - 1.0      # force expiry
    srv.step()
    rec = srv.results[rid]
    assert rec["status"] == "deadline_expired"
    assert len(prompt) < len(rec["tokens"]) < len(prompt) + 1 + 30
    assert rec["tokens"][:len(prompt)] == prompt
    assert srv._resil.counters["deadline_expired"] == 1
    assert srv.pool.used_blocks == 0
    assert srv.idle()


def test_queued_deadline_drops_without_admission(tiny):
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True)
    p = _prompts(cfg, n=3)
    r0 = srv.submit(p[0], 12)
    r1 = srv.submit(p[1], 12)
    r2 = srv.submit(p[2], 12, deadline_ms=0.5)
    time.sleep(0.01)
    res = srv.run_until_complete(timeout_sec=120.0)
    assert res[r2]["status"] == "deadline_expired"
    assert res[r2]["tokens"] == p[2]
    assert res[r2]["queue_wait_ms"] is None
    assert res[r0]["status"] == res[r1]["status"] == "finished"
    assert srv.pool.used_blocks == 0


def test_default_deadline_from_the_config(tiny):
    """``default_deadline_ms`` stamps every request without its own."""
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True, resil_default_deadline_ms=250.0)
    srv.submit(_prompts(cfg, n=1)[0], 4)
    req = srv.sched.waiting[0]
    assert req.deadline == pytest.approx(req.arrival + 0.25, abs=1e-6)


def test_cancel_releases_blocks_exactly_once(tiny):
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True)
    p = _prompts(cfg, n=2)
    r0 = srv.submit(p[0], 20)
    r1 = srv.submit(p[1], 6)
    for _ in range(3):
        srv.step()
    assert srv.cancel(r0)
    assert not srv.cancel(r0 + 999)
    res = srv.run_until_complete(timeout_sec=120.0)
    assert res[r0]["status"] == "cancelled"
    assert len(p[0]) < len(res[r0]["tokens"]) < len(p[0]) + 1 + 20
    assert res[r1]["status"] == "finished"
    assert srv._resil.counters["cancelled"] == 1
    assert srv.pool.used_blocks == 0
    assert not srv.cancel(r1)


def test_cancel_in_queue_and_off_wall(tiny):
    """A queued rid cancels without admission; without resilience
    ``cancel`` and ``deadline_ms`` raise, and no manager or plan exists."""
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True, max_batch_size=2)
    p = _prompts(cfg, n=3)
    rids = [srv.submit(pp, 8) for pp in p]
    assert srv.cancel(rids[2])
    res = srv.run_until_complete(timeout_sec=120.0)
    assert res[rids[2]]["status"] == "cancelled"
    assert res[rids[2]]["tokens"] == p[2]
    assert {res[r]["status"] for r in rids[:2]} == {"finished"}

    off = _serve(sd)
    assert off._resil is None and off._fault is None
    with pytest.raises(RuntimeError, match="resilience"):
        off.cancel(0)
    with pytest.raises(ValueError, match="resilience"):
        off.submit(p[0], 4, deadline_ms=10.0)
    with pytest.raises(ValueError, match="deadline_ms must be > 0"):
        srv.submit(p[0], 4, deadline_ms=0)


def test_close_aborts_what_is_left(tiny):
    """``close()`` gives every running and queued rid a terminal
    ``aborted`` record; all statuses come from ``TERMINAL_STATUSES``."""
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True)
    rids = [srv.submit(pp, 8) for pp in _prompts(cfg, n=3)]
    srv.step()
    srv.close()
    assert [srv.results[r]["status"] for r in rids] == ["aborted"] * 3
    assert srv.results[rids[2]]["tokens"] == _prompts(cfg, n=3)[2]
    assert all(srv.results[r]["status"] in TERMINAL_STATUSES for r in rids)
    assert srv.pool.used_blocks == 0 and srv.idle()


# ---------------------------------------------------------------------------
# Admission control + load shedding
# ---------------------------------------------------------------------------

def test_depth_backstop_sheds_with_terminal_records(tiny):
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True, resil_max_queue_depth=2)
    rng = np.random.default_rng(3)
    rids = [srv.submit(rng.integers(0, cfg.vocab_size, (5,)).tolist(), 6)
            for _ in range(8)]
    shed = [r for r in rids if r in srv.results]
    assert shed and len(shed) == srv._resil.counters["shed_requests"]
    for r in shed:
        assert srv.results[r]["status"] == "shed"
        assert "max_queue_depth" in srv.results[r]["shed_reason"]
    res = srv.run_until_complete(timeout_sec=120.0)
    assert set(res) == set(rids)
    assert all(res[r]["status"] in ("finished", "shed") for r in rids)
    assert [r for r in rids if res[r]["status"] == "finished"]


def test_projected_wait_gate(tiny):
    """With decode-rate evidence a submission whose projected wait blows
    ``max_queue_wait_ms`` is shed; a cold engine admits."""
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True, resil_max_queue_wait_ms=0.01)
    p = _prompts(cfg, n=3)
    r0 = srv.submit(p[0], 8)
    srv.run_until_complete(timeout_sec=120.0)
    assert srv.results[r0]["status"] == "finished"
    r1 = srv.submit(p[1], 30)
    r2 = srv.submit(p[2], 30)
    assert srv.results[r2]["status"] == "shed"
    assert "queue wait" in srv.results[r2]["shed_reason"]
    res = srv.run_until_complete(timeout_sec=120.0)
    assert res[r1]["status"] == "finished"


def test_storm_shed_keeps_admitted_queue_wait_bounded(tiny):
    """Under a FaultPlan request storm, shedding keeps the admitted
    requests' worst queue wait below the unshed run's."""
    _jm, cfg, _params, sd = tiny
    storm = {"serve_storm_at_step": 10_000, "serve_storm_requests": 12}
    waits = {}
    for mode, overrides in (
            ("off", {}),
            ("on", {"resilience": True, "resil_max_queue_depth": 2})):
        srv = _serve(sd, fault=storm, **overrides)
        rng = np.random.default_rng(11)
        warm = srv.submit(rng.integers(0, cfg.vocab_size, (6,)).tolist(), 4)
        srv.run_until_complete(timeout_sec=120.0)
        srv._fault.serve_storm_at_step = srv._step_count + 4
        for _ in range(4):
            srv.submit(rng.integers(0, cfg.vocab_size, (6,)).tolist(), 8)
        res = dict(srv.run_until_complete(timeout_sec=120.0))
        del res[warm]
        assert len(res) == 4 + 12
        waits[mode] = [r["queue_wait_ms"] for r in res.values()
                       if r["status"] == "finished"
                       and r["queue_wait_ms"] is not None]
        if mode == "on":
            assert sum(r["status"] == "shed" for r in res.values()) > 0
            assert all(r["status"] in ("finished", "shed")
                       for r in res.values())
        else:
            assert all(r["status"] == "finished" for r in res.values())
    assert max(waits["on"]) < max(waits["off"])


# ---------------------------------------------------------------------------
# In-flight recovery + degradation ladder
# ---------------------------------------------------------------------------

RECOVERY_CASES = {
    "bucketed": {},
    "spec": {"spec_decode": True, "spec_k": 3},
    "chunked": {"chunked_prefill": True, "chunked_token_budget": 16},
    "prefix-int8": {"prefix_cache": True, "int8_kv_cache": True},
}


@pytest.mark.parametrize("case", sorted(RECOVERY_CASES))
def test_fault_retry_and_rebuild_are_token_identical(tiny, case):
    """A transient decode-dispatch fault heals inside the retry budget (no
    rebuild); a persistent window exhausts it and forces rebuild + replay.
    Both finish every request with the fault-free run's tokens and leak no
    block."""
    _jm, cfg, _params, sd = tiny
    p = _prompts(cfg, n=3)
    outs = [10, 6, 8]

    def run(fault):
        srv = _serve(sd, fault=fault, resilience=True,
                     resil_retry_base_sec=0.01, **RECOVERY_CASES[case])
        rids = [srv.submit(pp, n) for pp, n in zip(p, outs)]
        res = srv.run_until_complete(timeout_sec=120.0)
        if srv.prefix_cache is not None:
            srv.prefix_cache.clear()
        assert srv.pool.used_blocks == 0
        return [res[r]["tokens"] for r in rids], srv._resil.counters

    base, _ = run(None)
    transient, c1 = run({"serve_decode_fault_at_step": 3})
    assert transient == base
    assert c1["retries"] >= 1 and c1["recoveries"] == 0
    persistent, c2 = run({"serve_decode_fault_at_step": 3,
                          "serve_decode_fault_count": 3})
    assert persistent == base
    assert c2["recoveries"] >= 1


def test_fault_recovery_matches_jax(tiny):
    """The persistent-fault run of both packages under one plan: the same
    tokens, retries and recoveries."""
    jm, cfg, params, sd = tiny
    p = _prompts(cfg, n=3)
    outs = [10, 6, 8]
    fault = {"serve_decode_fault_at_step": 3, "serve_decode_fault_count": 3}
    got, counters = [], []
    for srv in (_serve(sd, fault=fault, resilience=True,
                       resil_retry_base_sec=0.01),
                _jax_serve(jm, params, fault=fault, resilience=True,
                           resil_retry_base_sec=0.01)):
        rids = [srv.submit(pp, n) for pp, n in zip(p, outs)]
        res = srv.run_until_complete(timeout_sec=120.0)
        got.append([res[r]["tokens"] for r in rids])
        counters.append(dict(srv._resil.counters))
    assert got[0] == got[1]
    assert counters[0] == counters[1]
    assert counters[0]["recoveries"] == 1


def test_fault_without_resilience_crashes_the_loop(tiny):
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, fault={"serve_decode_fault_at_step": 1})
    srv.submit(_prompts(cfg, n=1)[0], 8)
    with pytest.raises(RuntimeError, match="injected serving"):
        srv.run_until_complete(timeout_sec=120.0)


def test_degradation_ladder(tiny):
    """Anomalies climb speculation off -> gather attention -> halved
    batch cap, one rung per ``degrade_after``, never past 3; past rung 2
    no decode round takes the kernel path."""
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True, resil_degrade_after=2,
                 spec_decode=True, spec_k=2)
    resil = srv._resil
    assert srv._spec_k == 2 and srv._attn_impl == "kernel"
    resil.note_anomaly()
    assert resil.degraded_level == 0
    resil.note_anomaly()
    assert resil.degraded_level == 1 and srv._spec_k == 0
    resil.note_anomaly()
    resil.note_anomaly()
    assert resil.degraded_level == 2 and srv._attn_impl == "gather"
    resil.note_anomaly()
    resil.note_anomaly()
    assert resil.degraded_level == 3
    assert srv.sched.slot_cap == 1
    for _ in range(6):
        resil.note_anomaly()
    assert resil.degraded_level == 3
    rids = [srv.submit(pp, 5) for pp in _prompts(cfg, n=2)]
    res = srv.run_until_complete(timeout_sec=120.0)
    assert all(res[r]["status"] == "finished" for r in rids)
    assert srv.stats["kernel_steps"] == srv.stats["spec_rounds"] == 0
    assert max(srv.stats["slot_assignments"]) == 0      # one slot used


def test_degradation_ladder_on_cuda_keeps_the_kernel(tiny):
    """On a CUDA engine the ladder skips rung 2: speculation off, then the
    halved batch cap, and kernel #1 stays the decode attention (tensors on
    the card never take the plain gather path)."""
    _jm, _cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True, resil_degrade_after=2,
                 spec_decode=True, spec_k=2)
    srv.device = torch.device("cuda")       # what the manager sees
    resil = srv._resil
    for _ in range(2):
        resil.note_anomaly()
    assert resil.degraded_level == 1 and srv._spec_k == 0
    resil.note_anomaly()
    resil.note_anomaly()
    assert resil.degraded_level == 3 and srv._attn_impl == "kernel"
    assert srv.sched.slot_cap == 1
    for _ in range(6):
        resil.note_anomaly()
    assert resil.degraded_level == 3 and srv._attn_impl == "kernel"


@pytest.mark.parametrize("error", [
    RuntimeError("paged_decode_attention kernel launch failed: "
                 "an illegal memory access was encountered"),
    ValueError("paged_attention kernel takes float32 or bfloat16 q")],
    ids=["launch", "operands"])
def test_kernel_error_propagates_without_recovery(tiny, monkeypatch, error):
    """A kernel wrapper's own error is not a fault to recover from: it
    leaves ``step()`` at once, with no retry, no rebuild and no rung."""
    from deepspeed_tpu_torch.ops.transformer import paged_attention

    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, resilience=True, resil_max_retries=2,
                 resil_retry_base_sec=0.01, resil_degrade_after=1)
    srv.submit(_prompts(cfg, n=1)[0], 8)
    srv.step()                              # prefill and a first decode

    def failing(*args, **kwargs):
        raise error

    monkeypatch.setattr(paged_attention, "paged_decode_attention", failing)
    with pytest.raises(type(error), match=str(error)[:20]):
        srv.step()
    assert srv._resil.counters["retries"] == 0
    assert srv._resil.counters["recoveries"] == 0
    assert srv._resil.degraded_level == 0 and srv._attn_impl == "kernel"


def test_failed_allocation_heals_under_retry(tiny, monkeypatch):
    """A failed allocation is transient: the round is retried, and the
    run finishes with the fault-free tokens."""
    from deepspeed_tpu_torch.ops.transformer import paged_attention

    _jm, cfg, _params, sd = tiny
    prompt = _prompts(cfg, n=1)[0]
    base = _serve(sd, resilience=True)
    rid = base.submit(prompt, 8)
    want = base.run_until_complete(timeout_sec=120.0)[rid]["tokens"]

    srv = _serve(sd, resilience=True, resil_retry_base_sec=0.01)
    rid = srv.submit(prompt, 8)
    srv.step()
    kernel, failed = paged_attention.paged_decode_attention, []

    def once(*args, **kwargs):
        if not failed:
            failed.append(1)
            raise torch.OutOfMemoryError("CUDA out of memory")
        return kernel(*args, **kwargs)

    monkeypatch.setattr(paged_attention, "paged_decode_attention", once)
    got = srv.run_until_complete(timeout_sec=120.0)[rid]["tokens"]
    assert got == want
    assert srv._resil.counters["retries"] == 1
    assert srv._resil.counters["recoveries"] == 0


def test_slow_steps_climb_the_ladder(tiny):
    """A decode step slower than ``slow_step_ms`` is an anomaly."""
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, fault={"serve_slow_step_at_step": 1,
                            "serve_slow_step_seconds": 0.05,
                            "serve_slow_step_count": 2},
                 resilience=True, resil_slow_step_ms=30.0,
                 resil_degrade_after=2)
    rid = srv.submit(_prompts(cfg, n=1)[0], 6)
    res = srv.run_until_complete(timeout_sec=120.0)
    assert res[rid]["status"] == "finished"
    assert srv._resil.anomalies == 2 and srv._resil.degraded_level == 1


def test_run_until_complete_timeout_raises_with_diagnostics(tiny):
    _jm, cfg, _params, sd = tiny
    srv = _serve(sd, fault={"serve_slow_step_at_step": 0,
                            "serve_slow_step_seconds": 0.4,
                            "serve_slow_step_count": 100_000})
    srv.submit(_prompts(cfg, n=1)[0], 30)
    with pytest.raises(RuntimeError, match="wall-clock timeout") as exc:
        srv.run_until_complete(timeout_sec=0.3)
    assert "running=" in str(exc.value)
    assert "queue=" in str(exc.value)


def test_chaos_through_init_serving(tiny, tmp_path):
    """The config path: a ``serving.resilience`` block and a top-level
    ``resilience.fault_injection`` plan through ``init_serving`` serve
    (both were refused before the port had them), recover, and match the
    fault-free run."""
    _jm, cfg, _params, sd = tiny
    p = _prompts(cfg, n=3)

    def run(config):
        model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
        path = tmp_path / "serve.json"
        path.write_text(json.dumps(config))
        srv = deepspeed_tpu_torch.init_serving(
            model, config=str(path), params=sd, dtype=torch.float32,
            device="cpu")
        rids = [srv.submit(pp, 8) for pp in p]
        res = srv.run_until_complete(timeout_sec=120.0)
        return srv, [res[r]["tokens"] for r in rids]

    serving = {**SERVE, "resilience": {"max_retries": 2,
                                       "retry_base_sec": 0.01}}
    clean, base = run({"serving": serving})
    assert clean._resil is not None and clean._fault is None
    srv, got = run({"serving": serving, "resilience": {"fault_injection": {
        "serve_decode_fault_at_step": 4, "serve_decode_fault_count": 3}}})
    assert got == base
    assert srv._fault.serve_decode_fault_count == 3
    assert srv._resil.counters["retries"] >= 1
    assert srv._resil.counters["recoveries"] >= 1


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["bucketed", "chunked"])
def test_kernel_build_failure_raises_at_construction(tiny, monkeypatch,
                                                     chunked):
    """With resilience on and a CUDA device, the engine builds its path's
    kernels (#1; #2 when chunked) before anything else on the card: a
    kernel that cannot build (no ``nvcc`` here) raises from the
    constructor, never inside a guarded dispatch's retries. Resilience
    off builds nothing up front."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.transformer import (chunked_prefill,
                                                     paged_attention)

    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", "/nonexistent/kernels")
    monkeypatch.setattr(paged_attention, "_FN", None)
    monkeypatch.setattr(chunked_prefill, "_FN", None)
    monkeypatch.setattr(build, "_LIBS", {})
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    eng = deepspeed_tpu_torch.init_inference(
        model, params=tiny[3], dtype=torch.float32, device="cpu")
    eng.device = torch.device("cuda")      # what the engine sees
    over = ({"chunked_prefill": True, "chunked_token_budget": 16,
             "decode_attention": "gather"} if chunked else {})
    with pytest.raises(RuntimeError, match="nvcc not found") as err:
        ServeEngine(eng, config=ServingConfig(**{**SERVE, **over},
                                              resilience=True))
    assert ("'chunked_prefill'" if chunked else "'paged_attention'") in \
        str(err.value)
    # off: no build up front; construction goes on to the pools
    from deepspeed_tpu_torch.serving import engine as engine_mod

    def no_pools(*args, **kwargs):
        raise RuntimeError("pools reached")

    monkeypatch.setattr(engine_mod, "init_paged_pools", no_pools)
    with pytest.raises(RuntimeError, match="pools reached"):
        ServeEngine(eng, config=ServingConfig(**{**SERVE, **over}))


# ---------------------------------------------------------------------------
# FaultPlan and the retry helper against the JAX package's
# ---------------------------------------------------------------------------

PLANS = [
    {"serve_decode_fault_at_step": 3, "serve_decode_fault_count": 2},
    {"preempt_at_step": 3, "ckpt_write_errors": 2, "nan_loss_at_step": 5,
     "nan_loss_steps": 2, "hang_at_step": 7, "hang_seconds": 1.5},
    {"slice_preempt_at_step": 2, "slice_preempt_slice": 1,
     "rejoin_after_steps": 3, "serve_storm_at_step": 4,
     "serve_storm_requests": 2, "max_attempt": 1},
    {"serve_slow_step_at_step": 0, "serve_slow_step_seconds": 0.2,
     "serve_slow_step_count": 5, "corrupt_shard_at_step": 6},
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_fault_plan_parses_as_the_reference(i):
    """Every field, training keys included, parses as the JAX plan does;
    the environment override merges over the block; a later resume
    attempt than ``max_attempt`` leaves no plan."""
    block = PLANS[i]
    env = {"DSTPU_FAULT_PLAN": json.dumps({"serve_storm_requests": 3})}
    for e in ({}, env, {"DSTPU_RESUME_ATTEMPT": "1"},
              {"DSTPU_RESUME_ATTEMPT": "2"}):
        got = FaultPlan.resolve(block, env=e)
        want = JaxFaultPlan.resolve(block, env=e)
        if want is None:
            assert got is None
            continue
        assert dataclasses.asdict(got) == {
            f.name: getattr(want, f.name)
            for f in dataclasses.fields(want)}
        for attempt in range(12):
            assert got.should_serve_decode_fault(attempt) == \
                want.should_serve_decode_fault(attempt)
            assert got.should_serve_slow_step(attempt) == \
                want.should_serve_slow_step(attempt)
            assert got.should_serve_storm(attempt) == \
                want.should_serve_storm(attempt)


@pytest.mark.parametrize("bad", [
    {"ckpt_write_errors": -1}, {"nan_loss_steps": 0}, {"hang_seconds": 0},
    {"preempt_grace_seconds": 0}, {"rejoin_after_steps": 0},
    {"serve_decode_fault_count": 0}, {"serve_slow_step_seconds": 0},
    {"serve_slow_step_count": 0}, {"serve_storm_requests": 0},
    {"serve_decode_fault_typo": 1}])
def test_fault_plan_walls(bad):
    with pytest.raises(ValueError) as want:
        JaxFaultPlan.resolve(bad, env={})
    with pytest.raises(ValueError) as got:
        FaultPlan.resolve(bad, env={})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not a JSON object"):
        FaultPlan.resolve({}, env={"DSTPU_FAULT_PLAN": "{oops"})
    assert FaultPlan.resolve(None, env={}) is None


def test_backoff_and_retry_match_the_reference():
    """``backoff_delay`` equals the JAX helper's for one seeded jitter
    stream; ``retry_call`` retries ``max_retries`` times with those
    delays, then re-raises."""
    for args in ((0, 0.5), (3, 0.5), (40, 0.1, 2.0, 5.0), (2, 1.0, 3.0),
                 (5, 0.05, 2.0, None, 0.0)):
        got = backoff_delay(*args, rng=random.Random(7))
        want = jax_retry.backoff_delay(*args, rng=random.Random(7))
        assert got == want
    for bad in ((-1, 0.5), (0, -1.0)):
        with pytest.raises(ValueError):
            backoff_delay(*bad)
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_call(flaky, max_retries=3, base=0.5, jitter=0.0,
                      sleep=slept.append) == "ok"
    assert slept == [0.5, 1.0]
    with pytest.raises(OSError):
        retry_call(lambda: (_ for _ in ()).throw(OSError("down")),
                   max_retries=1, base=0.0, sleep=slept.append)
    with pytest.raises(ValueError):
        retry_call(flaky, max_retries=-1)


def test_resilience_config_parses_as_the_reference():
    """The ``serving.resilience`` block's fields and walls, as the JAX
    ``ServingConfig`` reads them."""
    block = {"max_queue_depth": 4, "max_queue_wait_ms": 250,
             "default_deadline_ms": 1000, "max_retries": 3,
             "retry_base_sec": 0.2, "degrade_after": 5, "slow_step_ms": 40}
    got = ServingConfig.from_dict({"resilience": block})
    want = JaxServingConfig.from_dict({"resilience": block})
    for f in dataclasses.fields(got):
        if f.name == "resilience" or f.name.startswith("resil_"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.resilience
    for key, value in (("max_queue_depth", 0), ("max_queue_wait_ms", 0),
                       ("default_deadline_ms", -1), ("max_retries", -1),
                       ("retry_base_sec", 0), ("degrade_after", 0),
                       ("slow_step_ms", 0)):
        with pytest.raises(ConfigError, match=f"resilience.{key}"):
            ServingConfig.from_dict({"resilience": {key: value}})

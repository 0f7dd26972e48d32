"""Port parity: the training guardrails (``deepspeed_tpu_torch/guardrails``)
case by case as ``tests/test_guardrails.py`` holds the JAX package's, on
the tiny GPT (2 layers, d 64) on the CPU.

- the detector: the same (step, loss, grad_norm, overflow) sequence gives
  the JAX detector's verdicts, reasons and z-scores exactly (the same host
  arithmetic), through warm-up, a non-finite value in warm-up, overflow as
  skip and a grad-norm spike;
- the ring and the policy: bounded ring (its pinned buffer sets reused),
  spike streak, rollback budget, an empty ring escalating to disk (and
  refusing without it), LR decay;
- snapshot and restore bit-exact, the continuation equal to a fresh run;
- the bf16 / fp32 non-finite gate on (the update skipped, one more counted
  read) and off (the NaN commits, the failure it exists for);
- the cost: with guardrails and telemetry off a step makes no read by the
  host of its own (the only tensor reads are the dropout-seed draws from
  the CPU generator), no telemetry sync and no snapshot; on, one counted
  read of (loss, grad norm) a step;
- end to end: the fault plan NaN-poisons two step attempts; the rollback
  restores the ring's newest snapshot and the committed losses and final
  masters equal a clean run's with the window cut out, bit for bit, and
  the clean run's losses equal the JAX GPT's within 1e-5 in fp32 on the
  converted weights; a spike step is never checkpointed; the rollback's
  telemetry;
- the watchdog: a trip through the clock seam in process (no sleep), and
  a supervised child that hangs without bound at step 3: exit code 113, a
  dump with the stacks (naming the hang), ``memory.json``, the metrics
  tail and ``info.json``, an immediate restart that resumes and finishes,
  and the goodput manifests finalized.

A GPT batch holds int token ids, which the fault plan's NaN-fill leaves as
they are (the reference does the same). So the guarded runs' loss
multiplies the GPT's token loss by the mean of a float per-row ``weight``
leaf of exact 1.0s, which the plan poisons; a clean step's loss is the
plain GPT loss, bit for bit.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.guardrails import AnomalyDetector as JaxDetector
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import guardrails as gr_mod
from deepspeed_tpu_torch.guardrails import (OK, SKIP, SPIKE, AnomalyDetector,
                                            GuardrailsError, RollbackPolicy,
                                            SnapshotRing, StepWatchdog,
                                            is_watchdog_exit,
                                            restore_snapshot, take_snapshot)
from deepspeed_tpu_torch.models import gpt_params_from_flax, make_gpt
from deepspeed_tpu_torch.models.adapter import module_loss_fn
from deepspeed_tpu_torch.resilience import (find_restorable,
                                            list_checkpoints)
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO, GAS, SEQ = 2, 2, 32


def _config(**extra):
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                    "eps": 1e-6}},
           "zero_optimization": {"stage": 2},
           "steps_per_print": 10_000}
    cfg.update(extra)
    return cfg


def _stream(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, (GAS, MICRO, SEQ),
                                       dtype=np.int32),
             "weight": np.ones((GAS, MICRO), np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def weights():
    """The JAX tiny GPT's initial params, and the port's state dict of
    them."""
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     {"input_ids": np.zeros((MICRO, SEQ), np.int32)}
                     )["params"]
    return jm, params, gpt_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params))


def _engine(sd, dtype=torch.float32, **extra):
    """The port's engine over the tiny GPT whose loss is weighted by the
    batch's ``weight`` leaf."""
    model, _ = make_gpt("tiny", dtype=dtype)
    model.load_state_dict(sd)
    base, params = module_loss_fn(model)

    def loss_fn(p, batch, rng):
        batch = dict(batch)
        w = batch.pop("weight")
        out = base(p, batch, rng)
        return (out[0] if isinstance(out, tuple) else out) * w.mean()

    return deepspeed_tpu_torch.initialize(
        model=model, loss_fn=loss_fn, params=params, config=_config(**extra),
        device="cpu")[0]


def _masters(engine):
    return [p.detach().clone() for p in engine.state.params]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _finite(engine):
    return all(bool(torch.isfinite(p).all()) for p in engine.state.params)


# ---------------------------------------------------------------------------
# The detector, against the JAX detector
# ---------------------------------------------------------------------------

_NAN, _INF = float("nan"), float("inf")
DETECTOR_CASES = {
    # a descent through warm-up, then a loss spike
    "warmup_then_loss_spike": (
        dict(warmup_steps=5, zscore_threshold=4.0),
        [(i, 4.0 - 0.1 * i, 1.0 + 0.01 * i, False) for i in range(12)]
        + [(12, 40.0, 1.1, False), (13, 2.9, 1.1, False)]),
    # NaN and inf are spikes at any step, warm-up included
    "nonfinite_in_warmup": (
        dict(warmup_steps=20),
        [(0, 3.0, 1.0, False), (1, _NAN, 1.0, False), (2, 2.9, _INF, False),
         (3, 2.8, 1.0, False)]),
    # an overflow step is a skip, and the trackers ignore its scalars
    "overflow_is_skip": (
        dict(warmup_steps=2),
        [(0, 3.0, 1.0, False), (1, 1e9, _NAN, True), (2, 2.9, 1.0, False),
         (3, 2.95, 1.0, False), (4, _NAN, 1.0, True)]),
    # a flat loss with a grad-norm spike; then without grad-norm tracking
    "grad_norm_spike": (
        dict(warmup_steps=3, zscore_threshold=6.0),
        [(i, 2.0 + 1e-3 * (i % 3), 0.5 + 1e-3 * i, False) for i in range(8)]
        + [(8, 2.001, 50.0, False), (9, 2.0, 0.51, False)]),
    "grad_norm_untracked": (
        dict(warmup_steps=3, zscore_threshold=6.0, track_grad_norm=False),
        [(i, 2.0 + 1e-3 * (i % 3), 0.5, False) for i in range(6)]
        + [(6, 2.001, 50.0, False), (7, 2.0, None, False)]),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_detector_matches_jax(case):
    kw, seq = DETECTOR_CASES[case]
    port, ref = AnomalyDetector(**kw), JaxDetector(**kw)
    for step, loss, norm, overflow in seq:
        got = port.observe(step, loss, grad_norm=norm, overflow=overflow)
        want = ref.observe(step, loss, grad_norm=norm, overflow=overflow)
        assert (got.kind, got.reason) == (want.kind, want.reason), step
        assert repr((got.loss_z, got.norm_z)) == repr((want.loss_z,
                                                       want.norm_z)), step
    assert port.stats == ref.stats
    assert port.state_dict() == ref.state_dict()
    if case == "overflow_is_skip":
        assert port.stats[SKIP] == 2 and port.stats[SPIKE] == 0
    elif case != "grad_norm_untracked":
        assert port.stats[SPIKE] >= 1


def test_detector_and_policy_arguments_checked():
    for kw in ({"zscore_threshold": 0}, {"warmup_steps": 0},
               {"ewma_alpha": 0}):
        with pytest.raises(ValueError):
            AnomalyDetector(**kw)
    for kw in ({"consecutive_spikes": 0}, {"skip_batches": -1},
               {"lr_decay": 0}, {"max_rollbacks": 0}):
        with pytest.raises(ValueError):
            RollbackPolicy(SnapshotRing(1), **kw)
    with pytest.raises(ValueError):
        StepWatchdog(timeout=0)
    assert is_watchdog_exit(113) and not is_watchdog_exit(1)


# ---------------------------------------------------------------------------
# The ring and the policy
# ---------------------------------------------------------------------------

def test_ring_bounded_newest_wins():
    ring = SnapshotRing(capacity=2)
    for i in range(5):
        ring.push(i)
    assert len(ring) == 2 and ring.newest() == 4
    ring.drop_newest()
    assert ring.newest() == 3
    with pytest.raises(ValueError):
        SnapshotRing(0)


def test_ring_reuses_its_buffer_sets(weights):
    """A ring of 2 over 5 snapshots allocates 2 buffer sets: the evicted
    snapshot's set is the next one's."""
    engine = _engine(weights[2])
    ring = SnapshotRing(capacity=2)
    for b in _stream(5):
        engine.train_batch(b)
        ring.take(engine)
    assert len(ring) == 2 and ring.pool.allocated == 2
    assert int(ring.newest().meta["step"]) == 5


def test_snapshot_restore_bit_exact(weights):
    sd = weights[2]
    engine = _engine(sd)
    for b in _stream(3):
        engine.train_batch(b)
    snap = take_snapshot(engine)
    at3 = _masters(engine)
    for b in _stream(2, seed=11):
        engine.train_batch(b)
    assert engine.global_steps == 5
    assert restore_snapshot(engine, snap) == 2
    assert engine.global_steps == 3 and engine.micro_steps == 3 * GAS
    _equal(_masters(engine), at3)
    fresh = _engine(sd)
    for b in _stream(3):
        fresh.train_batch(b)
    tail = _stream(2, seed=23)
    got = [repr(float(engine.train_batch(b))) for b in tail]
    want = [repr(float(fresh.train_batch(b))) for b in tail]
    assert got == want
    _equal(_masters(engine), _masters(fresh))


def test_policy_streak_and_budget(weights):
    ring = SnapshotRing(2)
    pol = RollbackPolicy(ring, consecutive_spikes=3)
    assert not pol.note_spike() and not pol.note_spike()
    pol.note_ok()
    assert not pol.note_spike() and not pol.note_spike()
    assert pol.note_spike()

    engine = _engine(weights[2])
    ring = SnapshotRing(4)
    pol = RollbackPolicy(ring, consecutive_spikes=1, max_rollbacks=1,
                         skip_batches=0)
    engine.train_batch(_stream(1)[0])
    ring.take(engine)
    ring.take(engine)
    pol.rollback(engine)
    assert len(ring) == 1
    with pytest.raises(GuardrailsError, match="budget exhausted"):
        pol.rollback(engine)


def test_empty_ring_without_disk_raises(weights):
    engine = _engine(weights[2])
    pol = RollbackPolicy(SnapshotRing(1), consecutive_spikes=1,
                         escalate_to_disk=False)
    with pytest.raises(GuardrailsError, match="no in-memory snapshot"):
        pol.rollback(engine)


def test_empty_ring_escalates_to_disk(weights, tmp_path):
    engine = _engine(weights[2], resilience={
        "enabled": True, "checkpoint": {"dir": str(tmp_path),
                                        "interval": 100,
                                        "backoff_seconds": 0.01}})
    for b in _stream(2):
        engine.train_batch(b)
    engine.save_checkpoint_async()
    engine.ckpt_manager.wait()
    at2 = _masters(engine)
    engine.train_batch(_stream(1, seed=9)[0])
    pol = RollbackPolicy(SnapshotRing(1), consecutive_spikes=1,
                         skip_batches=0)
    summary = pol.rollback(engine)
    assert summary["source"] == "disk" and engine.global_steps == 2
    _equal(_masters(engine), at2)
    engine.ckpt_manager.close()


def test_lr_decay_applies_on_rollback(weights):
    engine = _engine(weights[2], guardrails={
        "enabled": True, "rollback": {"lr_decay": 0.5}})
    engine.train_batch(_stream(1)[0])      # an ok step primes the ring
    assert len(engine.guardrails.ring) == 1
    engine.guardrails.policy.rollback(engine)
    assert engine.guardrails.lr_scale == 0.5
    assert engine.get_lr() == [5e-4]


# ---------------------------------------------------------------------------
# The bf16 / fp32 non-finite gate
# ---------------------------------------------------------------------------

def _poisoned_stream():
    s = _stream(4)
    s[1] = dict(s[1], weight=np.full((GAS, MICRO), np.nan, np.float32))
    return s


@pytest.mark.parametrize("bf16", [False, True])
def test_nonfinite_gate_skips_the_update(weights, bf16, monkeypatch):
    extra = {"bf16": {"enabled": True}} if bf16 else {}
    engine = _engine(weights[2], dtype=torch.bfloat16 if bf16
                     else torch.float32, guardrails={
                         "enabled": True,
                         "detector": {"check_nonfinite_grads": True},
                         "rollback": {"enabled": False}}, **extra)
    fetches = []
    orig = gr_mod._host_fetch
    monkeypatch.setattr(gr_mod, "_host_fetch",
                        lambda x: (fetches.append(1), orig(x))[1])
    s = _poisoned_stream()
    engine.train_batch(s[0])
    assert len(fetches) == 2            # the gate's flag, (loss, norm)
    before = _masters(engine)
    engine.train_batch(s[1])
    assert engine.skipped_steps == 1 and engine.state.step == 1
    _equal(_masters(engine), before)
    assert engine.guardrails.last_verdict.kind == SKIP
    engine.train_batch(s[2])
    assert engine.state.step == 2 and _finite(engine)
    assert len(fetches) == 6


def test_nonfinite_gate_off_nan_commits(weights):
    engine = _engine(weights[2], dtype=torch.bfloat16,
                     bf16={"enabled": True})
    s = _poisoned_stream()
    engine.train_batch(s[0])
    engine.train_batch(s[1])
    assert engine.skipped_steps == 0
    assert not _finite(engine)           # the failure the gate prevents


# ---------------------------------------------------------------------------
# The cost: nothing when off, the counted reads when on
# ---------------------------------------------------------------------------

_READS = ("item", "tolist", "__bool__", "__float__", "__int__", "numpy",
          "cpu")


def _count_reads(monkeypatch, engine, batches):
    """Counts of the tensor reads by the host and of the telemetry
    syncs, snapshots and guardrails fetches over ``batches``."""
    from deepspeed_tpu_torch.resilience import checkpoint as ckpt_mod
    from deepspeed_tpu_torch.utils import timer as timer_mod

    counts = {}

    def counting(owner, name):
        orig = getattr(owner, name)

        def shim(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(owner, name, shim)

    counting(gr_mod, "_host_fetch")
    counting(timer_mod, "_device_synchronize")
    counting(ckpt_mod, "snapshot_engine")
    with monkeypatch.context() as m:
        for name in _READS:
            orig = getattr(torch.Tensor, name)

            def shim(self, *a, _o=orig, _n=name, **k):
                counts[_n] = counts.get(_n, 0) + 1
                return _o(self, *a, **k)
            m.setattr(torch.Tensor, name, shim)
        for b in batches:
            engine.train_batch(b)
    return counts


def test_zero_reads_and_syncs_when_disabled(weights, monkeypatch):
    """Off (the default): no guardrails fetch, no telemetry sync, no
    snapshot, and no tensor read but the GAS dropout-seed draws a step
    from the engine's CPU generator, which the step path made before
    guardrails."""
    engine = _engine(weights[2])
    assert engine.guardrails is None and engine.goodput is None
    assert engine.numerics is None and not engine.telemetry.enabled
    steps = 4
    counts = _count_reads(monkeypatch, engine, _stream(steps))
    assert counts == {"__int__": steps * GAS}


def test_enabled_reads_are_counted(weights, monkeypatch):
    """On: one ``_host_fetch`` of the stacked (loss, grad norm) a step
    (one ``tolist``), the ring's snapshots at the first ok step and every
    interval, and still no telemetry sync (telemetry off)."""
    engine = _engine(weights[2], guardrails={
        "enabled": True, "rollback": {"snapshot_interval": 2}})
    steps = 4
    counts = _count_reads(monkeypatch, engine, _stream(steps))
    assert counts["_host_fetch"] == steps and counts["tolist"] == steps
    assert counts["snapshot_engine"] == 3          # steps 1, 2 and 4
    assert "_device_synchronize" not in counts
    assert engine.guardrails.detector.stats[OK] == steps
    assert engine.guardrails.detector.norm_tracker.count == steps


# ---------------------------------------------------------------------------
# End to end: the NaN window -> detect -> rollback -> replay past it
# ---------------------------------------------------------------------------

class _StreamLoader:
    def __init__(self, stream):
        self.stream = stream

    def __iter__(self):
        return iter(self.stream)


def _jax_losses(jm, params, stream):
    """The JAX engine's losses on the plain GPT loss (the weight leaf is
    1.0: a clean step's weighted loss is the plain one)."""
    eng, *_ = deepspeed_tpu.initialize(
        model=jm, params=params,
        config=DeepSpeedTPUConfig(_config(), world_size=1),
        mesh=build_mesh(devices=jax.devices()[:1]))
    return [float(eng.train_batch({"input_ids": b["input_ids"]}))
            for b in stream]


def test_nan_window_rollback_bit_identical_tail(weights):
    """The fault plan NaN-poisons step attempts k+1 and k+2; two spikes
    make the rollback restore the step-k snapshot (the poisoned batches
    already consumed). The committed losses and the final masters equal a
    clean run's over the same stream with the window cut out, bit for bit;
    the clean losses equal the JAX GPT's within 1e-5."""
    jm, params, sd = weights
    k, total = 4, 10
    stream = _stream(total + 2)
    guarded = _engine(sd, guardrails={
        "enabled": True,
        "detector": {"zscore_threshold": 1e9, "warmup_steps": 1},
        "rollback": {"snapshot_interval": 1, "ring_size": 2,
                     "consecutive_spikes": 2, "skip_batches": 0}},
        resilience={"fault_injection": {"nan_loss_at_step": k + 1,
                                        "nan_loss_steps": 2}})
    loader = RepeatingLoader(_StreamLoader(stream))
    guarded.register_data_skip_fn(loader.skip_batches)
    losses, attempts = {}, 0
    while guarded.global_steps < total:
        before = guarded.global_steps
        loss = guarded.train_batch(next(loader))
        if guarded.global_steps == before + 1:
            losses[guarded.global_steps] = repr(float(loss))
        attempts += 1
        assert attempts < 50, "rollback did not converge"
    gr = guarded.guardrails
    assert gr.policy.rollbacks == 1 and gr.detector.stats[SPIKE] == 2
    assert guarded.step_attempts == total + 2
    assert _finite(guarded)
    assert all(np.isfinite(float(v)) for v in losses.values())

    clean = _engine(sd)
    clean_stream = stream[:k] + stream[k + 2:]
    clean_losses = {}
    for b in clean_stream[:total]:
        loss = clean.train_batch(b)
        clean_losses[clean.global_steps] = repr(float(loss))
    assert losses == clean_losses
    _equal(_masters(guarded), _masters(clean))

    want = _jax_losses(jm, params, clean_stream[:total])
    got = [float(clean_losses[i + 1]) for i in range(total)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_spike_steps_never_checkpointed(weights, tmp_path):
    """The interval save is gated on the verdict: no checkpoint holds a
    spike step's (NaN) masters."""
    engine = _engine(weights[2], guardrails={
        "enabled": True,
        "detector": {"zscore_threshold": 1e9, "warmup_steps": 1},
        "rollback": {"snapshot_interval": 1, "consecutive_spikes": 2,
                     "skip_batches": 0}},
        resilience={"enabled": True,
                    "fault_injection": {"nan_loss_at_step": 3,
                                        "nan_loss_steps": 2},
                    "checkpoint": {"dir": str(tmp_path), "interval": 1,
                                   "keep_last": 10,
                                   "backoff_seconds": 0.01,
                                   "async": False}})
    stream = _stream(10)
    i = 0
    while engine.global_steps < 6:
        engine.train_batch(stream[i % len(stream)])
        i += 1
    assert engine.guardrails.policy.rollbacks == 1
    steps = [s for s, _ in list_checkpoints(str(tmp_path))]
    assert steps == [1, 2, 3, 4, 5, 6]      # 3 and 4 saved after replay
    _path, _m, arrays, _cs = find_restorable(str(tmp_path))
    for name, arr in arrays.items():
        if name.startswith("params"):
            assert np.isfinite(arr).all(), name
    engine.ckpt_manager.close()


def test_rollback_emits_telemetry(weights, tmp_path):
    """Counters, the spike and rollback instants, the spike dump naming a
    worst group, and goodput's rollback_restore and rollback_replay."""
    dump = tmp_path / "dumps"
    engine = _engine(weights[2], guardrails={
        "enabled": True,
        "detector": {"zscore_threshold": 1e9, "warmup_steps": 1},
        "rollback": {"snapshot_interval": 1, "consecutive_spikes": 1,
                     "skip_batches": 0},
        "watchdog": {"crashdump_dir": str(dump)}},
        resilience={"fault_injection": {"nan_loss_at_step": 3}},
        telemetry={"enabled": True, "dir": str(tmp_path / "run"),
                   "trace": {"sync_spans": False},
                   "numerics": {"enabled": True}})
    stream = _stream(8)
    i = 0
    while engine.global_steps < 5:
        engine.train_batch(stream[i % len(stream)])
        i += 1
    engine.close()
    rows = [json.loads(line) for line in open(tmp_path / "run" /
                                              "metrics.jsonl")]
    tags = {r["tag"] for r in rows}
    assert {"guardrails/steps_ok", "guardrails/steps_spike",
            "guardrails/rollbacks", "guardrails/snapshots",
            "guardrails/loss_zscore"} <= tags
    doc = json.load(open(tmp_path / "run" / "trace.json"))
    instants = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "i"}
    assert {"guardrails_spike", "guardrails_rollback"} <= instants
    spans = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"dataloader", "train_step"} <= spans
    dumps = [d for d in os.listdir(dump) if d.startswith("spike_step3_")]
    info = json.load(open(dump / dumps[0] / "info.json"))
    assert info["worst_group"] in {g["group"] for g in info["groups"]}
    assert not all(g["finite"] for g in info["groups"])
    (manifest,) = [f for f in os.listdir(tmp_path / "run")
                   if f.startswith("run_manifest.")]
    cats = json.load(open(tmp_path / "run" / manifest))["categories"]
    assert cats["rollback_restore"] > 0 and cats["rollback_replay"] > 0


# ---------------------------------------------------------------------------
# The watchdog
# ---------------------------------------------------------------------------

def test_watchdog_trips_through_the_clock_seam(tmp_path):
    """Armed at t=0, the deadline 30 s: a poll at t=29 passes, one at t=31
    trips (no sleep); the dump holds the stacks, memory.json, the metrics
    tail and info.json, and exit_fn gets 113. Between steps, idle time
    never trips."""
    now = [0.0]
    exits = []
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(json.dumps({"tag": "t", "value": i,
                                           "step": i}) + "\n"
                               for i in range(5)))
    wd = StepWatchdog(timeout=30.0, crashdump_dir=str(tmp_path / "d"),
                      metrics_tail_of=str(metrics), exit_fn=exits.append,
                      clock=lambda: now[0])
    wd.step_begin(7)
    now[0] = 29.0
    assert not wd.check() and not exits
    wd.step_end()
    now[0] = 1000.0
    assert not wd.check()                    # disarmed between steps
    wd.step_begin(8)
    wd.step_begin(8)                         # re-entrant: still armed once
    now[0] = 1031.0
    assert wd.check() and exits == [113] and wd.tripped
    (out,) = os.listdir(tmp_path / "d")
    files = set(os.listdir(tmp_path / "d" / out))
    assert {"stacks.txt", "memory.json", "metrics_tail.jsonl",
            "info.json"} <= files
    info = json.load(open(tmp_path / "d" / out / "info.json"))
    assert info["step"] == 8 and info["exit_code"] == 113
    assert info["elapsed_sec"] == 31.0
    mem = json.load(open(tmp_path / "d" / out / "memory.json"))
    assert "devices" in mem and "min_headroom_bytes" in mem
    assert "test_watchdog_trips" in open(
        tmp_path / "d" / out / "stacks.txt").read()


_HANG_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np, torch
    torch.set_num_threads(1)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import init_gpt_params, make_gpt

    ckpt, dump, run, out, total = sys.argv[2:6] + [int(sys.argv[6])]
    model, cfg = make_gpt("tiny", dtype=torch.float32)
    engine = deepspeed_tpu_torch.initialize(
        model=model, params=init_gpt_params(cfg, seed=0), device="cpu",
        config={"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "steps_per_print": 1,
                "resilience": {"enabled": True, "checkpoint": {
                    "dir": ckpt, "interval": 1, "async": False}},
                "telemetry": {"enabled": True, "dir": run,
                              "trace": {"sync_spans": False}},
                "guardrails": {"enabled": True,
                               "rollback": {"enabled": False},
                               "watchdog": {"enabled": True,
                                            "step_timeout_seconds": 5.0,
                                            "poll_interval_seconds": 0.1,
                                            "crashdump_dir": dump}}})[0]
    engine.auto_resume()
    rng = np.random.default_rng(7)
    stream = [rng.integers(0, 512, (2, 2, 16), dtype=np.int32)
              for _ in range(total)]
    with open(out, "a", buffering=1) as f:
        for i in range(engine.global_steps, total):
            loss = float(engine.train_batch({"input_ids": stream[i]}))
            f.write(json.dumps({"step": i + 1, "loss": repr(loss)}) + "\\n")
    engine.close()
""")


def test_hang_watchdog_supervised_resume(tmp_path):
    """The fault plan hangs step attempt 3 without bound (an event nothing
    sets, for an hour); the watchdog's 5 s deadline ends the child with 113
    and a dump; the supervisor restarts it at once, the fault plan is inert
    on attempt 1, and the resumed child finishes from step 2's
    checkpoint. Nothing here depends on how fast the trip comes: the outer
    limit is 300 s."""
    total = 5
    ckpt, dump, run = tmp_path / "ckpt", tmp_path / "dump", tmp_path / "run"
    out = tmp_path / "losses.jsonl"
    env = dict(os.environ, DSTPU_FAULT_PLAN=json.dumps(
        {"hang_at_step": 3, "hang_seconds": 3600}))
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.resilience.supervisor",
         "--max_restarts", "2", "--backoff", "30", "--run_dir", str(run),
         "--", sys.executable, "-c", _HANG_CHILD, REPO, str(ckpt), str(dump),
         str(run), str(out), str(total)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    dumps = [d for d in os.listdir(dump) if d.startswith("watchdog_")]
    assert len(dumps) == 1 and dumps[0].startswith("watchdog_step3_")
    files = set(os.listdir(dump / dumps[0]))
    assert {"stacks.txt", "memory.json", "metrics_tail.jsonl",
            "info.json"} <= files
    assert "in hang" in open(dump / dumps[0] / "stacks.txt").read()
    info = json.load(open(dump / dumps[0] / "info.json"))
    assert info["exit_code"] == 113 and info["step"] == 3
    rows = [json.loads(line) for line in open(out)]
    assert [r["step"] for r in rows] == list(range(1, total + 1))
    assert [s for s, _ in list_checkpoints(str(ckpt))][-1] == total
    manifests = sorted(f for f in os.listdir(run)
                       if f.startswith("run_manifest."))
    docs = [json.load(open(run / f)) for f in manifests]
    assert [(d["attempt"], d["exit_rc"], d["restart_cause"])
            for d in docs] == [(0, 113, "watchdog"), (1, 0, "clean")]
    assert docs[1]["first_step"] == 3 and docs[1]["steps_committed"] == total
    report = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "goodput_report.py"),
         str(run), "--json"], capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stderr
    merged = json.loads(report.stdout)
    assert merged["n_attempts"] == 2 and merged["n_restarts"] == 1

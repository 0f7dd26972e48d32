"""Port parity: preemption-safe training (``deepspeed_tpu_torch/resilience``)
case by case as ``tests/test_resilience.py`` holds the JAX package, on the
tiny GPT on the CPU.

- the async manager: atomic commit, the manifest, keep-last GC, the
  double buffer (latest wins), injected write errors retried, a write that
  fails for good never kills training, digest fallback past a corrupt
  shard, ``.tmp-`` residue ignored, a fresh start without checkpoints;
- a snapshot holds the state of its step although the engine updates in
  place while the writer is held;
- the fault plan (env override, unknown keys, inert after its restart,
  the unported training keys refused at ``initialize``) and the config
  walls, against the JAX parser;
- the supervisor's restart loop and exit-code classes;
- end to end: a supervised child preempted by SIGTERM at step 3 (with one
  injected write error) resumes from step 2, and its loss trajectory, fed
  through
  ``initialize(training_data=...)``, ``RepeatingLoader`` and
  ``PrefetchLoader`` at dropout 0.1, is bit-identical to an uninterrupted
  run;
- across packages: the JAX manager's directory restores into the port
  (``models/convert.state_arrays_from_flax``), whose next loss is within
  1e-5 of JAX's; the port's directory read by JAX's ``find_restorable``
  gives the port's arrays.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import ConfigError as JaxConfigError
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.resilience import find_restorable as jax_find_restorable
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import (gpt_params_from_flax, make_gpt,
                                        state_arrays_from_flax)
from deepspeed_tpu_torch.resilience import (FAULT_PLAN_ENV,
                                            RESUME_ATTEMPT_ENV, FaultPlan,
                                            ResilienceError, Supervisor,
                                            corrupt_one_shard,
                                            find_restorable,
                                            list_checkpoints, restore)
from deepspeed_tpu_torch.resilience.checkpoint import (MANIFEST_FILE,
                                                       METRICS_FILE,
                                                       MetricsJSONL)
from deepspeed_tpu_torch.resilience.fault import TRAINING_UNPORTED_KEYS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO, GAS, SEQ = 2, 2, 16


def _config(ckpt_dir, interval=1, keep_last=3, fault_injection=None,
            async_write=True, grad_accum=None):
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2},
                         "fused_update": True},
           "steps_per_print": 1000,
           "resilience": {
               "enabled": True,
               "checkpoint": {"dir": str(ckpt_dir), "interval": interval,
                              "keep_last": keep_last, "async": async_write,
                              "backoff_seconds": 0.01},
               "fault_injection": fault_injection or {}}}
    if grad_accum:
        cfg["data_types"] = {"grad_accum_dtype": grad_accum}
    return cfg


def _make_engine(ckpt_dir, dropout=0.1, **kw):
    from deepspeed_tpu_torch.models import init_gpt_params

    model, cfg = make_gpt("tiny", dtype=torch.float32, dropout_rate=dropout)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, params=init_gpt_params(cfg, seed=0), device="cpu",
        config=_config(ckpt_dir, **kw), rng_seed=0)
    return engine


def _stream(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, (GAS, MICRO, SEQ),
                                       dtype=np.int32)} for _ in range(n)]


def _leaves(engine):
    return [(n, leaf.clone() if isinstance(leaf, torch.Tensor) else leaf)
            for n, leaf in engine._snapshot_state()]


def _assert_same_state(a, b):
    for (na, x), (nb, y) in zip(_leaves(a), _leaves(b)):
        assert na == nb
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), na
        else:
            assert x == y, na


# ---------------------------------------------------------------------------
# The async manager
# ---------------------------------------------------------------------------

def test_async_commit_manifest_and_roundtrip(tmp_path):
    e1 = _make_engine(tmp_path)
    for b in _stream(3):
        e1.train_batch(b)
        e1.ckpt_manager.wait()    # every step commits (none superseded)
    ckpts = list_checkpoints(str(tmp_path))
    assert [s for s, _ in ckpts] == [1, 2, 3]
    manifest = json.load(open(os.path.join(ckpts[-1][1], MANIFEST_FILE)))
    assert manifest["step"] == 3 and manifest["format"] == 1
    assert manifest["dp_world_size"] == 1 and manifest["zero_stage"] == 0
    assert "params.h.0.c_attn.weight" in manifest["shards"]
    for rec in manifest["shards"].values():
        assert set(rec) >= {"file", "sha256", "shape", "dtype",
                            "stored_dtype"}
    assert manifest["shards"]["rng"]["dtype"] == "uint8"
    assert manifest["shards"]["step"]["shape"] == []

    e2 = _make_engine(tmp_path)
    path, _ = e2.auto_resume()
    assert path == ckpts[-1][1]
    assert e2.global_steps == 3 and e2.micro_steps == 3 * GAS
    _assert_same_state(e1, e2)
    rows = MetricsJSONL(os.path.join(tmp_path, METRICS_FILE)).read(
        "Train/Checkpoint/write_latency_sec")
    assert [r["step"] for r in rows] == [1, 2, 3]
    e1.ckpt_manager.close()
    e2.ckpt_manager.close()


def test_bit_identical_continuation_after_resume(tmp_path):
    stream = _stream(6)
    e1 = _make_engine(tmp_path)
    for b in stream[:3]:
        e1.train_batch(b)
    e1.ckpt_manager.wait()
    e2 = _make_engine(tmp_path)
    e2.auto_resume()
    cont1 = [repr(float(e1.train_batch(b))) for b in stream[3:]]
    cont2 = [repr(float(e2.train_batch(b))) for b in stream[3:]]
    assert cont1 == cont2
    e1.ckpt_manager.close()
    e2.ckpt_manager.close()


def test_bf16_accumulator_leaf_stored_widened(tmp_path):
    """numpy has no bf16: the accumulator is stored as fp32 under the
    dtype "bfloat16" and restored bit for bit."""
    e1 = _make_engine(tmp_path, grad_accum="bfloat16")
    e1.forward({"input_ids": _stream(1)[0]["input_ids"][0]})
    e1.save_checkpoint_async()
    e1.ckpt_manager.wait()
    manifest = json.load(open(os.path.join(
        list_checkpoints(str(tmp_path))[-1][1], MANIFEST_FILE)))
    rec = manifest["shards"]["grad_acc.wte"]
    assert (rec["dtype"], rec["stored_dtype"]) == ("bfloat16", "float32")
    e2 = _make_engine(tmp_path, grad_accum="bfloat16")
    e2.auto_resume()
    assert e2.state.grad_acc[0].dtype == torch.bfloat16
    assert any(bool(a.any()) for a in e1.state.grad_acc)
    for a, b in zip(e1.state.grad_acc, e2.state.grad_acc):
        assert torch.equal(a, b)
    e1.ckpt_manager.close()
    e2.ckpt_manager.close()


def test_gc_keeps_last_n(tmp_path):
    e = _make_engine(tmp_path, keep_last=2)
    for b in _stream(5):
        e.train_batch(b)
        e.ckpt_manager.wait()
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [4, 5]
    e.ckpt_manager.close()


def test_double_buffer_latest_wins_and_snapshots_hold_their_step(tmp_path):
    """While the writer is held, newer snapshots replace the pending one;
    the engine updates its masters and moments in place meanwhile, yet the
    committed checkpoint holds the state of its own step, and no more than
    three host buffer sets exist."""
    e = _make_engine(tmp_path)
    mgr = e.ckpt_manager
    mgr._unpaused.clear()
    states = []
    for b in _stream(4):
        e.train_batch(b)
        states.append(_leaves(e))
    assert mgr.stats["dropped"] >= 2
    mgr._unpaused.set()
    mgr.wait()
    steps = [s for s, _ in list_checkpoints(str(tmp_path))]
    assert steps[-1] == 4 and 2 not in steps and 3 not in steps
    assert mgr._pool.allocated <= 3
    _p, manifest, arrays, _c = find_restorable(str(tmp_path))
    for name, leaf in states[3]:
        want = (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf))
        np.testing.assert_array_equal(arrays[name], want, err_msg=name)
    mgr.close()


def test_injected_io_error_retries_then_commits(tmp_path):
    e = _make_engine(tmp_path, fault_injection={"ckpt_write_errors": 2})
    assert e.fault_plan is not None
    e.train_batch(_stream(1)[0])
    e.ckpt_manager.wait()
    assert e.ckpt_manager.stats == {"saved": 1, "dropped": 0, "retries": 2,
                                    "failed": 0}
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1]
    e.ckpt_manager.close()


def test_write_failure_never_kills_training(tmp_path):
    e = _make_engine(tmp_path, fault_injection={"ckpt_write_errors": 99})
    e.ckpt_manager.max_retries = 1
    losses = []
    for b in _stream(2):
        losses.append(float(e.train_batch(b)))
        e.ckpt_manager.wait()
    assert all(np.isfinite(losses))
    assert e.ckpt_manager.stats["failed"] == 2
    assert list_checkpoints(str(tmp_path)) == []
    assert isinstance(e.ckpt_manager.last_error, OSError)
    e.ckpt_manager.close()


def test_sync_write_manager_writes_inline(tmp_path):
    e = _make_engine(tmp_path, async_write=False, interval=2)
    for b in _stream(4):
        e.train_batch(b)
    assert e.ckpt_manager._thread is None
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [2, 4]
    e.ckpt_manager.close()


# ---------------------------------------------------------------------------
# Corruption: digest verification and fallback
# ---------------------------------------------------------------------------

def test_corrupt_shard_falls_back_to_previous(tmp_path):
    e1 = _make_engine(tmp_path)
    for b in _stream(2):
        e1.train_batch(b)
        e1.ckpt_manager.wait()
    ckpts = list_checkpoints(str(tmp_path))
    assert [s for s, _ in ckpts] == [1, 2]
    manifest = json.load(open(os.path.join(ckpts[1][1], MANIFEST_FILE)))
    corrupt_one_shard(ckpts[1][1], manifest)
    path, found, _, _ = find_restorable(str(tmp_path))
    assert path == ckpts[0][1] and found["step"] == 1
    e2 = _make_engine(tmp_path)
    rpath, _ = e2.auto_resume()
    assert rpath == ckpts[0][1] and e2.global_steps == 1
    e1.ckpt_manager.close()
    e2.ckpt_manager.close()


def test_corrupt_injection_at_step(tmp_path):
    e = _make_engine(tmp_path, fault_injection={"corrupt_shard_at_step": 2})
    for b in _stream(2):
        e.train_batch(b)
        e.ckpt_manager.wait()
    _path, manifest, _, _ = find_restorable(str(tmp_path))
    assert manifest["step"] == 1
    e.ckpt_manager.close()


def test_tmp_dirs_and_junk_never_considered(tmp_path):
    e = _make_engine(tmp_path)
    e.train_batch(_stream(1)[0])
    e.ckpt_manager.wait()
    os.makedirs(tmp_path / ".tmp-step_00000009")
    os.makedirs(tmp_path / "step_notanumber")
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1]
    e.ckpt_manager.close()


def test_no_checkpoint_means_fresh_start(tmp_path):
    e = _make_engine(tmp_path)
    assert e.auto_resume() == (None, {})
    assert e.global_steps == 0
    e.ckpt_manager.close()


def test_restore_into_another_model_raises(tmp_path):
    e1 = _make_engine(tmp_path)
    e1.train_batch(_stream(1)[0])
    e1.ckpt_manager.wait()
    model, _ = make_gpt("tiny", dtype=torch.float32, hidden_size=32)
    e2, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu", config=_config(tmp_path / "other"))
    with pytest.raises(ResilienceError, match="shape"):
        restore(e2, str(tmp_path))
    model, _ = make_gpt("tiny", dtype=torch.float32, num_layers=3)
    e3, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu", config=_config(tmp_path / "other3"))
    with pytest.raises(ResilienceError, match="lacks state leaves"):
        restore(e3, str(tmp_path))
    for e in (e1, e2, e3):
        e.ckpt_manager.close()


def test_client_state_rides_checkpoints(tmp_path):
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    e = _make_engine(tmp_path)
    loader = RepeatingLoader(list(range(4)))
    e.register_client_state_fn(lambda: {"loader": loader.state_dict()})
    for b in _stream(3):
        next(loader)
        e.train_batch(b)
    e.ckpt_manager.wait()
    _, _, _, client = find_restorable(str(tmp_path))
    assert client["loader"] == {"epoch": 0, "batch_in_epoch": 3}
    e.ckpt_manager.close()
    with pytest.raises(RuntimeError, match="requires the resilience block"):
        _linear = make_gpt("tiny", dtype=torch.float32)[0]
        deepspeed_tpu_torch.initialize(
            model=_linear, device="cpu",
            config={"train_batch_size": 2})[0].save_checkpoint_async()


# ---------------------------------------------------------------------------
# FaultPlan and the config, against the JAX package
# ---------------------------------------------------------------------------

def test_fault_plan_env_override_and_unknown_keys(monkeypatch):
    monkeypatch.setenv(FAULT_PLAN_ENV, '{"preempt_at_step": 4}')
    plan = FaultPlan.resolve({"ckpt_write_errors": 1})
    assert plan.preempt_at_step == 4 and plan.ckpt_write_errors == 1
    assert plan.take_io_error() and not plan.take_io_error()
    assert plan.should_preempt(4) and not plan.should_preempt(3)
    monkeypatch.setenv(FAULT_PLAN_ENV, '{"not_a_fault": 1}')
    with pytest.raises(ValueError, match="unknown fault_injection keys"):
        FaultPlan.resolve({})
    monkeypatch.setenv(FAULT_PLAN_ENV, "not json")
    with pytest.raises(ValueError, match="not a JSON object"):
        FaultPlan.resolve({})
    monkeypatch.delenv(FAULT_PLAN_ENV)
    assert FaultPlan.resolve({}) is None and FaultPlan.resolve(None) is None


def test_fault_plan_inert_after_its_restart(monkeypatch):
    block = {"preempt_at_step": 2}
    assert FaultPlan.resolve(block).should_preempt(2)
    monkeypatch.setenv(RESUME_ATTEMPT_ENV, "1")
    assert FaultPlan.resolve(block) is None
    assert FaultPlan.resolve({**block, "max_attempt": 1}) is not None


@pytest.mark.parametrize("key", TRAINING_UNPORTED_KEYS)
def test_unported_training_fault_keys_raise_at_initialize(key, monkeypatch,
                                                          tmp_path):
    """A plan key whose hook belongs to live elasticity is
    refused (in the block and in the environment), where it would
    otherwise be inert; the JAX parser takes the same block."""
    value = 1 if key != "slice_preempt_slice" else 0
    block = {"train_batch_size": 2,
             "resilience": {"fault_injection": {key: value}}}
    DeepSpeedTPUConfig(dict(block), world_size=1)
    model = make_gpt("tiny", dtype=torch.float32)[0]
    with pytest.raises(ConfigError, match="not yet ported") as err:
        deepspeed_tpu_torch.initialize(model=model, device="cpu",
                                       config=block)
    assert key in str(err.value)
    monkeypatch.setenv(FAULT_PLAN_ENV, json.dumps({key: value}))
    with pytest.raises(ConfigError, match="not yet ported"):
        deepspeed_tpu_torch.initialize(model=model, device="cpu",
                                       config={"train_batch_size": 2})


@pytest.mark.parametrize("block", [
    {"enabled": True}, {"enabled": True, "checkpoint": {"dir": "x",
                                                        "interval": 0}},
    {"enabled": True, "checkpoint": {"dir": "x", "keep_last": 0}},
    {"checkpoint": {"dir": "x", "max_retries": -1}},
    {"enabled": True, "checkpoint": {"dir": "x", "interval": 5,
                                     "async": False}},
    {"auto_resume": False, "fault_injection": {"preempt_at_step": 2}}])
def test_config_validation(block):
    d = {"train_micro_batch_size_per_gpu": 1, "resilience": block}
    try:
        want = DeepSpeedTPUConfig(dict(d), world_size=1).resilience
    except JaxConfigError:
        with pytest.raises(ConfigError):
            DeepSpeedConfig(dict(d))
        return
    got = DeepSpeedConfig(dict(d)).resilience
    assert (got.enabled, got.auto_resume, got.fault_injection) == (
        want.enabled, want.auto_resume, want.fault_injection)
    assert got.checkpoint.__dict__ == want.checkpoint.__dict__


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------

def test_supervisor_restarts_until_success(tmp_path):
    marker = tmp_path / "died_once"
    script = textwrap.dedent(f"""
        import os, sys
        attempt = int(os.environ.get({RESUME_ATTEMPT_ENV!r}, "0"))
        with open({str(tmp_path / "attempts.log")!r}, "a") as f:
            f.write(str(attempt) + "\\n")
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()
            sys.exit(17)
        sys.exit(0)
    """)
    sup = Supervisor([sys.executable, "-c", script], max_restarts=3,
                     backoff=0.01, ckpt_dir=str(tmp_path / "ck"))
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.exit_codes == [17, 0]
    assert open(tmp_path / "attempts.log").read().split() == ["0", "1"]
    rows = MetricsJSONL(str(tmp_path / "ck" / METRICS_FILE)).read()
    assert [r["tag"] for r in rows] == ["Train/Resilience/worker_exit_code",
                                        "Train/Resilience/recovery_count"]


def test_supervisor_gives_up_after_budget():
    sup = Supervisor([sys.executable, "-c", "import sys; sys.exit(3)"],
                     max_restarts=2, backoff=0.01)
    assert sup.run() == 3 and sup.exit_codes == [3, 3, 3]


@pytest.mark.parametrize("rc,codes,immediate", [(114, [114], 0),
                                                (113, [113, 113], 1),
                                                (115, [115, 115], 0)])
def test_supervisor_exit_code_classes(rc, codes, immediate):
    """The OOM rc ends the loop at once; the watchdog rc restarts with no
    delay; the warned-preemption rc restarts as any death."""
    sup = Supervisor([sys.executable, "-c", f"import sys; sys.exit({rc})"],
                     max_restarts=1, backoff=0.01)
    assert sup.run() == rc
    assert sup.exit_codes == codes
    assert sup.immediate_restarts == immediate
    assert sup.oom_exits == (rc == 114)


def test_supervisor_unported_arguments_raise():
    """``available_worlds`` (the elastic world) is refused; ``run_dir``
    (the goodput manifests) is taken since the guardrails slice."""
    assert Supervisor(["true"], run_dir="run").run_dir == "run"
    with pytest.raises(ConfigError, match="not yet ported"):
        Supervisor(["true"], available_worlds=lambda a: 1)


# ---------------------------------------------------------------------------
# End to end: SIGTERM at step k -> supervisor -> auto-resume -> the same
# trajectory, bit for bit
# ---------------------------------------------------------------------------

_TRAIN_SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[4])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import init_gpt_params, make_gpt
    from deepspeed_tpu_torch.runtime.dataloader import (PrefetchLoader,
                                                        RepeatingLoader)

    ckpt_dir, total_steps, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    model, cfg = make_gpt("tiny", dtype=torch.float32, dropout_rate=0.1)
    rng = np.random.default_rng(7)
    data = [{"input_ids": rng.integers(0, 512, 16, dtype=np.int32)}
            for _ in range(10)]
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, params=init_gpt_params(cfg, seed=0), device="cpu",
        training_data=data, rng_seed=0,
        config={"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2},
                              "fused_update": True},
                "steps_per_print": 1000,
                "resilience": {"enabled": True,
                               "checkpoint": {"dir": ckpt_dir,
                                              "interval": 1,
                                              "backoff_seconds": 0.01}}})
    rep = RepeatingLoader(loader)
    consumed = {}
    engine.register_client_state_fn(lambda: {"loader": dict(consumed)})
    _path, client = engine.auto_resume()
    if client:
        rep.load_state_dict(client["loader"])

    def groups():
        # each step's [GAS, micro, S] batch, with the loader's position
        # after it (the prefetch reads ahead of the steps)
        while True:
            micro = [next(rep) for _ in range(2)]
            yield rep.state_dict(), {"input_ids": torch.stack(
                [m["input_ids"] for m in micro])}

    stream = iter(PrefetchLoader(
        groups(), lambda sb: (sb[0], engine.put_batch(
            sb[1], leading_gas_dim=True))))
    with open(out, "a", buffering=1) as f:
        for i in range(engine.global_steps, total_steps):
            pos, batch = next(stream)
            consumed.update(pos)
            loss = float(engine.train_batch(batch))
            f.write(json.dumps({"step": i + 1, "loss": repr(loss)}) + "\\n")
            # each step's checkpoint commits before the next step: the
            # preemption after step 3 then tears step 3's write only
            engine.ckpt_manager.wait()
    engine.ckpt_manager.close()
    mods = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax")
            or m.split(".")[0] == "deepspeed_tpu"]
    assert not mods, mods
""")


def _trajectory(path):
    out = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            out[row["step"]] = row["loss"]
    return out


def _child_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_sigterm_resume_bit_identical_trajectory(tmp_path):
    total = 6
    faulted = tmp_path / "faulted"
    faulted.mkdir()
    env = _child_env()
    env[FAULT_PLAN_ENV] = json.dumps({"preempt_at_step": 3,
                                      "ckpt_write_errors": 1})
    sup = Supervisor(
        [sys.executable, "-c", _TRAIN_SCRIPT, str(faulted / "ckpt"),
         str(total), str(faulted / "losses.jsonl"), REPO],
        max_restarts=2, backoff=0.01, env=env)
    assert sup.run() == 0
    assert sup.restarts == 1
    assert sup.exit_codes[0] == -15 and sup.exit_codes[-1] == 0

    clean = tmp_path / "clean"
    clean.mkdir()
    rc = subprocess.run(
        [sys.executable, "-c", _TRAIN_SCRIPT, str(clean / "ckpt"),
         str(total), str(clean / "losses.jsonl"), REPO],
        env=_child_env(), timeout=120).returncode
    assert rc == 0
    got = _trajectory(faulted / "losses.jsonl")
    want = _trajectory(clean / "losses.jsonl")
    assert set(got) == set(range(1, total + 1))
    assert got == want
    # the second incarnation restored step 2 (step 3's write was torn by
    # the SIGTERM) and ran steps 3-6 once each
    rows = MetricsJSONL(str(faulted / "ckpt" / METRICS_FILE)).read(
        "Train/Resilience/recovery_count")
    assert [(r["value"], r["step"]) for r in rows] == [(1, 2)]
    with open(faulted / "losses.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == list(
            range(1, total + 1))


# ---------------------------------------------------------------------------
# Across packages: each reads the other's directories
# ---------------------------------------------------------------------------

def _jax_engine(ckpt_dir, params):
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jax.numpy.float32)
    cfg = _config(ckpt_dir, interval=2)
    cfg["optimizer"] = {"type": "Adam", "params": {"lr": 1e-2, "eps": 1e-6}}
    eng, *_ = deepspeed_tpu.initialize(
        model=jm, params=params, config=DeepSpeedTPUConfig(cfg, world_size=1),
        mesh=build_mesh(devices=jax.devices()[:1]))
    return eng


def test_jax_written_directory_restores_into_the_port(tmp_path):
    """The JAX manager writes step 2; the port restores it through
    ``state_arrays_from_flax`` (its ``rng`` key left out) and its next
    loss is within 1e-5 of the JAX engine's; the masters, moments and
    counters equal JAX's after the transposes."""
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jax.numpy.float32)
    stream = _stream(3)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     {"input_ids": stream[0]["input_ids"][0]})["params"]
    jeng = _jax_engine(tmp_path / "jax", params)
    for b in stream[:2]:
        jeng.train_batch(b)
    jeng.ckpt_manager.wait()
    jnext = float(jeng.train_batch(stream[2]))
    jeng.ckpt_manager.close()

    sd = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    model, _ = make_gpt("tiny", dtype=torch.float32, dropout_rate=0.0)
    cfg = _config(tmp_path / "port")
    cfg["optimizer"] = {"type": "Adam", "params": {"lr": 1e-2, "eps": 1e-6}}
    peng, *_ = deepspeed_tpu_torch.initialize(model=model, params=sd,
                                              device="cpu", config=cfg)
    path, _ = restore(peng, str(tmp_path / "jax"),
                      convert=state_arrays_from_flax)
    assert path.endswith("step_00000002") and peng.global_steps == 2
    assert peng.state.step == 2 and peng.state.opt_state.step == 2
    found = jax_find_restorable(str(tmp_path / "jax"))[2]
    np.testing.assert_array_equal(
        model.state_dict()["h.1.c_fc.weight"].numpy(),
        found["params.h_1.c_fc.kernel"].T)
    i = peng.param_names.index("h.0.c_attn.weight")
    np.testing.assert_array_equal(peng.state.opt_state.exp_avg_sq[i].numpy(),
                                  found["opt_state.exp_avg_sq.h_0.c_attn."
                                        "kernel"].T)
    pnext = float(peng.train_batch(stream[2]))
    np.testing.assert_allclose(pnext, jnext, rtol=1e-5, atol=0)
    peng.ckpt_manager.close()


def test_port_written_directory_reads_in_jax(tmp_path):
    e = _make_engine(tmp_path)
    for b in _stream(2):
        e.train_batch(b)
    e.ckpt_manager.wait()
    path, manifest, arrays, client = jax_find_restorable(str(tmp_path))
    assert manifest["step"] == 2 and client == {}
    names = [n for n, _ in e._snapshot_state()]
    assert sorted(arrays) == sorted(names)
    for name, leaf in _leaves(e):
        want = (leaf.float().numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf))
        np.testing.assert_array_equal(arrays[name], want, err_msg=name)
    e.ckpt_manager.close()

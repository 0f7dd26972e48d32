"""Port parity: the top-level training blocks the port has not ported
yet (``config/constants.py:NOT_YET_PORTED_BLOCKS``) are read "on" by the
reference's own rule for each block, and the blocks it has ported since
(``resilience``, ``activation_checkpointing``, ``telemetry``,
``guardrails``, ``check_numerics``) parse to the reference's fields.

The same dict goes to the JAX package's ``DeepSpeedTPUConfig`` and to the
port's ``DeepSpeedConfig``. Where the reference parses it with the block's
feature off, the port parses it; where the reference's feature is on, the
port raises its "not yet ported" ``ConfigError`` naming the block; where
the reference raises, the port raises too. ``REFERENCE_ON`` reads each
feature's switch off the reference's parsed config, as its engine reads
it.
"""

import dataclasses

import deepspeed_tpu_torch
import pytest
import torch

from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.resilience import FaultPlan as JaxFaultPlan
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.models import make_gpt

torch.set_num_threads(1)

BASE = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 4}


def _mesh_on(cfg):
    m = cfg.mesh
    return max(m.model, m.pipe, m.sequence, m.expert, m.slices) > 1


# the reference's switch of each block's feature, on its parsed config
REFERENCE_ON = {
    "comm": lambda c: c.comm.hierarchical == "on",
    "pipeline": lambda c: int(c.pipeline.get("stages", 1)) > 1,
    "moe": lambda c: c.moe.enabled,
    "telemetry": lambda c: c.telemetry.enabled,
    "autotuning": lambda c: c.autotuning.enabled,
    "elasticity": lambda c: c.elasticity_enabled or c.elasticity_live.enabled,
    "sparse_gradients": lambda c: c.sparse_gradients_enabled,
    "flops_profiler": lambda c: c.flops_profiler.enabled,
    "progressive_layer_drop": lambda c: c.pld.enabled,
    "quantize_training": lambda c: bool(
        c.quantize_training.get("enabled", False)),
    "guardrails": lambda c: c.guardrails.enabled,
    "mesh": _mesh_on,
    "eigenvalue": lambda c: False,       # read by no feature
    "amp": lambda c: c.amp_enabled,
    "tensorboard": lambda c: c.tensorboard.enabled,
    "aio": lambda c: False,              # NVMe offload's settings only
    "wall_clock_breakdown": lambda c: c.wall_clock_breakdown,
    "memory_breakdown": lambda c: c.memory_breakdown,
    "dump_state": lambda c: c.dump_state,
    "check_numerics": lambda c: c.check_numerics,
    "communication_data_type": lambda c: c.communication_data_type
    is not None,
    "compressed_allreduce": lambda c: False,   # read by no feature
    "legacy_fusion": lambda c: c.optimizer_legacy_fusion,
}

# Blocks of CASES the port has ported since: every value parses to the
# reference's fields (or raises where the reference raises).
PORTED_SINCE = {"telemetry", "guardrails", "check_numerics"}

# Each block with keys but no ``enabled`` (the feature off in the
# reference), then values that turn it on or that the reference refuses.
CASES = [
    ("comm", {"bucket_mb": 8}), ("comm", {"hierarchical": "auto"}),
    ("comm", {"hierarchical": "on"}), ("comm", {"hierarchical": "maybe"}),
    ("pipeline", {"partition": "uniform"}), ("pipeline", {"stages": 2}),
    ("moe", {}), ("moe", False), ("moe", 0), ("moe", {"enabled": False}),
    ("moe", None), ("moe", {"num_experts": 8}),
    ("telemetry", {"dir": "run"}), ("telemetry", {"enabled": True,
                                                  "dir": "run"}),
    ("telemetry", {"enabled": True}),
    ("autotuning", {"top_k": 3}), ("autotuning", {"enabled": True}),
    ("elasticity", {"max_train_batch_size": 8}),
    ("elasticity", {"live": {"enabled": True}}),
    ("sparse_gradients", False), ("sparse_gradients", True),
    ("flops_profiler", {"profile_step": 1}),
    ("flops_profiler", {"enabled": True}),
    ("progressive_layer_drop", {"theta": 0.5}),
    ("progressive_layer_drop", {"enabled": True}),
    ("quantize_training", {"quantize_bits": 8}),
    ("quantize_training", {"enabled": True}),
    ("guardrails", {"detector": {}}), ("guardrails", {"enabled": True}),
    ("mesh", {"data": -1}), ("mesh", {"data": 1, "model": 1}),
    ("mesh", {"model": 2}),
    ("eigenvalue", {"max_iter": 10}), ("eigenvalue", {"enabled": True}),
    ("amp", {"opt_level": "O1"}), ("amp", {"enabled": True}),
    ("tensorboard", {"output_path": ""}), ("tensorboard", {"enabled": True}),
    ("aio", {"block_size": 1048576}), ("aio", {"enabled": True}),
    ("wall_clock_breakdown", False), ("wall_clock_breakdown", True),
    ("memory_breakdown", False), ("memory_breakdown", True),
    ("dump_state", False), ("dump_state", True),
    ("check_numerics", False), ("check_numerics", True),
    ("communication_data_type", None), ("communication_data_type", "bf16"),
    ("communication_data_type", "fp8"),
    ("compressed_allreduce", True), ("compressed_allreduce", {"x": 1}),
    ("legacy_fusion", False), ("legacy_fusion", True),
]


# The blocks ported since they were refused: each value parses to the
# reference's fields, or raises where the reference raises.
PORTED_CASES = [
    ("resilience", {"auto_resume": True}),
    ("resilience", {"fault_injection": {"preempt_at_step": 3}}),
    ("resilience", {"enabled": True}),
    ("activation_checkpointing", {"number_checkpoints": 4,
                                  "profile": True}),
    ("activation_checkpointing", {"partition_activations": True}),
    ("resilience", {"enabled": True, "checkpoint": {"dir": "d",
                                                    "interval": 7,
                                                    "async": False}}),
    ("resilience", {"enabled": False, "checkpoint": {"keep_last": 0}}),
    ("activation_checkpointing", {"cpu_checkpointing": True,
                                  "contiguous_memory_optimization": True,
                                  "synchronize_checkpoint_boundary": True}),
    ("activation_checkpointing", None),
]


def _parsed(cfg, key):
    """The reference's parsed fields of a ported block."""
    block = getattr(cfg, key)
    if key == "check_numerics":
        return block
    if key in ("telemetry", "guardrails"):
        fields = dataclasses.asdict(block)
        if key == "telemetry":
            fields["metrics"]["sinks"] = tuple(fields["metrics"]["sinks"])
        return fields
    fields = dict(block.__dict__)
    if key == "resilience":
        fields["checkpoint"] = dict(block.checkpoint.__dict__)
    else:
        fields["provided"] = cfg.activation_checkpointing_provided
    return fields


@pytest.mark.parametrize("key,value", PORTED_CASES)
def test_ported_block_parses_as_the_reference(key, value, monkeypatch):
    monkeypatch.delenv(C.FAULT_PLAN_ENV, raising=False)
    d = dict(BASE, **{key: value})
    try:
        want = _parsed(DeepSpeedTPUConfig(dict(d), world_size=1), key)
    except Exception:                   # the reference refuses it
        with pytest.raises(ConfigError):
            DeepSpeedConfig(dict(d))
        return
    assert _parsed(DeepSpeedConfig(dict(d)), key) == want


def test_cases_cover_every_unported_block():
    assert set(REFERENCE_ON) == set(C.NOT_YET_PORTED_BLOCKS) | PORTED_SINCE
    assert {k for k, _v in CASES} == set(C.NOT_YET_PORTED_BLOCKS) | \
        PORTED_SINCE
    assert not PORTED_SINCE & set(C.NOT_YET_PORTED_BLOCKS)
    assert not {k for k, _v in PORTED_CASES} & set(C.NOT_YET_PORTED_BLOCKS)


@pytest.mark.parametrize("key,value", CASES)
def test_block_read_on_as_the_reference_reads_it(key, value, monkeypatch):
    monkeypatch.delenv(C.AUTOTUNING_ENV, raising=False)
    monkeypatch.delenv(C.FAULT_PLAN_ENV, raising=False)
    d = dict(BASE, **{key: value})
    try:
        ref = DeepSpeedTPUConfig(dict(d), world_size=1)
        on = REFERENCE_ON[key](ref)
    except Exception:                   # the reference refuses it
        with pytest.raises(ConfigError):
            DeepSpeedConfig(dict(d))
        return
    if key in PORTED_SINCE:             # ported: on or off, the same fields
        assert _parsed(DeepSpeedConfig(dict(d)), key) == _parsed(ref, key)
    elif on:
        with pytest.raises(ConfigError, match="not yet ported") as err:
            DeepSpeedConfig(dict(d))
        assert key in str(err.value)
    else:
        DeepSpeedConfig(dict(d))


@pytest.mark.parametrize("env,key", [(C.AUTOTUNING_ENV, "autotuning"),
                                     (C.FAULT_PLAN_ENV, "resilience")])
def test_environment_turns_a_block_on_as_in_the_reference(env, key,
                                                          monkeypatch):
    """The launcher's autotuning handshake and a fault plan in the
    environment arm the feature of a block that does not say ``enabled``,
    and with no block at all (the reference's engine arms its fault plan
    from the environment alone); an explicit ``enabled: false`` keeps
    autotuning off. Autotuning is not ported and is refused; the fault
    plan is, and the engine arms it."""
    monkeypatch.setenv(env, "1" if key == "autotuning" else
                       '{"preempt_at_step": 3}')
    d = dict(BASE, **{key: {"top_k": 3} if key == "autotuning"
                      else {"auto_resume": True}})
    ref = DeepSpeedTPUConfig(dict(d), world_size=1)
    if key == "autotuning":
        assert ref.autotuning.enabled
    for cfg in (d, BASE):               # with the block and without it
        if key == "autotuning":
            with pytest.raises(ConfigError, match="not yet ported"):
                DeepSpeedConfig(dict(cfg))
        else:
            engine = deepspeed_tpu_torch.initialize(
                model=make_gpt("tiny")[0], config=dict(cfg),
                device="cpu")[0]
            assert engine.fault_plan.should_preempt(3)
    if key == "autotuning":
        off = dict(BASE, autotuning={"enabled": False})
        assert not DeepSpeedTPUConfig(dict(off),
                                      world_size=1).autotuning.enabled
        DeepSpeedConfig(dict(off))


def test_empty_moe_block_is_refused_by_initialize():
    """``moe: {}`` turns MoE on in the reference (8 experts, every 2nd
    block), so the port refuses it rather than train a dense model."""
    assert DeepSpeedTPUConfig({"moe": {}, **BASE}, world_size=1).moe.enabled
    with pytest.raises(ConfigError, match="not yet ported") as err:
        deepspeed_tpu_torch.initialize(model=make_gpt("tiny")[0],
                                       config=dict(BASE, moe={}),
                                       device="cpu")
    assert "moe" in str(err.value)


# The guardrails and the training telemetry blocks (the validation cases
# of tests/test_guardrails.py's TestGuardrailsConfig among them): both
# packages parse them to equal fields, or both raise.
GUARDRAILS_CASES = [
    {}, {"enabled": True}, {"enabled": False, "detector": {
        "check_nonfinite_grads": True}},
    {"enabled": True, "detector": {"check_nonfinite_grads": True}},
    {"enabled": True, "detector": {"zscore_threshold": 3.5,
                                   "warmup_steps": 4, "ewma_alpha": 0.1,
                                   "track_grad_norm": False}},
    {"enabled": True, "rollback": {"enabled": False}},
    {"enabled": True, "rollback": {"snapshot_interval": 1, "ring_size": 3,
                                   "consecutive_spikes": 1,
                                   "skip_batches": 0, "lr_decay": 0.5,
                                   "max_rollbacks": 5,
                                   "escalate_to_disk": False}},
    {"enabled": True, "watchdog": {"enabled": True,
                                   "step_timeout_seconds": 30,
                                   "poll_interval_seconds": 0.5,
                                   "crashdump_dir": "dumps",
                                   "exit_code": 99}},
    {"enabled": True, "detector": {"zscore_threshold": 0}},
    {"enabled": True, "detector": {"warmup_steps": 0}},
    {"enabled": True, "detector": {"ewma_alpha": 0}},
    {"enabled": True, "rollback": {"ring_size": 0}},
    {"enabled": True, "rollback": {"consecutive_spikes": 0}},
    {"enabled": True, "rollback": {"snapshot_interval": 0}},
    {"enabled": True, "rollback": {"lr_decay": 0}},
    {"enabled": True, "rollback": {"max_rollbacks": 0}},
    {"enabled": True, "rollback": {"skip_batches": -1}},
    {"enabled": True, "watchdog": {"enabled": True,
                                   "step_timeout_seconds": 0}},
    {"enabled": True, "watchdog": {"poll_interval_seconds": -1}},
    {"enabled": True, "watchdog": {"exit_code": 0}},
    {"enabled": True, "watchdog": {"exit_code": 256}},
]


@pytest.mark.parametrize("i", range(len(GUARDRAILS_CASES)))
def test_guardrails_block_parses_as_the_reference(i):
    d = dict(BASE, guardrails=GUARDRAILS_CASES[i])
    try:
        ref = DeepSpeedTPUConfig(dict(d), world_size=1)
    except Exception:                   # the reference refuses it
        with pytest.raises(ConfigError):
            DeepSpeedConfig(dict(d))
        return
    got = DeepSpeedConfig(dict(d))
    assert _parsed(got, "guardrails") == _parsed(ref, "guardrails")
    assert got.guardrails.nonfinite_grad_check == \
        ref.guardrails.nonfinite_grad_check


TRAINING_TELEMETRY_CASES = [
    {"enabled": True, "dir": "run", "goodput": True,
     "numerics": {"enabled": True, "max_groups": 8}},
    {"enabled": True, "dir": "run", "goodput": False,
     "trace": {"sync_spans": False}, "metrics": {"sinks": ["memory"]}},
    {"enabled": True, "dir": ""},
    {"enabled": True, "numerics": {"max_groups": 0}},
]
# on in the reference, refused by name in the port
REFUSED_TELEMETRY = [
    ("telemetry.fleet", {"enabled": True, "fleet": {"enabled": True}}),
    ("telemetry.memory", {"enabled": True, "memory": {"enabled": True}}),
    ("telemetry.devicetime", {"enabled": True,
                              "devicetime": {"enabled": True}}),
    ("'tensorboard' sink", {"enabled": True,
                            "metrics": {"sinks": ["tensorboard"]}}),
]


@pytest.mark.parametrize("i", range(len(TRAINING_TELEMETRY_CASES)))
def test_training_telemetry_parses_as_the_reference(i):
    d = dict(BASE, telemetry=TRAINING_TELEMETRY_CASES[i])
    try:
        ref = DeepSpeedTPUConfig(dict(d), world_size=1)
    except Exception:
        with pytest.raises(ConfigError):
            DeepSpeedConfig(dict(d))
        return
    assert _parsed(DeepSpeedConfig(dict(d)), "telemetry") == \
        _parsed(ref, "telemetry")


@pytest.mark.parametrize("name,block", REFUSED_TELEMETRY)
def test_unported_training_telemetry_raises_by_name(name, block):
    d = dict(BASE, telemetry=block)
    DeepSpeedTPUConfig(dict(d), world_size=1)
    with pytest.raises(ConfigError, match="not yet ported") as err:
        DeepSpeedConfig(dict(d))
    assert name in str(err.value)


@pytest.mark.parametrize("block", [
    {"nan_loss_at_step": 4, "nan_loss_steps": 2},
    {"hang_at_step": 7, "hang_seconds": 60},
    {"nan_loss_at_step": 1, "hang_at_step": 3}])
def test_guardrails_fault_keys_accepted_as_in_the_reference(block,
                                                            monkeypatch):
    """The NaN and hang keys arm the plan at ``initialize``; their window
    equals the JAX plan's over every step attempt."""
    monkeypatch.delenv(C.FAULT_PLAN_ENV, raising=False)
    engine = deepspeed_tpu_torch.initialize(
        model=make_gpt("tiny")[0], device="cpu",
        config=dict(BASE, resilience={"fault_injection": block}))[0]
    ref = JaxFaultPlan.resolve(block, env={})
    for attempt in range(10):
        assert engine.fault_plan.should_nan_loss(attempt) == \
            ref.should_nan_loss(attempt)
        assert engine.fault_plan.should_hang(attempt) == \
            ref.should_hang(attempt)

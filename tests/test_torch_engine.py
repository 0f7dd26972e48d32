"""Port parity: the training engine (deepspeed_tpu_torch.initialize ->
train_batch) against deepspeed_tpu.initialize on one CPU device, fed the
same batches from the same weights.

Tiny GPT, dropout 0, micro-batch 2, gradient accumulation 2, ZeRO stage 2,
Adam lr 1e-3, three train_batch steps.

- fp32: the three losses agree to 1e-5 relative and every final param to
  1e-5 absolute (measured: 2.2e-6). Adam's eps is 1e-6 here: the key bias
  of c_attn has an exact gradient of 0 (softmax ignores a constant added
  to every key's score), so its computed gradient is rounding noise, and
  with eps 1e-8 Adam turns that noise into steps of +-lr whose sign
  differs between the two frameworks.
- bf16 (the bench config: bf16 compute and a bf16 accumulator): see
  tests/test_torch_engine_bf16.py, ``test_bf16_bench_config_matches_jax``
  for what is compared and the readings its tolerances come from, and
  ``test_bf16_accumulator_sums_in_bf16_as_jax`` for the accumulator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import gpt_params_from_flax, make_gpt

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

MICRO, GAS, SEQ, STEPS = 2, 2, 32, 3


def _config(**extra):
    adam = {"lr": 1e-3}
    adam.update(extra.pop("adam", {}))
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "Adam", "params": adam},
           "zero_optimization": {"stage": 2}}
    cfg.update(extra)
    return cfg


def _batches(seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (GAS, MICRO, SEQ),
                                       dtype=np.int32)}
            for _ in range(STEPS)]


def _jax_run(cfg, dtype):
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=dtype)
    batches = _batches()
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     {"input_ids": batches[0]["input_ids"][0]})["params"]
    sd = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    eng, *_ = deepspeed_tpu.initialize(
        model=jm, params=params, config=DeepSpeedTPUConfig(cfg, world_size=1),
        mesh=build_mesh(devices=jax.devices()[:1]))
    losses = [float(eng.train_batch(b)) for b in batches]
    final = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        eng.state.params))
    return sd, losses, final


def _port_run(cfg, dtype, sd):
    model, _ = make_gpt("tiny", dtype=dtype)
    eng, opt, loader, _sched = deepspeed_tpu_torch.initialize(
        model=model, params=sd, config=cfg, device="cpu")
    assert loader is None and opt is eng.optimizer
    losses = [float(eng.train_batch(b)) for b in _batches()]
    return eng, losses, {k: v.detach() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def fp32_runs():
    cfg = _config(adam={"eps": 1e-6})
    sd, jl, jp = _jax_run(cfg, jnp.float32)
    eng, tl, tp = _port_run(cfg, torch.float32, sd)
    return sd, (jl, jp), (eng, tl, tp)


def test_fp32_losses_and_params_match_jax(fp32_runs):
    _sd, (jl, jp), (eng, tl, tp) = fp32_runs
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    assert eng.global_steps == STEPS and eng.micro_steps == STEPS * GAS
    assert eng.state.step == STEPS and eng.skipped_steps == 0
    assert eng.get_global_grad_norm() == 0.0    # zeroed after the step
    assert eng.zero_optimization() and eng.zero_optimization_stage() == 2
    assert eng.get_lr() == [1e-3] and eng.loss_scale() == 1.0


def test_fused_update_equals_plain_update_on_cpu(fp32_runs):
    """``optimizer.fused_update`` routes the apply through
    ``fused_adam_apply``, whose CPU path is the same op chain: the two
    engines end bit-equal."""
    sd, _jax, (_eng, tl, tp) = fp32_runs
    cfg = _config(adam={"eps": 1e-6})
    cfg["optimizer"]["fused_update"] = True
    eng, fl, fp = _port_run(cfg, torch.float32, sd)
    assert eng._fused_update
    assert fl == tl
    for k in tp:
        assert torch.equal(fp[k], tp[k]), k


def test_reference_api_equals_train_batch(fp32_runs):
    """forward/backward/step over the micro-batches gives train_batch's
    losses and params, to the bit."""
    sd, _jax, (_eng, tl, tp) = fp32_runs
    model, _ = make_gpt("tiny", dtype=torch.float32)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, params=sd, config=_config(adam={"eps": 1e-6}),
        device="cpu")
    for i, b in enumerate(_batches()):
        losses = []
        for j in range(GAS):
            loss = eng.forward({"input_ids": b["input_ids"][j]})
            eng.backward(loss)
            losses.append(loss)
            if j < GAS - 1:
                assert not eng.is_gradient_accumulation_boundary()
        eng.step()
        assert float(torch.stack(losses).mean()) == tl[i]
    for k, v in model.state_dict().items():
        assert torch.equal(v, tp[k]), k


def test_eval_batch_is_deterministic_forward(fp32_runs):
    _sd, _jax, (eng, _tl, tp) = fp32_runs
    b = {"input_ids": _batches(seed=1)[0]["input_ids"][0]}
    model, _ = make_gpt("tiny", dtype=torch.float32)
    model.load_state_dict(tp)
    want = model(torch.as_tensor(b["input_ids"]).long(),
                 deterministic=True)["loss"].detach()
    assert float(eng.eval_batch(b)) == pytest.approx(float(want), rel=1e-6)


def _linear_engine(config, device="cpu"):
    def loss_fn(params, batch, rng):
        w = params["w"]
        return ((batch["x"].to(w.dtype) @ w).float() ** 2).mean()

    w = torch.full((4, 3), 0.5)
    return deepspeed_tpu_torch.initialize(
        loss_fn=loss_fn, params={"w": w}, config=config, device=device)[0]


def test_fp16_inf_in_batch_skips_step():
    """fp16: a batch holding an inf makes the grads overflow; the step is
    skipped (params and Adam state untouched, skipped_steps bumped) and the
    dynamic loss scale backs off after its hysteresis."""
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 0.1}},
           "fp16": {"enabled": True, "initial_scale_power": 4,
                    "hysteresis": 1}}
    eng = _linear_engine(cfg)
    x = np.ones((1, 2, 4), np.float32)
    eng.train_batch({"x": x})
    assert eng.skipped_steps == 0 and eng.state.step == 1
    w1 = eng.state.params[0].clone()
    bad = x.copy()
    bad[0, 1, 2] = np.inf
    eng.train_batch({"x": bad})
    assert eng.skipped_steps == 1 and eng.state.step == 1
    assert torch.equal(eng.state.params[0], w1)
    assert eng.loss_scale() == 2.0 ** 3
    assert eng.global_steps == 2
    assert not any(a.any() for a in eng.state.grad_acc)


def test_gradient_clipping_and_scheduler():
    """Clipping scales the update's gradients to the max norm; the
    scheduler's lr is the one the step uses."""
    cfg = {"train_batch_size": 2, "gradient_clipping": 1e-3,
           "optimizer": {"type": "AdamW", "params": {"lr": 0.1}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 0.0,
                                    "warmup_max_lr": 0.1,
                                    "warmup_num_steps": 4}}}
    eng = _linear_engine(cfg)
    assert eng.get_lr() == [0.0]
    eng.train_batch({"x": np.ones((1, 2, 4), np.float32)})
    assert float(eng._last_norm) > 1e-3
    assert torch.equal(eng.state.params[0], torch.full((4, 3), 0.5))
    assert eng.get_lr() == [pytest.approx(0.025)]
    eng.train_batch({"x": np.ones((1, 2, 4), np.float32)})
    assert not torch.equal(eng.state.params[0], torch.full((4, 3), 0.5))


# A value of each block that turns its feature on by the reference's own
# rule (tests/test_torch_config_parity.py holds the rules against the
# reference's parser). ``aio``, ``compressed_allreduce`` and
# ``eigenvalue`` are read by no feature of the reference and always parse,
# so their places hold a second value of another block.
_ON = {"comm": {"hierarchical": "on"},
       "aio": ("elasticity", {"live": {"enabled": True}}),
       "compressed_allreduce": ("moe", {})}
NOT_PORTED = [_ON[k] if isinstance(_ON.get(k), tuple)
              else (k, _ON.get(k, {"enabled": True}))
              for k in C.NOT_YET_PORTED_BLOCKS
              if k not in ("pipeline", "mesh", "sparse_gradients",
                           "wall_clock_breakdown", "memory_breakdown",
                           "dump_state", "check_numerics",
                           "communication_data_type", "legacy_fusion",
                           "sparse_attention", "quantize_training",
                           "eigenvalue")]
NOT_PORTED += [("pipeline", {"stages": 2}), ("mesh", {"model": 2}),
               ("sparse_gradients", True), ("wall_clock_breakdown", True),
               ("memory_breakdown", True), ("dump_state", True),
               ("check_numerics", True), ("communication_data_type", "bf16"),
               ("legacy_fusion", True),
               ("telemetry", {"enabled": True, "dir": "run"}),
               ("quantize_training", {"enabled": True, "quantize_bits": 8}),
               ("moe", False), ("guardrails", {"enabled": True,
                                               "detector": {}}),
               ("flops_profiler", {"enabled": True, "profile_step": 2})]


@pytest.mark.parametrize("key,value", NOT_PORTED)
def test_unported_training_blocks_raise(key, value):
    with pytest.raises(ConfigError, match="not yet ported") as err:
        DeepSpeedConfig(dict(_config(), **{key: value}))
    assert key in str(err.value)


SPARSE = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
          "num_sliding_window_blocks": 3, "num_global_blocks": 1,
          "attention": "unidirectional", "rng_seed": 23}


def test_sparse_attention_block_is_accepted_and_routed(monkeypatch):
    """The ``sparse_attention`` block parses (its keys checked as the
    layout classes check them) and ``initialize`` routes the model's
    attention through it in place: the same parameter tensors, the block
    on the model's and every block's config, nothing done when the config
    already carries it; a loss_fn entry gets the JAX warning."""
    assert DeepSpeedConfig(_config()).sparse_attention is None
    assert DeepSpeedConfig(dict(_config(), sparse_attention=SPARSE)
                           ).sparse_attention == SPARSE
    for bad, match in (({"mode": "nope"}, "unknown sparse_attention mode"),
                       ({"mode": "fixed", "bogus": 1}, "invalid"),
                       ("fixed", "must be a dict")):
        with pytest.raises(ConfigError, match=match):
            DeepSpeedConfig(dict(_config(), sparse_attention=bad))
    model, _ = make_gpt("tiny", dtype=torch.float32, max_seq_len=64)
    params = list(model.parameters())
    cfg = dict(_config(), sparse_attention=SPARSE)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                             device="cpu")
    assert model.cfg.sparse_attention == SPARSE
    assert all(b.cfg is model.cfg for b in model.h)
    assert all(a is b for a, b in zip(model.parameters(), params))
    assert len(list(model.parameters())) == len(params)
    routed = model.cfg
    deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    assert model.cfg is routed                     # no-op when repeated
    loss = eng.train_batch({"input_ids": np.zeros((GAS, MICRO, 64),
                                                  np.int32)})
    assert torch.isfinite(loss)
    warned = []
    monkeypatch.setattr(deepspeed_tpu_torch.logger, "warning",
                        lambda msg, *a, **k: warned.append(msg))
    deepspeed_tpu_torch.initialize(
        loss_fn=lambda p, b, r: (p["w"] ** 2).sum(),
        params={"w": torch.ones(2)}, config=cfg, device="cpu")
    assert len(warned) == 1 and "no surgery applied" in warned[0]


def test_sparse_attention_training_matches_jax():
    """Tiny GPT at seq 64 with a BigBird block-16 ``sparse_attention``
    block, through ``initialize`` (the surgery included) on both sides:
    the losses of two train_batch steps to 1e-5 relative and every final
    param to 1e-5, fp32 (Adam eps 1e-6, as in the dense comparison)."""
    cfg = _config(adam={"eps": 1e-6}, sparse_attention=SPARSE)
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, 512, (GAS, MICRO, 64),
                                          dtype=np.int32)}
               for _ in range(2)]
    # the sparse path adds no parameters: the dense model's init is its
    params = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32,
                          max_seq_len=64)[0].init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        {"input_ids": batches[0]["input_ids"][0, :, :8]})["params"]
    sd = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32,
                         max_seq_len=64)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, params=params, config=DeepSpeedTPUConfig(cfg, world_size=1),
        mesh=build_mesh(devices=jax.devices()[:1]))
    jl = [float(jeng.train_batch(b)) for b in batches]
    jp = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jeng.state.params))
    model, _ = make_gpt("tiny", dtype=torch.float32, max_seq_len=64)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, params=sd,
                                             config=cfg, device="cpu")
    tl = [float(eng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jp[k], atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("key,value", [
    ("telemetry", {"enabled": False}), ("pipeline", {"stages": 1}),
    ("mesh", {"data": -1, "model": 1}), ("sparse_gradients", False),
    ("activation_checkpointing", None)])
def test_blocks_in_their_off_state_are_accepted(key, value):
    DeepSpeedConfig(dict(_config(), **{key: value}))


@pytest.mark.parametrize("block", [
    {"zero_optimization": {"stage": 2, "offload_optimizer":
                           {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
    {"zero_optimization": {"stage": 2, "cpu_offload": True}},
    {"zero_optimization": {"stage": 2,
                           "zeropp": {"quantized_weights": "int8"}}},
    {"optimizer": {"type": "OneBitLamb", "params": {}}},
    {"optimizer": {"type": "OneBitAdam", "params": {}}},
    {"optimizer": {"type": "cpuadam", "params": {}}},
])
def test_unported_zero_and_optimizer_options_raise(block):
    with pytest.raises(ConfigError, match="not yet ported"):
        DeepSpeedConfig(dict(_config(), **block))


@pytest.mark.parametrize("cfg,match", [
    ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3},
     "not divisible"),
    ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 3}, "inconsistent"),
    ({}, "at least one"),
    ({"train_batch_size": 4, "no_such_key": 1}, "unknown config keys"),
    ({"train_batch_size": 4, "zero_optimization": {"stage": 2, "bogus": 1}},
     "unknown zero_optimization keys"),
    ({"train_batch_size": 4, "zero_optimization": {"stage": 4}},
     "stage must be 0-3"),
    ({"train_batch_size": 4, "optimizer": {"type": "Adagrad"}},
     "unknown optimizer"),
    ({"train_batch_size": 4, "fp16": {"enabled": True},
      "bf16": {"enabled": True}}, "cannot both"),
    ({"train_batch_size": 4, "data_types": {"grad_accum_dtype": "fp8"}},
     "grad_accum_dtype"),
])
def test_config_walls(cfg, match):
    with pytest.raises(ConfigError, match=match):
        DeepSpeedConfig(cfg)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_every_zero_stage_runs_in_one_process(stage):
    eng = _linear_engine({"train_batch_size": 2,
                          "zero_optimization": {"stage": stage,
                                                "overlap_comm": True}})
    eng.train_batch({"x": np.ones((1, 2, 4), np.float32)})
    assert eng.zero_optimization_stage() == stage


def test_batch_triple_solved():
    c = DeepSpeedConfig({"train_batch_size": 32,
                         "train_micro_batch_size_per_gpu": 4})
    assert (c.train_batch_size, c.train_micro_batch_size_per_gpu,
            c.gradient_accumulation_steps) == (32, 4, 8)


def test_entry_point_walls():
    with pytest.raises(ConfigError, match="not yet ported"):
        deepspeed_tpu_torch.initialize(
            model=make_gpt("tiny")[0], device="cpu",
            config=dict(_config(), resilience={
                "fault_injection": {"nan_loss_at_step": 1}}))
    with pytest.raises(ConfigError, match="not yet ported"):
        _linear_engine(DeepSpeedConfig(_config(), world_size=2))
    with pytest.raises(ValueError, match="leading dim"):
        _linear_engine({"train_batch_size": 2,
                        "gradient_accumulation_steps": 1}).train_batch(
            {"x": np.ones((3, 2, 4), np.float32)})


def test_default_device_is_the_card(monkeypatch):
    """Without a card, the default device raises instead of falling back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=make_gpt("tiny")[0],
                                       config=_config())

"""Port parity: synchronous checkpoint save/load
(``deepspeed_tpu_torch/runtime/checkpointing.py``) as
``tests/test_checkpointing.py`` holds the JAX package, and serving from a
checkpoint.

- the round trip (tag directory, ``latest``, client state, the scheduler,
  every state leaf bit-equal, training continuing bit for bit), the load
  without optimizer states, an explicit tag, ``consolidate_to_fp32`` and
  ``zero_to_fp32_main``;
- the same weights and batches through both engines (tiny GPT, fp32,
  dropout 0): each saves at step 2 and reloads into a fresh engine; the
  port's next losses are within 1e-5 of JAX's and bit-equal to its own
  uninterrupted run; the same for BERT under LAMB;
- ``init_inference(checkpoint=...)`` / ``init_serving(checkpoint=...)``
  give the tokens of an engine built from the live masters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import make_bert as jax_make_bert
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models import (bert_params_from_flax,
                                        gpt_params_from_flax,
                                        init_gpt_params, make_bert,
                                        make_gpt)
from deepspeed_tpu_torch.resilience import ResilienceError
from deepspeed_tpu_torch.runtime.checkpointing import (consolidate_to_fp32,
                                                       load_module_params,
                                                       zero_to_fp32_main)

torch.set_num_threads(1)

MICRO, GAS, SEQ = 2, 2, 16


def _config(**extra):
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2,
                                                    "eps": 1e-6}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_max_lr": 0.01,
                                    "warmup_num_steps": 100}},
           "steps_per_print": 1000}
    cfg.update(extra)
    return cfg


def _stream(n, seed=3, vocab=512):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (GAS, MICRO, SEQ),
                                       dtype=np.int32)} for _ in range(n)]


def _engine(sd=None, dropout=0.1, stage=0, **extra):
    model, cfg = make_gpt("tiny", dtype=torch.float32, dropout_rate=dropout)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, params=sd if sd is not None else init_gpt_params(
            cfg, seed=0), device="cpu",
        config=_config(zero_optimization={"stage": stage}, **extra))
    return eng, model


def _state(engine):
    return [(n, leaf.clone() if isinstance(leaf, torch.Tensor) else leaf)
            for n, leaf in engine._snapshot_state()]


def _equal_states(a, b, skip=()):
    for (n, x), (m, y) in zip(_state(a), _state(b)):
        assert n == m
        if n.startswith(skip):
            continue
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), n
        else:
            assert x == y, n


@pytest.mark.parametrize("stage", [0, 2])
def test_checkpoint_roundtrip(tmp_path, stage):
    stream = _stream(5)
    e1, m1 = _engine(stage=stage)
    for b in stream[:3]:
        e1.train_batch(b)
    path = e1.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    assert os.path.isdir(path) and path.endswith("global_step3")
    assert open(tmp_path / "latest").read().strip() == "global_step3"
    assert sorted(os.listdir(path)) == ["client_state.pkl", "ds_meta.json",
                                        "lr_scheduler.json", "state"]
    e2, m2 = _engine(stage=stage)
    load_path, client = e2.load_checkpoint(str(tmp_path))
    assert load_path == path and client == {"epoch": 7}
    assert (e2.global_steps, e2.micro_steps) == (3, 3 * GAS)
    assert e2.lr_scheduler.get_lr() == e1.lr_scheduler.get_lr()
    _equal_states(e1, e2)
    # the masters are the module's parameters, updated in place
    assert all(torch.equal(a, b) for a, b in zip(
        m1.state_dict().values(), m2.state_dict().values()))
    assert [repr(float(e1.train_batch(b))) for b in stream[3:]] == \
        [repr(float(e2.train_batch(b))) for b in stream[3:]]


def test_load_without_optimizer_states(tmp_path):
    e1, _ = _engine()
    for b in _stream(2):
        e1.train_batch(b)
    e1.save_checkpoint(str(tmp_path))
    e2, _ = _engine()
    e2.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    _equal_states(e1, e2, skip=("opt_state.",))
    assert e2.state.opt_state.step == 0
    assert not any(bool(t.any()) for t in e2.state.opt_state.exp_avg)
    assert e2.state.step == e1.state.step == 2


def test_explicit_tag_and_missing_latest(tmp_path):
    e1, _ = _engine()
    e1.train_batch(_stream(1)[0])
    e1.save_checkpoint(str(tmp_path), tag="mytag", save_latest=False)
    assert not os.path.exists(tmp_path / "latest")
    e2, _ = _engine()
    assert e2.load_checkpoint(str(tmp_path)) == (None, {})
    path, _ = e2.load_checkpoint(str(tmp_path), tag="mytag")
    assert path.endswith("mytag") and e2.global_steps == 1
    with pytest.raises(FileNotFoundError):
        e2.load_checkpoint(str(tmp_path), tag="nope")


def test_consolidate_to_fp32(tmp_path):
    e1, model = _engine()
    e1.train_batch(_stream(1)[0])
    e1.save_checkpoint(str(tmp_path))
    flat = consolidate_to_fp32(str(tmp_path))
    sd = model.state_dict()
    assert set(flat) == set(sd)
    for k, v in flat.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, sd[k].numpy())
    out = tmp_path / "fp32.npz"
    assert zero_to_fp32_main([str(tmp_path), str(out)]) == 0
    with np.load(out) as z:
        np.testing.assert_array_equal(z["wte"], sd["wte"].numpy())


def test_a_torn_shard_is_refused(tmp_path):
    from deepspeed_tpu_torch.resilience import corrupt_one_shard
    from deepspeed_tpu_torch.resilience.checkpoint import _read_manifest

    e1, _ = _engine()
    path = e1.save_checkpoint(str(tmp_path))
    state = os.path.join(path, "state")
    corrupt_one_shard(state, _read_manifest(state))
    with pytest.raises(ResilienceError, match="digest mismatch"):
        _engine()[0].load_checkpoint(str(tmp_path))


def _jax_gpt_run(cfg, batches, tmp_path):
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     {"input_ids": batches[0]["input_ids"][0]})["params"]
    mesh = build_mesh(devices=jax.devices()[:1])

    def engine():
        return deepspeed_tpu.initialize(
            model=jm, params=params,
            config=DeepSpeedTPUConfig(cfg, world_size=1), mesh=mesh)[0]

    e1 = engine()
    for b in batches[:2]:
        e1.train_batch(b)
    e1.save_checkpoint(str(tmp_path / "jax"))
    e2 = engine()
    e2.load_checkpoint(str(tmp_path / "jax"))
    return params, [float(e2.train_batch(b)) for b in batches[2:]]


def test_save_and_reload_continue_as_jax(tmp_path):
    """Both engines from the same weights and batches save at step 2 and
    reload into fresh engines: the port's next losses are within 1e-5 of
    JAX's, and bit-equal to its own uninterrupted run."""
    cfg = _config(zero_optimization={"stage": 2})
    batches = _stream(4)
    params, jnext = _jax_gpt_run(cfg, batches, tmp_path)
    sd = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    e1, _ = _engine(sd={k: v.clone() for k, v in sd.items()}, dropout=0.0,
                    stage=2)
    for b in batches[:2]:
        e1.train_batch(b)
    e1.save_checkpoint(str(tmp_path / "port"))
    whole = [float(e1.train_batch(b)) for b in batches[2:]]
    e2, _ = _engine(sd=sd, dropout=0.0, stage=2)
    e2.load_checkpoint(str(tmp_path / "port"))
    tnext = [float(e2.train_batch(b)) for b in batches[2:]]
    assert [repr(x) for x in tnext] == [repr(x) for x in whole]
    np.testing.assert_allclose(tnext, jnext, rtol=1e-5, atol=0)


def test_bert_lamb_roundtrip_continues_as_jax(tmp_path):
    """BERT under LAMB: the same, on the MLM loss."""
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "Lamb", "params": {"lr": 2e-3}},
           "zero_optimization": {"stage": 2}, "steps_per_print": 1000}
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, 512, (1, MICRO, SEQ), dtype=np.int32)
        labels = np.where(rng.random(ids.shape) < 0.3, ids, -100)
        batches.append({"input_ids": ids, "labels": labels.astype(np.int32),
                        "attention_mask": np.ones_like(ids)})
    jm, _ = jax_make_bert("tiny", dropout_rate=0.0, dtype=jnp.float32)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     {k: v[0] for k, v in batches[0].items()})["params"]
    mesh = build_mesh(devices=jax.devices()[:1])

    def jax_engine():
        return deepspeed_tpu.initialize(
            model=jm, params=params,
            config=DeepSpeedTPUConfig(cfg, world_size=1), mesh=mesh)[0]

    j1 = jax_engine()
    for b in batches[:2]:
        j1.train_batch(b)
    j1.save_checkpoint(str(tmp_path / "jax"))
    j2 = jax_engine()
    j2.load_checkpoint(str(tmp_path / "jax"))
    jnext = float(j2.train_batch(batches[2]))

    sd = bert_params_from_flax(jax.tree_util.tree_map(np.asarray, params))

    def port_engine():
        model, _ = make_bert("tiny", dtype=torch.float32, dropout_rate=0.0)
        return deepspeed_tpu_torch.initialize(
            model=model, params={k: v.clone() for k, v in sd.items()},
            device="cpu", config=cfg)[0]

    t1 = port_engine()
    for b in batches[:2]:
        t1.train_batch(b)
    t1.save_checkpoint(str(tmp_path / "port"))
    whole = float(t1.train_batch(batches[2]))
    t2 = port_engine()
    t2.load_checkpoint(str(tmp_path / "port"))
    assert type(t2.optimizer).__name__ == "FusedLamb"
    tnext = float(t2.train_batch(batches[2]))
    assert repr(tnext) == repr(whole)
    np.testing.assert_allclose(tnext, jnext, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Serving from a checkpoint
# ---------------------------------------------------------------------------

def test_init_inference_from_a_checkpoint(tmp_path):
    e1, model = _engine()
    for b in _stream(2):
        e1.train_batch(b)
    path = e1.save_checkpoint(str(tmp_path))
    live = {k: v.clone() for k, v in model.state_dict().items()}
    params = load_module_params(str(tmp_path))
    assert set(params) == set(live)
    assert all(torch.equal(params[k], live[k]) for k in live)
    assert all(torch.equal(a, b) for a, b in zip(
        load_module_params(path).values(), params.values()))
    with pytest.raises(FileNotFoundError, match="not a tag directory"):
        load_module_params(str(tmp_path / "nothing"))

    prompt = np.random.default_rng(1).integers(0, 512, (2, 7))
    fresh = make_gpt("tiny", dtype=torch.float32)[0]
    from_ckpt = deepspeed_tpu_torch.init_inference(
        fresh, checkpoint=str(tmp_path), dtype=torch.float32, device="cpu")
    from_live = deepspeed_tpu_torch.init_inference(
        make_gpt("tiny", dtype=torch.float32)[0], params=live,
        dtype=torch.float32, device="cpu")
    a = from_ckpt.generate(prompt, max_new_tokens=6)
    assert torch.equal(a, from_live.generate(prompt, max_new_tokens=6))

    srv = deepspeed_tpu_torch.init_serving(
        make_gpt("tiny", dtype=torch.float32)[0], checkpoint=path,
        dtype=torch.float32, device="cpu",
        config={"serving": {"max_batch_size": 2, "kv_block_size": 4,
                            "kv_num_blocks": 16}})
    rid = srv.submit(prompt[0].tolist(), 6)
    assert srv.run_until_complete()[rid]["tokens"] == a[0].tolist()

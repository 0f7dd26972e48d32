"""Port parity: activation checkpointing
(``deepspeed_tpu_torch/runtime/activation_checkpointing.py``, the
``checkpointing`` alias, and ``remat`` in the GPT and BERT models) against
the JAX package.

- ``remat=True`` recomputes each block whole: the losses and every
  gradient equal ``remat=False`` bit for bit (fp32, dropout 0.1: the
  recomputed forward regenerates the keep masks from the folded seeds),
  under the engine's ``functional_call`` too, and are within 1e-5 of the
  JAX ``remat`` model's (dropout 0);
- the policies JAX's config maps to, in their torch forms: the default
  saves the plain products and recomputes the rest, ``partition_
  activations`` recomputes everything, ``cpu_checkpointing`` keeps what is
  saved on the host; each gives the direct call's value and gradient;
- ``configure`` / ``reset`` and the engine's ``activation_checkpointing``
  block, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch
import deepspeed_tpu_torch.checkpointing as alias
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import make_bert as jax_make_bert
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import (bert_params_from_flax,
                                        gpt_params_from_flax,
                                        init_bert_params, init_gpt_params,
                                        make_bert, make_gpt)
from deepspeed_tpu_torch.models.adapter import module_loss_fn
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_policy():
    ac.reset()
    jac.reset()
    yield
    ac.reset()
    jac.reset()


def _gpt_batch(seed=0):
    return {"input_ids": torch.from_numpy(np.random.default_rng(
        seed).integers(0, 512, (2, 32)))}


def _bert_batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (2, 32))
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    labels = np.where(rng.random(ids.shape) < 0.3, ids, -100)
    return {"input_ids": torch.from_numpy(ids),
            "attention_mask": torch.from_numpy(mask),
            "labels": torch.from_numpy(labels)}


def _loss_and_grads(model, sd, batch, seed):
    """Through the engine's adapter (``functional_call`` with leaf copies
    of the weights), as a training step differentiates."""
    model.load_state_dict(sd)
    fn, params = module_loss_fn(model)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    loss = fn(leaves, batch, seed)[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss, dict(zip(leaves, grads))


@pytest.mark.parametrize("family", ["gpt", "bert"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_equals_no_remat_bit_for_bit(family, dropout):
    make, init, batch = ((make_gpt, init_gpt_params, _gpt_batch())
                         if family == "gpt" else
                         (make_bert, init_bert_params, _bert_batch()))
    out = []
    for remat in (False, True):
        model, cfg = make("tiny", dtype=torch.float32, dropout_rate=dropout,
                          remat=remat)
        out.append(_loss_and_grads(model, init(cfg, seed=0), batch, 1234))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_recomputes_the_block_in_the_backward():
    """Under ``remat`` each block's forward runs again in the backward
    (counted at the attention call), and not without it."""
    from deepspeed_tpu_torch.models import gpt as gpt_mod

    calls = []
    orig = gpt_mod.attention

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return orig(*a, **k)

    gpt_mod.attention = counting
    try:
        for remat, want in ((False, 2), (True, 4)):
            calls.clear()
            model, cfg = make_gpt("tiny", dtype=torch.float32, remat=remat)
            _loss_and_grads(model, init_gpt_params(cfg, seed=0),
                            _gpt_batch(), None)
            assert len(calls) == want
    finally:
        gpt_mod.attention = orig


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_remat_matches_the_jax_remat_model(family):
    if family == "gpt":
        jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32,
                             remat=True)
        batch = _gpt_batch()
        conv, make = gpt_params_from_flax, make_gpt
    else:
        jm, _ = jax_make_bert("tiny", dropout_rate=0.0, dtype=jnp.float32,
                              remat=True)
        batch = _bert_batch()
        conv, make = bert_params_from_flax, make_bert
    jbatch = {k: v.numpy().astype(np.int32) for k, v in batch.items()}
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)}, jbatch)["params"]

    def jloss(p):
        return jm.apply({"params": p}, jbatch, deterministic=True)["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    sd = conv(jax.tree_util.tree_map(np.asarray, params))
    jg = conv(jax.tree_util.tree_map(np.asarray, jgrads))
    model, _ = make("tiny", dtype=torch.float32, dropout_rate=0.0,
                    remat=True)
    loss, grads = _loss_and_grads(model, sd, batch, 0)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, atol=0)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_engine_trains_with_remat_as_without():
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 512, (2, 2, 16),
                                          dtype=np.int32)} for _ in range(3)]
    losses = []
    for remat in (False, True):
        model, cfg = make_gpt("tiny", dtype=torch.float32, remat=remat,
                              dropout_rate=0.1)
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, params=init_gpt_params(cfg, seed=0), device="cpu",
            config={"train_micro_batch_size_per_gpu": 2,
                    "gradient_accumulation_steps": 2,
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3},
                                  "fused_update": True}})
        losses.append([repr(float(eng.train_batch(b))) for b in batches])
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# The policies
# ---------------------------------------------------------------------------

_POLICY_CASES = [
    ({}, "save_matmuls", "dots_with_no_batch_dims_saveable"),
    ({"partition_activations": True}, "nothing", "nothing_saveable"),
    ({"cpu_checkpointing": True}, "offload_to_host", None),
    ({"cpu_checkpointing": True, "partition_activations": True},
     "offload_to_host", None),
    ({"number_checkpoints": 4, "profile": True}, "save_matmuls",
     "dots_with_no_batch_dims_saveable")]


@pytest.mark.parametrize("block,name,jax_name", _POLICY_CASES)
def test_policy_of_each_config_as_in_jax(block, name, jax_name):
    d = {"train_batch_size": 2, "activation_checkpointing": block}
    jcfg = DeepSpeedTPUConfig(dict(d), world_size=1)
    tcfg = DeepSpeedConfig(dict(d))
    assert tcfg.activation_checkpointing.__dict__ == \
        jcfg.activation_checkpointing.__dict__
    assert tcfg.activation_checkpointing_provided
    assert ac.remat_policy(tcfg.activation_checkpointing) == name
    jpol = jac.remat_policy(jcfg.activation_checkpointing)
    if jax_name is not None:
        assert jpol is getattr(jax.checkpoint_policies, jax_name)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("block,recomputed_matmuls", [
    ({}, 0), ({"partition_activations": True}, 2),
    ({"cpu_checkpointing": True}, 2)])
def test_checkpoint_under_each_policy(block, recomputed_matmuls):
    """``checkpoint`` gives the direct call's value and gradients; the
    default policy recomputes no plain product in the backward, the other
    two recompute both."""
    ac.configure(deepspeed_config=DeepSpeedConfig(
        {"train_batch_size": 2, "activation_checkpointing": block}))
    w1 = torch.randn(8, 16, requires_grad=True)
    w2 = torch.randn(16, 4, requires_grad=True)
    x = torch.randn(5, 8, requires_grad=True)

    def f(x, w1, w2):
        return (torch.tanh(x @ w1) @ w2).square().sum()

    want = f(x, w1, w2)
    gwant = torch.autograd.grad(want, (x, w1, w2))
    got = alias.checkpoint(f, x, w1, w2)
    with _CountMatmuls() as count:
        ggot = torch.autograd.grad(got, (x, w1, w2))
    assert torch.equal(got, want)
    for a, b in zip(ggot, gwant):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    # the backward's own products (dx, dw of both) plus the recomputed ones
    assert count.n == 4 + recomputed_matmuls


def test_configure_reset_and_the_engine_block():
    assert not alias.is_configured() and alias.get_config() is None
    cfg = alias.configure(partition_activations=True, num_checkpoints=3)
    assert alias.is_configured() and cfg.number_checkpoints == 3
    assert alias.remat_policy() == "nothing"
    alias.reset()
    assert not ac.is_configured()

    def engine(extra):
        model, cfg = make_gpt("tiny", dtype=torch.float32)
        return deepspeed_tpu_torch.initialize(
            model=model, params=init_gpt_params(cfg, seed=0), device="cpu",
            config={"train_batch_size": 2, **extra})

    engine({})
    assert not ac.is_configured()        # no block: left untouched
    engine({"activation_checkpointing": {"cpu_checkpointing": True}})
    assert ac.remat_policy() == "offload_to_host"
    engine({})
    assert ac.remat_policy() == "offload_to_host"
    engine({"activation_checkpointing": {}})
    assert ac.remat_policy() == "save_matmuls"

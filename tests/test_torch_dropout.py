"""Port parity: activation dropout (deepspeed_tpu_torch/ops/dropout.py)
against deepspeed_tpu/ops/dropout.py, and dropout in the port's GPT and
training engine, on the CPU.

``hash_dropout`` is bit-equal to JAX's for the seed JAX derives from its
key, ``kd[0] ^ (kd[-1] << 1)``: same kept elements, same scaled values, in
fp32 and bf16. The GPT's sites fold their seeds with the port's own
``fold_seed`` (flax's ``make_rng`` folds need jax), so a whole model is
held to itself across paths and seeds, not to the JAX model's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.ops.dropout import hash_dropout as jax_hash_dropout
from deepspeed_tpu_torch.models import init_gpt_params, make_gpt
from deepspeed_tpu_torch.ops.dropout import (BernoulliDropout, HashDropout,
                                             dropout_module, fold_seed,
                                             hash_dropout)

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _seed_of(key) -> int:
    """The seed JAX's hash_dropout takes from a key, as a host int."""
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ (kd[-1] << np.uint32(1)))


def _binomial_ok(kept: int, n: int, p_keep: float) -> bool:
    """Within 5 standard deviations of the binomial mean."""
    return abs(kept - n * p_keep) <= 5 * (n * p_keep * (1 - p_keep)) ** 0.5


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_hash_dropout_bit_equal_to_jax(dtype, rate):
    """An odd shape [3, 37, 41], two keys. In bf16 the divisor ``1 - rate``
    is rounded to bf16 first (JAX divides by a weak-typed scalar): the
    control, a division by the unrounded 0.9 or 0.7, differs from JAX in
    hundreds of the kept elements."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(0).normal(size=(3, 37, 41)).astype(
        np.float32)
    for key in (jax.random.PRNGKey(0), jax.random.PRNGKey(12345)):
        want = np.asarray(jax_hash_dropout(jnp.asarray(x, jdt), rate, key)
                          .astype(jnp.float32))
        got = hash_dropout(torch.from_numpy(x).to(tdt), rate, _seed_of(key))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
        kept = want != 0
        assert _binomial_ok(int(kept.sum()), x.size, 1 - rate)
        if dtype == "bfloat16":
            naive = (torch.from_numpy(x).to(tdt) / (1 - rate)).float()
            assert (naive.numpy()[kept] != want[kept]).sum() > 100


def test_keep_share_and_scale():
    x = torch.ones(512, 512)
    y = hash_dropout(x, 0.1, 7)
    kept = y != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), 0.9)
    assert torch.all(y[kept] == torch.tensor(1.0) / torch.tensor(0.9))
    # the same seed gives the same mask, another seed another
    assert torch.equal(hash_dropout(x, 0.1, 7), y)
    assert not torch.equal(hash_dropout(x, 0.1, 8), y)


def test_deterministic_and_zero_rate_are_the_identity():
    x = torch.randn(4, 9)
    assert hash_dropout(x, 0.1, None) is x
    assert hash_dropout(x, 0.0, 3) is x
    for cls in (HashDropout, BernoulliDropout):
        assert cls(0.1)(x) is x and cls(0.1)(x, None) is x
        assert cls(0.0)(x, 5) is x


def test_bernoulli_dropout_distribution():
    """``fast_dropout=False``: a Bernoulli mask from a generator seeded by
    the site's seed; distribution-equal to flax's nn.Dropout (keep share,
    scale), reproducible per seed."""
    assert dropout_module(make_gpt("tiny")[1]) is HashDropout
    assert dropout_module(make_gpt("tiny", fast_dropout=False)[1]) is \
        BernoulliDropout
    drop = BernoulliDropout(0.3)
    x = torch.ones(256, 256)
    y = drop(x, 11)
    kept = y != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), 0.7)
    assert torch.all(y[kept] == torch.tensor(1.0) / torch.tensor(0.7))
    assert torch.equal(drop(x, 11), y) and not torch.equal(drop(x, 12), y)


def test_fold_seed():
    seeds = {fold_seed(5, layer, site) for layer in range(13)
             for site in range(3)}
    assert len(seeds) == 39
    assert all(0 <= s < 2 ** 32 for s in seeds)
    assert fold_seed(5, 1, 2) == fold_seed(5, 1, 2) != fold_seed(5, 2, 1)
    assert fold_seed(-1, 0) == fold_seed(2 ** 32 - 1, 0)


def _gpt(sd, **over):
    model, _ = make_gpt("tiny", dtype=torch.float32, dropout_rate=0.1,
                        **over)
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def tiny_weights():
    ids = np.random.default_rng(1).integers(0, 512, (2, 32))
    return init_gpt_params(make_gpt("tiny")[1], seed=3), \
        torch.from_numpy(ids)


def _loss_and_grads(model, ids, **kw):
    out = model(ids, **kw)
    out["loss"].backward()
    return out["loss"].detach(), {k: p.grad for k, p in
                                  model.named_parameters()}


def test_gpt_xla_and_flash_paths_agree_at_dropout(tiny_weights):
    """dropout 0.1, one seed: ``attention_impl="xla"`` and ``"flash"`` (on
    the CPU the kernels' plain version) drop the same probabilities (one
    mask function) and the same activations, so the loss and every
    gradient agree to fp32 rounding (1e-5 of the largest gradient)."""
    sd, ids = tiny_weights
    lx, gx = _loss_and_grads(_gpt(sd, attention_impl="xla"), ids,
                             dropout_seed=123)
    lf, gf = _loss_and_grads(_gpt(sd, attention_impl="flash"), ids,
                             dropout_seed=123)
    assert abs(float(lx) - float(lf)) <= 1e-6 * float(lx)
    for k in gx:
        scale = max(float(gx[k].abs().max()), 1e-3)
        assert float((gx[k] - gf[k]).abs().max()) <= 1e-5 * scale, k


def test_gpt_dropout_seeds_and_eval(tiny_weights):
    """The same seed gives the same loss, another seed another; a
    deterministic forward equals the dropout-0 model's training forward;
    a training forward without a seed raises."""
    sd, ids = tiny_weights
    model = _gpt(sd)
    a = model(ids, dropout_seed=5)["loss"]
    assert torch.equal(model(ids, dropout_seed=5)["loss"], a)
    assert not torch.equal(model(ids, dropout_seed=6)["loss"], a)
    plain = make_gpt("tiny", dtype=torch.float32, dropout_rate=0.0)[0]
    plain.load_state_dict(sd)
    det = model(ids, deterministic=True)["loss"]
    assert torch.equal(det, plain(ids)["loss"])
    assert not torch.equal(det, a)
    with pytest.raises(ValueError, match="needs dropout_seed"):
        model(ids)


def test_gpt_sparse_attention_keeps_the_activation_sites(tiny_weights):
    """Under ``sparse_attention`` the probabilities get no dropout (as in
    JAX) while the three activation sites still apply: the loss still
    depends on the seed, and a model whose dropout acts only inside
    attention gives the same loss for every seed."""
    sd, ids = tiny_weights
    block = {"mode": "bigbird", "block": 16, "attention": "unidirectional",
             "rng_seed": 41}
    model = _gpt(sd, sparse_attention=block)
    assert not torch.equal(model(ids, dropout_seed=1)["loss"],
                           model(ids, dropout_seed=2)["loss"])
    for blk in model.h:                # only the probabilities drop out
        blk.drop = HashDropout(0.0)
    model.drop = HashDropout(0.0)
    assert torch.equal(model(ids, dropout_seed=1)["loss"],
                       model(ids, dropout_seed=2)["loss"])


def test_initialize_train_batch_trains_at_dropout():
    """``make_gpt("tiny", dropout_rate=0.1)`` through ``initialize`` ->
    ``train_batch``: the engine draws one host seed per micro-batch from
    its CPU generator (``rng_seed``), the loss falls on a fixed batch, and
    two engines with one ``rng_seed`` give the same losses."""
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 2}}
    ids = np.random.default_rng(0).integers(0, 512, (2, 2, 32),
                                            dtype=np.int32)
    runs = []
    for _ in range(2):
        model, mcfg = make_gpt("tiny", dropout_rate=0.1, dtype=torch.float32)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, params=init_gpt_params(mcfg, seed=0), config=cfg,
            device="cpu")
        assert engine.generator.device.type == "cpu"
        runs.append([float(engine.train_batch({"input_ids": ids}))
                     for _ in range(4)])
    assert runs[0] == runs[1]
    assert np.all(np.isfinite(runs[0])) and runs[0][-1] < runs[0][0]

"""Port parity: BERT pretraining through the training engine
(deepspeed_tpu_torch.initialize -> train_batch) against
deepspeed_tpu.initialize on one CPU device: the tiny BERT, dropout 0,
LAMB (``bench.py:bench_bert``'s optimizer), ZeRO stage 2, micro-batch 2,
gradient accumulation 2, three steps, fed the same batches (MLM labels,
a key-padding mask) from the same weights.

- fp32: the three losses agree to 1e-5 relative and every final param to
  1e-5 absolute (readings: losses 1.5e-7, params 8.6e-7). LAMB's eps is
  1e-6 here for the GPT engine test's reason: the key third of each
  ``c_attn.bias`` has an exact gradient of 0, so its computed gradient is
  rounding noise, which eps 1e-8 turns into steps of +-lr whose sign
  differs between the two frameworks (params 3.3e-4 apart at eps 1e-8;
  at eps 1e-6 that third is held to 1e-4).
- bf16 with a bf16 accumulator (the bench config): see
  ``test_bf16_bench_config_matches_jax``.
- Sparse BERT: the JAX package's ``test_bert_sparse_with_padding_mask``
  case, and training through the config surgery at the reference's
  block 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine_bf16 import _param_change_errors

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.models import make_bert as jax_make_bert
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models import (bert_params_from_flax,
                                        init_flax_bert_params, make_bert)
from deepspeed_tpu_torch.ops.lamb import FusedLamb

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

MICRO, GAS, SEQ, STEPS = 2, 2, 32, 3


def _config(**extra):
    lamb = {"lr": 2e-3, "weight_decay": 0.01, "eps": 1e-6}
    cfg = {"train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "Lamb", "params": lamb},
           "zero_optimization": {"stage": 2}}
    cfg.update(extra)
    return cfg


def _batches(label_rate=0.15, seq=SEQ, seed=0):
    """``bench.py:bench_bert``'s batches (MLM labels at ``label_rate`` of
    the positions) with the second row of each micro-batch padded from
    position 20 (its keys masked, its labels -100 there)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = rng.integers(0, 512, (GAS, MICRO, seq), dtype=np.int32)
        mask = np.ones((GAS, MICRO, seq), np.int32)
        mask[:, 1, 20:] = 0
        labels = np.where(rng.random((GAS, MICRO, seq)) < label_rate, ids,
                          -100).astype(np.int32)
        labels[mask == 0] = -100
        out.append({"input_ids": ids, "attention_mask": mask,
                    "labels": labels})
    return out


def _runs(cfg, jdt, tdt, batches, **over):
    """Both engines from ``init_flax_bert_params(seed=0)``: the initial
    state_dict, then each side's losses and final state_dict."""
    tm, tcfg = make_bert("tiny", dtype=tdt, **over)
    tree = init_flax_bert_params(tcfg, seed=0)
    sd = bert_params_from_flax(tree)
    jm, _ = jax_make_bert("tiny", dropout_rate=0.0, dtype=jdt, **over)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jm, params=jax.tree_util.tree_map(jnp.asarray, tree),
        config=DeepSpeedTPUConfig(cfg, world_size=1),
        mesh=build_mesh(devices=jax.devices()[:1]))
    jl = [float(jeng.train_batch(b)) for b in batches]
    jp = bert_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                      jeng.state.params))
    eng, opt, _loader, _sched = deepspeed_tpu_torch.initialize(
        model=tm, params=sd, config=cfg, device="cpu")
    assert isinstance(opt, FusedLamb) and opt is eng.optimizer
    tl = [float(eng.train_batch(b)) for b in batches]
    tp = {k: v.detach() for k, v in tm.state_dict().items()}
    return eng, sd, (jl, jp), (tl, tp)


def _key_third(k, n):
    """The indices of ``k``'s key third if it is a ``c_attn.bias`` of n
    elements, else an empty slice."""
    return slice(n // 3, 2 * n // 3) if k.endswith("c_attn.bias") else \
        slice(0, 0)


def test_fp32_losses_and_params_match_jax():
    """Every final param to 1e-5, but the key third of each
    ``c_attn.bias`` (its gradient is rounding noise even at eps 1e-6; the
    module docstring), held to 1e-4 (reading: 1.1e-5)."""
    eng, _sd, (jl, jp), (tl, tp) = _runs(_config(), jnp.float32,
                                         torch.float32, _batches())
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert set(tp) == set(jp)
    for k in jp:
        got, want = tp[k].numpy().ravel(), jp[k].numpy().ravel()
        key = _key_third(k, want.size)
        rest = np.ones(want.size, bool)
        rest[key] = False
        np.testing.assert_allclose(got[rest], want[rest], atol=1e-5,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert eng.global_steps == STEPS and eng.state.step == STEPS
    assert eng.state.opt_state.step == STEPS and tl[-1] < tl[0]


# LAMB's first step on a tensor at 0 has trust 1 and moves each element
# by lr x g / (|g| + eps), about lr x sign(g): a bf16 rounding that flips
# the sign of a small gradient flips a whole step, and the later steps
# are too small (trust ~ ||w|| / ||update|| ~ lr) to dilute it.
ZERO_INIT_BIAS_TOL = 0.3


def test_bf16_bench_config_matches_jax():
    """bf16 compute and a bf16 accumulator (bench_bert's config), LAMB eps
    1e-6 as in fp32. The three losses agree to 1e-4 relative; each leaf's
    change over the three steps to 0.15 of JAX's change, except the
    biases that start at 0, held to ZERO_INIT_BIAS_TOL; the whole tree's
    change to 0.15. The key third of ``c_attn.bias`` is left out, as in
    the GPT's bf16 test.

    Every position carries an MLM label here, as every position is a
    target in the GPT's test: the loss is a mean over the labelled
    tokens, and at bench_bert's 15% (~10 tokens a micro-batch) its bf16
    rounding noise reaches the bound (losses 8.9e-5, 3.5e-5, 1.8e-4
    apart; the head alone, at 0 layers and before any update, 4.4e-5; the
    gradients of both packages sit 1.0-1.4e-2 from an fp32 run and
    1.5e-2 from each other). Readings on the CPU (this tree): losses
    7.7e-6, 9.8e-6, 5.1e-5; leaves other than the zero-init biases at
    most 0.082 (layer.1.ln_mlp.weight); zero-init biases (LayerNorm
    biases included) at most 0.236 (layer.0.ln_mlp.bias); the whole tree
    0.075. Controls, each in the port against the same JAX run: a
    dropped micro-batch (the first fed twice): losses 2.0e-4, 9.5e-4,
    7.6e-3, every leaf at least 0.55, the tree 0.81; no update (lr 0):
    every leaf 1.0, losses 1.5e-4 and 1.5e-3 at steps 2 and 3."""
    cfg = _config(bf16={"enabled": True},
                  data_types={"grad_accum_dtype": "bfloat16"})
    eng, sd, (jl, jp), (tl, tp) = _runs(cfg, jnp.bfloat16, torch.bfloat16,
                                        _batches(label_rate=1.0))
    assert all(a.dtype == torch.bfloat16 for a in eng.state.grad_acc)
    assert all(p.dtype == torch.float32 for p in eng.state.params)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    errs = _param_change_errors(sd, jp, tp)
    assert set(errs) == set(tp)
    for k, e in errs.items():
        zero_init = k.endswith(".bias") and not sd[k].any()
        assert e <= (ZERO_INIT_BIAS_TOL if zero_init else 0.15), (k, e)
    d_jax = np.concatenate([(jp[k].float() - sd[k]).numpy().ravel()
                            for k in sorted(jp)])
    d_port = np.concatenate([(tp[k].float() - sd[k]).numpy().ravel()
                             for k in sorted(jp)])
    assert np.linalg.norm(d_port - d_jax) <= 0.15 * np.linalg.norm(d_jax)


def test_sparse_bert_with_padding_mask_matches_jax():
    """``tests/test_sparse_attention.py::test_bert_sparse_with_padding_mask``
    through both packages: the tiny BERT routed by the surgery through
    bslongformer block 16 (the JAX side's xla executor, the port's kernel
    path's plain versions), seq 64, keys 48: masked. The losses agree to
    1e-5 relative, and tokens changed in the masked tail change neither
    side's loss."""
    from deepspeed_tpu.ops.sparse_attention import \
        SparseAttentionUtils as JaxUtils
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils

    block = {"mode": "bslongformer", "block": 16,
             "num_sliding_window_blocks": 3}
    jm, cfg = jax_make_bert("tiny", dropout_rate=0.0, dtype=jnp.float32)
    jm = JaxUtils.replace_model_self_attention_with_sparse_self_attention(
        jm, dict(block, impl="xla"))
    tm, tcfg = make_bert("tiny", dtype=torch.float32)
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, init_flax_bert_params(tcfg, seed=0))}
    tm.load_state_dict(bert_params_from_flax(init_flax_bert_params(
        tcfg, seed=0)))
    params_before = list(tm.parameters())
    tm = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(tm, block)
    assert all(a is b for a, b in zip(tm.parameters(), params_before))
    assert all(layer.cfg is tm.cfg for layer in tm.layer)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, (2, 64), dtype=np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[:, 48:] = 0
    labels = np.where(rng.random((2, 64)) < 0.15, ids, -100).astype(np.int32)
    labels[:, 48:] = -100
    ids2 = ids.copy()
    ids2[:, 48:] = (ids2[:, 48:] + 7) % cfg.vocab_size
    losses = []
    for x in (ids, ids2):
        batch = {"input_ids": x, "attention_mask": mask, "labels": labels}
        jl = float(jm.apply(params, batch, deterministic=True)["loss"])
        tl = float(tm(**{k: torch.from_numpy(v) for k, v in batch.items()},
                      deterministic=True)["loss"].detach())
        assert abs(tl - jl) <= 1e-5 * jl
        losses.append((jl, tl))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


@pytest.mark.parametrize("block", [
    {"mode": "fixed", "block": 16, "num_local_blocks": 2,
     "num_global_blocks": 1, "attention": "bidirectional"},
    {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
     "num_sliding_window_blocks": 3, "num_global_blocks": 1,
     "attention": "bidirectional", "rng_seed": 53}],
    ids=["fixed16", "bigbird16"])
def test_sparse_bert_training_matches_jax(block):
    """The tiny BERT at seq 64 with a block-16 ``sparse_attention`` block
    through ``initialize`` (the surgery included) on both sides,
    non-causal under the key mask: the losses of three train_batch steps
    to 1e-5 relative and every final param to 1e-5, fp32. The fixed
    layout draws nothing at random; BigBird's random blocks take an
    ``rng_seed`` no other test uses (the layout caches are process-global
    in both packages)."""
    cfg = _config(sparse_attention=block)
    eng, _sd, (jl, jp), (tl, tp) = _runs(cfg, jnp.float32, torch.float32,
                                         _batches(seq=64, seed=5),
                                         max_seq_len=64)
    assert eng.module.cfg.sparse_attention == block
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_default_device_is_the_card(monkeypatch):
    """``initialize`` with bench_bert's configuration and no ``device``
    takes the card: without one it raises instead of falling back to the
    CPU; ``device="cpu"`` builds."""
    cfg = {"train_micro_batch_size_per_gpu": 32,
           "gradient_accumulation_steps": 8,
           "optimizer": {"type": "Lamb", "params": {"lr": 2e-3}},
           "zero_optimization": {"stage": 2},
           "data_types": {"grad_accum_dtype": "bfloat16"},
           "bf16": {"enabled": True}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=make_bert("tiny")[0],
                                       config=cfg)
    eng, opt, *_ = deepspeed_tpu_torch.initialize(
        model=make_bert("tiny")[0], config=cfg, device="cpu")
    assert isinstance(opt, FusedLamb) and eng.gradient_accumulation_steps == 8


def test_sparse_surgery_routes_bert_in_place():
    """``initialize`` with a ``sparse_attention`` block routes a
    ``BertModel`` as it routes the GPT: the block on the model's and every
    layer's config, the same parameter objects, nothing done when the
    config already carries the block; a model without the config field is
    refused by the utility with the families named."""
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils

    block = {"mode": "fixed", "block": 16, "attention": "bidirectional"}
    model = make_bert("tiny", dtype=torch.float32, max_seq_len=64)[0]
    params = list(model.parameters())
    cfg = _config(sparse_attention=block)
    deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    assert model.cfg.sparse_attention == block
    assert all(layer.cfg is model.cfg for layer in model.layer)
    assert all(a is b for a, b in zip(model.parameters(), params))
    assert len(list(model.parameters())) == len(params)
    routed = model.cfg
    deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    assert model.cfg is routed
    with pytest.raises(ValueError, match="GPT and BERT"):
        SparseAttentionUtils.\
            replace_model_self_attention_with_sparse_self_attention(
                torch.nn.Linear(2, 2), block)

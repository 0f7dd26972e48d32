"""Port parity: the BERT model and its weight conversion
(deepspeed_tpu_torch.models) against deepspeed_tpu.models.make_bert, fp32
on the CPU, and its dropout sites.

Tolerances: the loss and the logits within 1e-5 (absolute; the loss is
~6.2, the logits ~0.5); every parameter's gradient within 1e-4 of the
leaf's norm (readings: at most 5e-6). Both sides run fp32; flax's
LayerNorm takes the variance as E[x^2] - E[x]^2, torch's as a two-pass
mean, and the matmuls sum in other orders. Model-level parity runs at
dropout 0 (flax's ``make_rng`` folds need jax); dropout is held site by
site against ``hash_dropout`` and ``dropout_keep_mask`` of each site's
folded seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import make_bert as jax_make_bert
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.models import (BERT_CONFIGS, make_bert,
                                        bert_params_from_flax,
                                        flax_params_from_bert,
                                        init_bert_params,
                                        init_flax_bert_params)
from deepspeed_tpu_torch.ops.dropout import fold_seed, hash_dropout
from deepspeed_tpu_torch.ops.transformer import attention as attn_mod
from deepspeed_tpu_torch.ops.transformer.flash_attention import \
    dropout_keep_mask

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

B, S = 3, 32
ATOL = 1e-5
GRAD_REL = 1e-4


def _batch(nsp=True, seed=0, vocab=512):
    """MLM labels at 15% of the positions, token types, a key mask with
    one row padded from 20 and one from 5 (a padded row's keys drop out of
    every query), and NSP labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S), dtype=np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    batch = {"input_ids": ids, "attention_mask": mask,
             "token_type_ids": rng.integers(0, 2, (B, S), dtype=np.int32),
             "labels": np.where(rng.random((B, S)) < 0.15, ids,
                                -100).astype(np.int32)}
    if nsp:
        batch["next_sentence_label"] = rng.integers(0, 2, (B,),
                                                    dtype=np.int32)
    return batch


def _pair(nsp=True, **over):
    """The tiny BERT in both packages on the same weights
    (``init_flax_bert_params``), fp32, dropout 0."""
    jm, _ = jax_make_bert("tiny", dropout_rate=0.0, dtype=jnp.float32,
                          **over)
    tm, cfg = make_bert("tiny", nsp=nsp, dtype=torch.float32, **over)
    tree = init_flax_bert_params(cfg, seed=0, nsp=nsp)
    tm.load_state_dict(bert_params_from_flax(tree), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("over", [
    {}, {"pre_layer_norm": False}, {"fused_ce": False},
    {"pre_layer_norm": False, "fused_ce": False},
    {"fused_ce_fp32_logits": True}],
    ids=["preln", "postln", "preln_unfused", "postln_unfused",
         "fp32_logits"])
def test_forward_and_grads_match_jax(over):
    """Deterministic forward (loss, MLM and NSP logits), then the training
    forward's loss and every gradient against ``jax.grad``."""
    jm, params, tm = _pair(**over)
    batch = _batch()
    jout = jax.jit(jm.apply, static_argnames="deterministic")(
        {"params": params}, batch, deterministic=True)
    tout = tm(**_torch_batch(batch), deterministic=True)
    for key in ("logits", "nsp_logits"):
        want = np.asarray(jout[key])
        got = tout[key].detach().numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= ATOL, key
    assert abs(float(tout["loss"].detach()) - float(jout["loss"])) <= ATOL

    def jloss(p):
        return jm.apply({"params": p}, batch, deterministic=False)["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    out = tm(**_torch_batch(batch))
    if tm.cfg.fused_ce:
        assert out["logits"] is None          # not materialised in training
    out["loss"].backward()
    assert abs(float(out["loss"].detach()) - float(want)) <= ATOL
    wg = bert_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(wg) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        w = wg[k].numpy()
        err = np.linalg.norm(p.grad.numpy() - w)
        assert err <= GRAD_REL * max(np.linalg.norm(w), 1e-6), k


def test_forward_without_optional_keys_matches_jax():
    """No token types (type 0 broadcast), no mask, no labels (loss 0, the
    logits still made), no NSP head."""
    jm, params, tm = _pair(nsp=False)
    ids = _batch(nsp=False)["input_ids"]
    jout = jm.apply({"params": params}, {"input_ids": ids},
                    deterministic=True)
    tout = tm(torch.from_numpy(ids))
    assert float(tout["loss"]) == 0.0 == float(jout["loss"])
    assert "nsp_logits" not in tout
    assert np.abs(tout["logits"].detach().numpy()
                  - np.asarray(jout["logits"])).max() <= ATOL


@pytest.mark.parametrize("nsp", [False, True])
def test_flax_tree_and_round_trip(nsp):
    """``init_flax_bert_params`` makes the tree ``BertModel.init`` makes
    (same paths, shapes and dtypes; ``pooler`` / ``nsp_head`` only when
    the init batch carries ``next_sentence_label``), and the round trip
    through the port's ``state_dict`` is bit-exact."""
    for pre in (True, False):
        jm, cfg = jax_make_bert("tiny", pre_layer_norm=pre)
        batch = _batch(nsp=nsp)
        ref = jm.init({"params": jax.random.PRNGKey(0),
                       "dropout": jax.random.PRNGKey(1)}, batch)["params"]
        tcfg = make_bert("tiny", pre_layer_norm=pre)[1]
        tree = init_flax_bert_params(tcfg, seed=0, nsp=nsp)
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(ref)):
            assert a.shape == b.shape and a.dtype == b.dtype
        sd = bert_params_from_flax(tree)
        assert ("pooler.weight" in sd) == nsp
        model = make_bert("tiny", nsp=nsp, pre_layer_norm=pre)[0]
        model.load_state_dict(sd, strict=True)
        back = flax_params_from_bert(model.state_dict())
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    tree = init_flax_bert_params(BERT_CONFIGS["tiny"], seed=0)
    assert abs(tree["wte"].std() - 0.02) < 2e-3
    k = tree["layer_0"]["c_fc"]["kernel"]          # lecun_normal, fan_in 64
    assert abs(k.std() - 1 / 8) < 0.01
    assert not tree["mlm_bias"].any()
    assert np.array_equal(init_bert_params(BERT_CONFIGS["tiny"])["wte"]
                          .numpy(), tree["wte"])


def test_nsp_labels_need_the_head():
    """A model built without the NSP head holds exactly a tree without
    it; ``next_sentence_label`` then raises, where flax would have made
    the head at init."""
    model = make_bert("tiny", dtype=torch.float32)[0]
    assert model.pooler is None and model.nsp_head is None
    with pytest.raises(ValueError, match="without the NSP head"):
        model(**_torch_batch(_batch(nsp=True)))


@pytest.mark.parametrize("override", [{"sparse_embedding_grad": True},
                                      {"sparse_embedding_grad": ("data",)}])
def test_training_options_not_yet_ported(override):
    with pytest.raises(ConfigError, match="not yet ported"):
        make_bert("tiny", **override)


def test_pld_theta_not_yet_ported():
    model = make_bert("tiny", dtype=torch.float32)[0]
    with pytest.raises(ConfigError, match="not yet ported"):
        model(**_torch_batch(_batch(nsp=False)),
              pld_theta=torch.tensor(0.5))


@pytest.mark.parametrize("name", ["tiny", "bert-base", "bert-large"])
def test_config_defaults_match_jax(name):
    """Every field both ``BertConfig``s have agrees (dtypes by name)."""
    _jm, jcfg = jax_make_bert(name)
    tcfg = BERT_CONFIGS[name]
    jf = jcfg.__dataclass_fields__
    shared = [f for f in tcfg.__dataclass_fields__ if f in jf]
    assert len(shared) == len(jf) == 18
    for f in shared:
        a, b = getattr(tcfg, f), getattr(jcfg, f)
        if f == "dtype":
            a, b = str(a).split(".")[-1], jnp.dtype(b).name
        assert a == b, (f, a, b)


def _dropout_model(sd, **over):
    model = make_bert("tiny", dtype=torch.float32, dropout_rate=0.1,
                      **over)[0]
    model.load_state_dict(sd)
    return model


def _masked_attention_at_dropout(q, k, v, mask, rate, seed):
    """Non-causal attention under a [B, 1, 1, S] key mask, its fp32
    probabilities kept where ``dropout_keep_mask`` of (seed, b * H + h,
    row, col) is set and scaled by 1 / (1 - rate), written out here."""
    b, s, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    bh = (torch.arange(b)[:, None] * h + torch.arange(h)[None, :])
    keep = dropout_keep_mask(seed, bh[:, :, None, None],
                             torch.arange(s)[:, None],
                             torch.arange(s)[None, :], rate)
    probs = torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def test_dropout_sites_use_their_folded_seeds(monkeypatch):
    """At dropout 0.1 a training forward drops out at the JAX model's
    sites, each with its own seed folded from ``dropout_seed``: the
    embeddings ``(0, 0)``, then per layer i the attention output ``(i + 1,
    1)`` and the MLP output ``(i + 1, 2)``, each exactly
    ``hash_dropout(x, 0.1, seed)``; the probabilities of layer i drop out
    with ``dropout_keep_mask`` of ``(i + 1, 0)``, the mask the plain
    attention and the flash kernels share."""
    from deepspeed_tpu_torch.ops import dropout as drop_mod

    sd = init_bert_params(BERT_CONFIGS["tiny"], seed=2)
    model = _dropout_model(sd)
    batch = _torch_batch(_batch(nsp=False))
    hidden, probs = [], []
    real_drop, real_attn = drop_mod.hash_dropout, attn_mod.xla_attention

    def record(x, rate, seed):
        y = real_drop(x, rate, seed)
        hidden.append((x.detach(), y.detach(), rate, seed))
        return y

    def record_attn(q, k, v, **kw):
        o = real_attn(q, k, v, **kw)
        probs.append((q.detach(), k.detach(), v.detach(), kw, o.detach()))
        return o

    monkeypatch.setattr(drop_mod, "hash_dropout", record)
    monkeypatch.setattr(attn_mod, "xla_attention", record_attn)
    model(**batch, dropout_seed=77)
    layers = BERT_CONFIGS["tiny"].num_layers
    want = [fold_seed(77, 0, 0)] + [fold_seed(77, i + 1, site)
                                    for i in range(layers)
                                    for site in (1, 2)]
    assert [h[3] for h in hidden] == want
    for x, y, rate, seed in hidden:
        assert rate == 0.1 and torch.equal(y, hash_dropout(x, 0.1, seed))
        assert 0.85 < float((y != 0).float().mean()) < 0.95
    assert len(probs) == layers
    for i, (q, k, v, kw, o) in enumerate(probs):
        assert kw["dropout_rate"] == 0.1
        assert kw["dropout_seed"] == fold_seed(77, i + 1, 0)
        assert not kw["causal"]
        want = _masked_attention_at_dropout(q, k, v, kw["mask"], 0.1,
                                            fold_seed(77, i + 1, 0))
        assert float((o - want).abs().max()) <= 1e-6


def test_dropout_paths_and_seeds():
    """``attention_impl="xla"`` and ``"flash"`` (the kernels' plain
    version on the CPU) drop the same probabilities under the key mask:
    equal losses to fp32 rounding. The same seed gives the same loss,
    another seed another; a deterministic forward equals the dropout-0
    model's; a training forward without a seed raises."""
    sd = init_bert_params(BERT_CONFIGS["tiny"], seed=2)
    batch = _torch_batch(_batch(nsp=False))
    lx = _dropout_model(sd, attention_impl="xla")(
        **batch, dropout_seed=9)["loss"].detach()
    model = _dropout_model(sd, attention_impl="flash")
    lf = model(**batch, dropout_seed=9)["loss"].detach()
    assert abs(float(lx) - float(lf)) <= 1e-6 * float(lx)
    assert torch.equal(model(**batch, dropout_seed=9)["loss"], lf)
    assert not torch.equal(model(**batch, dropout_seed=10)["loss"], lf)
    plain = make_bert("tiny", dtype=torch.float32)[0]
    plain.load_state_dict(sd)
    det = model(**batch, deterministic=True)["loss"]
    assert torch.equal(det, plain(**batch, deterministic=True)["loss"])
    with pytest.raises(ValueError, match="needs dropout_seed"):
        model(**batch)

"""Port parity: the GPT model, weight conversion and ``generate``
(deepspeed_tpu_torch) against the JAX package, fp32 on the CPU.

Tolerance for logits: max |diff| <= 1e-4. Both sides run fp32, but flax's
LayerNorm takes the variance as E[x^2] - E[x]^2 and torch's as a two-pass
mean of squared deviations, and the matmuls sum in other orders.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.models.gpt import init_kv_cache as jax_init_kv_cache
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.models import (GPT_CONFIGS, flax_params_from_gpt,
                                        gpt_params_from_flax,
                                        init_flax_gpt_params, init_kv_cache,
                                        make_gpt)

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

LOGITS_ATOL = 1e-4


def _flax_init(model, seed=0):
    return jax.jit(model.init)({"params": jax.random.PRNGKey(seed),
                                "dropout": jax.random.PRNGKey(seed + 1)},
                               {"input_ids": np.zeros((1, 8), np.int32)}
                               )["params"]


def _jax_params(model, seed=0):
    """Weights for the JAX ``model``: ``init_flax_gpt_params`` of its
    configuration, the tree and distributions of flax's init (held by
    ``test_seeded_weights_have_the_flax_layout_and_distributions``)
    without flax's eager init, which costs seconds per model."""
    c = model.cfg
    cfg = replace(GPT_CONFIGS["tiny"], **{f: getattr(c, f) for f in (
        "vocab_size", "max_seq_len", "hidden_size", "num_layers",
        "num_heads", "mlp_ratio", "tie_embeddings", "vocab_pad_multiple")})
    return jax.tree_util.tree_map(jnp.asarray,
                                  init_flax_gpt_params(cfg, seed))


def _pair(**overrides):
    """The tiny GPT in both packages on the same (flax-initialised)
    weights; the port's engine on the CPU in fp32."""
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32,
                         **overrides)
    params = _jax_params(jm)
    tm, _ = make_gpt("tiny", dtype=torch.float32, **overrides)
    sd = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    eng = deepspeed_tpu_torch.init_inference(tm, params=sd,
                                             dtype=torch.float32,
                                             device="cpu")
    return jm, params, eng


@pytest.fixture(scope="module")
def tiny_pair():
    return _pair()


def test_flax_round_trip_is_bit_exact(tiny_pair):
    _jm, params, _eng = tiny_pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = flax_params_from_gpt(gpt_params_from_flax(tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("tie", [True, False])
def test_logits_match_jax(tie, tiny_pair):
    jm, params, eng = tiny_pair if tie else _pair(tie_embeddings=False)
    ids = np.random.default_rng(1).integers(0, 512, (2, 24), dtype=np.int32)
    want = np.asarray(jax.jit(jm.apply, static_argnames="deterministic")(
        {"params": params}, {"input_ids": ids}, deterministic=True)["logits"])
    got = eng.forward(ids)["logits"].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGITS_ATOL


def test_bf16_tied_head_keeps_fp32_logits():
    """In bf16 the tied head multiplies bf16-rounded operands with fp32
    sums, as the JAX einsum with ``preferred_element_type=float32`` does:
    no bf16 rounding of the logits. With no blocks the logits are the head
    of LN(embedding) alone, so both sides agree to fp32 summation order
    (1e-5), well under the ~1e-3 a bf16 rounding of them would cost."""
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.bfloat16,
                         num_layers=0)
    params = _jax_params(jm)
    tm, _ = make_gpt("tiny", dtype=torch.bfloat16, num_layers=0)
    sd = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    eng = deepspeed_tpu_torch.init_inference(tm, params=sd,
                                             dtype=torch.bfloat16,
                                             device="cpu")
    ids = np.random.default_rng(4).integers(0, 512, (2, 16), dtype=np.int32)
    want = jm.apply({"params": params}, {"input_ids": ids},
                    deterministic=True)["logits"]
    got = eng.forward(ids)["logits"]
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    want_bf16 = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(want)
    assert np.abs(want_bf16 - want).max() > 1e-4   # the rounding avoided
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_dense_cache_prefill_and_decode_match_jax(tiny_pair):
    """Prefill 10 tokens into the dense cache, then 4 single-token decode
    steps, on both sides; every step's logits agree."""
    jm, params, eng = tiny_pair
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (2, 10), dtype=np.int32)
    steps = rng.integers(0, 512, (4, 2, 1), dtype=np.int32)
    jcache = jax_init_kv_cache(jm.cfg, 2, 16, dtype=jnp.float32)
    tcache = init_kv_cache(eng.model_cfg, 2, 16, dtype=torch.float32)
    # one compiled program per input shape (pos traced), not op by op
    apply = jax.jit(lambda ids, cache, pos: jm.apply(
        {"params": params}, {"input_ids": ids}, deterministic=True,
        cache=cache, pos=pos))
    jo = apply(ids, jcache, 0)
    to = eng.forward(ids, cache=tcache, pos=0)
    assert np.abs(to["logits"].numpy()
                  - np.asarray(jo["logits"])).max() <= LOGITS_ATOL
    for i, tok in enumerate(steps):
        jo = apply(tok, jo["cache"], 10 + i)
        to = eng.forward(tok, cache=to["cache"], pos=10 + i)
        assert np.abs(to["logits"].numpy()
                      - np.asarray(jo["logits"])).max() <= LOGITS_ATOL


def test_generate_matches_jax_on_ragged_prompts(tiny_pair):
    """Greedy generate is token-identical with left-padded ragged prompts
    (masked pads, re-based positions, pow2 prompt buckets)."""
    jm, params, eng = tiny_pair
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 512, (3, 11), dtype=np.int32)
    mask = np.ones((3, 11), np.int32)
    mask[0, :5] = 0
    mask[2, :9] = 0
    ids[mask == 0] = 0
    jeng = deepspeed_tpu.init_inference(jm, params=params,
                                        dtype=jnp.float32)
    want = np.asarray(jeng.generate(ids, max_new_tokens=9,
                                    attention_mask=mask))
    got = eng.generate(ids, max_new_tokens=9, attention_mask=mask).numpy()
    np.testing.assert_array_equal(got, want)
    # no mask at all: the prompt is taken as unpadded
    want = np.asarray(jeng.generate(ids[1:2, :7], max_new_tokens=5))
    got = eng.generate(ids[1:2, :7], max_new_tokens=5).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_walls(tiny_pair):
    _jm, _params, eng = tiny_pair
    with pytest.raises(ValueError, match="usable context"):
        eng.generate(np.zeros((1, 120), np.int32), max_new_tokens=9)
    with pytest.raises(ValueError, match="left-padded"):
        eng.generate(np.ones((1, 4), np.int32), max_new_tokens=2,
                     attention_mask=np.array([[1, 0, 1, 1]]))


def test_seeded_weights_have_the_flax_layout_and_distributions():
    """init_flax_gpt_params makes the tree GPT.init makes (same paths,
    shapes and dtypes) with flax's initialiser distributions."""
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0)
    ref = _flax_init(jm)
    tree = init_flax_gpt_params(GPT_CONFIGS["tiny"], seed=0)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert abs(tree["wte"].std() - 0.02) < 2e-3
    assert abs(tree["wpe"].std() - 0.01) < 1e-3
    k = tree["h_0"]["c_fc"]["kernel"]               # lecun_normal, fan_in 64
    assert abs(k.std() - 1 / 8) < 0.01 and np.abs(k).max() <= 2 / 0.8796 / 8
    assert np.array_equal(tree["ln_f"]["scale"], np.ones(64, np.float32))
    again = init_flax_gpt_params(GPT_CONFIGS["tiny"], seed=0)
    assert np.array_equal(again["h_1"]["c_attn"]["kernel"],
                          tree["h_1"]["c_attn"]["kernel"])


@pytest.mark.parametrize("override", [
    {"moe_experts": 4}, {"remat": True}, {"sparse_embedding_grad": True}])
def test_training_options_not_yet_ported(override):
    """Each option is refused at construction. ``fused_ln`` and dropout
    are ported: tests/test_torch_fused_ln.py holds fused_ln's values and
    sites, tests/test_torch_dropout.py the dropout sites."""
    with pytest.raises(ConfigError, match="not yet ported"):
        model, _ = make_gpt("tiny", **override)
        model(torch.zeros(1, 4, dtype=torch.long), deterministic=False)


@pytest.mark.parametrize("name", ["tiny", "gpt2"])
def test_config_defaults_match_jax(name):
    """``make_gpt(name)`` builds the same configuration in both packages:
    every field they share agrees (dtypes by name)."""
    _jm, jcfg = jax_make_gpt(name)
    _tm, tcfg = make_gpt(name) if name == "tiny" else (None, GPT_CONFIGS[
        name])
    jf = jcfg.__dataclass_fields__
    shared = [f for f in tcfg.__dataclass_fields__ if f in jf]
    assert len(shared) >= 20
    for f in shared:
        a, b = getattr(tcfg, f), getattr(jcfg, f)
        if f == "dtype":
            a, b = str(a).split(".")[-1], jnp.dtype(b).name
        assert a == b, (f, a, b)
    assert tcfg.head_dim == jcfg.head_dim
    assert tcfg.padded_vocab == jcfg.padded_vocab


def test_dropout_config_still_serves():
    """A dropout-0.1 config (the gpt2 default) serves and evaluates: cache
    mode and deterministic forwards ignore dropout, as in JAX."""
    cfg = GPT_CONFIGS["tiny"]
    model, _ = make_gpt("tiny", dropout_rate=0.1, dtype=torch.float32)
    sd = deepspeed_tpu_torch.models.init_gpt_params(cfg, seed=0)
    srv = deepspeed_tpu_torch.init_serving(
        model, params=sd, dtype=torch.float32, device="cpu",
        config={"serving": {"max_batch_size": 2, "kv_block_size": 4,
                            "kv_num_blocks": 16}})
    rid = srv.submit([1, 2, 3], 3)
    assert len(srv.run_until_complete()[rid]["tokens"]) == 6
    out = srv.engine.forward(np.array([[1, 2, 3, 4]]))
    assert torch.isfinite(out["loss"]) and out["logits"].shape == (1, 4, 512)


@pytest.mark.parametrize("padded", [False, True])
def test_training_loss_and_grads_match_jax(padded):
    """The training forward (fused CE head, shifted labels, key-padding
    mask) and its gradient against jax.grad of the JAX model, fp32: loss to
    1e-5 relative, every parameter's gradient to 1e-5 of its largest
    element. ``padded`` pads the vocab to a multiple of 128 (masked pad
    logits, pad rows with zero gradient)."""
    over = {"vocab_pad_multiple": 128} if padded else {}
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32,
                         vocab_size=500, **over)
    params = _jax_params(jm)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 500, (2, 20), dtype=np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[1, 15:] = 0
    batch = {"input_ids": ids, "attention_mask": mask}

    def jloss(p):
        return jm.apply({"params": p}, batch, deterministic=True)["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    tm, _ = make_gpt("tiny", dtype=torch.float32, vocab_size=500, **over)
    tm.load_state_dict(gpt_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    out = tm(torch.from_numpy(ids).long(),
             attention_mask=torch.from_numpy(mask))
    assert out["logits"] is None          # not materialised in training
    out["loss"].backward()
    assert abs(float(out["loss"].detach()) - float(want)) <= 1e-5 * float(want)
    wg = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in tm.named_parameters():
        w = wg[k].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * max(
            np.abs(w).max(), 1e-3), k


SPARSE_BLOCK = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
                "num_sliding_window_blocks": 3, "num_global_blocks": 1,
                "attention": "unidirectional", "rng_seed": 17}


def test_sparse_attention_model_matches_jax():
    """A tiny GPT whose attention is BigBird block-sparse (block 16, seq
    64), fp32: deterministic logits to 1e-4, and the training forward with
    a key-padding mask (its loss to 1e-5 relative, every gradient to 1e-5
    of its largest element) against the JAX model on the same weights.
    The JAX side runs its xla executor, the port its kernel path's plain
    versions; both draw the layout once for the config and length."""
    over = {"sparse_attention": dict(SPARSE_BLOCK), "max_seq_len": 64}
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32, **over)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 512, (2, 64), dtype=np.int32)
    # the sparse path adds no parameters: the dense model's init is its
    params = _jax_params(jax_make_gpt("tiny", dropout_rate=0.0,
                                      dtype=jnp.float32, max_seq_len=64)[0])
    sd = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    eng = deepspeed_tpu_torch.init_inference(
        make_gpt("tiny", dtype=torch.float32, **over)[0], params=sd,
        dtype=torch.float32, device="cpu")
    want = np.asarray(jax.jit(jm.apply, static_argnames="deterministic")(
        {"params": params}, {"input_ids": ids}, deterministic=True)["logits"])
    got = eng.forward(ids)["logits"].numpy()
    assert np.abs(got - want).max() <= LOGITS_ATOL
    mask = np.ones((2, 64), np.int32)
    mask[1, 40:] = 0
    batch = {"input_ids": ids, "attention_mask": mask}
    wloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, batch, deterministic=True)["loss"]))(params)
    tm, _ = make_gpt("tiny", dtype=torch.float32, **over)
    tm.load_state_dict(sd)
    out = tm(torch.from_numpy(ids).long(),
             attention_mask=torch.from_numpy(mask))
    out["loss"].backward()
    assert abs(float(out["loss"].detach()) - float(wloss)) <= \
        1e-5 * float(wloss)
    wg = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in tm.named_parameters():
        w = wg[k].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * max(
            np.abs(w).max(), 1e-3), k
    # decode with a cache stays dense, as in JAX
    assert eng.generate(ids[:1, :8], max_new_tokens=2).shape == (1, 10)

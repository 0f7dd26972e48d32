"""Port parity: DeepSpeedTransformerLayer
(deepspeed_tpu_torch.ops.transformer) against the JAX layer on
``tests/test_transformer_layer.py``'s grid, fp32 on the CPU, and against
the port's own BertLayer.

Tolerances: the output within 1e-5 (absolute) of the JAX layer's, every
gradient within 1e-4 of the leaf's norm. The checkpoint options recompute
the same ops with the same dropout seeds, so they are held bit-equal to
the option off; the layer and the port's ``BertLayer`` run the same ops on
the same weights and are held bit-equal too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import \
    DeepSpeedTransformerConfig as JaxConfig
from deepspeed_tpu.ops.transformer import \
    DeepSpeedTransformerLayer as JaxLayer
from deepspeed_tpu_torch.models import (BertLayer, bert_layer_params_from_flax,
                                        make_bert)
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

GRID = [(2, 16, 32, 4), (1, 64, 64, 8), (3, 8, 48, 3)]  # (b, s, d, heads)
OPTIONS = [{"normalize_invertible": True}, {"gelu_checkpoint": True},
           {"attn_dropout_checkpoint": True},
           {"normalize_invertible": True, "gelu_checkpoint": True,
            "attn_dropout_checkpoint": True}]


def _configs(b, s, d, h, pre_ln=True, rate=0.0, **opts):
    kw = dict(batch_size=b, hidden_size=d, heads=h, max_seq_length=s,
              attn_dropout_ratio=rate, hidden_dropout_ratio=rate,
              pre_layer_norm=pre_ln, num_hidden_layers=1, **opts)
    return JaxConfig(**kw), DeepSpeedTransformerConfig(**kw)


def _pair(b, s, d, h, pre_ln=True, **opts):
    """Both layers on the JAX layer's initial weights, and x [b, s, d]."""
    jcfg, tcfg = _configs(b, s, d, h, pre_ln, **opts)
    jl = JaxLayer(jcfg)
    x = np.random.default_rng(0).standard_normal((b, s, d)).astype(
        np.float32)
    params = jl.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))[
        "params"]
    tl = DeepSpeedTransformerLayer(tcfg)
    tl.load_state_dict(bert_layer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jl, params, tl, x


def _mask(b, s):
    am = np.ones((b, s), np.int32)
    am[0, s // 2:] = 0
    return am


def _weights(shape):
    """The loss's fixed output weights: sum(out * r). (sum(out ** 2), the
    JAX test's loss, is a constant of a post-LN layer's input: every
    gradient but the last LayerNorm's is rounding noise.)"""
    return np.random.default_rng(7).standard_normal(shape).astype(
        np.float32)


def _port_grads(tl, x, mask=None, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    out = tl(xt, mask, **kw)
    (out * torch.from_numpy(_weights(out.shape))).sum().backward()
    grads = {k: p.grad.clone() for k, p in tl.named_parameters()}
    tl.zero_grad()
    return out.detach(), grads, xt.grad


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("b,s,d,h", GRID)
def test_forward_and_grads_match_jax(b, s, d, h, pre_ln):
    """The output and the gradient of sum(out * r) of every parameter,
    without a mask and with a key mask ([B, 1, 1, S] bool, as the JAX test
    passes it)."""
    jl, params, tl, x = _pair(b, s, d, h, pre_ln)
    r = jnp.asarray(_weights((b, s, d)))

    @jax.jit
    def jax_run(p, mask):
        def loss(p):
            out = jl.apply({"params": p}, jnp.asarray(x), mask, True)
            return jnp.sum(out * r), out
        return jax.grad(loss, has_aux=True)(p)

    for am in (None, _mask(b, s)):
        jmask = (None if am is None
                 else jnp.asarray(am)[:, None, None, :].astype(bool))
        tmask = (None if am is None
                 else torch.from_numpy(am).bool()[:, None, None, :])
        jg, want = jax_run(params, jmask)
        got, grads, _ = _port_grads(tl, x, tmask)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
        wg = bert_layer_params_from_flax(jax.tree_util.tree_map(
            np.asarray, jg))
        for k, g in grads.items():
            w = wg[k].numpy()
            assert np.linalg.norm(g.numpy() - w) <= 1e-4 * max(
                np.linalg.norm(w), 1e-6), k


@pytest.mark.parametrize("opts", OPTIONS,
                         ids=["norm", "gelu", "attn", "all"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_checkpoint_options_are_bit_equal_to_off(opts, rate):
    """Each memory option recomputes its piece in the backward
    (``torch.utils.checkpoint``): outputs and every gradient (input
    included) equal the option off to the bit, at dropout 0 and at 0.1
    (the recomputation draws the same hash masks from the same seeds)."""
    b, s, d, h = GRID[0]
    kw = {} if rate == 0.0 else {"deterministic": False, "dropout_seed": 5}
    runs = []
    for o in ({}, opts):
        _jcfg, tcfg = _configs(b, s, d, h, rate=rate, **o)
        torch.manual_seed(0)
        tl = DeepSpeedTransformerLayer(tcfg)
        x = np.random.default_rng(1).standard_normal((b, s, d)).astype(
            np.float32)
        runs.append(_port_grads(tl, x, torch.from_numpy(_mask(b, s)), **kw))
    (o0, g0, x0), (o1, g1, x1) = runs
    assert torch.equal(o0, o1) and torch.equal(x0, x1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("opts", OPTIONS[-1:], ids=["all"])
def test_options_match_jax_grads(opts):
    """With every option on, the gradients still match the JAX layer with
    every option on (its ``nn.remat``)."""
    b, s, d, h = GRID[1]
    jl, params, tl, x = _pair(b, s, d, h, **opts)
    _got, grads, _ = _port_grads(tl, x)
    r = jnp.asarray(_weights(x.shape))
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jl.apply(
        {"params": p}, jnp.asarray(x), None, True) * r)))(params)
    wg = bert_layer_params_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    for k, g in grads.items():
        w = wg[k].numpy()
        assert np.linalg.norm(g.numpy() - w) <= 1e-4 * np.linalg.norm(w), k


@pytest.mark.parametrize("dtype,fp16", [(torch.float32, False),
                                        (torch.bfloat16, True)])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_equals_bert_layer(pre_ln, dtype, fp16):
    """The layer and ``models/bert.py:BertLayer`` of the same width on the
    same weights give the same output and gradients, to the bit, in fp32
    and in bf16 (``fp16=True`` selects bf16, as in JAX)."""
    b, s, d, h = GRID[0]
    _jcfg, tcfg = _configs(b, s, d, h, pre_ln, fp16=fp16)
    assert tcfg.dtype == dtype and tcfg.intermediate_size == 4 * d
    torch.manual_seed(0)
    tl = DeepSpeedTransformerLayer(tcfg)
    bl = BertLayer(make_bert("tiny", hidden_size=d, num_heads=h,
                             pre_layer_norm=pre_ln, dtype=dtype)[1])
    bl.load_state_dict(tl.state_dict(), strict=True)
    x = np.random.default_rng(2).standard_normal((b, s, d)).astype(
        np.float32)
    mask = torch.from_numpy(_mask(b, s)).bool()[:, None, None, :]
    xt = torch.from_numpy(x).to(dtype)
    a, ga, xa = _port_grads(tl, xt.float().numpy(), mask)
    xb = xt.clone().float().requires_grad_()
    out = bl(xb, mask)
    (out * torch.from_numpy(_weights(out.shape))).sum().backward()
    assert torch.equal(a, out.detach())
    assert torch.equal(xa, xb.grad)
    for k, p in bl.named_parameters():
        assert torch.equal(ga[k], p.grad), k


def test_dropout_seeds_and_init():
    """Dropout acts only with ``deterministic=False`` and needs a seed:
    the same seed gives the same output, another seed another; the init
    is normal(initializer_range) with the output projections damped by
    1/sqrt(2L) under ``adjust_init_range``; ``intermediate_size``
    defaults to 4x; ``stochastic_mode`` is accepted."""
    cfg = DeepSpeedTransformerConfig(hidden_size=64, heads=4,
                                     attn_dropout_ratio=0.2,
                                     hidden_dropout_ratio=0.2,
                                     num_hidden_layers=8,
                                     stochastic_mode=True)
    assert cfg.intermediate_size == 256
    torch.manual_seed(0)
    tl = DeepSpeedTransformerLayer(cfg)
    x = torch.randn(2, 16, 64)
    a = tl(x, deterministic=False, dropout_seed=2)
    assert torch.equal(tl(x, deterministic=False, dropout_seed=2), a)
    assert (tl(x, deterministic=False, dropout_seed=3) - a).abs().max() > 1e-4
    assert torch.equal(tl(x), tl(x, None, True))
    with pytest.raises(ValueError, match="dropout_seed"):
        tl(x, deterministic=False)
    assert abs(float(tl.c_fc.weight.detach().std()) - 0.02) < 2e-3
    assert abs(float(tl.mlp_proj.weight.detach().std()) - 0.02 / 4) < 5e-4
    assert not tl.c_attn.bias.any()

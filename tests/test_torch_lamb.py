"""Port parity: LAMB (deepspeed_tpu_torch.ops.lamb.FusedLamb) against the
JAX package's FusedLamb, fp32 on the CPU, and its place in the engine's
config.

Tolerance: after each of several steps, every parameter and both moments
within 1e-6 of the leaf's largest value (readings: at most 5.3e-8). The
two agree op for op; the norms of the trust ratio sum in another order,
and torch's CPU ``sqrt`` is one ulp off on some inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JaxLamb
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.ops.lamb import FusedLamb, LambState
from deepspeed_tpu_torch.runtime.engine import configure_optimizer

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

SHAPES = [(8, 8), (16,), (3, 5, 7), (6,)]
STEPS = 5
REL = 1e-6


def _run(kw, zero_leaf=False, zero_grad_leaf=False, seed=0, lr=None):
    """STEPS updates of both optimizers from the same params and
    gradients (numpy, seeded). ``zero_leaf``: the last leaf starts at 0
    (||w|| = 0: trust 1 on the first step); ``zero_grad_leaf``: its
    gradient is 0 throughout (||update|| = 0 without weight decay)."""
    rng = np.random.default_rng(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    if zero_leaf:
        ps[-1][:] = 0.0
    j, t = JaxLamb(lr=1e-2, **kw), FusedLamb(lr=1e-2, **kw)
    jp = [jnp.asarray(p) for p in ps]
    tp = [torch.from_numpy(p.copy()) for p in ps]
    js, ts = j.init(jp), t.init(tp)
    for _ in range(STEPS):
        gs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        if zero_grad_leaf:
            gs[-1][:] = 0.0
        jp, js = j.update([jnp.asarray(g) for g in gs], js, jp,
                          **({} if lr is None else {"lr": jnp.float32(lr)}))
        tp, ts = t.update([torch.from_numpy(g) for g in gs], ts, tp, lr=lr)
        for name, a, b in (("param", jp, tp), ("exp_avg", js.exp_avg,
                                                ts.exp_avg),
                           ("exp_avg_sq", js.exp_avg_sq, ts.exp_avg_sq)):
            for i, (x, y) in enumerate(zip(a, b)):
                x = np.asarray(x)
                err = np.abs(x - y.numpy()).max()
                assert err <= REL * max(np.abs(x).max(), 1e-30), (
                    name, i, err)
    assert ts.step == int(js.step) == STEPS
    return jp, tp


@pytest.mark.parametrize("kw", [
    {}, {"weight_decay": 0.01}, {"bias_correction": False},
    {"betas": (0.8, 0.99), "eps": 1e-6, "weight_decay": 0.1}],
    ids=["default", "weight_decay", "no_bias_correction", "betas_eps"])
def test_update_matches_jax(kw):
    _run(kw)


def test_zero_norm_leaves_take_trust_one():
    """A leaf that starts at 0 (||w|| = 0) and, without weight decay, a
    leaf whose gradient is always 0 (||update|| = 0) take trust 1: the
    first moves by lr x update, the second stays where it is."""
    jp, tp = _run({}, zero_leaf=True, zero_grad_leaf=True)
    assert not tp[-1].any() and not np.asarray(jp[-1]).any()
    jp, tp = _run({}, zero_leaf=True, seed=1)
    assert tp[-1].abs().max() > 0


@pytest.mark.parametrize("kw,coeff", [({"max_coeff": 0.5}, 0.5),
                                      ({"min_coeff": 5.0, "max_coeff": 10.0},
                                       5.0)],
                         ids=["clipped_high", "clipped_low"])
def test_trust_clipped_at_both_coefficients(kw, coeff):
    """Every ratio here is near 1: clipped at max_coeff 0.5, or at
    min_coeff 5. The runs match JAX's, and the port's first step moves
    each leaf by exactly lr x coeff x ||update|| (to fp32 rounding). Not
    to the bit: torch's CPU ``sqrt`` misses the correctly rounded value
    by one ulp on some inputs, where XLA's and numpy's do not."""
    _run(kw)
    rng = np.random.default_rng(0)
    ps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in SHAPES]
    gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in SHAPES]
    t = FusedLamb(lr=1e-2, **kw)
    new, st = t.update(gs, t.init(ps), ps)
    for p, q, m, v in zip(ps, new, st.exp_avg, st.exp_avg_sq):
        u = (m / 0.1) / ((v / (1 - np.float32(0.999))).sqrt() + 1e-8)
        ratio = float((p - q).norm() / (1e-2 * u.norm()))
        assert ratio == pytest.approx(coeff, rel=1e-5)


def test_explicit_lr_matches_jax():
    _run({"weight_decay": 0.01}, lr=3e-3)


def test_update_is_functional():
    """``update`` leaves its inputs untouched and returns new lists, as
    the JAX function does; an empty list steps the counter."""
    t = FusedLamb(lr=0.1)
    p = [torch.ones(4)]
    state = t.init(p)
    new_p, new_state = t.update([torch.ones(4)], state, p)
    assert torch.equal(p[0], torch.ones(4)) and state.step == 0
    assert not torch.equal(new_p[0], p[0]) and new_state.step == 1
    assert not state.exp_avg[0].any()
    assert t.update([], LambState(0, [], []), [])[1].step == 1


def test_lamb_decreases_quadratic():
    """``tests/test_optimizers.py``'s quadratic, through the port."""
    opt = FusedLamb(lr=0.1)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(16)
                         .astype(np.float32))
    params, state = [w], opt.init([w])
    l0 = float((w ** 2).sum())
    for _ in range(20):
        params, state = opt.update([2 * params[0]], state, params)
    assert float((params[0] ** 2).sum()) < l0


def _config(opt):
    return {"train_batch_size": 4, "optimizer": opt}


def test_config_builds_lamb_as_jax_does():
    """``{"type": "Lamb"}`` parses and builds ``FusedLamb(**params)``:
    ``max_grad_norm`` is popped (the engine owns clipping), a param LAMB
    does not take raises TypeError, and ``fused_update`` (the Adam
    kernel) raises at the engine."""
    opt = configure_optimizer(DeepSpeedConfig(_config(
        {"type": "Lamb", "params": {"lr": 2e-3, "max_grad_norm": 1.0,
                                    "max_coeff": 5.0}})))
    assert isinstance(opt, FusedLamb)
    assert opt.lr == 2e-3 and opt.max_coeff == 5.0
    with pytest.raises(TypeError):
        configure_optimizer(DeepSpeedConfig(_config(
            {"type": "lamb", "params": {"adam_w_mode": True}})))
    cfg = _config({"type": "Lamb", "params": {}, "fused_update": True})
    with pytest.raises(ConfigError, match="Adam family"):
        deepspeed_tpu_torch.initialize(
            loss_fn=lambda p, b, r: (p["w"] ** 2).sum(),
            params={"w": torch.ones(2)}, config=cfg, device="cpu")

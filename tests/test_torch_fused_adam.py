"""Port parity: Adam(W), the fused multi-tensor update, and the runtime's
numeric helpers (deepspeed_tpu_torch) against the JAX package, on the CPU.

The Adam update keeps the JAX leaf chain's op order, so the two agree to
at most 1 ulp: element by element against ``FusedAdam.update``, and within
1 ulp of each array's largest element against the Pallas kernel run by the
interpreter (which contracts a multiply-add that the port rounds twice).
On the CPU the port's ``fused_adam_apply`` runs its plain version;
``chip_smoke.py`` holds the CUDA kernel against it bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.fused_adam import AdamState as JaxAdamState
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JaxFusedAdam
from deepspeed_tpu.ops.adam.fused_update import fused_adam_leaf, scalar_tile
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import precision as jax_precision
from deepspeed_tpu.runtime import utils as jax_utils
from deepspeed_tpu_torch.ops.adam import (AdamState, FusedAdam, FusedAdamW,
                                          fused_adam_apply, fused_update_cost)
from deepspeed_tpu_torch.ops.adam.fused_adam import bias_corrections
from deepspeed_tpu_torch.runtime import lr_schedules, precision, utils

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

SHAPES = [(33, 17), (129,), (8, 4, 3)]


def _state(seed):
    rng = np.random.default_rng(seed)
    p = [rng.normal(size=s).astype(np.float32) * 0.1 for s in SHAPES]
    g = [rng.normal(size=s).astype(np.float32) * 1e-2 for s in SHAPES]
    m = [rng.normal(size=s).astype(np.float32) * 1e-3 for s in SHAPES]
    v = [np.square(rng.normal(size=s).astype(np.float32) * 1e-3)
         for s in SHAPES]
    return p, g, m, v


def _ulp_equal(got, want):
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(want, np.float32), maxulp=1)


def _ulp_close(got, want):
    """Within 1 ulp of the array's largest element. The Pallas
    interpreter contracts ``b1 * m + (1 - b1) * g`` into one multiply-add,
    whose single rounding can move a result near zero (the two terms
    nearly cancel) by many of that result's own ulps."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = np.spacing(np.abs(want).max())
    assert np.abs(got - want).max() <= bound


CASES = [dict(adamw_mode=True, weight_decay=0.0),
         dict(adamw_mode=True, weight_decay=0.01),
         dict(adamw_mode=False, weight_decay=0.0),
         dict(adamw_mode=False, weight_decay=0.01),
         dict(adamw_mode=True, weight_decay=0.0, bias_correction=False)]


@pytest.mark.parametrize("kw", CASES)
def test_update_matches_jax(kw):
    """Three steps of ``FusedAdam.update`` from the same state: params and
    both moments within 1 ulp of the JAX update."""
    p, g, m, v = _state(1)
    jopt, topt = JaxFusedAdam(lr=1e-3, **kw), FusedAdam(lr=1e-3, **kw)
    jst = JaxAdamState(step=jnp.asarray(2, jnp.int32),
                       exp_avg=[jnp.asarray(x) for x in m],
                       exp_avg_sq=[jnp.asarray(x) for x in v])
    tst = AdamState(step=2, exp_avg=[torch.from_numpy(x) for x in m],
                    exp_avg_sq=[torch.from_numpy(x) for x in v])
    jp, tp = [jnp.asarray(x) for x in p], [torch.from_numpy(x) for x in p]
    for i in range(3):
        grads = [x * (i + 1) for x in g]
        jp, jst = jopt.update([jnp.asarray(x) for x in grads], jst, jp)
        tp, tst = topt.update([torch.from_numpy(x) for x in grads], tst, tp)
    assert tst.step == int(jst.step) == 5
    for a, b in zip(tp + tst.exp_avg + tst.exp_avg_sq,
                    list(jp) + list(jst.exp_avg) + list(jst.exp_avg_sq)):
        _ulp_equal(a.numpy(), b)


@pytest.mark.parametrize("kw", CASES[:4])
def test_fused_apply_matches_jax_kernel(kw):
    """The port's fused update (its plain version on the CPU, in place)
    against the JAX Pallas kernel ``fused_adam_leaf(interpret=True)``,
    leaf by leaf, with the bf16 cast of the new params."""
    p, g, m, v = _state(2)
    opt = FusedAdam(lr=3e-4, **kw)
    step = 7
    bc1, bc2 = bias_corrections(opt.beta1, opt.beta2, step)
    tile = scalar_tile(np.float32(3e-4), bc1, bc2)
    want = [fused_adam_leaf(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                            jnp.asarray(d), tile, b1=opt.beta1, b2=opt.beta2,
                            eps=opt.eps, weight_decay=opt.weight_decay,
                            adamw_mode=opt.adamw_mode,
                            cast_dtype=jnp.bfloat16, interpret=True)
            for a, b, c, d in zip(p, g, m, v)]
    tp = [torch.from_numpy(x.copy()) for x in p]
    st = AdamState(step - 1, [torch.from_numpy(x.copy()) for x in m],
                   [torch.from_numpy(x.copy()) for x in v])
    new_p, new_st, cast = fused_adam_apply(
        opt, [torch.from_numpy(x) for x in g], st, tp,
        cast_dtype=torch.bfloat16)
    assert new_st.step == step and new_p[0] is tp[0]
    for i, w in enumerate(want):
        _ulp_close(tp[i].numpy(), w[0])
        _ulp_close(new_st.exp_avg[i].numpy(), w[1])
        _ulp_close(new_st.exp_avg_sq[i].numpy(), w[2])
        assert cast[i].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            cast[i].float().numpy(), tp[i].to(torch.bfloat16).float().numpy())


def test_fused_apply_equals_update_on_cpu():
    """Same op order: the fused path and ``update`` agree to the bit."""
    p, g, m, v = _state(3)
    opt = FusedAdamW(lr=1e-3, weight_decay=0.01)
    grads = [torch.from_numpy(x) for x in g]
    want_p, want_st = opt.update(
        grads, AdamState(0, [torch.from_numpy(x) for x in m],
                         [torch.from_numpy(x) for x in v]),
        [torch.from_numpy(x) for x in p])
    tp = [torch.from_numpy(x.copy()) for x in p]
    _p, st = fused_adam_apply(opt, grads, AdamState(
        0, [torch.from_numpy(x.copy()) for x in m],
        [torch.from_numpy(x.copy()) for x in v]), tp)
    for a, b in zip(tp + st.exp_avg + st.exp_avg_sq,
                    want_p + want_st.exp_avg + want_st.exp_avg_sq):
        assert torch.equal(a, b)


def test_fused_update_cost_and_walls():
    params = [torch.zeros(s) for s in SHAPES]
    n = sum(p.numel() for p in params)
    assert fused_update_cost(params) == (12.0 * n, 28.0 * n)
    with pytest.raises(NotImplementedError, match="amsgrad"):
        FusedAdam(amsgrad=True)
    opt = FusedAdam()
    st = opt.init(params)
    with pytest.raises(TypeError, match="cast_dtype"):
        fused_adam_apply(opt, params, st, params, cast_dtype=torch.int8)
    meta = [torch.zeros(3, device="meta")]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_adam_apply(opt, meta, opt.init(meta), meta)
    with pytest.raises(ValueError, match="cast_out needs cast_dtype"):
        fused_adam_apply(opt, params, st, params,
                         cast_out=[p.half() for p in params])
    with pytest.raises(ValueError, match="one contiguous"):
        fused_adam_apply(opt, params, st, params, cast_dtype=torch.bfloat16,
                         cast_out=[p.half() for p in params])


def test_fused_apply_writes_the_cast_into_given_buffers():
    """``cast_out``: the bf16 copy of the new params lands in the caller's
    buffers (the engine keeps them from step to step), equal to casting
    the updated masters."""
    p, g, m, v = _state(4)
    opt = FusedAdam(lr=1e-3)
    tp = [torch.from_numpy(x.copy()) for x in p]
    bufs = [torch.empty(x.shape, dtype=torch.bfloat16) for x in p]
    _p, _st, cast = fused_adam_apply(
        opt, [torch.from_numpy(x) for x in g],
        AdamState(0, [torch.from_numpy(x.copy()) for x in m],
                  [torch.from_numpy(x.copy()) for x in v]), tp,
        cast_dtype=torch.bfloat16, cast_out=bufs)
    for c, b, x in zip(cast, bufs, tp):
        assert c is b and torch.equal(b, x.to(torch.bfloat16))


def test_grad_helpers_match_jax():
    _p, g, _m, _v = _state(4)
    jg = [jnp.asarray(x) for x in g]
    tg = [torch.from_numpy(x) for x in g]
    want = float(jax_utils.global_norm(jg))
    got = float(utils.global_norm(tg))
    assert abs(got - want) <= 1e-6 * want
    for a, b in zip(utils.clip_grad_by_global_norm(tg, 0.05),
                    jax_utils.clip_grad_by_global_norm(jg, 0.05)):
        _ulp_equal(a.numpy(), b)
    assert not bool(utils.has_inf_or_nan(tg))
    bad = [t.clone() for t in tg]
    bad[1][3] = float("nan")
    assert bool(utils.has_inf_or_nan(bad))
    assert bool(utils.has_inf_or_nan({"a": torch.tensor([float("inf")])}))
    assert not bool(utils.has_inf_or_nan([torch.arange(3)]))


def test_dynamic_loss_scaler_matches_jax():
    """The same overflow sequence gives the same scale, good-step and
    hysteresis history (growth window 3, hysteresis 2)."""
    kw = dict(init_scale=2.0 ** 8, scale_window=3, min_scale=1.0,
              hysteresis=2)
    js, ts = (jax_precision.DynamicLossScaler(**kw),
              precision.DynamicLossScaler(**kw))
    jst, tst = js.init(), ts.init()
    for ovf in [False, True, True, False, False, False, True, False] * 2:
        jst = js.update(jst, jnp.asarray(ovf))
        tst = ts.update(tst, ovf)
        assert (tst.scale, tst.good_steps, tst.hysteresis) == (
            float(jst.scale), int(jst.good_steps), int(jst.hysteresis))
    static = precision.make_loss_scaler(False, True, 0.0, 16, 1000, 1.0, 2)
    assert static.init().scale == 1.0
    assert precision.PrecisionPolicy("bfloat16").cast(
        torch.zeros(2)).dtype == torch.bfloat16
    assert precision.PrecisionPolicy("bfloat16").cast(
        torch.zeros(2, dtype=torch.long)).dtype == torch.long


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=3e-4,
                      warmup_num_steps=7)),
    ("WarmupDecayLR", dict(total_num_steps=20, warmup_min_lr=0.0,
                           warmup_max_lr=1e-3, warmup_num_steps=5)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                      cycle_first_step_size=4, cycle_second_step_size=6,
                      decay_step_size=2, decay_lr_rate=0.1)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=3,
                         lr_range_test_step_rate=2.0,
                         lr_range_test_staircase=True)),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedules_match_jax(name, params):
    """float32 arithmetic on both sides: the same learning rate, to the
    bit, at every step of a warmup/cycle/decay."""
    js = jax_lr.build_lr_schedule(name, dict(params))
    ts = lr_schedules.build_lr_schedule(name, dict(params))
    for step in range(0, 25):
        assert ts.lr_at(step) == float(js.lr_at(step)), step
    assert ts.get_lr() == js.get_lr()
    ts.step(3)
    assert ts.get_last_lr() == [ts.lr_at(3)]
    if name == "OneCycle":
        for step in (0, 3, 7, 12):
            assert ts.momentum_at(step) == float(js.momentum_at(step))
    assert lr_schedules.build_lr_schedule(None, {}) is None
    with pytest.raises(ValueError, match="unknown scheduler"):
        lr_schedules.build_lr_schedule("Cosine", {})

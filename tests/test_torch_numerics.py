"""Port parity: the numerics observatory of training
(``deepspeed_tpu_torch/telemetry/numerics.py``) against the JAX package's
``NumericsPlan`` and ``NumericsObservatory``, on the tiny GPT on the CPU.

- the grouping: the port's parameter names (``h.0.attn...``) give the flax
  tree's top-level groups (``h_0``) in the order the JAX plan holds them,
  capped at ``max_groups`` with the same ``_other`` group;
- ``group_stats`` of the tiny GPT's gradients (``jax.grad`` of its loss,
  with a few elements set to values that saturate or underflow in the
  compute dtype), the masters and the masters after an update, in bf16 and
  fp16 compute: the squared norms within 1e-6 relative in fp32, the counts
  exactly;
- ``worst_group`` and ``group_table`` equal, on finite statistics and with
  a non-finite group;
- the engine: with ``telemetry.numerics`` on, the apply's statistics equal
  a plain fp32 recomputation from the step's gradients and masters; they
  stay on the device until the flush, which reads them once (``_fetch``)
  and emits the ``numerics/*`` gauges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.telemetry.numerics import \
    NumericsObservatory as JaxObservatory
from deepspeed_tpu.telemetry.numerics import NumericsPlan as JaxPlan
from deepspeed_tpu_torch.config.config import TelemetryNumericsConfig
from deepspeed_tpu_torch.models import gpt_params_from_flax, make_gpt
from deepspeed_tpu_torch.telemetry import numerics as num_mod
from deepspeed_tpu_torch.telemetry.numerics import (NumericsObservatory,
                                                    NumericsPlan, top_key)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    """The tiny GPT's flax params, its grads on one batch (a few elements
    set to saturate or underflow in 16 bits) and an updated copy of the
    params, as flax trees and as the port's ordered tensors."""
    jm, _ = jax_make_gpt("tiny", dropout_rate=0.0, dtype=jnp.float32)
    ids = np.random.default_rng(0).integers(0, 512, (2, 32), dtype=np.int32)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     {"input_ids": ids})["params"]

    def loss(p):
        out = jm.apply({"params": p}, {"input_ids": ids},
                       deterministic=True)
        return out[0] if isinstance(out, tuple) else out["loss"] \
            if isinstance(out, dict) else out

    grads = jax.tree_util.tree_map(np.array, jax.grad(loss)(params))
    grads["h_1"]["c_fc"]["kernel"][0, :3] = 3.4e38     # inf in bf16 / fp16
    grads["h_0"]["c_attn"]["kernel"][1, :5] = 1e5      # inf in fp16
    grads["wpe"][2, :4] = 1e-9                         # 0 in fp16
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.asarray, params)
    new = jax.tree_util.tree_map(
        lambda x: (x + 1e-3 * rng.standard_normal(x.shape)).astype(
            np.float32), params)
    names = list(gpt_params_from_flax(params))

    def port(tree):
        sd = gpt_params_from_flax(tree)
        return [sd[n] for n in names]

    return params, grads, new, names, port(params), port(grads), port(new)


def test_groups_match_the_flax_tree(tiny):
    params, _g, _n, names, *_ = tiny
    assert top_key("h.11.attn.c_attn.weight") == "h_11"
    assert top_key("wte") == "wte" and top_key("ln_f.bias") == "ln_f"
    for cap in (16, 4, 1):
        jp = JaxPlan(params, max_groups=cap)
        pp = NumericsPlan(names, max_groups=cap)
        assert pp.group_names == jp.group_names
        assert pp.num_groups == jp.num_groups


@pytest.mark.parametrize("cdt", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("cap", [16, 3])
def test_group_stats_match_jax(tiny, cdt, cap):
    params, grads, new, names, p, g, n = tiny
    jp = JaxPlan(params, max_groups=cap,
                 compute_dtype=None if cdt == "float32" else getattr(
                     jnp, cdt))
    pp = NumericsPlan(names, max_groups=cap,
                      compute_dtype=getattr(torch, cdt))
    want = np.asarray(jp.group_stats(grads, params=params, new_params=new))
    got = pp.group_stats(g, p, n).numpy()
    assert got.shape == want.shape == (pp.num_groups, 5)
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    if cdt != "float32":
        assert got[:, 3].sum() > 0
    if cdt == "float16":
        assert got[:, 4].sum() > 0


def _observatories(tiny, poison=None):
    params, grads, new, names, p, g, n = tiny
    if poison is not None:
        grads = jax.tree_util.tree_map(np.array, grads)
        grads[poison]["c_proj"]["kernel"][0, 0] = np.nan
        g = [x.clone() for x in g]
        g[names.index(f"h.{poison[-1]}.c_proj.weight")][0, 0] = float("nan")
    cfg = TelemetryNumericsConfig(enabled=True)
    jp, pp = JaxPlan(params), NumericsPlan(names)
    jo = JaxObservatory(cfg, jp)
    jo.note_step({"groups": jp.group_stats(grads, params=params,
                                           new_params=new)}, 1)
    po = NumericsObservatory(cfg, pp)
    po.note_step({"groups": pp.group_stats(g, p, n)}, 1)
    return jo, po


@pytest.mark.parametrize("poison", [None, "h_1"])
def test_worst_group_and_table_match_jax(tiny, poison):
    jo, po = _observatories(tiny, poison)
    assert po.worst_group() == jo.worst_group()
    if poison:
        assert po.worst_group() == poison
    got, want = po.group_table(), jo.group_table()
    assert [r["group"] for r in got] == [r["group"] for r in want]
    for a, b in zip(got, want):
        for key in ("saturated", "underflowed", "finite"):
            assert a[key] == b[key], (a["group"], key)
        for key in ("grad_norm", "weight_norm", "update_ratio"):
            if isinstance(b[key], str):
                assert a[key] == b[key]
            else:
                np.testing.assert_allclose(a[key], b[key], rtol=1e-6)


def test_engine_statistics_read_once_at_the_flush(tmp_path, monkeypatch):
    """The apply's statistics equal a plain fp32 recomputation from the
    step's own gradients and masters (gradients captured from the engine's
    buffers before the update, masters before and after); the step path
    makes no read; the flush reads once and emits the gauges."""
    model, cfg = make_gpt("tiny", dtype=torch.bfloat16)
    engine = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "bf16": {"enabled": True},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3},
                              "fused_update": True},
                "steps_per_print": 2,
                "telemetry": {"enabled": True, "dir": str(tmp_path),
                              "metrics": {"sinks": ["memory"]},
                              "trace": {"enabled": False},
                              "numerics": {"enabled": True}}})[0]
    obs = engine.numerics
    assert obs is not None and obs.plan.compute_dtype == torch.bfloat16
    fetches = []
    orig = obs._fetch
    monkeypatch.setattr(obs, "_fetch", lambda: (fetches.append(1),
                                                orig())[1])
    seen = {}
    apply = engine._apply_step

    def capture(lr):
        seen["before"] = [p.detach().clone() for p in engine.state.params]
        seen["grads"] = [a.float().clone() for a in engine.state.grad_acc]
        out = apply(lr)
        seen["after"] = [p.detach().clone() for p in engine.state.params]
        return out

    monkeypatch.setattr(engine, "_apply_step", capture)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 512, (2, 2, 16), dtype=np.int32)}
    engine.train_batch(batch)
    assert not fetches
    got = obs._last["groups"].clone()
    want = torch.zeros_like(got)
    for gi, g, b, a in zip(obs.plan.leaf_group, seen["grads"],
                           seen["before"], seen["after"]):
        gc = g.to(torch.bfloat16)
        want[gi] += torch.stack([
            (g.double() ** 2).sum().float(), (b.double() ** 2).sum().float(),
            ((a.double() - b.double()) ** 2).sum().float(),
            (~torch.isfinite(gc) & torch.isfinite(g)).sum().float(),
            ((gc == 0) & (g != 0)).sum().float()])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    engine.train_batch(batch)                # step 2: the flush
    assert len(fetches) == 1
    sink = engine.telemetry.registry.sinks[0]
    tags = {r["tag"] for r in sink.rows}
    assert num_mod.NUMERICS_METRIC_TAGS <= tags
    groups = {r["group"] for r in sink.rows
              if r["tag"] == "numerics/grad_norm"}
    assert groups == set(obs.plan.group_names)
    engine.close()

"""Port parity: the training engine in bf16 (the bench config: bf16
compute over fp32 masters and a bf16 accumulator) against
deepspeed_tpu.initialize on one CPU device, and the fused update's bf16
cast. The setup and the fp32 comparison are tests/test_torch_engine.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_engine import _config, _jax_run, _port_run

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedTPUConfig
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models import make_gpt

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)


def _param_change_errors(sd, jp, tp):
    """Per leaf, |change_port - change_jax| / |change_jax| over the run.
    The key third of c_attn.bias is left out: its exact gradient is 0 (see
    the module docstring), so both sides step it by rounding noise."""
    errs = {}
    for k in jp:
        d_jax = (jp[k].float() - sd[k].float()).numpy().ravel()
        d_port = (tp[k].float() - sd[k].float()).numpy().ravel()
        if k.endswith("c_attn.bias"):
            n = d_jax.size // 3
            keep = np.r_[0:n, 2 * n:3 * n]
            d_jax, d_port = d_jax[keep], d_port[keep]
        errs[k] = float(np.linalg.norm(d_port - d_jax)
                        / np.linalg.norm(d_jax))
    return errs


def test_bf16_bench_config_matches_jax():
    """bf16 compute and a bf16 accumulator (the bench config), Adam eps
    1e-6 as in fp32. The three losses agree to 1e-4 relative, and each
    leaf's change over the three steps to 0.15 of JAX's change.

    Readings on the CPU (this tree): losses 1.5e-5, 2.0e-6, 9.9e-6
    relative; worst leaf change 0.073 (wpe), all leaves together 0.058;
    the fused update gives the same numbers to the bit. Controls, each run
    in the port against the same JAX run: no update (lr 0): losses 9.7e-5
    and 1.2e-3 at steps 2 and 3, every leaf 1.0; a dropped micro-batch
    (the first fed twice): loss 3.4e-3 at step 1, worst leaf 1.06. A
    control that sums the accumulator in fp32 reads the same as the sound
    run (losses <= 1.4e-5, worst leaf 0.076): Adam's normalised step hides
    one bf16 rounding of the sum, so that property is held by
    ``test_bf16_accumulator_sums_in_bf16_as_jax`` instead."""
    cfg = _config(adam={"eps": 1e-6}, bf16={"enabled": True},
                  data_types={"grad_accum_dtype": "bfloat16"})
    sd, jl, jp = _jax_run(cfg, jnp.bfloat16)
    eng, tl, tp = _port_run(cfg, torch.bfloat16, sd)
    assert all(a.dtype == torch.bfloat16 for a in eng.state.grad_acc)
    assert all(p.dtype == torch.float32 for p in eng.state.params)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    errs = _param_change_errors(sd, jp, tp)
    assert set(errs) == set(tp)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.15, (worst, errs[worst])


def test_bf16_accumulator_sums_in_bf16_as_jax():
    """The bf16 accumulator adds each micro-batch's gradient in bf16, as
    the JAX step does (``a + g.astype(a.dtype)``): on a loss whose
    gradients are exact in bf16 (sum(x * w): the gradient is x / GAS, GAS
    4), the two engines' accumulators after a window of forward calls are
    equal to the bit. The control, the same gradients summed in fp32 and
    rounded to bf16 once, differs from both in 152 of the 512 elements
    (small gradients added to a large one are rounded away one by one in
    bf16, not in fp32)."""
    rng = np.random.default_rng(4)
    n = 512
    xs = [rng.normal(size=(1, n))] + [rng.normal(size=(1, n)) * 2.0 ** -9
                                      for _ in range(3)]
    xs = [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float()
          .numpy() for x in xs]
    cfg = {"train_micro_batch_size_per_gpu": 1,
           "gradient_accumulation_steps": len(xs),
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 2}, "bf16": {"enabled": True},
           "data_types": {"grad_accum_dtype": "bfloat16"}}

    def jax_loss(params, batch, rng):
        w = params["w"]
        return jnp.sum(batch["x"].astype(w.dtype) * w)

    jeng, *_ = deepspeed_tpu.initialize(
        loss_fn=jax_loss, params={"w": jnp.ones((n,), jnp.float32)},
        config=DeepSpeedTPUConfig(cfg, world_size=1),
        mesh=build_mesh(devices=jax.devices()[:1]))

    def port_loss(params, batch, rng):
        w = params["w"]
        return (batch["x"].to(w.dtype) * w).sum()

    teng = deepspeed_tpu_torch.initialize(
        loss_fn=port_loss, params={"w": torch.ones(n)}, config=cfg,
        device="cpu")[0]
    for x in xs:
        jeng.forward({"x": x})
        teng.forward({"x": x})
    j_acc = np.asarray(jeng.state.grad_acc["w"].astype(jnp.float32))
    t_acc = teng.state.grad_acc[0]
    assert t_acc.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_acc.float().numpy(), j_acc)
    fp32_sum = torch.from_numpy(sum(x[0] for x in xs) / len(xs))
    control = fp32_sum.to(torch.bfloat16).float().numpy()
    assert np.sum(t_acc.float().numpy() != control) > 100


def test_fused_bf16_update_casts_the_next_forwards_params():
    """bf16 with ``optimizer.fused_update``: the update also writes the new
    masters in bf16, and the next step's forward reads that copy instead
    of casting the masters again. The run ends bit-equal to the plain
    update's; an in-place write to a master (here a state-dict load)
    bumps its version counter, and the next forward casts afresh."""
    sd = {k: v.detach() for k, v in make_gpt("tiny")[0].state_dict().items()}
    cfg = _config(bf16={"enabled": True},
                  data_types={"grad_accum_dtype": "bfloat16"})
    fused_cfg = _config(bf16={"enabled": True},
                        data_types={"grad_accum_dtype": "bfloat16"})
    fused_cfg["optimizer"]["fused_update"] = True
    eng, tl, tp = _port_run(cfg, torch.bfloat16, sd)
    feng, fl, fp = _port_run(fused_cfg, torch.bfloat16, sd)
    assert fl == tl
    for k in tp:
        assert torch.equal(fp[k], tp[k]), k
    assert eng._casts is None
    compute = feng._make_compute_params()
    assert [c.data_ptr() for c in compute] == [
        c.data_ptr() for c in feng._casts]
    for c, p in zip(compute, feng.state.params):
        assert c.dtype == torch.bfloat16 and torch.equal(
            c, p.to(torch.bfloat16))
    feng.module.load_state_dict(sd)
    fresh = feng._make_compute_params()
    assert fresh[0].data_ptr() != feng._casts[0].data_ptr()
    for c, p in zip(fresh, feng.state.params):
        assert torch.equal(c, p.to(torch.bfloat16))

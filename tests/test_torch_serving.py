"""Port parity: the continuous-batching ServeEngine (deepspeed_tpu_torch)
against the JAX package's, fp32 on the CPU, tiny GPT.

The JAX engine runs ``decode_attention: "kernel"`` through the Pallas
interpreter; the port's wrapper takes its plain version on CPU tensors.
The oracle in both packages is greedy ``generate``: every served request
must match it token for token.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.serving import ServeEngine as JaxServeEngine
from deepspeed_tpu_torch.config import ConfigError, ServingConfig
from deepspeed_tpu_torch.models import (gpt_params_from_flax,
                                        init_flax_gpt_params, make_gpt)
from deepspeed_tpu_torch.serving import ServeEngine
from deepspeed_tpu_torch.serving.engine import resolve_decode_attention

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

# the serving config of tests/test_serving.py, with the kernel on
SERVE = {"max_batch_size": 2, "kv_block_size": 4, "kv_num_blocks": 64,
         "max_model_len": 48, "decode_attention": "kernel"}
# (prompt length, max_new_tokens): staggered and varied, more requests
# than slots, so finished slots are backfilled
TRACE = [(5, 12), (9, 3), (3, 10), (12, 4), (7, 8)]


@pytest.fixture(scope="module")
def tiny():
    jm, cfg = jax_make_gpt("tiny", dropout_rate=0.0, max_seq_len=64,
                           dtype=jnp.float32)
    # flax's tree and distributions from numpy (flax's eager init costs
    # seconds)
    tree = init_flax_gpt_params(make_gpt("tiny", max_seq_len=64)[1], seed=0)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jm, cfg, params, gpt_params_from_flax(tree)


def _port_engine(sd, **kw):
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    return deepspeed_tpu_torch.init_inference(
        model, params=sd, dtype=torch.float32, device="cpu", **kw)


def _port(sd, **overrides):
    return ServeEngine(_port_engine(sd),
                       config=ServingConfig(**{**SERVE, **overrides}))


def _jax(jm, params, **overrides):
    eng = deepspeed_tpu.init_inference(jm, params=params, dtype=jnp.float32)
    return JaxServeEngine(eng, config=JaxServingConfig(**{**SERVE,
                                                          **overrides}))


def _prompts(trace, vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (t,)).tolist() for t, _ in trace]


def _run(srv, prompts, trace, stagger=2):
    """Submit the first half, step ``stagger`` times, submit the rest,
    drain; returns each request's tokens in submission order."""
    half = len(prompts) // 2
    rids = [srv.submit(p, n) for p, (_, n) in
            zip(prompts[:half], trace[:half])]
    for _ in range(stagger):
        srv.step()
    rids += [srv.submit(p, n) for p, (_, n) in
             zip(prompts[half:], trace[half:])]
    res = srv.run_until_complete()
    return [res[r]["tokens"] for r in rids]


def _generate(sd, prompts, trace):
    eng = _port_engine(sd)
    return [eng.generate([p], max_new_tokens=n)[0].tolist()
            for p, (_, n) in zip(prompts, trace)]


def test_mixed_trace_matches_jax_and_generate(tiny):
    jm, cfg, params, sd = tiny
    prompts = _prompts(TRACE, cfg.vocab_size)
    srv = _port(sd)
    got = _run(srv, prompts, TRACE)
    assert got == _run(_jax(jm, params), prompts, TRACE)
    assert got == _generate(sd, prompts, TRACE)
    assert max(srv.stats["slot_assignments"].values()) >= 2   # backfill
    assert srv.stats["kernel_steps"] == srv.stats["decode_steps"] > 0
    assert srv.pool.used_blocks == 0


def test_preemption_matches_jax_and_generate(tiny):
    """11 usable blocks of 4 positions: two long requests cannot both
    grow to their lifetime need, so the youngest is evicted and
    restarted; the outputs do not change."""
    jm, cfg, params, sd = tiny
    trace = [(10, 24), (9, 24), (4, 6)]
    prompts = _prompts(trace, cfg.vocab_size, seed=11)
    srv = _port(sd, kv_num_blocks=12)
    got = _run(srv, prompts, trace, stagger=0)
    assert srv.sched.preempted_total >= 1
    jsrv = _jax(jm, params, kv_num_blocks=12)
    assert got == _run(jsrv, prompts, trace, stagger=0)
    assert srv.sched.preempted_total == jsrv.sched.preempted_total
    assert got == _generate(sd, prompts, trace)
    assert srv.pool.used_blocks == 0


def test_gather_and_kernel_modes_give_identical_tokens(tiny):
    _jm, cfg, _params, sd = tiny
    prompts = _prompts(TRACE, cfg.vocab_size, seed=3)
    kern = _port(sd)
    gath = _port(sd, decode_attention="gather")
    assert _run(kern, prompts, TRACE) == _run(gath, prompts, TRACE)
    # the kernel mode caps the window at the longest active row
    assert kern.stats["gathered_positions"] < \
        gath.stats["gathered_positions"] == gath.stats["full_positions"]
    assert gath.stats["kernel_steps"] == 0


def test_init_serving_entry_point(tiny, tmp_path):
    """The user entry, with the config as a JSON file; "auto" takes the
    gather path on the CPU."""
    import json

    _jm, cfg, _params, sd = tiny
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"serving": {**SERVE,
                                            "decode_attention": "auto"}}))
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    srv = deepspeed_tpu_torch.init_serving(model, config=str(path),
                                           params=sd, dtype=torch.float32,
                                           device="cpu")
    prompts = _prompts(TRACE[:2], cfg.vocab_size)
    assert _run(srv, prompts, TRACE[:2]) == \
        _generate(sd, prompts, TRACE[:2])
    assert srv.stats["kernel_steps"] == 0


def test_auto_decode_attention_takes_the_kernel_on_cuda():
    """"auto" resolves to the kernel on a CUDA device and raises where the
    kernel does not take the pool; only the CPU gathers."""
    bf16 = torch.bfloat16
    assert resolve_decode_attention("auto", "cuda", 64, bf16) == "kernel"
    assert resolve_decode_attention("auto", "cpu", 64, bf16) == "gather"
    assert resolve_decode_attention("gather", "cuda", 60,
                                    torch.float16) == "gather"
    for mode in ("auto", "kernel"):
        with pytest.raises(ValueError, match="CUDA kernel takes"):
            resolve_decode_attention(mode, "cuda", 64, torch.float16)
        with pytest.raises(ValueError, match="CUDA kernel takes"):
            resolve_decode_attention(mode, "cuda", 60, bf16)


@pytest.mark.parametrize("config", [
    {"serving": {"speculative": {"enabled": True, "draft_layers": 1}},
     "telemetry": {"enabled": True}},
    {"serving": {"speculative": {"enabled": True, "k": 3}},
     "telemetry": {"enabled": True, "dir": "run"}},
    {"serving": {"resilience": {"max_retries": 3}},
     "telemetry": {"enabled": 1}},
    {"serving": {"resilience": {"enabled": True}},
     "telemetry": {"enabled": True, "requests": {"enabled": True}}},
    {"telemetry": {"enabled": True}},
    {"telemetry": {"enabled": True, "dir": "run"}},
    {"resilience": {"fault_injection": {"serve_decode_fault_at_step": 1}},
     "telemetry": {"enabled": True}},
])
def test_unported_config_keys_raise(tiny, config, tmp_path, monkeypatch):
    """A telemetry block that is on now serves, beside speculative
    decoding, a resilience block or a fault plan, with the telemetry
    parsed as the reference parses it (``dir`` defaults to "telemetry"
    in the working directory). What is still not ported raises by name:
    the same config with ``telemetry.fleet`` on."""
    from deepspeed_tpu.config.config import TelemetryConfig as JaxTelemetry

    _jm, _cfg, _params, sd = tiny
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DSTPU_FAULT_PLAN", raising=False)
    want = JaxTelemetry.from_dict(config["telemetry"])
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    srv = deepspeed_tpu_torch.init_serving(model, config=config, params=sd,
                                           device="cpu")
    assert srv.telemetry.enabled == want.enabled
    assert (srv._req_acc is not None) == want.requests.enabled
    assert srv.telemetry.tracer.path == os.path.join(want.dir,
                                                     want.trace.file)
    assert srv.telemetry.metrics_path == os.path.join(want.dir,
                                                      want.metrics.file)
    srv.close()
    assert os.path.exists(tmp_path / want.dir / want.metrics.file)
    fleet = {**config, "telemetry": {**config["telemetry"],
                                     "fleet": {"enabled": True}}}
    JaxTelemetry.from_dict(fleet["telemetry"])
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    with pytest.raises(ConfigError, match="telemetry.fleet is not yet "
                                          "ported"):
        deepspeed_tpu_torch.init_serving(model, config=fleet, params=sd,
                                         device="cpu")


@pytest.mark.parametrize("kwargs", [{"mp_size": 2}, {"quantize": True},
                                    {"mp_size": 4}])
def test_unported_inference_options_raise(tiny, kwargs):
    with pytest.raises(ConfigError, match="not yet ported"):
        _port_engine(tiny[3], **kwargs)


def test_unknown_and_inert_keys(tiny):
    with pytest.raises(ConfigError, match="unknown serving keys"):
        ServingConfig.from_dict({"max_batch_size": 2, "kv_blocks": 9})
    with pytest.raises(ConfigError, match="unknown init_serving"):
        deepspeed_tpu_torch.init_serving(
            make_gpt("tiny")[0], config={"train_batch_size": 8},
            device="cpu")
    with pytest.raises(ConfigError, match="decode_attention"):
        ServingConfig.from_dict({"decode_attention": "warp"})
    with pytest.raises(ConfigError,
                       match="unknown serving.chunked_prefill keys"):
        ServingConfig.from_dict({"chunked_prefill": {"token_budget": 16,
                                                     "max_chunks": 2}})
    # features named in their off state are accepted
    cfg = ServingConfig.from_dict({
        "prefix_cache": False, "int8_kv_cache": False,
        "speculative": {"enabled": False}, "resilience": {"enabled": False},
        "chunked_prefill": {"enabled": False}})
    assert cfg == ServingConfig()


def test_entry_points_never_fall_back_to_cpu(tiny, monkeypatch):
    """With no device given the port runs on CUDA; without a card it
    raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = tiny[3]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(make_gpt("tiny")[0], params=sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_serving(make_gpt("tiny")[0], params=sd)


def test_submit_walls(tiny):
    srv = _port(tiny[3])
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit([], 4)
    with pytest.raises(ValueError, match="max_model_len"):
        srv.submit([1] * 40, 9)
    with pytest.raises(ValueError, match="token ids"):
        srv.submit([1, 512], 2)
    with pytest.raises(ValueError, match="KV blocks"):
        _port(tiny[3], kv_num_blocks=4).submit([1] * 20, 8)


def test_compute_dtype_may_differ_from_cache_dtype(tiny):
    """A bf16-computing model behind an fp32 engine (fp32 weights, cache
    and pools), which the JAX package allows too: both decode paths run,
    and agree."""
    _jm, cfg, _params, sd = tiny
    prompts = _prompts(TRACE[:3], cfg.vocab_size, seed=5)
    outs = []
    for mode in ("kernel", "gather"):
        model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.bfloat16)
        eng = deepspeed_tpu_torch.init_inference(
            model, params=sd, dtype=torch.float32, device="cpu")
        srv = ServeEngine(eng, config=ServingConfig(
            **{**SERVE, "decode_attention": mode}))
        outs.append(_run(srv, prompts, TRACE[:3]))
    assert outs[0] == outs[1]
    assert [len(t) for t in outs[0]] == [t + n for t, n in TRACE[:3]]

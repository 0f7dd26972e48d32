"""Port parity: speculative decoding in the continuous-batching
ServeEngine (deepspeed_tpu_torch) against the JAX package's, fp32 on the
CPU, tiny GPT (2 layers, so the draft is its first layer).

The second layer's output projections are scaled by 0.2 in both packages'
weights, so the one-layer draft agrees with the target often enough
(about three draft tokens in four) that every branch of the accept rule
runs: partial accepts, full accepts with their bonus token, and rejects.
The JAX engine runs ``decode_attention: "kernel"`` through the Pallas
interpreter; the port's wrapper takes its plain version on CPU tensors.
The oracles are the JAX engine (tokens and the ``spec_*`` statistics),
the port without speculation and greedy ``generate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serving import SERVE, TRACE, _prompts, _run
from test_torch_serving_chunked import PREFIX_TRACE, _prefix_prompts

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.models import make_gpt as jax_make_gpt
from deepspeed_tpu.serving import ServeEngine as JaxServeEngine
from deepspeed_tpu.serving.kv_cache import \
    PagedLayerCache as JaxPagedLayerCache
from deepspeed_tpu_torch.config import ConfigError, ServingConfig
from deepspeed_tpu_torch.models import (gpt_params_from_flax,
                                        init_flax_gpt_params, make_gpt)
from deepspeed_tpu_torch.serving import ServeEngine
from deepspeed_tpu_torch.serving.kv_cache import PagedLayerCache

# One intra-op thread: the tests run in several worker processes at once.
torch.set_num_threads(1)

DRAFT_SCALE = 0.2
SPEC = {"spec_decode": True, "spec_k": 3}
CHUNK16 = {"chunked_prefill": True, "chunked_token_budget": 16}
# each configuration served with speculation in both packages
CASES = {
    "gather": {**SPEC, "decode_attention": "gather"},
    "kernel": SPEC,
    "chunked-16": {**SPEC, **CHUNK16},
    "chunked-2": {**SPEC, "chunked_prefill": True,
                  "chunked_token_budget": 2},
    "int8": {**SPEC, "int8_kv_cache": True},
    "prefix": {**SPEC, "prefix_cache": True},
    "all": {**SPEC, **CHUNK16, "int8_kv_cache": True, "prefix_cache": True},
    "k2": {**SPEC, "spec_k": 2},
    "k8": {**SPEC, "spec_k": 8},
}
STATS = ("spec_rounds", "spec_proposed", "spec_accepted", "spec_new_tokens")


@pytest.fixture(scope="module")
def tiny():
    jm, cfg = jax_make_gpt("tiny", dropout_rate=0.0, max_seq_len=64,
                           dtype=jnp.float32)
    tree = init_flax_gpt_params(make_gpt("tiny", max_seq_len=64)[1], seed=0)
    for site in ("c_proj", "mlp_proj"):
        for leaf in ("kernel", "bias"):
            tree["h_1"][site][leaf] = tree["h_1"][site][leaf] * DRAFT_SCALE
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jm, cfg, params, gpt_params_from_flax(tree)


def _port(sd, **overrides):
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    eng = deepspeed_tpu_torch.init_inference(
        model, params=sd, dtype=torch.float32, device="cpu")
    return ServeEngine(eng, config=ServingConfig(**{**SERVE, **overrides}))


def _jax(jm, params, **overrides):
    eng = deepspeed_tpu.init_inference(jm, params=params, dtype=jnp.float32)
    return JaxServeEngine(eng, config=JaxServingConfig(**{**SERVE,
                                                          **overrides}))


def _case_trace(case, vocab):
    """The prompts and (length, max_new_tokens) trace of a case: prompts
    sharing a head under the prefix cache."""
    if CASES[case].get("prefix_cache"):
        return _prefix_prompts(vocab), PREFIX_TRACE
    return _prompts(TRACE, vocab), TRACE


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_matches_jax(tiny, case):
    """Both packages serve the same staggered trace with speculation:
    identical tokens, identical ``spec_*`` statistics (so the same
    drafts were proposed and accepted), the same prefix hits and blocks
    held after the drain."""
    jm, cfg, params, sd = tiny
    over = CASES[case]
    prompts, trace = _case_trace(case, cfg.vocab_size)
    srv = _port(sd, **over)
    jsrv = _jax(jm, params, **over)
    got = _run(srv, prompts, trace)
    assert got == _run(jsrv, prompts, trace)
    assert {s: srv.stats[s] for s in STATS} == \
        {s: jsrv.stats[s] for s in STATS}
    assert srv.stats["spec_rounds"] > 0
    assert 0 < srv.stats["spec_accepted"] < srv.stats["spec_proposed"]
    assert srv.pool.used_blocks == jsrv.pool.used_blocks
    if over.get("prefix_cache"):
        assert srv.stats["prefix_hits"] == jsrv.prefix_cache.hits >= 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_matches_the_port_without_it(tiny, case):
    """Speculation changes no token: the same configuration without it
    serves the same trace identically, and every request is greedy
    ``generate``'s."""
    _jm, cfg, _params, sd = tiny
    over = CASES[case]
    prompts, trace = _case_trace(case, cfg.vocab_size)
    srv = _port(sd, **over)
    got = _run(srv, prompts, trace)
    plain = {k: v for k, v in over.items() if not k.startswith("spec")}
    off = _port(sd, **plain)
    assert got == _run(off, prompts, trace)
    assert off.stats["spec_rounds"] == 0
    if over.get("chunked_prefill"):
        # a round with a prompt chunk in flight is a mixed step
        assert 0 < srv.stats["mixed_steps"] < off.stats["mixed_steps"]
    if not over.get("int8_kv_cache"):
        model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
        eng = deepspeed_tpu_torch.init_inference(
            model, params=sd, dtype=torch.float32, device="cpu")
        for p, (_, n), toks in zip(prompts, trace, got):
            assert toks == eng.generate([p], max_new_tokens=n)[0].tolist()
    assert srv.pool.used_blocks == off.pool.used_blocks


def test_spec_respects_eos_and_max_tokens(tiny):
    """Tokens accepted past EOS or max_new_tokens are cut exactly as
    greedy decode cuts them (the finish check runs per appended token)."""
    _jm, cfg, _params, sd = tiny
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                               (5,)).tolist()
    srv0 = _port(sd)
    rid0 = srv0.submit(prompt, 10)
    full = srv0.run_until_complete()[rid0]["tokens"]
    for at in (2, 4, 7):
        eos = full[len(prompt) + at]
        got, want = [], []
        for spec, out in ((True, got), (False, want)):
            srv = _port(sd, **({**SPEC, "spec_k": 4} if spec else {}))
            rid = srv.submit(prompt, 10, eos_token_id=eos)
            out.extend(srv.run_until_complete()[rid]["tokens"])
        assert got == want
        assert got[-1] == eos and len(got) <= len(prompt) + at + 1
    for n in (1, 2, 6):
        srv = _port(sd, **{**SPEC, "spec_k": 4})
        rid = srv.submit(prompt, n)
        assert srv.run_until_complete()[rid]["tokens"] == \
            full[:len(prompt) + n]


def test_lookahead_at_max_model_len_writes_only_scratch(tiny):
    """A row whose run ends at ``max_model_len``: the verify chunk's
    lookahead passes the end of the block table, and those writes land
    only in scratch block 0. Each speculative round changes no block but
    the row's own and block 0, and after the run every block but scratch
    equals the JAX engine's within 1e-6 of the pool's largest value."""
    jm, cfg, params, sd = tiny
    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size,
                                                (40,)).tolist()
    over = {**SPEC, "spec_k": 8}
    srv = _port(sd, **over)
    rid = srv.submit(prompt, 8)            # 40 + 8 = max_model_len 48
    spec_impl, rounds = srv._spec_impl, []

    def checked(bt, pos, toks, k, impl):
        # the round's writes, against the pools just before it
        seq = next(iter(srv.sched.running.values()))
        before = [t.clone() for layer in srv._pools for t in layer[:2]]
        out = spec_impl(bt, pos, toks, k, impl)
        for a, b in zip(before, (t for layer in srv._pools
                                 for t in layer[:2])):
            changed = (a != b).flatten(1).any(dim=1).nonzero()[:, 0]
            assert set(changed.tolist()) <= set(seq.block_table) | {0}
        rounds.append(seq.pos + k >= srv.max_blocks * srv.block_size)
        return out

    srv._spec_impl = checked
    srv.run_until_complete()
    overshoot = sum(rounds)
    assert overshoot >= 1
    jsrv = _jax(jm, params, **over)
    jrid = jsrv.submit(prompt, 8)
    want = jsrv.run_until_complete()[jrid]["tokens"]
    assert srv.results[rid]["tokens"] == want
    # fp32 sums differ in their last bits between XLA and torch: each
    # pool is held to 1e-6 of its largest magnitude
    for (k, v, _ks, _vs), (jk, jv, _jks, _jvs) in zip(srv._pools,
                                                       jsrv._pools):
        for got_pool, want_pool in ((k, jk), (v, jv)):
            want_pool = np.asarray(want_pool)[1:]
            np.testing.assert_allclose(
                got_pool.numpy()[1:], want_pool, rtol=0,
                atol=1e-6 * np.abs(want_pool).max())


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_clamp_writes_matches_jax(int8):
    """``PagedLayerCache(clamp_writes=True)``: a chunk whose positions run
    past the table lands in scratch block 0 (a column past the last one
    clamped to it, a position at or past WB * BS routed to block 0), the
    same pool update as the JAX cache's; without the clamp the port's
    write indexes past the table."""
    rng = np.random.default_rng(5)
    n, bs, h, d, b, s = 9, 4, 2, 8, 2, 6
    bt = np.array([[3, 5, 6], [7, 2, 0]], np.int32)     # WB = 3: 12 slots
    pos = np.array([9, 4], np.int32)      # row 0 writes positions 9..14
    k_new = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v_new = rng.normal(size=(b, s, h, d)).astype(np.float32)
    if int8:
        pools = (np.zeros((n, bs, h, d), np.int8),) * 2 + (
            np.ones((n, bs, h), np.float32),) * 2
    else:
        pools = (np.zeros((n, bs, h, d), np.float32),) * 2 + (None, None)
    port = PagedLayerCache(
        *(torch.tensor(p) if p is not None else None for p in pools),
        torch.tensor(bt), torch.tensor(pos), bs, clamp_writes=True)
    port.update(torch.tensor(k_new), torch.tensor(v_new))
    ref = JaxPagedLayerCache(
        *(jnp.asarray(p) if p is not None else None for p in pools),
        jnp.asarray(bt), jnp.asarray(pos), bs, "float32",
        clamp_writes=True)
    new, *_ = ref.update(jnp.asarray(k_new), jnp.asarray(v_new))
    for got, want in zip((port.k, port.v, port.k_scale, port.v_scale),
                         new.pools):
        if want is not None:
            np.testing.assert_array_equal(got.numpy()[1:],
                                          np.asarray(want)[1:])
    # row 0's positions 9..11 are in its block 6, 12..14 in scratch only;
    # row 1's 8..9 (a table entry of 0) in scratch
    assert port.k[6].abs().sum() > 0 and port.k[4].abs().sum() == 0
    with pytest.raises(IndexError):
        PagedLayerCache(
            *(torch.tensor(p) if p is not None else None for p in pools),
            torch.tensor(bt), torch.tensor(pos), bs).update(
                torch.tensor(k_new), torch.tensor(v_new))


def test_tight_pool_preempts_under_lookahead(tiny):
    """11 usable blocks of 4: the lookahead's capacity pass evicts the
    youngest sequence, as the JAX engine does; the tokens do not
    change."""
    jm, cfg, params, sd = tiny
    trace = [(10, 24), (9, 24), (4, 6)]
    prompts = _prompts(trace, cfg.vocab_size, seed=11)
    srv = _port(sd, kv_num_blocks=12, **SPEC)
    got = _run(srv, prompts, trace, stagger=0)
    assert srv.sched.preempted_total >= 1
    jsrv = _jax(jm, params, kv_num_blocks=12, **SPEC)
    assert got == _run(jsrv, prompts, trace, stagger=0)
    assert srv.sched.preempted_total == jsrv.sched.preempted_total
    assert {s: srv.stats[s] for s in STATS} == \
        {s: jsrv.stats[s] for s in STATS}
    assert got == _run(_port(sd, kv_num_blocks=12), prompts, trace,
                       stagger=0)
    assert srv.pool.used_blocks == 0


def test_config_walls(tiny):
    """The reference's walls (tests/test_serving_fastpath.py): greedy
    only, k >= 1, draft_layers >= 1 and below the target's depth."""
    sd = tiny[3]
    with pytest.raises(ConfigError, match="temperature"):
        ServingConfig.from_dict({"speculative": {"enabled": True},
                                 "temperature": 0.7})
    with pytest.raises(ConfigError, match="k must be"):
        ServingConfig.from_dict({"speculative": {"k": 0}})
    with pytest.raises(ConfigError, match="draft_layers must be"):
        ServingConfig.from_dict({"speculative": {"enabled": True,
                                                 "draft_layers": 0}})
    with pytest.raises(ConfigError, match="decode_attention"):
        ServingConfig.from_dict({"decode_attention": "warp"})
    with pytest.raises(ValueError, match="draft_layers"):
        _port(sd, **SPEC, spec_draft_layers=2)
    parsed = ServingConfig.from_dict({"speculative": {
        "enabled": True, "k": 5, "draft_layers": 1}})
    want = JaxServingConfig.from_dict({"speculative": {
        "enabled": True, "k": 5, "draft_layers": 1}})
    assert (parsed.spec_decode, parsed.spec_k, parsed.spec_draft_layers) == \
        (want.spec_decode, want.spec_k, want.spec_draft_layers)


def test_draft_shares_the_targets_parameters(tiny):
    """The draft is a GPT of the target's first layer whose parameters
    are the target's own objects: no weight is copied, none is left on
    the meta device, and it computes what the target's first layer
    does."""
    srv = _port(tiny[3], **SPEC)
    draft, target = srv._draft, srv.module
    assert draft.cfg.num_layers == 1 == srv._draft_layers
    target_params = {id(p) for p in target.parameters()}
    assert all(id(p) in target_params for p in draft.parameters())
    assert len(list(draft.parameters())) == \
        len(list(target.parameters())) - len(list(target.h[1].parameters()))
    assert draft.h[0] is target.h[0] and draft.wte is target.wte
    assert all(p.device.type == "cpu" for p in draft.parameters())


def test_init_serving_serves_speculative(tiny, tmp_path):
    """The user entry with a ``speculative`` block serves (it was refused
    before the port had the feature) and is greedy ``generate``'s."""
    import json

    _jm, cfg, _params, sd = tiny
    path = tmp_path / "serve.json"
    path.write_text(json.dumps({"serving": {
        **SERVE, "speculative": {"enabled": True, "k": 3}}}))
    model, _ = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    srv = deepspeed_tpu_torch.init_serving(model, config=str(path),
                                           params=sd, dtype=torch.float32,
                                           device="cpu")
    assert srv._spec_k == 3 and srv._draft_layers == 1
    prompts = _prompts(TRACE[:2], cfg.vocab_size)
    got = _run(srv, prompts, TRACE[:2])
    assert got == _run(_port(sd), prompts, TRACE[:2])
    assert srv.stats["spec_rounds"] > 0

"""Port parity: the chunked-prefill, int8-pool and prefix-cache paths of
the continuous-batching ServeEngine (deepspeed_tpu_torch) against the JAX
package's, fp32 on the CPU, tiny GPT. The setup, the bucketed path and
the oracle (greedy ``generate``) are tests/test_torch_serving.py's.
"""

import numpy as np
import pytest
import torch
from test_torch_serving import (TRACE, _generate, _jax, _port,  # noqa: F401
                                _prompts, _run, tiny)

from deepspeed_tpu_torch.config import ConfigError, ServingConfig
from deepspeed_tpu_torch.serving.engine import resolve_decode_attention

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

# four requests sharing a 9-token head (2 full blocks of 4, then a partial
# one) with distinct tails, plus one cold request
PREFIX_TRACE = [(13, 6), (11, 5), (15, 4), (6, 7), (10, 3)]


def _prefix_prompts(vocab, seed=13):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, (9,)).tolist()
    prompts = [head + rng.integers(0, vocab, (t - 9,)).tolist()
               for t, _ in PREFIX_TRACE[:3]]
    prompts.append(rng.integers(0, vocab, (PREFIX_TRACE[3][0],)).tolist())
    prompts.append(head + rng.integers(0, vocab, (1,)).tolist())
    return prompts


SERVING_CASES = {
    "chunked-16": ({"chunked_prefill": True, "chunked_token_budget": 16},
                   False),
    "chunked-2": ({"chunked_prefill": True, "chunked_token_budget": 2},
                  False),
    "chunked-int8": ({"chunked_prefill": True, "chunked_token_budget": 16,
                      "int8_kv_cache": True}, False),
    "chunked-prefix": ({"chunked_prefill": True, "chunked_token_budget": 16,
                        "prefix_cache": True}, True),
    "int8-kernel": ({"int8_kv_cache": True}, False),
    "int8-gather": ({"int8_kv_cache": True, "decode_attention": "gather"},
                    False),
    "prefix": ({"prefix_cache": True}, True),
    "chunked-int8-prefix": ({"chunked_prefill": True,
                             "chunked_token_budget": 16,
                             "int8_kv_cache": True, "prefix_cache": True},
                            True),
}


@pytest.mark.parametrize("case", sorted(SERVING_CASES))
def test_serving_configs_match_jax(tiny, case):
    """The port's engine and the JAX package's serve the same staggered
    trace: identical tokens (exact: both are fp32 and greedy), the same
    prefix-cache hits, and the same blocks still held after the drain
    (the prefix cache's, which ``clear()`` gives back)."""
    jm, cfg, params, sd = tiny
    overrides, prefix = SERVING_CASES[case]
    trace = PREFIX_TRACE if prefix else TRACE
    prompts = (_prefix_prompts(cfg.vocab_size) if prefix
               else _prompts(TRACE, cfg.vocab_size, seed=21))
    srv, jsrv = _port(sd, **overrides), _jax(jm, params, **overrides)
    got = _run(srv, prompts, trace)
    assert got == _run(jsrv, prompts, trace)
    assert srv.pool.used_blocks == jsrv.pool.used_blocks
    if prefix:
        assert srv.stats["prefix_hits"] == jsrv.prefix_cache.hits >= 3
        assert srv.pool.used_blocks > 0
        srv.prefix_cache.clear()
    assert srv.pool.used_blocks == 0
    if overrides.get("chunked_prefill"):
        assert srv.stats["mixed_steps"] == srv.stats["decode_steps"] > 0
        assert srv.stats["kernel_steps"] == 0
    if not overrides.get("int8_kv_cache"):
        assert got == _generate(sd, prompts, trace)


def test_chunked_preemption_matches_jax(tiny):
    """11 usable blocks of 4 under chunked admission: the youngest is
    evicted (possibly mid-prefill), restarts from its prompt, and the
    outputs equal JAX's and ``generate``'s."""
    jm, cfg, params, sd = tiny
    trace = [(10, 24), (9, 24), (4, 6)]
    prompts = _prompts(trace, cfg.vocab_size, seed=11)
    kw = {"kv_num_blocks": 12, "chunked_prefill": True,
          "chunked_token_budget": 4}
    srv, jsrv = _port(sd, **kw), _jax(jm, params, **kw)
    got = _run(srv, prompts, trace, stagger=0)
    assert got == _run(jsrv, prompts, trace, stagger=0)
    assert srv.sched.preempted_total == jsrv.sched.preempted_total >= 1
    assert got == _generate(sd, prompts, trace)
    assert srv.pool.used_blocks == 0


def test_chunked_budget_spreads_a_prompt_over_steps(tiny):
    """A 12-token prompt at budget 4 beside a decoding row: its chunks
    take the rows the decode token leaves, its first token comes with the
    last chunk, and ``chunk_tokens_last`` counts the real rows."""
    _jm, cfg, _params, sd = tiny
    srv = _port(sd, chunked_prefill=True, chunked_token_budget=4)
    first = srv.submit(list(range(1, 4)), 8)
    srv.step()                                  # 3-token prompt at once
    assert srv.stats["chunk_tokens_last"] == 3
    rid = srv.submit(list(range(5, 17)), 3)
    reports = [srv.step() for _ in range(4)]
    # decode row + 3 chunk rows per step: 12 prompt tokens in 4 steps
    assert [r["prefilled"] for r in reports] == [[], [], [], [rid]]
    assert srv.stats["chunk_tokens_last"] == 4
    res = srv.run_until_complete()
    assert res[rid]["tokens"] == _generate(sd, [list(range(5, 17))],
                                           [(12, 3)])[0]
    assert len(res[first]["tokens"]) == 11


def test_chunked_config_walls_and_parsing():
    with pytest.raises(ConfigError, match="token_budget must be >="):
        ServingConfig.from_dict({"max_batch_size": 4,
                                 "chunked_prefill": {"token_budget": 3}})
    with pytest.raises(ConfigError, match="token_budget must be >="):
        ServingConfig(max_batch_size=8, chunked_token_budget=4)
    with pytest.raises(ConfigError, match="temperature == 0"):
        ServingConfig.from_dict({"temperature": 0.7,
                                 "chunked_prefill": {}})
    with pytest.raises(ConfigError, match="must be a dict"):
        ServingConfig.from_dict({"chunked_prefill": 16})
    # a present block defaults to enabled, with the JAX default budget
    cfg = ServingConfig.from_dict({"chunked_prefill": {}})
    assert cfg.chunked_prefill and cfg.chunked_token_budget == 64
    cfg = ServingConfig.from_dict({"chunked_prefill": {"token_budget": 8},
                                   "int8_kv_cache": True,
                                   "prefix_cache": True})
    assert (cfg.chunked_prefill, cfg.chunked_token_budget,
            cfg.int8_kv_cache, cfg.prefix_cache) == (True, 8, True, True)
    # a bare ``false`` is a present key read as an empty block: on, as the
    # JAX parser reads it (test_torch_serving_config_parity.py)
    assert ServingConfig.from_dict({"chunked_prefill": False}
                                   ).chunked_prefill


def test_int8_decode_attention_on_cuda_takes_the_kernel():
    """An int8 pool resolves to the kernel under "auto" on CUDA with
    fp32 or bf16 queries, and raises where the kernel does not take it."""
    i8, bf16 = torch.int8, torch.bfloat16
    assert resolve_decode_attention("auto", "cuda", 64, bf16, i8) == "kernel"
    assert resolve_decode_attention("kernel", "cuda", 64, torch.float32,
                                    i8) == "kernel"
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        resolve_decode_attention("auto", "cuda", 64, torch.float16, i8)
    with pytest.raises(ValueError, match="CUDA kernel takes"):
        resolve_decode_attention("kernel", "cuda", 60, bf16, i8)


def test_block_pool_refcounts():
    from deepspeed_tpu_torch.serving import BlockPool

    pool = BlockPool(5)
    a = pool.alloc(2)
    pool.share(a[:1])
    assert pool.refcount(a[0]) == 2 and pool.used_blocks == 2
    pool.release(a)
    assert pool.used_blocks == 1 and pool.refcount(a[1]) == 0
    pool.release(a[:1])
    assert pool.used_blocks == 0
    for bad, match in (([0], "scratch"), ([a[0]], "double free")):
        with pytest.raises(ValueError, match=match):
            pool.release(bad)
    with pytest.raises(ValueError, match="scratch"):
        pool.share([0])
    with pytest.raises(ValueError, match="unallocated"):
        pool.share([a[0]])

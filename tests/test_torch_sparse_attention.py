"""Port parity: block-sparse attention (deepspeed_tpu_torch.ops.
sparse_attention) against the JAX package's, on the CPU.

- Layouts of every sparsity mode are bit-equal to JAX's for the same
  arguments, the BigBird / Variable random blocks included (the same
  ``np.random.default_rng`` draws, and the same stream across the lengths
  one config object is asked for).
- The port's kernel wrappers run their plain versions on CPU tensors; the
  forward, each backward plain version (fed the same lse and delta) and
  the autograd gradient are held against the JAX kernels in interpret
  mode and the JAX ``impl="xla"`` path: fp32, max |diff| <= 1e-5 (the same
  arithmetic summed in another order). ``chip_smoke.py`` holds the CUDA
  kernels against the same plain versions on the GPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jax_sc
from deepspeed_tpu.ops.sparse_attention import utils as jax_utils
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.sparse_attention import (
    SparseAttentionUtils, SparseSelfAttention, causal_blockmask,
    get_sparse_self_attention, layout_kv_indices, layout_to_dense_mask,
    pad_to_block_size, sparse_attention, sparsity_config_from_dict)
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

# The packages export a function of the module's name: import the modules.
jax_ops = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.sparse_attention")
sp = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention")

ATOL = 1e-5
HEADS = 4

# (mode, kwargs): every family, both attention directions, the options
# that change a layout (horizontal globals, rotating global patterns,
# per-head layouts, random blocks, global ranges).
MODES = [
    ("dense", {}),
    ("fixed", {"num_local_blocks": 4, "num_global_blocks": 1}),
    ("fixed", {"num_local_blocks": 4, "num_global_blocks": 2,
               "attention": "unidirectional"}),
    ("fixed", {"num_local_blocks": 4, "horizontal_global_attention": True,
               "different_layout_per_head": True,
               "num_different_global_patterns": 2}),
    ("variable", {"num_random_blocks": 2, "local_window_blocks": [1, 2, 3],
                  "global_block_indices": [0, 5],
                  "different_layout_per_head": True, "rng_seed": 3}),
    ("variable", {"num_random_blocks": 1, "global_block_indices": [1],
                  "global_block_end_indices": [3],
                  "attention": "unidirectional"}),
    ("bigbird", {"num_random_blocks": 2, "different_layout_per_head": True,
                 "rng_seed": 5}),
    ("bigbird", {"num_random_blocks": 1, "attention": "unidirectional"}),
    ("bslongformer", {"num_sliding_window_blocks": 5,
                      "global_block_indices": [0, 4],
                      "global_block_end_indices": [2, 6]}),
    ("bslongformer", {"attention": "unidirectional"}),
]
MODE_IDS = [f"{m}{i}" for i, (m, _kw) in enumerate(MODES)]


def _both(mode, kwargs, block=16):
    d = dict(kwargs, mode=mode, block=block)
    return (sparsity_config_from_dict(d, HEADS),
            jax_utils.sparsity_config_from_dict(d, HEADS))


@pytest.mark.parametrize("mode,kwargs", MODES, ids=MODE_IDS)
def test_layouts_bit_equal_to_jax(mode, kwargs):
    """Three lengths asked of one config object in turn (the random blocks
    continue one stream), and the block-causal intersection."""
    port, ref = _both(mode, kwargs)
    for seq in (128, 64, 256):
        got, want = port.make_layout(seq), ref.make_layout(seq)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), (mode, seq)
        assert np.array_equal(causal_blockmask(got),
                              jax_sc.causal_blockmask(want))


@pytest.mark.parametrize("mode,kwargs", MODES, ids=MODE_IDS)
def test_index_lists_equal_jax(mode, kwargs):
    layout = _both(mode, kwargs)[0].make_layout(128)
    for fn in ("layout_kv_indices", "layout_q_indices"):
        (got, gmax), (want, wmax) = (getattr(sp, fn)(layout),
                                     getattr(jax_ops, fn)(layout))
        assert gmax == wmax and np.array_equal(got, want)
    assert np.array_equal(layout_to_dense_mask(layout, 16),
                          jax_ops.layout_to_dense_mask(layout, 16))
    plan = sp.sparse_plan(layout, 16)
    kv_idx, kv_cnt, q_idx, q_cnt = (t.numpy() for t in plan.on("cpu"))
    assert kv_idx.dtype == np.int32 and q_cnt.dtype == np.int32
    assert np.array_equal(kv_cnt, layout.sum(-1))
    assert np.array_equal(q_cnt, layout.sum(-2))
    assert np.array_equal(kv_idx, layout_kv_indices(layout)[0])
    assert sp.sparse_plan(layout.copy(), 16) is plan          # cached


def _case(seed, b, s, h, d, masked):
    """q, k, v, dO normal; with ``masked``, batch row 0 padded at the end
    and row 1 all padding (its every query row has no visible key)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((b, s), np.int32)
        mask[0, s - 21:] = 0
        mask[1] = 0
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, layout, block, causal, impl):
    def f(q, k, v):
        kw = {"interpret": True} if impl == "pallas" else {}
        out = jax_ops.sparse_attention(
            q, k, v, layout, block, causal=causal, impl=impl,
            key_mask=None if mask is None else jnp.asarray(mask), **kw)
        return jnp.sum(out * do), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(q, k, v, do, mask, layout, block, causal, impl="auto"):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = sparse_attention(*ts, layout, block, causal=causal, impl=impl,
                           key_mask=None if mask is None
                           else torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


KERNEL_CASES = [  # (mode, kwargs, block, causal, masked)
    ("bigbird", {"num_random_blocks": 1, "attention": "unidirectional",
                 "rng_seed": 11}, 16, True, False),
    ("bigbird", {"num_random_blocks": 1, "attention": "unidirectional",
                 "rng_seed": 11}, 32, True, True),
    ("fixed", {"num_local_blocks": 2}, 16, False, True),
    ("variable", {"num_random_blocks": 1, "local_window_blocks": [1, 2],
                  "different_layout_per_head": True, "rng_seed": 2},
     32, False, False),
]


@pytest.mark.parametrize("mode,kwargs,block,causal,masked", KERNEL_CASES,
                         ids=[f"{c[0]}-b{c[2]}-causal{int(c[3])}-"
                              f"mask{int(c[4])}" for c in KERNEL_CASES])
def test_plain_versions_match_jax_kernels(mode, kwargs, block, causal,
                                          masked):
    """The port's kernel path (its plain versions on the CPU, through the
    autograd Function) against JAX's Pallas kernels (interpret) and its
    xla path: output and q/k/v gradients, fp32, atol 1e-5. The
    all-padding batch row gives exactly zero output and gradients."""
    b, s, d = 2, 128, 32
    layout = _both(mode, kwargs, block)[1].make_layout(s)
    q, k, v, do, mask = _case(block + 2 * causal + masked, b, s, HEADS, d,
                              masked)
    got, got_g = _port_grads(q, k, v, do, mask, layout, block, causal)
    for impl in ("pallas", "xla"):
        want, want_g = _jax_grads(q, k, v, do, mask, layout, block, causal,
                                  impl)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=impl)
        for name, g, w in zip("qkv", got_g, want_g):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                       err_msg=f"{impl} d{name}")
    if masked:
        assert not got[1].any() and not any(g[1].any() for g in got_g)


@pytest.mark.parametrize("causal,masked", [(True, True), (False, False)])
def test_backward_plain_versions_match_jax_kernels(causal, masked):
    """The forward's (o, lse) and the dq / dk-dv plain versions, fed the
    same lse and delta, against the JAX forward and backward kernels
    themselves (interpret), fp32 atol 1e-5; an empty row's lse is -1e30
    on both sides."""
    b, s, h, d, block = 2, 64, 2, 16, 16
    cfg = jax_sc.BigBirdSparsityConfig(h, block, num_random_blocks=1,
                                       attention="unidirectional",
                                       rng_seed=4)
    layout = cfg.make_layout(s)
    q, k, v, do, mask = _case(9 + causal, b, s, h, d, masked)
    scale = 1.0 / d ** 0.5

    def bhsd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)

    kv_idx, _ = jax_ops.layout_kv_indices(layout)
    q_idx, _ = jax_ops.layout_q_indices(layout)
    kv_cnt = jnp.asarray(layout.sum(-1).astype(np.int32))
    q_cnt = jnp.asarray(layout.sum(-2).astype(np.int32))
    mf = (None if mask is None
          else jnp.asarray(mask, jnp.float32)[:, None, :])
    jo, jlse = jax_ops._sparse_forward(
        bhsd(q), bhsd(k), bhsd(v), mf, jnp.asarray(kv_idx), kv_cnt, block,
        causal, scale, h, True)
    jdq, jdk, jdv = jax_ops._sparse_backward(
        bhsd(q), bhsd(k), bhsd(v), mf, bhsd(do), jo, jlse,
        jnp.asarray(kv_idx), kv_cnt, jnp.asarray(q_idx), q_cnt, block,
        causal, scale, h, True)

    def back(x):
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)

    plan = sp.sparse_plan(layout, block)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = sp.sparse_attention_fwd(tq, tk, tv, tm, plan, causal, scale)
    want_lse = np.asarray(jlse)[..., 0].reshape(b, h, s)
    np.testing.assert_allclose(out.numpy(), back(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=0)
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    dq = sp.sparse_attention_bwd_dq(tq, tk, tv, tdo, tm, lse, delta, plan,
                                    causal, scale)
    dk, dv = sp.sparse_attention_bwd_dkv(tq, tk, tv, tdo, tm, lse, delta,
                                         plan, causal, scale)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), back(want), atol=ATOL,
                                   rtol=0, err_msg=name)
    if masked:
        assert (lse[1] == sp.NEG_INF).all() and (want_lse[1] == -1e30).all()


def test_xla_impl_matches_jax_xla():
    """``impl="xla"`` (dense under the expanded mask, autograd) against
    JAX's xla path, with a key mask and a fully masked row."""
    layout = _both("bslongformer", {})[1].make_layout(64)
    q, k, v, do, mask = _case(3, 2, 64, HEADS, 16, True)
    got, got_g = _port_grads(q, k, v, do, mask, layout, 16, True, "xla")
    want, want_g = _jax_grads(q, k, v, do, mask, layout, 16, True, "xla")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_cpu_wrappers_count_no_launch():
    layout = _both("fixed", {})[0].make_layout(64)
    q, k, v, do, _m = _case(1, 1, 64, HEADS, 16, False)
    fns = (sp.sparse_attention_fwd, sp.sparse_attention_bwd_dq,
           sp.sparse_attention_bwd_dkv)
    before = [f.launches for f in fns]
    _port_grads(q, k, v, do, None, layout, 16, False)
    assert before == [f.launches for f in fns]


def test_kernel_walls():
    """What the CUDA kernels refuse raises before any launch (checked on
    CPU tensors, which never reach the kernels otherwise)."""
    layout = np.ones((2, 4, 4), np.int32)

    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    q = t(1, 32, 2, 16)
    sp._prepare(q, q, q, None, sp.sparse_plan(np.ones((2, 2, 2)), 16))
    with pytest.raises(ValueError, match="multiple of 16"):
        sp._prepare(t(1, 32, 2, 16), t(1, 32, 2, 16), t(1, 32, 2, 16), None,
                    sp.sparse_plan(layout, 8))
    with pytest.raises(ValueError, match="head_dim"):
        sp._prepare(t(1, 64, 2, 12), t(1, 64, 2, 12), t(1, 64, 2, 12), None,
                    sp.sparse_plan(layout, 16))
    with pytest.raises(ValueError, match="head_dim"):
        wide = t(1, 64, 2, 136)
        sp._prepare(wide, wide, wide, None, sp.sparse_plan(layout, 16))
    with pytest.raises(ValueError, match="int8"):
        i8 = t(1, 64, 2, 16, dtype=torch.int8)
        sp._prepare(i8, i8, i8, None, sp.sparse_plan(layout, 16))
    with pytest.raises(ValueError, match="does not fit"):
        sp._prepare(q, q, q, None, sp.sparse_plan(layout, 16))
    with pytest.raises(TypeError, match="dtype"):
        q64 = t(1, 64, 2, 16)
        sp._prepare(q64, q64.double(), q64, None, sp.sparse_plan(layout, 16))
    with pytest.raises(ValueError, match="key_mask shape"):
        q64 = t(1, 64, 2, 16)
        sp._prepare(q64, q64, q64, torch.ones(1, 63),
                    sp.sparse_plan(layout, 16))


def test_other_devices_and_impls_raise():
    q = torch.empty(1, 32, 2, 16, device="meta")
    layout = np.ones((2, 2, 2), np.int32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sparse_attention(q, q, q, layout, 16)
    with pytest.raises(ValueError, match="unknown sparse attention impl"):
        sparse_attention(q, q, q, layout, 16, impl="triton")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """A CUDA call whose kernel cannot be built raises; nothing falls back
    to the plain version."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("sparse_attention")
    assert not list(tmp_path.iterdir())


def test_config_errors_match_jax():
    for d in ({"mode": "nope"}, {"mode": "fixed", "bogus": 1},
              {"mode": "bigbird", "num_local_blocks": 4},
              {"mode": "fixed", "attention": "sideways"},
              {"mode": "fixed", "num_local_blocks": 3,
               "num_global_blocks": 2},
              {"mode": "fixed", "num_different_global_patterns": 2}):
        with pytest.raises(ValueError) as got:
            sparsity_config_from_dict(d, 2)
        with pytest.raises(ValueError) as want:
            jax_utils.sparsity_config_from_dict(d, 2)
        assert str(got.value) == str(want.value)
    cfg = sparsity_config_from_dict({"mode": "bigbird", "impl": "xla"}, 2)
    assert type(cfg).__name__ == "BigBirdSparsityConfig"
    assert sparsity_config_from_dict(None, 2).num_local_blocks == 4


def test_seq_not_a_block_multiple_raises():
    q = torch.zeros(1, 40, 2, 16)
    with pytest.raises(ValueError, match="not divisible by block"):
        sparse_attention(q, q, q, np.ones((2, 2, 2)), 16)
    with pytest.raises(ValueError, match="sequence needs 2"):
        sparse_attention(q[:, :32], q[:, :32], q[:, :32], np.ones((2, 4, 4)),
                         16)
    with pytest.raises(ValueError, match="not divisible by block"):
        sc.FixedSparsityConfig(2, 16).make_layout(40)


def test_self_attention_layout_cache_is_shared():
    """One object per (config, heads, impl): every layer shares its layout
    of a length, drawn once, and equal to the JAX object's first draw."""
    d = {"mode": "bigbird", "block": 16, "num_random_blocks": 2,
         "rng_seed": 21}
    a = get_sparse_self_attention(d, HEADS)
    assert get_sparse_self_attention(dict(d), HEADS) is a
    assert get_sparse_self_attention(d, HEADS, impl="xla") is not a
    assert isinstance(a, SparseSelfAttention) and a.impl == "auto"
    first = a.layout(128)
    assert a.layout(128) is first
    fresh = jax_utils.sparsity_config_from_dict(d, HEADS).make_layout(128)
    assert np.array_equal(first, fresh)


def test_pad_to_block_size_matches_jax():
    x = np.arange(2 * 37 * 3, dtype=np.float32).reshape(2, 37, 3)
    got, pad = pad_to_block_size(torch.from_numpy(x), 16)
    want, wpad = jax_ops.pad_to_block_size(jnp.asarray(x), 16)
    assert pad == wpad == 11 and np.array_equal(got.numpy(), want)
    same, none = pad_to_block_size(torch.from_numpy(x[:, :32]), 16)
    assert none == 0 and same.shape == (2, 32, 3)
    ids = np.arange(2 * 21, dtype=np.int32).reshape(2, 21)
    labels = ids + 1
    got_pad, got = SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), pad_token_id=7,
        labels=torch.from_numpy(labels))
    want_pad, want = jax_utils.SparseAttentionUtils.pad_to_block_size(
        16, jnp.asarray(ids), pad_token_id=7, labels=jnp.asarray(labels))
    assert got_pad == want_pad == 11 and set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    out = torch.zeros(2, 32, 5)
    assert SparseAttentionUtils.unpad_sequence_output(11, out).shape == \
        (2, 21, 5)
    assert SparseAttentionUtils.unpad_sequence_output(0, out) is out


def test_extend_position_embedding_matches_jax():
    """A 1024-position table tiled to 16384, as the long-sequence model
    needs; the other leaves are untouched."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(1024, 8)).astype(np.float32)
    other = torch.ones(3)
    got = SparseAttentionUtils.extend_position_embedding(
        {"wpe": torch.from_numpy(table), "wte": other}, 16384)
    want = jax_utils.SparseAttentionUtils.extend_position_embedding(
        {"wpe": jnp.asarray(table)}, 16384)
    assert np.array_equal(got["wpe"].numpy(), np.asarray(want["wpe"]))
    assert got["wte"] is other and got["wpe"].shape == (16384, 8)
    odd = SparseAttentionUtils.extend_position_embedding({"wpe": table}, 2500)
    assert np.array_equal(odd["wpe"].numpy(), np.asarray(
        jax_utils.SparseAttentionUtils.extend_position_embedding(
            {"wpe": jnp.asarray(table)}, 2500)["wpe"]))
    with pytest.raises(ValueError, match="must exceed"):
        SparseAttentionUtils.extend_position_embedding({"wpe": table}, 1024)


def test_surgery_needs_an_in_tree_model():
    with pytest.raises(ValueError, match="in-tree model"):
        SparseAttentionUtils.\
            replace_model_self_attention_with_sparse_self_attention(
                torch.nn.Linear(2, 2), {"mode": "fixed"})

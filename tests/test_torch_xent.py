"""Port parity: the fused cross-entropy head and the embedding ops
(deepspeed_tpu_torch) against the JAX package, on the CPU.

Tolerances: fp32, 1e-5 relative to each array's largest element (the
same arithmetic; the logsumexp and the matmuls sum in other orders).
bf16: 2e-2 of the largest element (bf16 keeps 8 bits of mantissa, and
the two frameworks round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt import \
    cross_entropy_with_ignore as jax_ce_with_ignore
from deepspeed_tpu.ops.embedding import embedding_lookup as jax_lookup
from deepspeed_tpu.ops.embedding import vocab_pad_mask as jax_vocab_pad_mask
from deepspeed_tpu.ops.xent import fused_cross_entropy as jax_fused_ce
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.models.gpt import cross_entropy_with_ignore
from deepspeed_tpu_torch.ops.embedding import embedding_lookup, vocab_pad_mask
from deepspeed_tpu_torch.ops.xent import fused_cross_entropy

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

N, D, V, VPAD = 24, 16, 50, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _inputs(seed, padded):
    rng = np.random.default_rng(seed)
    v = VPAD if padded else V
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(v, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[[3, 11]] = -100                          # ignored positions
    return x, w, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("logits_fp32", [False, True])
def test_fused_ce_loss_and_grads_match_jax(dtype, padded, logits_fp32):
    x, w, labels = _inputs(int(padded) + 2 * int(logits_fp32), padded)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jbias = jax_vocab_pad_mask(VPAD, V) if padded else None

    def jloss(x, w):
        return jax_fused_ce(x, w, jnp.asarray(labels), bias=jbias,
                            bias_grad=False, logits_fp32=logits_fp32)

    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want, (wdx, wdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jx, jw)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    tbias = vocab_pad_mask(VPAD, V) if padded else None
    got = fused_cross_entropy(tx, tw, torch.from_numpy(labels), bias=tbias,
                              bias_grad=False, logits_fp32=logits_fp32)
    got.backward()
    tol = TOL[dtype]
    _close(got.detach().float(), np.float32(want), tol)
    _close(tx.grad.float(), np.asarray(wdx, np.float32), tol)
    _close(tw.grad.float(), np.asarray(wdw, np.float32), tol)
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    if padded:     # pad rows get no gradient and stay at init
        assert not tw.grad[V:].float().abs().any()


def test_bias_gradient_matches_jax():
    x, w, labels = _inputs(9, False)
    b = np.random.default_rng(9).normal(size=V).astype(np.float32)

    def jloss(x, w, b):
        return jax_fused_ce(x, w, jnp.asarray(labels), bias=b)

    _, (jdx, jdw, jdb) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    fused_cross_entropy(tx, tw, torch.from_numpy(labels), bias=tb).backward()
    for got, want in ((tx.grad, jdx), (tw.grad, jdw), (tb.grad, jdb)):
        _close(got, np.asarray(want), TOL["float32"])


def test_w_transposed_and_ignore_everything():
    x, w, labels = _inputs(4, False)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    lab = torch.from_numpy(labels)
    a = fused_cross_entropy(tx, tw, lab)
    b = fused_cross_entropy(tx, tw.t().contiguous(), lab, w_transposed=True)
    assert torch.equal(a, b)
    none = fused_cross_entropy(tx, tw, torch.full_like(lab, -100))
    assert float(none) == 0.0


def test_unfused_ce_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 6, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (2, 6)).astype(np.int32)
    labels[0, -1] = -100
    want = jax_ce_with_ignore(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy_with_ignore(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    _close(got, np.float32(want), TOL["float32"])


@pytest.mark.parametrize("matmul_grad", [False, True])
def test_embedding_lookup_and_grad_match_jax(matmul_grad):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (3, 7)).astype(np.int32)
    ids[0, :3] = 5                                     # repeated rows
    g = rng.normal(size=(3, 7, D)).astype(np.float32)

    def jf(t):
        return jnp.sum(jax_lookup(t, jnp.asarray(ids),
                                  matmul_grad=matmul_grad) * g)

    want = jax.grad(jf)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    out = embedding_lookup(tt, torch.from_numpy(ids),
                           matmul_grad=matmul_grad)
    assert torch.equal(out.detach(), torch.from_numpy(table)[ids])
    (out * torch.from_numpy(g)).sum().backward()
    _close(tt.grad, np.asarray(want), TOL["float32"])


def test_embedding_fp32_grad_keeps_table_dtype():
    table = torch.randn(V, D, dtype=torch.bfloat16, requires_grad=True)
    out = embedding_lookup(table, torch.tensor([[1, 1, 2]]),
                           matmul_grad=True)
    out.float().sum().backward()
    assert table.grad.dtype == torch.bfloat16
    assert float(table.grad[1, 0]) == 2.0 and float(table.grad[3, 0]) == 0.0


def test_vocab_pad_mask_and_sparse_grad_wall():
    np.testing.assert_array_equal(vocab_pad_mask(VPAD, V).numpy(),
                                  np.asarray(jax_vocab_pad_mask(VPAD, V)))
    with pytest.raises(ConfigError, match="not yet ported"):
        embedding_lookup(torch.zeros(4, 2), torch.tensor([1]),
                         sparse_grad_axes=("data",))

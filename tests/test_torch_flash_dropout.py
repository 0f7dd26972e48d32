"""Port parity: the dropout branch of flash attention (deepspeed_tpu_torch)
against the JAX package's Pallas kernels, run as the JAX tests run them on
the CPU (``interpret=True``), and the keep-mask against JAX's
``dropout_keep_mask`` bit for bit.

On the CPU the port's wrapper runs its plain version; ``chip_smoke.py``
holds the CUDA kernels' dropout branch against the same plain versions
and reads their keep-mask back on the GPU. Tolerance: fp32, max |diff| <=
1e-5, as tests/test_torch_flash_attention.py (the masks are equal, so
only summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.flash_attention import \
    dropout_keep_mask as jax_keep_mask
from deepspeed_tpu.ops.transformer.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.attention import (attention,
                                                           xla_attention)

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

ATOL = 1e-5
RATE = 0.3
B, S, H, D = 2, 128, 2, 32


@pytest.mark.parametrize("seed", [0, -1, 2 ** 31 - 1, -2 ** 31])
def test_keep_mask_bit_equal_to_jax(seed):
    """Rows and cols up to 16383 and batch-heads up to 191 (GPT-2 at seq
    16384, and 16 x 12 heads), rates 0.1 and 0.3."""
    rows = np.r_[np.arange(0, 16384, 61), 16383][:, None]
    cols = np.r_[np.arange(0, 16384, 67), 16383][None, :]
    for bh in (0, 1, 95, 191):
        for rate in (0.1, 0.3):
            want = np.asarray(jax_keep_mask(jnp.int32(seed), bh,
                                            jnp.asarray(rows),
                                            jnp.asarray(cols), rate))
            got = fa.dropout_keep_mask(seed, bh, torch.from_numpy(rows),
                                       torch.from_numpy(cols), rate)
            np.testing.assert_array_equal(got.numpy(), want)


def test_keep_share():
    keep = fa.dropout_keep_mask(123, 3, torch.arange(512)[:, None],
                                torch.arange(512)[None, :], 0.3)
    n = keep.numel()
    assert abs(int(keep.sum()) - 0.7 * n) <= 5 * (n * 0.21) ** 0.5


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, S), np.float32)
        mask[0, 100:] = 0.0          # padded tail
        mask[1] = 0.0                # a batch row that is all padding
    return q, k, v, do, mask


def _seed_of(key) -> int:
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ (kd[-1] << np.uint32(1)))


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (True, True)])
def test_dropout_matches_jax_kernels(causal, masked):
    """Forward and dq/dk/dv at rate 0.3 (64-blocks on the JAX side, so
    the mask spans several grid steps), against autograd through the
    port's plain version with the seed of the same key."""
    q, k, v, do, mask = _inputs(3 + causal + 2 * masked, masked)
    key = jax.random.PRNGKey(7 + causal)

    def f(q, k, v):
        out = jax_flash_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            block_q=64, block_k=64, dropout_rate=RATE, dropout_rng=key,
            interpret=True)
        return jnp.sum(out * do), out

    (_, want), wgrads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(
        *ts, causal=causal,
        kv_mask=None if mask is None else torch.from_numpy(mask),
        dropout_rate=RATE, dropout_seed=_seed_of(key))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    for name, t, w in zip("qkv", ts, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=f"d{name}")
    if masked:
        assert not out[1].detach().any()


@pytest.mark.parametrize("causal", [False, True])
def test_backward_plain_versions_match_autograd_at_dropout(causal):
    """The plain versions of the dq and dk/dv kernels at rate 0.3, given
    lse (of the undropped probabilities) and delta = rowsum(dO * O), equal
    the autograd gradients of the plain forward (fp32, 1e-5)."""
    q, k, v, do, mask = (None if x is None else torch.from_numpy(x)
                         for x in _inputs(11, True))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_reference(*ts, causal=causal, kv_mask=mask,
                                       dropout_rate=RATE, dropout_seed=9)
    out.backward(do)
    scale = 1.0 / D ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    m = s.amax(-1, keepdim=True)
    l = (torch.exp(s - m) * mask[:, None, None, :]).sum(-1, keepdim=True)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    delta = (do * out.detach()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, mask, lse, delta, causal, scale, RATE, 9)
    dq = fa.flash_bwd_dq_reference(*args)
    dk, dv = fa.flash_bwd_dkv_reference(*args)
    for name, a, t in (("dq", dq, ts[0]), ("dk", dk, ts[1]),
                       ("dv", dv, ts[2])):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_xla_path_uses_the_same_mask():
    """The port's plain attention drops out with the kernels' mask: "xla"
    and "flash" give the same output for one seed (a different seed does
    not), and a deterministic call ignores the rate."""
    q, k, v, _do, _m = (None if x is None else torch.from_numpy(x)
                        for x in _inputs(5, False))
    kw = dict(causal=True, dropout_rate=0.1, deterministic=False)
    a = attention(q, k, v, impl="xla", dropout_seed=4, **kw)
    b = attention(q, k, v, impl="flash", dropout_seed=4, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    c = attention(q, k, v, impl="xla", dropout_seed=5, **kw)
    assert np.abs(a.numpy() - c.numpy()).max() > 0.1
    det = attention(q, k, v, causal=True, dropout_rate=0.1,
                    deterministic=True, impl="xla")
    assert torch.equal(det, xla_attention(q, k, v, causal=True))


def test_kernel_dropout_arguments():
    """What the CUDA kernels get: the seed as uint32, the threshold of the
    top 24 bits (JAX's ``int(rate * 2**24)``) and 1 / (1 - rate); rate 0
    selects the variant without the hash. A rate without a seed, or
    outside [0, 1), raises."""
    assert fa._drop_args(0.0, None) == (0, 0, 1.0)
    assert fa._drop_args(0.1, -1) == (2 ** 32 - 1, 1677721, 1 / 0.9)
    for rate, seed in ((0.1, None), (1.0, 3), (-0.1, 3)):
        with pytest.raises(ValueError):
            fa._drop_args(rate, seed)
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        fa.flash_attention(q, q, q, dropout_rate=0.1)

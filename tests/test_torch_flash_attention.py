"""Port parity: flash attention and the attention dispatch
(deepspeed_tpu_torch) against the JAX package's Pallas kernels, run as the
JAX tests run them on the CPU (``interpret=True``).

On the CPU the port's wrapper runs its plain version (materialised fp32
scores, autograd); ``chip_smoke.py`` holds the CUDA kernels against the
same plain versions on the GPU. Tolerance: fp32, max |diff| <= 1e-5 (the
same arithmetic summed in another order: online softmax over 128-blocks in
the JAX kernels, one softmax here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.attention import (
    _as_kv_mask, attention, resolve_attention_impl, xla_attention)

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

ATOL = 1e-5
B, S, H, D = 2, 256, 2, 64


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, S), np.float32)
        mask[0, 200:] = 0.0          # padded tail
        mask[1] = 0.0                # a batch row that is all padding
    return q, k, v, do, mask


def _jax(q, k, v, do, mask, causal):
    def f(q, k, v):
        out = jax_flash_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            block_q=128, block_k=128, interpret=True)
        return jnp.sum(out * do), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(q, k, v, do, mask, causal, fn=fa.flash_attention):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ts, causal=causal,
             kv_mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_version_matches_jax_kernels(causal, masked):
    """Output and q/k/v gradients, fp32, atol 1e-5; the all-padding row
    gives exactly zero output and gradient on both sides."""
    q, k, v, do, mask = _inputs(int(causal) * 2 + int(masked), masked)
    want, want_g = _jax(q, k, v, do, mask, causal)
    got, got_g = _port(q, k, v, do, mask, causal)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for name, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")
    if masked:
        assert not np.abs(got[1]).any() and not np.abs(want[1]).any()
        assert not np.abs(got_g[0][1]).any()


def _lse(q, k, mask, causal, scale):
    """The kernels' row logsumexp, from its definition."""
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril(
            k.shape[1] - q.shape[1])
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        p = p * mask[:, None, None, :]
    return m + torch.log(p.sum(-1).clamp_min(1e-30))


@pytest.mark.parametrize("masked", [False, True])
def test_backward_plain_versions_match_autograd(masked):
    """The plain versions of the dq and dk/dv kernels (the yardsticks of
    the CUDA backward on the card), given lse and delta = rowsum(dO * O),
    equal the reference's autograd gradients (fp32, atol 1e-5)."""
    q, k, v, do, mask = _inputs(7, masked)
    got, (gq, gk, gv) = _port(q, k, v, do, mask, True,
                              fn=fa.flash_attention_reference)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    scale = 1.0 / D ** 0.5
    lse = _lse(tq, tk, tm, True, scale)
    delta = (tdo * torch.from_numpy(got)).sum(-1).transpose(1, 2)
    dq = fa.flash_bwd_dq_reference(tq, tk, tv, tdo, tm, lse, delta, True,
                                   scale)
    dk, dv = fa.flash_bwd_dkv_reference(tq, tk, tv, tdo, tm, lse, delta,
                                        True, scale)
    for name, a, b in (("dq", dq, gq), ("dk", dk, gk), ("dv", dv, gv)):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_ragged_lengths_and_cross_attention():
    """Sequences that are not 128-multiples (the CUDA kernels take any S):
    the plain version equals dense masked attention where no row is fully
    masked."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 5, 3, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 300, 3, 16))
                             .astype(np.float32)) for _ in range(2))
    mask = torch.ones(2, 300)
    mask[1, 290:] = 0
    got = fa.flash_attention(q, k, v, causal=True, kv_mask=mask)
    want = xla_attention(q, k, v, causal=True, mask=mask.bool())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_cpu_wrapper_counts_no_launch():
    q, k, v, _do, _m = _inputs(1, False)
    counts = [f.launches for f in (fa.flash_attention_fwd,
                                   fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    _port(q, k, v, _do, None, True)
    assert counts == [f.launches for f in (fa.flash_attention_fwd,
                                           fa.flash_attention_bwd_dq,
                                           fa.flash_attention_bwd_dkv)]


def test_kernel_gate():
    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    assert fa.flash_ok(t(16, 512, 12, 64), t(16, 512, 12, 64), True)
    assert fa.flash_ok(t(2, 5, 2, 8), t(2, 300, 2, 8), True)
    assert fa.flash_ok(t(2, 7, 2, 256, dtype=torch.float32),
                       t(2, 7, 2, 256, dtype=torch.float32), False)
    assert not fa.flash_ok(t(2, 8, 2, 60), t(2, 8, 2, 60), True)
    assert not fa.flash_ok(t(2, 8, 2, 264), t(2, 8, 2, 264), True)
    assert not fa.flash_ok(t(2, 9, 2, 64), t(2, 8, 2, 64), True)
    assert fa.flash_ok(t(2, 9, 2, 64), t(2, 8, 2, 64), False)
    assert not fa.flash_ok(t(2, 8, 2, 64, dtype=torch.int8),
                           t(2, 8, 2, 64, dtype=torch.int8), False)


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(1, 8, 1, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa.flash_attention(q, q, q, causal=True)


@pytest.mark.parametrize("name", ["flash_attention", "fused_adam"])
def test_missing_nvcc_raises(name, monkeypatch, tmp_path):
    """A CUDA call whose kernel cannot be built raises; nothing falls back
    to the plain version."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(name)
    assert not list(tmp_path.iterdir())


def test_kv_mask_forms():
    m = torch.ones(2, 7, dtype=torch.bool)
    assert _as_kv_mask(m, 2, 7) is m
    assert torch.equal(_as_kv_mask(m[:, None, None, :], 2, 7), m)
    assert torch.equal(_as_kv_mask(m[:, None, :], 2, 7), m)
    assert _as_kv_mask(torch.ones(2, 1, 7, 7, dtype=torch.bool), 2, 7) is None
    assert _as_kv_mask(None, 2, 7) is None


@pytest.mark.parametrize("impl", ["auto", "flash", "pallas", "xla"])
def test_dispatch_on_cpu_matches_xla(impl):
    """Every impl computes the same causal, key-masked attention (no row
    fully masked); "auto" on the CPU is the plain dense path, as the JAX
    dispatch is off the TPU."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 9, 2, 16))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.ones(2, 1, 1, 9, dtype=torch.bool)
    mask[0, ..., 7:] = False
    got = attention(q, k, v, causal=True, mask=mask, impl=impl)
    want = xla_attention(q, k, v, causal=True, mask=mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_dispatch_walls():
    q = torch.zeros(1, 4, 1, 8)
    general = torch.ones(1, 1, 4, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="key-padding"):
        attention(q, q, q, mask=general, impl="flash")
    with pytest.raises(ValueError, match="key-padding"):
        attention(q, q, q, bias=torch.zeros(1, 1, 4, 4), impl="pallas")
    for impl in ("ring", "ulysses", "pallas_pad"):
        with pytest.raises(ConfigError, match="not yet ported"):
            attention(q, q, q, impl=impl)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        attention(q, q, q, dropout_rate=0.1, deterministic=False)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, q, q, impl="cudnn")
    # a bias or a general mask stays on the plain path under "auto"
    out = attention(q, q, q, bias=torch.zeros(1, 1, 4, 4), mask=general)
    assert out.shape == q.shape


def test_auto_attention_takes_the_kernel_on_cuda():
    """"auto" on a CUDA device is the flash kernels for every causal or
    key-padding-masked call, whatever its shape; only a bias or a general
    mask goes to the plain path there, and only the CPU runs plain
    attention otherwise. A shape the kernels refuse raises before any
    launch instead of being computed by the plain version."""
    assert resolve_attention_impl("auto", "cuda", general=False) == "flash"
    assert resolve_attention_impl("auto", "cuda", general=True) == "xla"
    assert resolve_attention_impl("auto", "cpu", general=False) == "xla"
    assert resolve_attention_impl("pallas", "cpu", general=False) == "flash"
    assert resolve_attention_impl("xla", "cuda", general=False) == "xla"

    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    for q, k in ((t(2, 8, 2, 60), t(2, 8, 2, 60)),      # head_dim % 8
                 (t(2, 8, 2, 264), t(2, 8, 2, 264)),    # head_dim > 256
                 (t(2, 9, 2, 64), t(2, 8, 2, 64))):     # causal Sq > Sk
        with pytest.raises(ValueError):
            fa._FlashAttention.apply(q, k, k, None, True, 0.125, 0.0,
                                         None)

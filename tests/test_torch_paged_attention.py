"""Port parity: paged decode attention (deepspeed_tpu_torch) against the
JAX package's Pallas kernel, run as the JAX tests run it on the CPU
(``interpret=True``, automatic off-TPU).

The CUDA kernel itself is held against the same plain version by
``chip_smoke.py`` on the GPU; here the wrapper takes its plain path because
its tensors lie on the CPU.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer.paged_attention import \
    paged_decode_attention as jax_paged_decode_attention
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference,
    paged_decode_ok)
from deepspeed_tpu_torch.serving.kv_cache import _quant_tokens

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

H, WB = 3, 4


def _case(seed, s, d, bs):
    """Pools [N, BS, H, D] and a decode batch of three rows: a full window
    with a scrambled table, a row whose last query sits mid-block and whose
    table tail points at scratch block 0, and an inactive row (position 0,
    all-scratch table)."""
    rng = np.random.default_rng(seed)
    n = 2 * WB + 1
    k = rng.normal(size=(n, bs, H, d)).astype(np.float32)
    v = rng.normal(size=(n, bs, H, d)).astype(np.float32)
    bt = np.zeros((3, WB), np.int32)
    bt[0] = rng.permutation(np.arange(1, n))[:WB]
    used = (bs + bs // 2 + s - 1) // bs + 1
    bt[1, :used] = rng.permutation(np.arange(1, n))[:used]
    pos = np.array([WB * bs - s, bs + bs // 2, 0], np.int32)
    q = rng.normal(size=(3, s, H, d)).astype(np.float32)
    return q, k, v, bt, pos


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("bs", [4, 16])
def test_plain_version_matches_jax_kernel(s, d, bs):
    """fp32, atol 1e-5: the same arithmetic in another summation order
    (online softmax over blocks in the JAX kernel, one softmax here)."""
    q, k, v, bt, pos = _case(seed=s * 100 + d + bs, s=s, d=d, bs=bs)
    want = np.asarray(jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None,
        jnp.asarray(bt), jnp.asarray(pos), block_size=bs))
    got = paged_decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(pos), block_size=bs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    q, k, v, bt, pos = (torch.from_numpy(a) for a in _case(1, 2, 16, 4))
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, k, v, None, None, bt, pos, block_size=4,
                                 softmax_scale=0.3)
    want = paged_decode_attention_reference(q, k, v, bt, pos, block_size=4,
                                            softmax_scale=0.3)
    assert torch.equal(got, want)
    assert paged_decode_attention.launches == before


def test_masked_garbage_cannot_leak():
    """NaN in the scratch block and in slots past a row's last query must
    not reach the output: masked keys take part in no product."""
    q, k, v, bt, pos = (torch.from_numpy(a) for a in _case(2, 3, 16, 4))
    clean = paged_decode_attention(q, k, v, None, None, bt, pos,
                                   block_size=4)
    k2, v2 = k.clone(), v.clone()
    k2[0] = float("nan")
    v2[0] = float("inf")
    last = int(pos[1]) + q.shape[1] - 1          # row 1's last query
    blk, off = int(bt[1, last // 4]), last % 4
    k2[blk, off + 1:] = float("nan")
    v2[blk, off + 1:] = float("nan")
    dirty = paged_decode_attention(q, k2, v2, None, None, bt, pos,
                                   block_size=4)
    # row 1 sees none of the poisoned slots (rows 0 and 2 may: row 2's
    # one visible key is in the scratch block, row 0 may share row 1's
    # block in this random table)
    assert torch.isfinite(dirty[1]).all()
    assert torch.equal(clean[1], dirty[1])


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("d", [16, 64])
def test_int8_plain_version_matches_jax_kernel(s, d):
    """int8 pools with per-(token, head) scales, made by each package's
    own ``_quant_tokens`` (bit-equal), against the JAX kernel's int8
    branch in interpret mode (the oracle of
    tests/test_serving_fastpath.py::test_int8_in_kernel_dequant_parity),
    fp32 q, atol 2e-5: the dequantized values are equal, only the
    summation order differs."""
    bs = 4
    q, k, v, bt, pos = _case(seed=40 + s + d, s=s, d=d, bs=bs)
    kq, ks = _quant_tokens(torch.from_numpy(k))
    vq, vs = _quant_tokens(torch.from_numpy(v))
    want = np.asarray(jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), jnp.asarray(bt),
        jnp.asarray(pos), block_size=bs))
    got = paged_decode_attention(
        torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(bt),
        torch.from_numpy(pos), block_size=bs)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_int8_scales_not_yet_ported():
    """The int8 branch is ported now: k_scale/v_scale are taken (the CPU
    wrapper runs the plain version, which dequantizes in fp32), a bf16 q
    over int8 pools keeps its dtype, and half a pair of scales raises."""
    q, k, v, bt, pos = (torch.from_numpy(a) for a in _case(3, 1, 16, 4))
    kq, ks = _quant_tokens(k)
    vq, vs = _quant_tokens(v)
    got = paged_decode_attention(q, kq, vq, ks, vs, bt, pos, block_size=4)
    kd = kq.float() * ks[..., None]
    vd = vq.float() * vs[..., None]
    want = paged_decode_attention_reference(q, kd, vd, bt, pos,
                                            block_size=4)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    half = paged_decode_attention(q.bfloat16(), kq, vq, ks, vs, bt, pos,
                                  block_size=4)
    assert half.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_decode_attention(q, kq, vq, ks, None, bt, pos, block_size=4)


def test_other_devices_raise_instead_of_falling_back():
    q, k, v, bt, pos = (torch.from_numpy(a).to("meta")
                        for a in _case(4, 1, 16, 4))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        paged_decode_attention(q, k, v, None, None, bt, pos, block_size=4)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """A CUDA call whose kernel cannot be built raises; nothing falls
    back to the plain version."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("paged_attention")
    assert not list(tmp_path.iterdir())


def test_kernel_geometry_gate():
    bf16, fp32 = torch.bfloat16, torch.float32
    assert paged_decode_ok(64, bf16) and paged_decode_ok(8, fp32)
    assert paged_decode_ok(256, bf16)
    assert not paged_decode_ok(60, bf16) and not paged_decode_ok(264, fp32)
    assert not paged_decode_ok(64, torch.float16)
    # pools of q's dtype or int8 (with fp32/bf16 q); never mixed floats
    assert paged_decode_ok(64, bf16, torch.int8)
    assert paged_decode_ok(64, fp32, torch.int8)
    assert paged_decode_ok(64, fp32, fp32)
    assert not paged_decode_ok(64, fp32, bf16)
    assert not paged_decode_ok(64, torch.float16, torch.int8)
    assert not paged_decode_ok(60, bf16, torch.int8)

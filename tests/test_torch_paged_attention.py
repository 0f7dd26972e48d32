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


def test_int8_scales_not_yet_ported():
    q, k, v, bt, pos = (torch.from_numpy(a) for a in _case(3, 1, 16, 4))
    scale = torch.ones(k.shape[:3])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        paged_decode_attention(q, k, v, scale, scale, bt, pos, block_size=4)


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

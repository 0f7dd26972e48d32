"""Port parity: ragged chunked-prefill attention (deepspeed_tpu_torch)
against the JAX package's Pallas kernel, run as the JAX tests run it on
the CPU (``interpret=True``, automatic off-TPU; the interpreter takes any
head_dim, so 64 is held here too, which the TPU's ``head_dim % 128`` gate
would refuse).

The CUDA kernel itself is held against the same plain version by
``chip_smoke.py`` on the GPU; here the wrapper takes its plain path because
its tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.chunked_prefill import \
    chunked_prefill_attention as jax_chunked_prefill_attention
from deepspeed_tpu.serving.kv_cache import _quant_tokens as jax_quant_tokens
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer import chunked_prefill
from deepspeed_tpu_torch.ops.transformer.chunked_prefill import (
    chunked_prefill_attention, chunked_prefill_attention_reference)
from deepspeed_tpu_torch.serving.kv_cache import _quant_tokens

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

BS, H, WB = 4, 2, 4

# the four mixes of tests/test_chunked_prefill.py
MIXES = {
    "mixed": [11, 3, 0, 1, 2, 5, 6, 7],        # decode rows + prefill rows
    "mid-block": [5, 6, 7, 8, 9, 10, 11, 12],  # a chunk crossing a block
    "all-decode": [9, 14, 3, 7, 12, 5, 8, 10],
    "all-prefill": [0, 1, 2, 3, 4, 5, 6, 7],
}


def _case(seed, pos, d, shared_rows=False):
    """fp32 pools [16, BS, H, D] and q [T, H, D]. Tables are scrambled and
    distinct per row, or (``shared_rows``) one row for all tokens, as a
    prompt chunk's tokens share their sequence's row."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((16, BS, H, d)).astype(np.float32)
    v = rng.standard_normal((16, BS, H, d)).astype(np.float32)
    t = len(pos)
    q = rng.standard_normal((t, H, d)).astype(np.float32)
    rows = [rng.permutation(np.arange(1, 16))[:WB]
            for _ in range(1 if shared_rows else t)]
    table = np.stack(rows * t if shared_rows else rows).astype(np.int32)
    return q, k, v, table, np.asarray(pos, np.int32)


def _jax(q, k, v, ks, vs, table, pos):
    return np.asarray(jax_chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(pos), block_size=BS))


def _port(q, k, v, ks, vs, table, pos, fn=chunked_prefill_attention_reference,
          **kw):
    t = (lambda a: None if a is None else torch.from_numpy(np.asarray(a)))
    return fn(t(q), t(k), t(v), t(ks), t(vs), t(table), t(pos),
              block_size=BS, **kw).numpy()


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shared_rows", [False, True])
def test_plain_version_matches_jax_kernel(mix, d, shared_rows):
    """fp32, atol 2e-5 (the JAX tests' bound): the same arithmetic in
    another summation order (online softmax over blocks in the JAX
    kernel, one softmax here)."""
    q, k, v, table, pos = _case(len(mix) + d, MIXES[mix], d, shared_rows)
    np.testing.assert_allclose(_port(q, k, v, None, None, table, pos),
                               _jax(q, k, v, None, None, table, pos),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_int8_pools_match_jax_kernel(d):
    """int8 pools made by each package's own ``_quant_tokens`` from the
    same fp32 pools (bit-equal codes and scales), atol 2e-5."""
    q, kf, vf, table, _ = _case(5, [0] * 6, d)
    pos = np.asarray([0, 5, 9, 2, 13, 7], np.int32)
    kq, ks = _quant_tokens(torch.from_numpy(kf))
    vq, vs = _quant_tokens(torch.from_numpy(vf))
    jkq, jks = jax_quant_tokens(jnp.asarray(kf))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    args = (q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(), table, pos)
    np.testing.assert_allclose(_port(*args), _jax(*args), atol=2e-5, rtol=0)


def test_pad_rows_attend_scratch_only():
    """A pad row (all-scratch table row, position 0) sees pool block 0,
    offset 0 only: its output is that value row; as in the JAX test."""
    q, k, v, _table, _pos = _case(6, [0, 0], 64)
    table = np.zeros((2, 2), np.int32)
    pos = np.zeros((2,), np.int32)
    got = _port(q, k, v, None, None, table, pos)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.broadcast_to(v[0, 0], got.shape),
                               atol=2e-5)
    np.testing.assert_allclose(got, _jax(q, k, v, None, None, table, pos),
                               atol=2e-5)


def test_pad_rows_and_nan_scratch_leave_real_rows_untouched():
    """A mixed batch padded with pad rows, the scratch block filled with
    NaN: the real rows equal the unpadded batch's, and only the pad rows
    see the NaN."""
    q, k, v, table, pos = _case(7, MIXES["mixed"], 64)
    table[:, -1] = 0                    # row tails on scratch, as served
    k[0] = np.nan
    v[0] = np.nan
    real = _port(q, k, v, None, None, table, pos)
    assert np.isfinite(real).all()
    qp = np.concatenate([q, q[:3]])
    tp = np.concatenate([table, np.zeros((3, WB), np.int32)])
    pp = np.concatenate([pos, np.zeros(3, np.int32)])
    padded = _port(qp, k, v, None, None, tp, pp)
    np.testing.assert_array_equal(padded[:len(pos)], real)
    assert np.isnan(padded[len(pos):]).all()


def test_cpu_wrapper_takes_plain_path_and_counts_no_launch():
    q, k, v, table, pos = _case(8, MIXES["mid-block"], 64)
    before = chunked_prefill_attention.launches
    got = _port(q, k, v, None, None, table, pos,
                fn=chunked_prefill_attention, softmax_scale=0.3)
    want = _port(q, k, v, None, None, table, pos, softmax_scale=0.3)
    np.testing.assert_array_equal(got, want)
    assert chunked_prefill_attention.launches == before


def test_walls_and_other_devices():
    q, k, v, table, pos = (torch.from_numpy(a) for a in
                           _case(9, MIXES["mixed"], 64))
    scale = torch.ones(k.shape[:3])
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        chunked_prefill_attention(q, k, v, scale, None, table, pos,
                                  block_size=BS)
    with pytest.raises(ValueError, match="block size"):
        chunked_prefill_attention(q, k, v, None, None, table, pos,
                                  block_size=8)
    meta = [t.to("meta") for t in (q, k, v, table, pos)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        chunked_prefill_attention(meta[0], meta[1], meta[2], None, None,
                                  meta[3], meta[4], block_size=BS)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """The kernel a CUDA call would launch cannot be built without nvcc:
    the wrapper's loader raises; nothing falls back to the plain
    version."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(chunked_prefill, "_FN", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        chunked_prefill._kernel()
    assert not list(tmp_path.iterdir())


def test_library_names_follow_the_shared_header(monkeypatch, tmp_path):
    """Both paged kernels include csrc/paged_walk.cuh: an edit there
    renames (so rebuilds) both libraries, and no other."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = {n: build.library_path(n) for n in
              ("paged_attention", "chunked_prefill", "fused_adam")}
    with open(csrc / "paged_walk.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build.library_path(n) for n in before}
    assert before["paged_attention"] != after["paged_attention"]
    assert before["chunked_prefill"] != after["chunked_prefill"]
    assert before["chunked_prefill"] != before["paged_attention"]
    assert before["fused_adam"] == after["fused_adam"]

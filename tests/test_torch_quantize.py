"""Port parity: the blockwise int8 core (deepspeed_tpu_torch.comm.quantize)
and the KV pool's per-(token, head) quantization (``_quant_tokens``)
against the JAX package's, bit for bit on the same fp32 input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.quantize import \
    dequantize_blockwise as jax_dequantize_blockwise
from deepspeed_tpu.comm.quantize import \
    quantize_blockwise as jax_quantize_blockwise
from deepspeed_tpu.serving.kv_cache import _quant_tokens as jax_quant_tokens
from deepspeed_tpu_torch.comm.quantize import (dequantize_blockwise,
                                               qmax_for_bits,
                                               quantize_blockwise)
from deepspeed_tpu_torch.serving.kv_cache import _quant_tokens

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)


def _blocks(seed):
    """[6, 3, 64] fp32 with the cases that decide bit equality: a zero
    block, a block holding NaN, one holding inf, one of exact half steps
    (amax 127, so the scale is 1 and every x.5 is a tie), one whose
    values sit on half steps of a non-unit scale, and a normal block."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 3, 64)).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1, 7] = np.nan
    x[0, 2, 9] = -np.inf
    x[1, 0] = np.arange(64, dtype=np.float32) - 31.5
    x[1, 0, 0] = 127.0
    scale = np.float32(3.0) / np.float32(127.0)
    x[1, 1] = (np.arange(64, dtype=np.float32) - 20.5) * scale
    x[1, 1, 0] = 3.0
    x[2] *= 1e-30                       # tiny, still nonzero
    x[3] *= 1e4
    return x


@pytest.mark.parametrize("block", [64, 16])
def test_codes_and_scales_bit_equal_to_jax(block):
    x = _blocks(seed=block)
    wq, ws = jax_quantize_blockwise(jnp.asarray(x), block)
    gq, gs = quantize_blockwise(torch.from_numpy(x), block)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))  # NaN == NaN
    # the half steps really are ties, rounded to even
    assert gq[1, 0, 1:5].tolist() == [-30, -30, -28, -28]
    np.testing.assert_array_equal(
        dequantize_blockwise(gq, gs, block).numpy(),
        np.asarray(jax_dequantize_blockwise(wq, ws, block)))


def test_zero_and_nonfinite_blocks():
    x = _blocks(seed=1)
    q, s = quantize_blockwise(torch.from_numpy(x), 64)
    # a zero block's absmax is taken as 1: scale 1/127, codes 0
    assert s[0, 0] == torch.tensor(1.0) / 127 and not q[0, 0].any()
    assert (dequantize_blockwise(q, s, 64)[0, 0] == 0).all()
    assert torch.isnan(s[0, 1]) and torch.isnan(s[0, 2])
    assert torch.isfinite(s[1:]).all()
    assert qmax_for_bits(8) == 127
    with pytest.raises(ValueError, match="bits=8"):
        quantize_blockwise(torch.from_numpy(x), 64, bits=4)
    with pytest.raises(ValueError, match="not divisible"):
        quantize_blockwise(torch.from_numpy(x), 48)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_tokens_bit_equal_to_jax(dtype):
    """K/V chunks [B, S, H, D] as the pools receive them; bf16 input is
    upcast to fp32 before the absmax and the division in both packages."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    wq, ws = jax_quant_tokens(xj)
    gq, gs = _quant_tokens(xt)
    assert tuple(gs.shape) == (2, 5, 4)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))

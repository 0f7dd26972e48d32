"""Port parity: the fp16 branch of the fused LayerNorm + projection
(kernels #6/#7) against the JAX package's ``ln_matmul`` in fp16 (Pallas,
interpret), on the CPU, and the dtype gate of the CUDA wrappers.

The JAX kernels round ``ln`` and ``dy gelu'(pre)`` to w's dtype before
their products, whatever it is; the port's plain versions do the same, so
y and the gradients agree within 1e-3 of max(1, max |value|): one fp16
rounding step is up to 2**-10 of a value, and the sums run in other
orders on each side (measured on the CPU: up to 4.6e-4, dw and dx). The
helpers are tests/test_torch_fused_ln.py's.
"""

import numpy as np
import pytest
import torch
from test_torch_fused_ln import EPS, _close, _inputs, _jax_side, _port_side

from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.ops.transformer import fused

# One intra-op thread: the tests run in several worker processes at
# once, and torch's OpenMP threads spinning against the other workers
# made them several times slower.
torch.set_num_threads(1)

@pytest.mark.parametrize("act", [None, "gelu"])
def test_fp16_matches_jax(act):
    arrs = _inputs(4, 256, 128, 256)
    want_y, want = _jax_side(arrs, "float16", act)
    got_y, got = _port_side(arrs, "float16", act)
    _close(got_y, want_y, 1e-3, "y")
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw", "dbias"), got,
                          want):
        _close(g, w, 1e-3, name)


def test_kernel_dtype_gate():
    """The CUDA wrappers' checks (run here on CPU tensors): fp16 x and w
    pass, as fp32 and bf16 do; a dtype the kernels do not take, or x and
    w of two dtypes, raises the port's "not yet ported" error, not a
    TypeError."""
    def args(dt, wdt=None):
        return (torch.zeros(4, 16, dtype=dt), torch.ones(16),
                torch.zeros(16), torch.zeros(8, 16, dtype=wdt or dt),
                torch.zeros(8))

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        x = fused._prepare(*args(dt))[0]
        assert x.dtype == dt
    for bad in (args(torch.float64), args(torch.float16, torch.bfloat16)):
        with pytest.raises(ConfigError, match="not yet ported"):
            fused._prepare(*bad)
    y = fused.ln_matmul(*args(torch.float16), eps=EPS)
    assert y.dtype == torch.float16 and y.shape == (4, 8)
    assert np.isfinite(y.float().numpy()).all()

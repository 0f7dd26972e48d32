"""Blockwise symmetric int8 quantization: deterministic round trips with
per-block fp32 scales, and the round-trip error gauges built on them.

The port's copy of ``deepspeed_tpu/comm/quantize.py`` (the JAX package's
one int8 implementation). In the port its consumers are the serving KV pool
(``serving/kv_cache.py``), one block per (token, head) vector, and the
int8 KV-cache error gauges of serving telemetry (``roundtrip_error``). The codes
match the JAX package's bit for bit on the same fp32 input:

- **round half to even**: ``torch.round`` rounds ties to even, as
  ``jnp.round`` does;
- **the step is a true fp32 division** ``blocks / scale`` (a multiply by
  the reciprocal would move codes that sit on a half step);
- **zero-preserving**: an all-zero block takes its absmax as 1 (a finite
  scale, 1/127), gets codes 0, and dequantizes to exact zeros;
- **overflow-transparent**: a block holding inf or NaN gets a NaN scale,
  so its dequantized block is NaN.
"""

from typing import Tuple

import torch

__all__ = ["qmax_for_bits", "quantize_blockwise", "dequantize_blockwise",
           "roundtrip_error_parts", "rel_from_parts", "roundtrip_error"]


def qmax_for_bits(bits: int) -> int:
    """Largest magnitude representable by a signed ``bits``-wide code."""
    return 2 ** (bits - 1) - 1


def quantize_blockwise(x: torch.Tensor, block_size: int,
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize the last dim of ``x`` in blocks of ``block_size``.

    ``x``: [..., m] float, ``m % block_size == 0``. Returns ``(q int8
    [..., m], scales fp32 [..., m // block_size])``. The math runs in fp32
    whatever the input dtype."""
    if bits != 8:
        raise ValueError(f"quantize_blockwise supports bits=8, got {bits}")
    *lead, m = x.shape
    if m % block_size:
        raise ValueError(f"last dim {m} not divisible by block {block_size}")
    qmax = float(qmax_for_bits(bits))
    blocks = x.reshape(*lead, m // block_size, block_size).float()
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    finite = torch.isfinite(amax)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    safe = torch.where(finite & (amax > 0), amax, one)
    scale = safe / qmax
    q = torch.clamp(torch.round(blocks / scale), -qmax, qmax)
    q = torch.nan_to_num(q).to(torch.int8)   # a NaN block's codes: 0
    scale = torch.where(finite, scale, torch.full_like(scale, float("nan")))
    return q.reshape(*lead, m), scale[..., 0]


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`: fp32 output [..., m]."""
    *lead, m = q.shape
    blocks = q.reshape(*lead, m // block_size, block_size).float()
    return (blocks * scales[..., None]).reshape(*lead, m)


def roundtrip_error_parts(x: torch.Tensor, bits: int = 8,
                          block_size: int = 256
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``(err_sq, ref_sq, max_abs)`` fp32 scalars of the round trip of
    ``x``: ``bits`` 8 is the blockwise int8 round trip (half to even), 16
    the bf16 cast, 32 and more exact (zero error). A non-finite block
    poisons its scale, so the error is NaN rather than hidden."""
    x32 = x.float()
    ref_sq = torch.sum(x32 * x32)
    if bits >= 32:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return zero, ref_sq, zero
    if bits == 16:
        dq = x32.to(torch.bfloat16).float()
    else:
        q, s = quantize_blockwise(x32, block_size, bits=bits)
        dq = dequantize_blockwise(q, s, block_size)
    diff = dq - x32
    return torch.sum(diff * diff), ref_sq, torch.max(torch.abs(diff))


def rel_from_parts(err_sq: torch.Tensor, ref_sq: torch.Tensor
                   ) -> torch.Tensor:
    """Relative L2 error from the parts (0 for a zero reference; NaN
    propagates)."""
    return torch.sqrt(err_sq) / torch.sqrt(torch.clamp(ref_sq, min=1e-30))


def roundtrip_error(x: torch.Tensor, bits: int = 8,
                    block_size: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rel_l2, max_abs)`` fp32 scalars of the round trip of ``x``'s last
    dim in blocks: ``rel_l2 = ||dq(q(x)) - x|| / ||x||`` and the worst
    element error (at most half a block's step for a finite block)."""
    err_sq, ref_sq, max_abs = roundtrip_error_parts(x, bits, block_size)
    return rel_from_parts(err_sq, ref_sq), max_abs

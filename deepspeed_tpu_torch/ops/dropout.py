"""Counter-hash dropout for activations.

The port of ``deepspeed_tpu/ops/dropout.py``. The keep-mask of
:func:`hash_dropout` is a pure function of the element's flat index and a
32-bit seed, through a splitmix32 finalizer: the same bits as the JAX
function for the same seed, on any device. The JAX function takes a PRNG
key and uses ``kd[0] ^ (kd[-1] << 1)`` of its data as the seed; the port
takes that seed as a host int (``seed & 0xFFFFFFFF`` is hashed), so the
caller never reads a number back from the card.

Like the JAX function, this is plain tensor code on both devices (XLA
fuses the JAX version into its neighbours; here it runs as eager passes).
Torch has no shift or add for ``uint32`` on the CPU, so the hash runs in
int64 holding uint32 values, each product wrapped to 32 bits: a multiplier
at or above 2**31 is taken as its negative twin ``c - 2**32`` (the same
product modulo 2**32), so no int64 product overflows.

:func:`dropout_module` picks the module a model uses: :class:`HashDropout`
under ``cfg.fast_dropout`` (the default), else :class:`BernoulliDropout`,
the counterpart of flax's ``nn.Dropout``: a Bernoulli mask drawn from a
``torch.Generator`` seeded with the same int, distribution-equal to the
JAX module and not bit-equal (no torch code reproduces ``jax.random``).
Both modules take ``(x, seed)``; a seed of None is the deterministic
(evaluation) form and returns ``x``.

:func:`fold_seed` derives the seed of one dropout site from a step's seed:
the port's own fold, written down here, since flax's ``make_rng`` path
folds cannot be reproduced without jax.
"""

from typing import Optional

import torch
from torch import nn

__all__ = ["hash_dropout", "HashDropout", "BernoulliDropout",
           "dropout_module", "fold_seed", "keep_threshold", "mul32"]

MASK32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2**32 for int64 ``x`` holding uint32 values and a
    uint32 constant ``c``, without int64 overflow."""
    return (x * (c - (1 << 32) if c >= 1 << 31 else c)) & MASK32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer (JAX ``ops/dropout.py:_hash_u32``; not the
    flash kernels' murmur3-style hash of ``flash_attention._hash_u32``)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """The integer threshold the top 24 hash bits are held against (a bit
    pattern is kept iff ``bits >> 8 >= keep_threshold(rate)``), computed as
    JAX computes it."""
    return int(float(rate) * (1 << 24))


def hash_dropout(x: torch.Tensor, rate: float,
                 seed: Optional[int]) -> torch.Tensor:
    """Dropout via a counter hash: keep-probability ``1 - rate``, kept
    elements scaled by ``1 / (1 - rate)``. ``seed``: a host int, or None
    for the identity (as a JAX ``rng`` of None).

    The divisor ``1 - rate`` is rounded to x's dtype first, as JAX divides
    by a weak-typed scalar (in bf16, 0.9 becomes 0.8984375). Autograd
    keeps the bool keep-mask for the backward (1 byte per element)."""
    if rate <= 0.0 or seed is None:
        return x
    s = (int(seed) + 0x165667B1) & MASK32
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    bits = _hash_u32(mul32(idx, 0x9E3779B9) ^ s)
    keep = ((bits >> 8) >= keep_threshold(rate)).reshape(x.shape)
    divisor = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / divisor, 0.0)


class HashDropout(nn.Module):
    """``nn.Dropout``'s place in the model, backed by :func:`hash_dropout`;
    ``forward(x, seed)`` with the site's seed, None when deterministic."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        return hash_dropout(x, self.rate, seed)


class BernoulliDropout(nn.Module):
    """``fast_dropout=False``: a Bernoulli keep-mask from a generator on
    x's device seeded with the site's seed, kept elements divided by
    ``1 - rate`` (rounded to x's dtype, as in :func:`hash_dropout`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        if self.rate <= 0.0 or seed is None:
            return x
        g = torch.Generator(device=x.device)
        g.manual_seed(int(seed) & MASK32)
        keep = torch.rand(x.shape, generator=g, device=x.device) >= self.rate
        divisor = float(torch.tensor(1.0 - self.rate, dtype=x.dtype))
        return torch.where(keep, x / divisor, 0.0)


def dropout_module(cfg):
    """The model families' dropout selector: :class:`HashDropout` when
    ``cfg.fast_dropout`` (the default), else :class:`BernoulliDropout`."""
    if getattr(cfg, "fast_dropout", False):
        return HashDropout
    return BernoulliDropout


def fold_seed(seed: int, *data: int) -> int:
    """A 32-bit seed from ``seed`` and the ints ``data`` (a layer, a site),
    on the host: for each datum, ``h = mix(h ^ mix(d + 0x9E3779B9 * i))``
    with ``mix`` the splitmix32 finalizer of :func:`_hash_u32` and ``i``
    the datum's position from 1. Distinct (layer, site) pairs get
    decorrelated seeds; the same arguments always give the same seed."""
    def mix(v: int) -> int:
        v &= MASK32
        v ^= v >> 16
        v = (v * 0x7FEB352D) & MASK32
        v ^= v >> 15
        v = (v * 0x846CA68B) & MASK32
        return v ^ (v >> 16)

    h = mix(int(seed))
    for i, d in enumerate(data, 1):
        h = mix(h ^ mix(int(d) + 0x9E3779B9 * i))
    return h

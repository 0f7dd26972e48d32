"""Multi-head attention: the dispatch and its plain path.

The port of ``deepspeed_tpu/ops/transformer/attention.py``. Every model
reaches attention through :func:`attention` over [B, S, H, D] tensors;
``impl`` picks the path:

- ``"xla"``: :func:`xla_attention`, dense attention in plain PyTorch (the
  JAX package's always-correct path, left to XLA there), softmax in fp32.
  Prefill, ``generate`` and the gather decode path use it directly.
- ``"flash"`` (``"pallas"``, the JAX name, is an alias): the flash kernels
  of ``flash_attention.py``; a key-padding mask only.
- ``"auto"``: on a CUDA tensor, the flash kernels for causal or
  key-padding-masked attention; plain attention only for what the JAX
  dispatch also leaves to XLA (a bias or a general mask). A shape the
  kernels refuse raises there; it does not drop to the plain path on the
  card. On the CPU, plain attention, as the JAX package off the TPU. (The
  JAX crossover ``PALLAS_MIN_SEQ_K`` is a TPU measurement and is not
  carried over.)

Attention dropout (``dropout_rate`` > 0 in a non-deterministic call) takes
the step's int ``dropout_seed`` where JAX takes ``dropout_rng``. Both of
the port's paths drop out with the same mask, the flash kernels'
counter hash ``flash_attention.dropout_keep_mask`` over (seed,
batch-head, row, col), so the kernel path and the plain path agree bit
for bit on the mask for one seed. That differs from the JAX xla branch,
which draws ``jax.random.bernoulli`` bits that no torch code reproduces;
the JAX flash kernels use the same hash as the port.

``"ring"``, ``"ulysses"`` and ``"pallas_pad"`` are not ported yet.
"""

from typing import Optional

import torch

from deepspeed_tpu_torch.config.config import not_yet_ported
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    _check_dropout, _dropped, _keep_bhqk, flash_attention)

IMPLS = ("auto", "flash", "pallas", "xla")
NOT_YET_PORTED_IMPLS = ("ring", "ulysses", "pallas_pad")


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  softmax_scale: Optional[float] = None,
                  dropout_rate: float = 0.0,
                  dropout_seed: Optional[int] = None) -> torch.Tensor:
    """q, k, v: [B, S, H, D] (k/v's sequence may differ from q's).

    Logits and softmax are fp32 whatever the input dtype; masked logits are
    ``finfo(float32).min``; the causal mask is aligned bottom-right
    (``tril(k=sk-sq)``), as in the JAX package. ``bias``: added to the
    logits. ``mask``: [B, Sk] key padding, or anything broadcastable to
    [B, H, Sq, Sk]; True = attend. ``dropout_rate`` > 0: the fp32
    probabilities masked by ``dropout_keep_mask`` of ``dropout_seed`` and
    scaled by ``1 / (1 - rate)``, as the flash kernels do.
    """
    _check_dropout(dropout_rate, dropout_seed)
    orig_dtype = q.dtype
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (q.shape[-1] ** 0.5))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    neg = torch.finfo(torch.float32).min
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, neg)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, None, :]
        elif mask.ndim == 3:
            mask = mask[:, None]
        logits = logits.masked_fill(~mask.bool(), neg)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        keep = _keep_bhqk(dropout_seed, q.shape[0], q.shape[2], q.shape[1],
                          k.shape[1], dropout_rate, q.device)
        probs = _dropped(probs, keep, dropout_rate)
    # as jnp.einsum promotes: bf16 probs against an fp32 cache give fp32
    dt = torch.promote_types(orig_dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v.to(dt))


def _as_kv_mask(mask: Optional[torch.Tensor], batch: int, sk: int
                ) -> Optional[torch.Tensor]:
    """A key-padding mask [B, Sk] from the common mask forms ([B, Sk],
    [B, 1, Sk], [B, 1, 1, Sk]), or None if ``mask`` is a general pattern
    the flash kernels cannot take."""
    if mask is None:
        return None
    if mask.ndim == 2 and tuple(mask.shape) == (batch, sk):
        return mask
    if (mask.ndim == 4 and mask.shape[0] == batch and mask.shape[1] == 1
            and mask.shape[2] == 1 and mask.shape[3] == sk):
        return mask[:, 0, 0, :]
    if (mask.ndim == 3 and mask.shape[0] == batch and mask.shape[1] == 1
            and mask.shape[2] == sk):
        return mask[:, 0, :]
    return None


def resolve_attention_impl(impl: str, device_type: str,
                           general: bool) -> str:
    """The path ``impl`` takes on ``device_type``: "flash" or "xla".
    ``general``: the call has a bias or a mask that is not key padding."""
    if impl in NOT_YET_PORTED_IMPLS:
        raise not_yet_ported(f"attention impl={impl!r}")
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                         f"{IMPLS}")
    if impl == "auto":
        return "flash" if device_type == "cuda" and not general else "xla"
    return "xla" if impl == "xla" else "flash"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False,
              bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              dropout_rate: float = 0.0,
              dropout_seed: Optional[int] = None,
              deterministic: bool = True,
              softmax_scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """Dispatching attention entry point used by the model families.
    Dropout acts only when ``deterministic`` is False; it then needs
    ``dropout_seed``."""
    kv_mask = _as_kv_mask(mask, q.shape[0], k.shape[1])
    general = bias is not None or (mask is not None and kv_mask is None)
    path = resolve_attention_impl(impl, q.device.type, general)
    if deterministic:
        dropout_rate = 0.0
    _check_dropout(dropout_rate, dropout_seed)
    if path == "flash":
        if general:
            raise ValueError("impl='flash' attention takes only key-padding "
                             "masks ([B, Sk] / [B, 1, Sk] / [B, 1, 1, Sk]) "
                             "and no bias: use impl='xla' for those")
        return flash_attention(q, k, v, causal=causal, kv_mask=kv_mask,
                               softmax_scale=softmax_scale,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
    return xla_attention(q, k, v, causal=causal, bias=bias, mask=mask,
                         softmax_scale=softmax_scale,
                         dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed)

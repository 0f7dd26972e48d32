"""Dense multi-head attention in plain PyTorch.

The port of ``deepspeed_tpu/ops/transformer/attention.py:xla_attention``,
the always-correct path the JAX package leaves to XLA. Prefill, ``generate``
and the gather decode path use it. It is no Pallas kernel, so plain
``einsum`` is its right form.
"""

from typing import Optional

import torch


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  mask: Optional[torch.Tensor] = None,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: [B, S, H, D] (k/v's sequence may differ from q's).

    Logits and softmax are fp32 whatever the input dtype; masked logits are
    ``finfo(float32).min``; the causal mask is aligned bottom-right
    (``tril(k=sk-sq)``), as in the JAX package. ``mask``: [B, Sk] key
    padding, or anything broadcastable to [B, H, Sq, Sk]; True = attend.
    """
    orig_dtype = q.dtype
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (q.shape[-1] ** 0.5))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
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
    # as jnp.einsum promotes: bf16 probs against an fp32 cache give fp32
    dt = torch.promote_types(orig_dtype, v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v.to(dt))

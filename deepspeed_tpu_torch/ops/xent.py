"""Fused softmax cross-entropy head.

The port of ``deepspeed_tpu/ops/xent.py``. The [N, V] logits are the
largest intermediate of LM training (16 x 512 tokens x 50257 vocab is
1.6 GB in fp32). This op keeps them out of the saved activations:

- the logits are stored in the compute dtype (bf16 under mixed
  precision), or in fp32 with ``logits_fp32`` (the unfused path's
  numerics);
- the autograd residual is only the per-row logsumexp: the backward
  recomputes the logits (one extra matmul) instead of reading a saved
  fp32 log-softmax;
- ``dlogits = (softmax - onehot) * g`` is formed in place on the
  recomputed probabilities, with no [N, V] one-hot buffer.
"""

from typing import Optional

import torch


def _logits(x, w, b, logits_fp32: bool) -> torch.Tensor:
    """fp32 [N, V] logits: a matmul in the compute dtype (fp32 sums, stored
    in the compute dtype), or, with ``logits_fp32``, the compute-dtype
    operands multiplied with an fp32 result."""
    if logits_fp32:
        out = x.float() @ w.float().t()
    else:
        out = (x @ w.t()).float()
    return out + b if b is not None else out


class _FusedNLL(torch.autograd.Function):
    """Per-token NLL of ``x @ w.T (+ b)`` against ``labels``."""

    @staticmethod
    def forward(ctx, x, w, b, labels, logits_fp32, bias_grad):
        logits = _logits(x, w, b, logits_fp32)
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(1, labels[:, None])[:, 0]
        ctx.save_for_backward(x, w, b, labels, lse)
        ctx.logits_fp32, ctx.bias_grad = logits_fp32, bias_grad
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, lse = ctx.saved_tensors
        p = _logits(x, w, b, ctx.logits_fp32)
        p.sub_(lse[:, None]).exp_()
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, labels] -= 1.0
        p.mul_(g[:, None])                       # dlogits, fp32
        db = None
        if b is not None and ctx.bias_grad:
            db = p.sum(dim=0).to(b.dtype)
        if ctx.logits_fp32:
            dx = (p @ w.float()).to(x.dtype)
            dw = (p.t() @ x.float()).to(w.dtype)
        else:
            dl = p.to(x.dtype)
            dx = dl @ w
            dw = (dl.t() @ x).to(w.dtype)
        return dx, dw, db, None, None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                        labels: torch.Tensor, ignore_index: int = -100,
                        w_transposed: bool = False,
                        bias: Optional[torch.Tensor] = None,
                        bias_grad: bool = True,
                        logits_fp32: bool = False) -> torch.Tensor:
    """Token-mean cross entropy of ``x @ w.T`` against ``labels``, ignoring
    ``ignore_index`` positions.

    x: [..., D] activations (compute dtype); w: [V, D] tied-embedding
    layout (or [D, V] with ``w_transposed``); labels: [...] int. ``bias``:
    an fp32 [V] logit bias (the padded-vocab mask); with ``bias_grad``
    False it is a constant and gets no gradient.
    """
    d = x.shape[-1]
    if w_transposed:
        w = w.t()
    xf = x.reshape(-1, d)
    lf = labels.reshape(-1)
    valid = lf != ignore_index
    safe = torch.where(valid, lf, torch.zeros_like(lf)).long()
    if bias is not None:
        bias = bias.float()
        if not bias_grad:
            bias = bias.detach()
    nll = _FusedNLL.apply(xf, w.to(x.dtype), bias, safe, bool(logits_fp32),
                          bool(bias_grad))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)

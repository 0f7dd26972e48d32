"""Embedding lookup and the padded-vocab logit mask.

The port of ``deepspeed_tpu/ops/embedding.py``. The forward is a row
gather; its gradient is an index-add into the [V, D] table. The JAX
package's ``matmul_grad`` (a one-hot matmul in place of the TPU's slow
serialised scatter) is a TPU lever: here it selects the same gradient
summed in fp32 and cast to the table's dtype, which is what the one-hot
matmul with fp32 accumulation computes. The row-sparse cross-rank exchange
(``sparse_grad_axes``, config ``sparse_gradients``) is not ported yet.
"""

import torch

from deepspeed_tpu_torch.config.config import not_yet_ported


class _LookupFp32Grad(torch.autograd.Function):
    """``table[ids]`` whose table gradient is summed in fp32."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        d = g.shape[-1]
        dtable = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        dtable.index_add_(0, ids.reshape(-1), g.reshape(-1, d).float())
        return dtable.to(ctx.dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     matmul_grad: bool = False,
                     sparse_grad_axes=None) -> torch.Tensor:
    """``table[ids]`` ([V, D] x [...] int -> [..., D]). The gradient is an
    index-add in the table's dtype, or summed in fp32 with
    ``matmul_grad``."""
    if sparse_grad_axes:
        raise not_yet_ported("embedding_lookup(sparse_grad_axes=...) (the "
                             "sparse_gradients row exchange)")
    if matmul_grad:
        return _LookupFp32Grad.apply(table, ids)
    return table[ids]


def vocab_pad_mask(padded_vocab: int, vocab_size: int,
                   device=None) -> torch.Tensor:
    """[padded_vocab] fp32 additive logit mask: 0 on real rows, -1e9 on pad
    rows, so a padded-vocab CE equals the unpadded one (pad logits vanish
    from the logsumexp; pad rows get zero gradient and stay at init)."""
    mask = torch.zeros(padded_vocab, dtype=torch.float32, device=device)
    mask[vocab_size:] = -1e9
    return mask

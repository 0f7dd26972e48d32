"""Transformer operators: attention (flash, paged decode, chunked prefill)
and the fused LayerNorm + projection."""

from deepspeed_tpu_torch.ops.transformer.fused import ln_matmul, ln_matmul_ok

__all__ = ["ln_matmul", "ln_matmul_ok"]

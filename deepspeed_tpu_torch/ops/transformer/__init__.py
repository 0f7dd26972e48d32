"""Transformer operators: attention (flash, paged decode, chunked prefill),
the fused LayerNorm + projection, and the fused transformer layer."""

from deepspeed_tpu_torch.ops.transformer.fused import ln_matmul, ln_matmul_ok

__all__ = ["ln_matmul", "ln_matmul_ok", "DeepSpeedTransformerConfig",
           "DeepSpeedTransformerLayer"]


def __getattr__(name: str):
    # The layer subclasses models/bert.py:BertLayer, which imports this
    # package's attention: it loads on first use, not with the package.
    if name in ("DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer"):
        from deepspeed_tpu_torch.ops.transformer import transformer
        return getattr(transformer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""DeepSpeedTransformerLayer: the reference's fused transformer layer op.

The port of ``deepspeed_tpu/ops/transformer/transformer.py`` (reference
``deepspeed/ops/transformer/transformer.py``: ``DeepSpeedTransformerConfig``,
``DeepSpeedTransformerLayer``). The layer is the port's
``models/bert.py:BertLayer`` (the same parameter names: ``ln_attn``,
``c_attn``, ``c_proj``, ``ln_mlp``, ``c_fc``, ``mlp_proj``, so the two
hold each other's weights) on this config's widths and dropout rates; its
attention is ``ops/transformer/attention.attention(impl="auto")``, the
flash kernels on the card.

The reference's memory-saving kernel options recompute a piece in the
backward instead of saving its activations (``BertLayer.recompute``:
``torch.utils.checkpoint``, non-reentrant) around the same pieces that the
JAX layer wraps in ``nn.remat``:

- ``normalize_invertible``: the two LayerNorms;
- ``attn_dropout_checkpoint``: the attention block (projections,
  attention, its dropout);
- ``gelu_checkpoint``: the MLP block.

Dropout is the port's hash dropout (``ops/dropout.py`` for the hidden
sites, the flash kernels' keep-mask for the probabilities) with one seed
per site folded from the call's ``dropout_seed`` (sites 1, 2, 3: the
probabilities, the attention output, the MLP output), where the JAX layer
draws ``nn.Dropout`` bits from flax's rng. The recomputation regenerates
the same masks from the same seeds, so every option gives outputs and
gradients bit-equal to the option off. ``stochastic_mode`` is accepted:
masks are drawn fresh per call from the caller's seed already.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from deepspeed_tpu_torch.models.bert import BertConfig, BertLayer
from deepspeed_tpu_torch.ops.dropout import fold_seed

# fold_seed data of the layer's dropout sites (the JAX layer's site ids)
ATTN_SITE, PROJ_SITE, MLP_SITE = 1, 2, 3


@dataclass
class DeepSpeedTransformerConfig:
    """The reference's config surface. ``batch_size`` and
    ``max_seq_length`` are accepted and not used: PyTorch runs each shape
    as it comes, where the CUDA layer pre-allocated workspaces. ``fp16``
    selects bfloat16 compute, as in the JAX package."""

    batch_size: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    huggingface: bool = False
    training: bool = True
    max_seq_length: int = 512
    layer_norm_eps: float = 1e-12

    def __post_init__(self):
        if self.intermediate_size in (-1, 0) and self.hidden_size > 0:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.fp16 else torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads


class DeepSpeedTransformerLayer(BertLayer):
    """One transformer layer with the reference kernel's option surface:
    ``models/bert.py:BertLayer`` on this config's widths, rates and
    recomputed pieces, with the reference's init.
    ``forward(x, attn_mask=None, deterministic=True, dropout_seed=None)``:
    x [B, S, H]; ``attn_mask`` a key-padding mask ([B, S], or bool [B, 1,
    1, S], True = attend); ``dropout_seed`` the host int a call with
    ``deterministic=False`` drops out with."""

    def __init__(self, config: DeepSpeedTransformerConfig):
        cfg = config
        super().__init__(
            BertConfig(hidden_size=cfg.hidden_size, num_heads=cfg.heads,
                       dropout_rate=cfg.hidden_dropout_ratio,
                       dtype=cfg.dtype, pre_layer_norm=cfg.pre_layer_norm,
                       layer_norm_epsilon=cfg.layer_norm_eps),
            intermediate_size=cfg.intermediate_size,
            attn_dropout_rate=cfg.attn_dropout_ratio)
        self.config = cfg
        self.recompute = frozenset(
            name for name, on in (("norm", cfg.normalize_invertible),
                                  ("attn", cfg.attn_dropout_checkpoint),
                                  ("mlp", cfg.gelu_checkpoint)) if on)
        out_std = cfg.initializer_range
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            # reference: output projections damped by 1/sqrt(2L)
            out_std = cfg.initializer_range / (2 * cfg.num_hidden_layers
                                               ) ** 0.5
        with torch.no_grad():
            for lin, std in ((self.c_attn, cfg.initializer_range),
                             (self.c_proj, out_std),
                             (self.c_fc, cfg.initializer_range),
                             (self.mlp_proj, out_std)):
                lin.weight.normal_(0.0, std)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        drop = not deterministic and (cfg.attn_dropout_ratio > 0
                                      or cfg.hidden_dropout_ratio > 0)
        if drop and dropout_seed is None:
            raise ValueError("a DeepSpeedTransformerLayer call with "
                             "deterministic=False and dropout needs "
                             "dropout_seed")
        seeds = (tuple(fold_seed(dropout_seed, site) for site in
                       (ATTN_SITE, PROJ_SITE, MLP_SITE)) if drop else None)
        return super().forward(x, attn_mask, seeds=seeds)

"""Config-driven sparse-attention wiring: the port of
``deepspeed_tpu/ops/sparse_attention/utils.py`` (the reference's
``SparseAttentionUtils`` model surgery and the ``sparse_attention`` config
presets).

The in-tree model families route attention by config
(``GPTConfig.sparse_attention``, ``BertConfig.sparse_attention``), so
"replacing self-attention" swaps the config the model and its blocks carry:
no weight surgery, since a sparse layout masks the same dense q/k/v
projections, and the module keeps its parameter tensors.
``deepspeed_tpu_torch.initialize`` applies it when the training config
carries a ``sparse_attention`` block.
"""

import dataclasses
import functools
import json
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention import (
    SparseSelfAttention, pad_to_block_size)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, SparsityConfig, VariableSparsityConfig)

# Reference mode names (runtime/config.py:249-258 SPARSE_*_MODE).
SPARSE_MODES = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
}


def sparsity_config_from_dict(d: Dict[str, Any],
                              num_heads: int) -> SparsityConfig:
    """Build a SparsityConfig from a ``sparse_attention`` config block —
    same keys as the reference's presets (``mode``, ``block``,
    ``num_local_blocks``, ``num_sliding_window_blocks``, ...)."""
    d = dict(d or {})
    mode = d.pop("mode", "fixed")
    d.pop("impl", None)   # executor choice, not a layout parameter
    if mode not in SPARSE_MODES:
        raise ValueError(f"unknown sparse_attention mode '{mode}' "
                         f"(one of {sorted(SPARSE_MODES)})")
    try:
        return SPARSE_MODES[mode](num_heads=num_heads, **d)
    except TypeError as e:
        raise ValueError(
            f"invalid sparse_attention key for mode '{mode}': {e}") from None


@functools.lru_cache(maxsize=None)
def _cached_ssa(cfg_json: str, num_heads: int, impl: str):
    d = json.loads(cfg_json)
    return SparseSelfAttention(sparsity_config_from_dict(d, num_heads),
                               impl=impl)


def get_sparse_self_attention(d: Dict[str, Any], num_heads: int,
                              impl: str = None) -> SparseSelfAttention:
    """Cached layout-bound attention for a config block: every layer and
    every step of a model shares one object, so the layout (and BigBird's
    random blocks) is drawn once per (config, heads, impl) and seq."""
    if impl is None:
        impl = (d or {}).get("impl", "auto")
    return _cached_ssa(json.dumps(d or {}, sort_keys=True), num_heads, impl)


class SparseAttentionUtils:
    """Reference-named utility surface (sparse_attention_utils.py:14)."""

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, sparse_attention_config: Dict[str, Any]):
        """Route an in-tree family's attention (the GPT's causal blocks,
        BERT's bidirectional layers) through the sparse executor, in
        place: the model and every submodule that carries the model's
        config get a copy of it with ``sparse_attention`` set. The
        parameter tensors stay the same objects. Returns the model."""
        cfg = getattr(model, "cfg", None)
        if cfg is None or not hasattr(cfg, "sparse_attention"):
            raise ValueError(
                f"sparse attention surgery supports the in-tree model "
                f"families (GPT and BERT, with a `sparse_attention` config "
                f"field); got {type(model).__name__} — route attention "
                f"through ops.sparse_attention.SparseSelfAttention in your "
                f"model instead")
        block = dict(sparse_attention_config)
        sparsity_config_from_dict(block, cfg.num_heads)     # check the keys
        new_cfg = dataclasses.replace(cfg, sparse_attention=block)
        for module in model.modules():
            if getattr(module, "cfg", None) is cfg:
                module.cfg = new_cfg
        return model

    @staticmethod
    def extend_position_embedding(params: Dict[str, Any], max_position: int,
                                  key: str = "wpe") -> Dict[str, Any]:
        """Tile a learned position table to a longer max length (reference
        :19 repeats the pretrained table). Returns a NEW params dict."""
        table = params[key]
        if not isinstance(table, torch.Tensor):
            table = torch.as_tensor(np.asarray(table))
        orig = table.shape[0]
        if max_position <= orig:
            raise ValueError(f"max_position {max_position} must exceed the "
                             f"current table length {orig}")
        reps = -(-max_position // orig)
        out = dict(params)
        out[key] = table.repeat(reps, 1)[:max_position]
        return out

    @staticmethod
    def pad_to_block_size(block_size: int, input_ids, pad_token_id: int = 0,
                          attention_mask=None, labels=None
                          ) -> Tuple[int, Dict[str, Any]]:
        """Right-pad a token batch to a block multiple (reference :142):
        ids with ``pad_token_id``, mask with 0, labels with -100. Returns
        ``(pad_len, batch_dict)``."""
        s = input_ids.shape[1]
        pad = (-s) % block_size
        batch = {"input_ids": input_ids}
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.int32,
                                        device=input_ids.device)
        if pad:
            batch["input_ids"] = F.pad(input_ids, (0, pad),
                                       value=pad_token_id)
            attention_mask = F.pad(attention_mask, (0, pad))
            if labels is not None:
                labels = F.pad(labels, (0, pad), value=-100)
        batch["attention_mask"] = attention_mask
        if labels is not None:
            batch["labels"] = labels
        return pad, batch

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """Reference :208 — strip the pad tail added by pad_to_block_size."""
        if pad_len:
            return sequence_output[:, :-pad_len]
        return sequence_output


__all__ = ["SPARSE_MODES", "SparseAttentionUtils",
           "get_sparse_self_attention", "sparsity_config_from_dict",
           "pad_to_block_size"]

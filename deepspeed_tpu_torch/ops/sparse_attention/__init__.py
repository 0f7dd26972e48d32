"""Block-sparse attention: sparsity layouts and executors (the port of
``deepspeed_tpu/ops/sparse_attention``)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention import (
    SparseSelfAttention, layout_kv_indices, layout_to_dense_mask,
    pad_to_block_size, sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, SparsityConfig, VariableSparsityConfig,
    causal_blockmask)
from deepspeed_tpu_torch.ops.sparse_attention.utils import (
    SPARSE_MODES, SparseAttentionUtils, get_sparse_self_attention,
    sparsity_config_from_dict)

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig", "causal_blockmask", "sparse_attention",
    "SparseSelfAttention", "layout_to_dense_mask", "layout_kv_indices",
    "pad_to_block_size", "SPARSE_MODES", "SparseAttentionUtils",
    "get_sparse_self_attention", "sparsity_config_from_dict",
]

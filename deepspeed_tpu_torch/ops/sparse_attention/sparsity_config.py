"""Block-sparse attention layouts: the port's own copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (reference
``deepspeed/ops/sparse_attention/sparsity_config.py:9-544``).

A *layout* is an int32 array ``[num_heads, B, B]`` (B = seq_len/block) where
``layout[h, qi, ki] == 1`` means q-block ``qi`` attends kv-block ``ki`` for
head ``h``. The config classes reproduce the reference's families —
Dense, Fixed, Variable, BigBird, BSLongformer — as pure layout math in
numpy, bit for bit the JAX package's (the BigBird and Variable random
blocks come from the same ``np.random.default_rng(rng_seed)`` draws, in
the same order). The executors of ``sparse_attention.py`` consume the
layout.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: common fields + layout scaffolding (reference :9)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    @property
    def num_layout_heads(self) -> int:
        return self.num_heads if self.different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        b = seq_len // self.block
        return np.zeros((self.num_heads, b, b), np.int32)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attend all blocks (reference :63) — the parity baseline."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + fixed global blocks (reference :94).

    Each q-block attends every block in its own local window of
    ``num_local_blocks``; the last ``num_global_blocks`` of each window act
    as global: every later block attends them (unidirectional), and with
    bidirectional/horizontal attention those rows also attend everything.
    """

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % max(num_global_blocks, 1):
            raise ValueError("num_local_blocks must be divisible by "
                             "num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention '{attention}'")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        if (num_different_global_patterns > 1 and
                not different_layout_per_head):
            raise ValueError("different global patterns require "
                             "different_layout_per_head")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        b = layout.shape[1]
        uni = self.attention == "unidirectional"
        for h in range(self.num_layout_heads):
            # local windows
            for start in range(0, b, self.num_local_blocks):
                end = min(start + self.num_local_blocks, b)
                for qi in range(start, end):
                    hi = qi + 1 if uni else end
                    layout[h, qi, start:hi] = 1
            # global columns: pattern index rotates across heads
            pattern = h % self.num_different_global_patterns
            # the global blocks are the LAST num_global_blocks of each
            # window, offset by the head's pattern
            first_global = (self.num_local_blocks - (1 + pattern) *
                            self.num_global_blocks)
            for wstart in range(0, b, self.num_local_blocks):
                g0 = wstart + max(first_global, 0)
                g1 = min(g0 + self.num_global_blocks, b)
                for ki in range(g0, g1):
                    if uni:
                        layout[h, ki:, ki] = 1   # later queries attend it
                    else:
                        layout[h, :, ki] = 1
                    if self.horizontal_global_attention:
                        layout[h, ki, :] = 1
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + user-chosen global blocks + random
    blocks (reference :243)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 rng_seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention '{attention}'")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and \
                len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices length mismatch")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.rng = np.random.default_rng(rng_seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        b = layout.shape[1]
        uni = self.attention == "unidirectional"
        for h in range(self.num_layout_heads):
            # variable local windows: cycle through the size list
            start = 0
            i = 0
            while start < b:
                size = self.local_window_blocks[
                    min(i, len(self.local_window_blocks) - 1)]
                end = min(start + size, b)
                for qi in range(start, end):
                    hi = qi + 1 if uni else end
                    layout[h, qi, start:hi] = 1
                start, i = end, i + 1
            # globals
            for gi, g in enumerate(self.global_block_indices):
                if self.global_block_end_indices is None:
                    cols = [g] if g < b else []
                else:
                    cols = range(g, min(self.global_block_end_indices[gi], b))
                for ki in cols:
                    if uni:
                        layout[h, ki:, ki] = 1
                    else:
                        layout[h, :, ki] = 1
                    if self.horizontal_global_attention:
                        layout[h, ki, :] = 1
            # random blocks
            for qi in range(b):
                if self.num_random_blocks:
                    cols = self.rng.choice(
                        qi + 1 if uni else b,
                        size=min(self.num_random_blocks,
                                 qi + 1 if uni else b),
                        replace=False)
                    layout[h, qi, cols] = 1
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + global-edge blocks (reference :421)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 rng_seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention '{attention}'")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.rng = np.random.default_rng(rng_seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        b = layout.shape[1]
        uni = self.attention == "unidirectional"
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for qi in range(b):
                lo = max(0, qi - w)
                hi = qi + 1 if uni else min(b, qi + w + 1)
                layout[h, qi, lo:hi] = 1
            g = min(self.num_global_blocks, b)
            layout[h, :, :g] = 1              # everyone attends first blocks
            if not uni:
                layout[h, :g, :] = 1          # first blocks attend everyone
                layout[h, :, b - g:] = 1      # and last blocks are global
                layout[h, b - g:, :] = 1
            for qi in range(b):
                pool = qi + 1 if uni else b
                k = min(self.num_random_blocks, pool)
                cols = self.rng.choice(pool, size=k, replace=False)
                layout[h, qi, cols] = 1
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + selected global blocks (reference :544)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None
                                     else [0])
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        b = layout.shape[1]
        uni = self.attention == "unidirectional"
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for qi in range(b):
                lo = max(0, qi - w)
                hi = qi + 1 if uni else min(b, qi + w + 1)
                layout[h, qi, lo:hi] = 1
            for gi, g in enumerate(self.global_block_indices):
                if self.global_block_end_indices is None:
                    cols = [g] if g < b else []
                else:
                    cols = range(g, min(self.global_block_end_indices[gi], b))
                for ki in cols:
                    layout[h, :, ki] = 1
                    if not uni:
                        layout[h, ki, :] = 1
        return self.check_and_propagate_first_head_layout(layout)


def causal_blockmask(layout: np.ndarray) -> np.ndarray:
    """Intersect a layout with block-level causality (strictly-above-diagonal
    blocks dropped; the diagonal keeps intra-block causal masking for the
    executor)."""
    b = layout.shape[1]
    tril = np.tril(np.ones((b, b), np.int32))
    return layout * tril[None]

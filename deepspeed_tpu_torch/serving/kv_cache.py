"""Paged KV cache: a pool of fixed-size blocks plus per-sequence tables.

The port of ``deepspeed_tpu/serving/kv_cache.py`` (vLLM's PagedAttention,
arXiv 2309.06180): sequences of any length share one preallocated device
allocation with no fragmentation and no reallocation as they grow.

Layout (per layer; all layers share one block table):

- ``k``/``v`` pool: ``[num_blocks, block_size, heads, head_dim]`` in the
  compute dtype. (The int8 pool of the JAX package is not ported yet.)
- block table: ``[batch_slots, max_blocks_per_seq]`` int32; row ``b``
  lists the pool blocks of the sequence in slot ``b``. **Block 0 is a
  reserved scratch block**: inactive slots point at it, so their (masked,
  discarded) decode writes land somewhere harmless.

Where the JAX package donates the pools to a jitted program that returns
rewritten copies, the port writes them in place (``index_put_``): one copy
of the cache lives on the device, and nothing is copied per token.
"""

from typing import List, Optional, Tuple

import torch

from deepspeed_tpu_torch.config.config import not_yet_ported


class BlockPool:
    """Host-side free-list allocator over ``num_blocks`` pool slots.

    Block 0 is reserved as the scratch block for inactive batch slots and
    is never handed out; ``capacity`` is therefore ``num_blocks - 1``.
    (The JAX package's pool also ref-counts blocks for its prefix cache,
    which is not ported yet.)
    """

    SCRATCH = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is reserved scratch), "
                             f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(1, self.num_blocks))
        # Mirror of _free for O(1) double-free checks.
        self._free_set = set(self._free)

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks or None (never a partial grant: the caller either
        admits a sequence whole or leaves it queued)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        self._free_set.difference_update(taken)
        return taken

    def release(self, blocks: List[int]) -> None:
        for b in blocks:
            if b == self.SCRATCH:
                raise ValueError("scratch block cannot be released")
            if not 0 < b < self.num_blocks:
                raise ValueError(f"block {b} is not in the pool")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"double free in {blocks}")
        self._free.extend(blocks)
        self._free_set.update(blocks)


Pools = List[Tuple[torch.Tensor, torch.Tensor, None, None]]


def init_paged_pools(cfg, num_blocks: int, block_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device=None) -> Pools:
    """Per-layer ``(k, v, k_scale, v_scale)`` pools, zeroed (scales are
    None: the fp pool; the int8 pool is not ported yet). Zeroed, so
    scratch and unwritten slots hold finite values."""
    dtype = dtype if dtype is not None else cfg.dtype
    shape = (num_blocks, block_size, cfg.num_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device), None, None)
            for _ in range(cfg.num_layers)]


class PagedLayerCache:
    """One layer's view of the paged cache for one decode dispatch: the
    pools plus the batch's block table and write positions.

    The GPT block hands it this step's K/V chunk: :meth:`update` writes
    the chunk and returns the gathered window and its visibility mask
    (``attn_impl == "gather"``); :meth:`update_attend` writes the chunk
    and runs the paged decode-attention kernel over the pools
    (``attn_impl == "kernel"``).
    """

    def __init__(self, k: torch.Tensor, v: torch.Tensor, k_scale, v_scale,
                 block_table: torch.Tensor, pos: torch.Tensor,
                 block_size: int, attn_impl: str = "gather"):
        if k_scale is not None or v_scale is not None:
            raise not_yet_ported("the int8 KV pool (int8_kv_cache)")
        if attn_impl not in ("gather", "kernel"):
            raise ValueError(f"attn_impl must be 'gather' or 'kernel', got "
                             f"{attn_impl!r}")
        self.k = k
        self.v = v
        self.block_table = block_table      # [B, MB] int32
        self.pos = pos                      # [B] int32: next write index
        self.block_size = int(block_size)
        self.attn_impl = attn_impl

    @property
    def key_len(self) -> int:
        """Gathered key-axis length (window blocks * block_size)."""
        return self.block_table.shape[1] * self.block_size

    def _write(self, pool: torch.Tensor, chunk: torch.Tensor) -> None:
        """Scatter ``chunk`` [B, S, H, D] at per-row positions
        ``pos..pos+S-1`` through the block table, in place."""
        b, s = chunk.shape[:2]
        idx = self.pos.long()[:, None] + torch.arange(
            s, device=chunk.device)[None, :]                     # [B, S]
        rows = torch.arange(b, device=chunk.device)[:, None]
        blk = self.block_table.long()[rows, idx // self.block_size]
        pool.index_put_((blk, idx % self.block_size), chunk.to(pool.dtype))

    def _gather(self, pool: torch.Tensor) -> torch.Tensor:
        """[B, MB, BS, H, D] pool gather -> [B, L, H, D]."""
        b = self.block_table.shape[0]
        g = pool[self.block_table.long()]
        return g.reshape(b, self.key_len, *pool.shape[2:])

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write this step's [B, S, H, D] chunk, gather the full window.

        Returns ``(self, K [B, L, H, D], V, mask [B, 1, S, L])``; key ``j``
        is visible to query ``i`` iff ``j <= pos + i`` (scratch and
        not-yet-written slots are always masked out).
        """
        s = k_new.shape[1]
        self._write(self.k, k_new)
        self._write(self.v, v_new)
        qpos = self.pos.long()[:, None] + torch.arange(
            s, device=k_new.device)[None, :]                     # [B, S]
        kpos = torch.arange(self.key_len, device=k_new.device)
        mask = kpos[None, None, :] <= qpos[:, :, None]           # [B, S, L]
        return self, self._gather(self.k), self._gather(self.v), \
            mask[:, None]

    def update_attend(self, q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor,
                      softmax_scale: Optional[float] = None):
        """Write the chunk, then attend straight over the pools through
        the block table (the gathered window is never made). Returns
        ``(self, o [B, S, H, D])``, with the same visibility as
        :meth:`update`."""
        from deepspeed_tpu_torch.ops.transformer.paged_attention import \
            paged_decode_attention

        self._write(self.k, k_new)
        self._write(self.v, v_new)
        o = paged_decode_attention(q.to(self.k.dtype).contiguous(), self.k,
                                   self.v, None, None, self.block_table,
                                   self.pos, block_size=self.block_size,
                                   softmax_scale=softmax_scale)
        return self, o.to(q.dtype)


def pack_prefill(pools: Pools, blocks: torch.Tensor,
                 k_stack: torch.Tensor, v_stack: torch.Tensor) -> Pools:
    """Scatter a prefilled contiguous cache into pool blocks, in place.

    ``blocks``: [nb] pool blocks assigned to the sequence;
    ``k_stack``/``v_stack``: [layers, T, H, D] from the prefill forward,
    with ``T == nb * block_size`` (bucketed: positions past the true prompt
    length carry garbage that stays masked by ``pos``).
    """
    nb = blocks.shape[0]
    idx = blocks.long()
    for i, (k, v, _ks, _vs) in enumerate(pools):
        bs = k.shape[1]
        k.index_put_((idx,), k_stack[i].reshape(nb, bs, *k.shape[2:])
                     .to(k.dtype))
        v.index_put_((idx,), v_stack[i].reshape(nb, bs, *v.shape[2:])
                     .to(v.dtype))
    return pools

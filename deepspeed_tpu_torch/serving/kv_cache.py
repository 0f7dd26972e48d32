"""Paged KV cache: a pool of fixed-size blocks plus per-sequence tables.

The port of ``deepspeed_tpu/serving/kv_cache.py`` (vLLM's PagedAttention,
arXiv 2309.06180): sequences of any length share one preallocated device
allocation with no fragmentation and no reallocation as they grow.

Layout (per layer; all layers share one block table):

- ``k``/``v`` pool: ``[num_blocks, block_size, heads, head_dim]`` in the
  compute dtype, or **int8** with per-(token, head) fp32 scales
  ``[num_blocks, block_size, heads]`` (``int8=True``). Quantization is
  the deterministic RTNE blockwise round trip of ``comm/quantize.py``
  with one block per (token, head) vector.
- block table: ``[batch_slots, max_blocks_per_seq]`` int32; row ``b``
  lists the pool blocks of the sequence in slot ``b``. **Block 0 is a
  reserved scratch block**: inactive slots and pad tokens point at it, so
  their (masked, discarded) writes land somewhere harmless.

Where the JAX package donates the pools to a jitted program that returns
rewritten copies, the port writes them in place (``index_put_``): one copy
of the cache lives on the device, and nothing is copied per token.
"""

from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.comm.quantize import quantize_blockwise


class BlockPool:
    """Host-side free-list allocator over ``num_blocks`` pool slots.

    Block 0 is reserved as the scratch block for inactive batch slots and
    is never handed out; ``capacity`` is therefore ``num_blocks - 1``.

    Blocks are ref-counted so the prefix cache can share immutable
    prompt-head blocks between sequences: ``alloc`` hands out blocks at
    refcount 1, ``share`` takes one more reference on an allocated block,
    and ``release`` drops one; a block returns to the free list only when
    its last holder lets go.
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
        self._refs: Dict[int, int] = {}

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
        for b in taken:
            self._refs[b] = 1
        return taken

    def share(self, blocks: List[int]) -> None:
        """Take one more reference on already-allocated blocks."""
        for b in blocks:
            if b == self.SCRATCH:
                raise ValueError("scratch block cannot be shared")
            if b not in self._refs:
                raise ValueError(f"share of unallocated block {b}")
        for b in blocks:
            self._refs[b] += 1

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def release(self, blocks: List[int]) -> None:
        """Drop one reference per block; a block frees only at zero."""
        for b in blocks:
            if b == self.SCRATCH:
                raise ValueError("scratch block cannot be released")
            if not 0 < b < self.num_blocks:
                raise ValueError(f"block {b} is not in the pool")
            if b in self._free_set or b not in self._refs:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)
                self._free_set.add(b)


Pools = List[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                   Optional[torch.Tensor]]]


def init_paged_pools(cfg, num_blocks: int, block_size: int,
                     int8: bool = False, dtype: Optional[torch.dtype] = None,
                     device=None) -> Pools:
    """Per-layer ``(k, v, k_scale, v_scale)`` pools (scales None in the fp
    pool). Codes are zeroed and int8 scales set to ones, so scratch and
    unwritten slots dequantize to exact zeros."""
    dtype = dtype if dtype is not None else cfg.dtype
    shape = (num_blocks, block_size, cfg.num_heads, cfg.head_dim)
    sshape = shape[:3]
    layers = []
    for _ in range(cfg.num_layers):
        if int8:
            layers.append((
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device)))
        else:
            layers.append((torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device),
                           None, None))
    return layers


def _quant_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] float -> (int8 [..., H, D], fp32 scales [..., H]): one
    RTNE quantization block per (token, head) vector, in fp32."""
    q, s = quantize_blockwise(x.float(), x.shape[-1])
    return q, s[..., 0]        # head_dim is one block: drop the block axis


def _store(pool: torch.Tensor, scale: Optional[torch.Tensor], index,
           chunk: torch.Tensor) -> None:
    """Write ``chunk`` [..., H, D] at ``index`` into the pool, quantizing
    it (codes and scales) when the pool is int8."""
    if scale is not None:
        q, sc = _quant_tokens(chunk)
        pool.index_put_(index, q)
        scale.index_put_(index, sc)
    else:
        pool.index_put_(index, chunk.to(pool.dtype))


class PagedLayerCache:
    """One layer's view of the paged cache for one decode dispatch: the
    pools plus the batch's block table and write positions.

    The GPT block hands it this step's K/V chunk: :meth:`update` writes
    the chunk and returns the gathered window and its visibility mask
    (``attn_impl == "gather"``); :meth:`update_attend` writes the chunk
    and runs the paged decode-attention kernel over the pools
    (``attn_impl == "kernel"``). ``dtype`` is the compute dtype the
    gathered int8 window is dequantized to (default: the pool's dtype,
    float32 for an int8 pool). ``clamp_writes``: a write past the table
    goes to scratch block 0 (a block index past the last column is
    clamped to it, a position at or past ``WB * BS`` is routed to block
    0), never to a block another row owns; a speculative round's chunk may
    overshoot a row's blocks. Off on the plain decode path, which never
    overshoots.
    """

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor],
                 block_table: torch.Tensor, pos: torch.Tensor,
                 block_size: int, attn_impl: str = "gather",
                 dtype: Optional[torch.dtype] = None,
                 clamp_writes: bool = False):
        if (k_scale is None) != (v_scale is None):
            raise ValueError("int8 pools need both k_scale and v_scale")
        if attn_impl not in ("gather", "kernel"):
            raise ValueError(f"attn_impl must be 'gather' or 'kernel', got "
                             f"{attn_impl!r}")
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.block_table = block_table      # [B, MB] int32
        self.pos = pos                      # [B] int32: next write index
        self.block_size = int(block_size)
        self.attn_impl = attn_impl
        self.clamp_writes = bool(clamp_writes)
        self.dtype = dtype if dtype is not None else (
            torch.float32 if k.dtype == torch.int8 else k.dtype)

    @property
    def int8(self) -> bool:
        return self.k_scale is not None

    @property
    def key_len(self) -> int:
        """Gathered key-axis length (window blocks * block_size)."""
        return self.block_table.shape[1] * self.block_size

    def _write(self, pool: torch.Tensor, scale: Optional[torch.Tensor],
               chunk: torch.Tensor) -> None:
        """Scatter ``chunk`` [B, S, H, D] at per-row positions
        ``pos..pos+S-1`` through the block table, in place."""
        b, s = chunk.shape[:2]
        idx = self.pos.long()[:, None] + torch.arange(
            s, device=chunk.device)[None, :]                     # [B, S]
        rows = torch.arange(b, device=chunk.device)[:, None]
        if self.clamp_writes:
            mb = self.block_table.shape[1]
            blk = self.block_table.long()[
                rows, torch.clamp(idx // self.block_size, max=mb - 1)]
            blk = torch.where(idx < mb * self.block_size, blk,
                              torch.zeros_like(blk))
        else:
            blk = self.block_table.long()[rows, idx // self.block_size]
        _store(pool, scale, (blk, idx % self.block_size), chunk)

    def _gather(self, pool: torch.Tensor,
                scale: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, MB, BS, H, D] pool gather -> [B, L, H, D] in ``dtype``; an
        int8 pool is dequantized in fp32 first, per (token, head)."""
        b = self.block_table.shape[0]
        bt = self.block_table.long()
        g = pool[bt].reshape(b, self.key_len, *pool.shape[2:])
        if scale is not None:
            sc = scale[bt].reshape(b, self.key_len, scale.shape[-1])
            g = g.float() * sc[..., None]
        return g.to(self.dtype)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write this step's [B, S, H, D] chunk, gather the full window.

        Returns ``(self, K [B, L, H, D], V, mask [B, 1, S, L])``; key ``j``
        is visible to query ``i`` iff ``j <= pos + i`` (scratch and
        not-yet-written slots are always masked out).
        """
        s = k_new.shape[1]
        self._write(self.k, self.k_scale, k_new)
        self._write(self.v, self.v_scale, v_new)
        qpos = self.pos.long()[:, None] + torch.arange(
            s, device=k_new.device)[None, :]                     # [B, S]
        kpos = torch.arange(self.key_len, device=k_new.device)
        mask = kpos[None, None, :] <= qpos[:, :, None]           # [B, S, L]
        return (self, self._gather(self.k, self.k_scale),
                self._gather(self.v, self.v_scale), mask[:, None])

    def update_attend(self, q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor,
                      softmax_scale: Optional[float] = None):
        """Write the chunk, then attend straight over the pools through
        the block table (the gathered window, and for an int8 pool its
        dequantized copy, is never made). ``q`` goes to the kernel in the
        pool's dtype, or for an int8 pool in its own compute dtype.
        Returns ``(self, o [B, S, H, D])``, with the same visibility as
        :meth:`update`."""
        from deepspeed_tpu_torch.ops.transformer.paged_attention import \
            paged_decode_attention

        self._write(self.k, self.k_scale, k_new)
        self._write(self.v, self.v_scale, v_new)
        qk = q if self.int8 else q.to(self.k.dtype)
        o = paged_decode_attention(qk.contiguous(), self.k, self.v,
                                   self.k_scale, self.v_scale,
                                   self.block_table, self.pos,
                                   block_size=self.block_size,
                                   softmax_scale=softmax_scale)
        return self, o.to(q.dtype)


class ChunkedLayerCache:
    """One layer's view of the paged cache for one **mixed** (chunked
    prefill) step: the batch is a flat ragged token batch ``[T]`` of
    decode tokens and prompt chunks, where token ``t`` belongs to slot
    ``slots[t]`` and sits at position ``pos[t]`` of its sequence. Pad
    tokens carry slot ``B``, the spare all-scratch row of ``block_table``
    ``[B + 1, MB]``: their writes land in block 0 and their reads see only
    it.

    The GPT block hands :meth:`update_attend` a ``[1, T, H, D]`` chunk (the
    flat batch rides as one row); key ``j`` is visible to token ``t`` iff
    ``j <= pos[t]`` over the token's own table row. ``runs``: the step's
    ``chunked_prefill.chunked_runs``, found once on the host and shared by
    every layer's cache (None: the kernel finds them itself).
    """

    attn_impl = "chunked"       # routes the model's paged branch

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor],
                 block_table: torch.Tensor, slots: torch.Tensor,
                 pos: torch.Tensor, block_size: int, runs=None):
        if (k_scale is None) != (v_scale is None):
            raise ValueError("int8 pools need both k_scale and v_scale")
        self.runs = runs
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.block_table = block_table      # [B + 1, MB] int32 (row B: pads)
        self.slots = slots                  # [T] int32: the token's slot
        self.pos = pos                      # [T] int32: the token's position
        self.block_size = int(block_size)

    @property
    def int8(self) -> bool:
        return self.k_scale is not None

    def _write(self, pool: torch.Tensor, scale: Optional[torch.Tensor],
               chunk: torch.Tensor) -> None:
        """Scatter ``chunk`` [T, H, D], one write per token at its own
        ``(slot, pos)``. Pad tokens all land on scratch block 0, offset 0
        (the last writer wins; nothing reads it for a real token); real
        tokens never collide."""
        pos = self.pos.long()
        blk = self.block_table.long()[self.slots.long(),
                                      pos // self.block_size]
        _store(pool, scale, (blk, pos % self.block_size), chunk)

    def update_attend(self, q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor,
                      softmax_scale: Optional[float] = None):
        """Write the whole ragged batch's K/V, then run the chunked-prefill
        kernel over the pools through per-token table rows: a chunk's
        token sees the keys its earlier chunk-mates wrote in this step.
        ``q``/``k_new``/``v_new``: [1, T, H, D]. Returns ``(self, o [1, T,
        H, D])``."""
        from deepspeed_tpu_torch.ops.transformer import chunked_prefill

        self._write(self.k, self.k_scale, k_new[0])
        self._write(self.v, self.v_scale, v_new[0])
        table = self.block_table[self.slots.long()]              # [T, MB]
        qk = q[0] if self.int8 else q[0].to(self.k.dtype)
        o = chunked_prefill.chunked_prefill_attention(
            qk.contiguous(), self.k, self.v, self.k_scale, self.v_scale,
            table, self.pos, block_size=self.block_size,
            softmax_scale=softmax_scale, runs=self.runs)
        return self, o[None].to(q.dtype)


def pack_prefill(pools: Pools, blocks: torch.Tensor,
                 k_stack: torch.Tensor, v_stack: torch.Tensor) -> Pools:
    """Scatter a prefilled contiguous cache into pool blocks, in place
    (quantized for an int8 pool).

    ``blocks``: [nb] pool blocks assigned to the sequence;
    ``k_stack``/``v_stack``: [layers, T, H, D] from the prefill forward,
    with ``T == nb * block_size`` (bucketed: positions past the true prompt
    length carry garbage that stays masked by ``pos``).
    """
    nb = blocks.shape[0]
    idx = (blocks.long(),)
    for i, (k, v, ks, vs) in enumerate(pools):
        bs = k.shape[1]
        _store(k, ks, idx, k_stack[i].reshape(nb, bs, *k.shape[2:]))
        _store(v, vs, idx, v_stack[i].reshape(nb, bs, *v.shape[2:]))
    return pools

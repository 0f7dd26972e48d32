"""Paged decode attention: the serving decode hot loop.

The port of ``deepspeed_tpu/ops/transformer/paged_attention.py``. Queries
``q`` [B, S, H, D] attend over the paged K/V pools [N, BS, H, D] through
each row's block table [B, WB]: the K/V blocks are read straight from the
pool, and the gathered [B, WB*BS, H, D] copy is never made. Table-relative
key ``j`` is visible to query ``i`` iff ``j <= pos[b] + i``. The pools are
in q's dtype, or int8 with per-(token, head) fp32 scales ``k_scale`` /
``v_scale`` [N, BS, H], dequantized in fp32 as each key is read.

- On a CUDA tensor, :func:`paged_decode_attention` launches the Hopper
  kernel ``csrc/paged_attention.cu`` (built at first use) or raises. It
  never falls back to the plain version. The kernel splits each (head,
  sequence, query group)'s keys over a thread-block cluster of
  :func:`paged_decode_splits` blocks, in one launch.
- On a CPU tensor it runs :func:`paged_decode_attention_reference`, the
  plain PyTorch version the CPU tests hold against the JAX kernel and
  ``chip_smoke.py`` holds the CUDA kernel against.

``paged_decode_attention.launches`` counts kernel launches (CUDA only), so
a run can show that its decode went through the kernel, and
``paged_decode_attention.launches_by_queries`` counts them by S (1 for a
decode step or a speculative draft step, ``k + 1`` for a verify).
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import build

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "paged_decode_ok", "paged_decode_splits"]

MAX_HEAD_DIM = 256
MAX_SPLITS = 8              # the portable thread-block cluster size
KEYS_PER_SPLIT = 64         # the fewest keys worth a block of a cluster
BLOCKS_PER_CARD = 792       # six blocks on each of an H100's 132 SMs
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def paged_decode_ok(head_dim: int, dtype: torch.dtype,
                    pool_dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the CUDA kernel takes these operands: q (and out) float32
    or bfloat16, the pools in q's dtype (``pool_dtype`` None) or int8, and
    ``head_dim`` a multiple of 8 (one 16-byte bf16 vector per thread) and
    at most 256. Any block size works."""
    return (dtype in _DTYPE_CODES
            and pool_dtype in (None, dtype, torch.int8)
            and head_dim % 8 == 0 and 8 <= head_dim <= MAX_HEAD_DIM)


def paged_decode_splits(context: int, heads: int, batch: int) -> int:
    """Blocks per (head, sequence, query group) of the decode kernel, 1 to
    ``MAX_SPLITS``: one per ``KEYS_PER_SPLIT`` keys of ``context`` (the
    longest visible context of the batch; the wrapper passes its window,
    block table columns x block size, which the host knows without
    reading ``pos``), and no more than the ``heads x batch`` clusters fit
    in ``BLOCKS_PER_CARD``: past that the blocks queue and each split
    adds only its combine. ``chip_smoke.py`` (``time_paged_splits``)
    times every count against this rule on the card for a single-token
    decode (batches 1, 8 and 32, windows of 128 to 1024 keys)."""
    by_keys = -(-int(context) // KEYS_PER_SPLIT)
    by_card = BLOCKS_PER_CARD // max(1, int(heads) * int(batch))
    return max(1, min(MAX_SPLITS, by_keys, by_card))


def dequantized(pool: torch.Tensor, scale: Optional[torch.Tensor],
                index) -> torch.Tensor:
    """``pool[index]`` in fp32, dequantized with ``scale[index]`` for an
    int8 pool. Shared by the plain versions of kernels #1 and #2."""
    x = pool[index].float()
    if scale is not None:
        x = x * scale[index][..., None]
    return x


def paged_decode_attention_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_table: torch.Tensor, pos: torch.Tensor, *, block_size: int,
        softmax_scale: Optional[float] = None,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: gather the window (dequantized in fp32 for an int8
    pool), masked fp32 softmax. Keys that no query of a row can see are
    zeroed before use, so garbage there (the scratch block, unwritten
    slots) reaches the output through no product, as in the kernel."""
    b, s, h, d = q.shape
    length = block_table.shape[1] * block_size
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (d ** 0.5))
    bt = block_table.long()
    k = dequantized(k_pool, k_scale, bt).reshape(b, length, h, d)
    v = dequantized(v_pool, v_scale, bt).reshape(b, length, h, d)
    kpos = torch.arange(length, device=q.device)
    qpos = pos.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    visible = kpos[None, None, :] <= qpos[:, :, None]            # [B, S, L]
    seen = visible.any(dim=1)[:, :, None, None]                  # [B, L, 1, 1]
    k = torch.where(seen, k, 0.0)
    v = torch.where(seen, v, 0.0)
    logits = torch.einsum("bshd,blhd->bhsl", q.float() * scale, k)
    logits = logits.masked_fill(~visible[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhsl,blhd->bshd", probs, v).to(q.dtype)


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("paged_attention")
        fn = lib.paged_decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.paged_decode_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FN = (fn, err)
    return _FN


def check_pool_operands(kernel: str, q, k_pool, v_pool, k_scale, v_scale,
                        tables, pos, block_size) -> None:
    """The CUDA kernels' operand checks, shared by kernels #1 and #2:
    dtypes, pool and scale shapes, int32 tables and positions, one
    device, contiguous and 16-byte aligned. ``tables``: ``(tensor,
    rows)`` with ``rows`` the table's expected row count; ``pos`` must be
    [rows]."""
    h, d = q.shape[-2:]
    int8 = k_scale is not None
    pool_dtype = torch.int8 if int8 else q.dtype
    if not paged_decode_ok(d, q.dtype, pool_dtype):
        raise ValueError(f"{kernel} kernel takes float32 or bfloat16 q, "
                         f"pools of q's dtype or int8, and head_dim a "
                         f"multiple of 8 in [8, {MAX_HEAD_DIM}], got q "
                         f"{q.dtype}, head_dim {d}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != pool_dtype:
            raise TypeError(f"{name} dtype {t.dtype} != {pool_dtype} (q "
                            f"{q.dtype}, scales given: {int8})")
        if t.ndim != 4 or tuple(t.shape[1:]) != (block_size, h, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"[N, {block_size}, {h}, {d}]")
    scales = ()
    if int8:
        if v_scale is None:
            raise ValueError("int8 pools need both k_scale and v_scale")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != tuple(
                    k_pool.shape[:3]):
                raise ValueError(f"{name} must be float32 "
                                 f"{list(k_pool.shape[:3])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
    table, rows = tables
    if table.dtype != torch.int32 or table.ndim != 2 \
            or table.shape[0] != rows:
        raise ValueError(f"block table must be int32 [{rows}, WB], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (rows,):
        raise ValueError(f"pos must be int32 [{rows}], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block table", table), ("pos", pos)) + scales:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           k_scale: Optional[torch.Tensor],
                           v_scale: Optional[torch.Tensor],
                           block_table: torch.Tensor, pos: torch.Tensor, *,
                           block_size: int,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Attention of ``q`` [B, S, H, D] over the paged pools through each
    row's block table.

    ``k_pool``/``v_pool``: [N, BS, H, D] in q's dtype, or int8 with
    ``k_scale``/``v_scale`` [N, BS, H] fp32 per-(token, head) scales
    (None for an fp pool). ``block_table``: [B, WB] int32 pool-block ids
    (a column-sliced window is fine: positions are table-relative).
    ``pos``: [B] int32, the first query's position. Returns [B, S, H, D]
    in ``q.dtype``. The chunk's own K/V must already be in the pools
    (``PagedLayerCache.update_attend`` does both).
    """
    if k_pool.shape[1] != block_size:
        raise ValueError(f"pool block size {k_pool.shape[1]} != "
                         f"{block_size}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need both k_scale and v_scale")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_table, pos, block_size=block_size,
            softmax_scale=softmax_scale, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on CUDA or CPU "
                         f"tensors, got {q.device}")
    b, s, h, d = q.shape
    check_pool_operands("paged_decode_attention", q, k_pool, v_pool,
                        k_scale, v_scale, (block_table, b), pos, block_size)
    splits = paged_decode_splits(block_table.shape[1] * block_size, h, b)
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, block_table, pos,
                  block_size, softmax_scale, splits)
    paged_decode_attention.launches += 1
    by_s = paged_decode_attention.launches_by_queries
    by_s[s] = by_s.get(s, 0) + 1
    return out


def _launch(q, k_pool, v_pool, k_scale, v_scale, block_table, pos,
            block_size: int, softmax_scale: Optional[float],
            splits: int) -> torch.Tensor:
    """One launch of the kernel with ``splits`` blocks per cluster, on
    operands :func:`check_pool_operands` accepted."""
    b, s, h, d = q.shape
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (d ** 0.5))
    out = torch.empty_like(q)
    int8 = k_scale is not None
    fn, err = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if int8 else None,
                v_scale.data_ptr() if int8 else None,
                block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                b, s, h, d, block_size, block_table.shape[1], float(scale),
                _DTYPE_CODES[q.dtype], int(int8), int(splits), stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_queries = {}

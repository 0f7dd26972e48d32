"""Ragged chunked-prefill attention: the mixed decode + prefill step.

The port of ``deepspeed_tpu/ops/transformer/chunked_prefill.py`` (Sarathi
-style chunked prefill, arXiv 2308.16369). One serving step's batch is a
flat ragged token batch ``q`` [T, H, D]: decode tokens, chunks of prompts
being prefilled, and pad tokens. Each token carries its own row of the
block table ([T, WB]) and its own position, and key ``j`` is visible to
token ``t`` iff ``j <= pos[t]``: a chunk's token sees its prompt up to
itself, a decode token its whole written past, and a token's walk touches
only its own sequence's blocks. The pools are in q's dtype, or int8 with
per-(token, head) fp32 scales [N, BS, H].

- On a CUDA tensor, :func:`chunked_prefill_attention` launches the Hopper
  kernel ``csrc/chunked_prefill.cu`` (built at first use) or raises. It
  never falls back to the plain version.
- On a CPU tensor it runs :func:`chunked_prefill_attention_reference`,
  the plain PyTorch version the CPU tests hold against the JAX kernel and
  ``chip_smoke.py`` holds the CUDA kernel against.

The JAX package gates its kernel on ``head_dim % 128`` (TPU lane tiling);
the CUDA kernel takes what the paged decode kernel takes
(``paged_decode_ok``). ``chunked_prefill_attention.launches`` counts
kernel launches (CUDA only).
"""

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer.paged_attention import (
    _DTYPE_CODES, check_pool_operands, dequantized)

__all__ = ["chunked_prefill_attention",
           "chunked_prefill_attention_reference"]

_FN = None


def chunked_prefill_attention_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
        table: torch.Tensor, pos: torch.Tensor, *, block_size: int,
        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: per token, gather its table row's window (cut to the
    blocks the furthest token can see; dequantized in fp32 for an int8
    pool) and take a masked fp32 softmax. Keys a token cannot see are
    zeroed before use, so garbage there reaches no output, as in the
    kernel."""
    t, h, d = q.shape
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (d ** 0.5))
    wb = min(table.shape[1], int(pos.max()) // block_size + 1)
    tb = table[:, :wb].long()
    length = wb * block_size
    k = dequantized(k_pool, k_scale, tb).reshape(t, length, h, d)
    v = dequantized(v_pool, v_scale, tb).reshape(t, length, h, d)
    kpos = torch.arange(length, device=q.device)
    visible = kpos[None, :] <= pos.long()[:, None]               # [T, L]
    k = torch.where(visible[:, :, None, None], k, 0.0)
    v = torch.where(visible[:, :, None, None], v, 0.0)
    logits = torch.einsum("thd,tlhd->thl", q.float() * scale, k)
    logits = logits.masked_fill(~visible[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("thl,tlhd->thd", probs, v).to(q.dtype)


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("chunked_prefill")
        fn = lib.chunked_prefill_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.chunked_prefill_attention_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FN = (fn, err)
    return _FN


def chunked_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              k_scale: Optional[torch.Tensor],
                              v_scale: Optional[torch.Tensor],
                              table: torch.Tensor, pos: torch.Tensor, *,
                              block_size: int,
                              softmax_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Attention of a ragged token batch ``q`` [T, H, D] over the paged
    pools through **per-token** table rows.

    ``k_pool``/``v_pool``: [N, BS, H, D] in q's dtype, or int8 with
    ``k_scale``/``v_scale`` [N, BS, H] fp32 scales (None for an fp pool).
    ``table``: [T, WB] int32, row ``t`` the table row of token ``t``'s
    sequence (pad tokens: an all-scratch row). ``pos``: [T] int32, token
    ``t``'s own position. Returns [T, H, D] in ``q.dtype``. The batch's
    K/V must already be in the pools (``ChunkedLayerCache.update_attend``
    does both).
    """
    if k_pool.shape[1] != block_size:
        raise ValueError(f"pool block size {k_pool.shape[1]} != "
                         f"{block_size}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need both k_scale and v_scale")
    if q.device.type == "cpu":
        return chunked_prefill_attention_reference(
            q, k_pool, v_pool, k_scale, v_scale, table, pos,
            block_size=block_size, softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"chunked_prefill_attention runs on CUDA or CPU "
                         f"tensors, got {q.device}")
    if q.ndim != 3:
        raise ValueError(f"q must be [T, H, D], got {tuple(q.shape)}")
    t, h, d = q.shape
    if not 1 <= t <= 65535:
        raise ValueError(f"chunked_prefill_attention kernel takes 1 to "
                         f"65535 tokens, got {t}")
    check_pool_operands("chunked_prefill_attention", q, k_pool, v_pool,
                        k_scale, v_scale, (table, t), pos, block_size)
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
                table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                t, h, d, block_size, table.shape[1], float(scale),
                _DTYPE_CODES[q.dtype], int(int8), stream)
    if rc != 0:
        raise RuntimeError(f"chunked_prefill_attention kernel launch "
                           f"failed: {err(rc).decode()} (cudaError {rc})")
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0

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
  kernels of ``csrc/chunked_prefill.cu`` (built at first use) or raises.
  It never falls back to the plain version. :func:`_route` picks them:
  with ``head_dim`` a multiple of 8 up to 128, bfloat16 q over bfloat16
  or int8 pools (:func:`chunked_prefill_attention_tc`) and float32 q over
  float32 or int8 pools (:func:`chunked_prefill_attention_tf32`) run the
  step's runs of one sequence: :func:`chunked_runs` finds them once, on
  the host; runs of two or more tokens run on the tensor cores in items
  of up to 64 tokens (fp32 as 3xTF32), decode rows on the one-query walk
  with their keys split over a thread-block cluster, kernel #1's design.
  Wider heads run the first kernel (``chunked_prefill_attention_fwd``,
  which finds runs of up to 8 tokens in each block, on FMAs).
- On a CPU tensor it runs :func:`chunked_prefill_attention_reference`,
  the plain PyTorch version the CPU tests hold against the JAX kernel and
  ``chip_smoke.py`` holds the CUDA kernels against.

The JAX package gates its kernel on ``head_dim % 128`` (TPU lane tiling);
the CUDA kernels take what the paged decode kernel takes
(``paged_decode_ok``). ``chunked_prefill_attention.launches`` counts the
first kernel's launches, ``chunked_prefill_attention_tc.launches`` and
``chunked_prefill_attention_tf32.launches`` the calls of the run kernels
(one or two launches each: the chunk items' kernel if the step holds a
run of two or more tokens, the decode items' if it holds a run of one),
CUDA only.
"""

import ctypes
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer.paged_attention import (
    _DTYPE_CODES, KEYS_PER_SPLIT, MAX_SPLITS, check_pool_operands,
    dequantized)

__all__ = ["chunked_prefill_attention", "chunked_prefill_attention_tc",
           "chunked_prefill_attention_tf32",
           "chunked_prefill_attention_reference", "chunked_runs",
           "ChunkedRuns", "chunked_decode_splits"]

TC_TOKENS = 64          # the tensor-core kernel's query rows per item
TC_MAX_HEAD_DIM = 128
# The decode items' cluster blocks that run well at once: three on each of
# an H100's 132 SMs. chip_smoke.py (time_chunked_splits) timed 1, 2, 4 and
# 8 decode rows x 12 heads over 256 and 1,024 keys at every split count:
# 8 rows at 8 splits (768 blocks, kernel #1's 792 allowed them) ran 1.2x
# (1,024 keys) and 1.7x (256 keys) behind 6 and 4 splits; with this bound
# the rule's pick was within 5% of the fastest count in every case (two
# runs).
DECODE_BLOCKS_PER_CARD = 396
_FN = None


def _route(dtype: torch.dtype, pool_dtype: torch.dtype,
           head_dim: int) -> str:
    """Which kernels run a call on CUDA. With ``head_dim`` a multiple of 8
    in [8, 128], the runs of one sequence (tensor cores for chunks, the
    split one-query walk for decode rows): ``"tc"`` for bfloat16 q over
    bfloat16 or int8 pools, ``"tf32"`` (3xTF32) for float32 q over float32
    or int8 pools. ``"walk"`` (the first kernel, on FMAs) for the rest:
    wider heads."""
    if head_dim % 8 or not 8 <= head_dim <= TC_MAX_HEAD_DIM:
        return "walk"
    if dtype == torch.bfloat16 and pool_dtype in (torch.bfloat16,
                                                  torch.int8):
        return "tc"
    if dtype == torch.float32 and pool_dtype in (torch.float32, torch.int8):
        return "tf32"
    return "walk"


class ChunkedRuns:
    """One step's work for the run kernels, as they read it: ``items``
    int32 [n_chunk + n_decode, 4], the chunk items (first token, tokens,
    keys, 0) and then the decode items (token, 1, keys, 0), each list
    longest walk first (keys: the last position + 1, at most the table's
    reach). ``on(device)`` copies it once per device."""

    def __init__(self, chunks: np.ndarray, decode: np.ndarray):
        self.n_chunk, self.n_decode = len(chunks), len(decode)
        self.items = np.ascontiguousarray(
            np.concatenate([chunks, decode]).astype(np.int32).reshape(-1, 4))
        self.longest_decode = int(decode[:, 2].max()) if len(decode) else 0
        self._on = {}

    def on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.from_numpy(self.items).to(device)
        return self._on[key]


def chunked_runs(table, pos, block_size: int) -> ChunkedRuns:
    """Find a step's runs once, on the host: consecutive tokens with one
    table row whose positions rise by one (a prompt chunk) or stay (pad
    tokens, all at position 0 on the scratch row). A run of two or more
    tokens is cut into chunk items of up to :data:`TC_TOKENS` consecutive
    tokens; a run of one is a decode item. ``table`` [T, WB] and ``pos``
    [T] (int32, host tensors or arrays). Each list is ordered by keys
    walked, longest first, then by first token."""
    table = np.asarray(table)
    pos = np.asarray(pos).astype(np.int64)
    reach = table.shape[1] * int(block_size)
    step = np.diff(pos)
    cont = (table[1:] == table[:-1]).all(axis=1) & ((step == 0) | (step == 1))
    starts = np.concatenate([[0], np.nonzero(~cont)[0] + 1])
    ends = np.concatenate([starts[1:], [len(pos)]])
    chunks, decode = [], []
    for a, e in zip(starts.tolist(), ends.tolist()):
        if e - a == 1:
            decode.append((a, 1, min(int(pos[a]) + 1, reach), 0))
            continue
        for t0 in range(a, e, TC_TOKENS):
            n = min(TC_TOKENS, e - t0)
            chunks.append((t0, n, min(int(pos[t0 + n - 1]) + 1, reach), 0))

    def order(items):
        items.sort(key=lambda x: (-x[2], x[0]))
        return np.asarray(items, np.int64).reshape(-1, 4)

    return ChunkedRuns(order(chunks), order(decode))


def chunked_decode_splits(runs: ChunkedRuns, heads: int) -> int:
    """Blocks per decode item of the run kernels' cluster walk, 1 to
    ``MAX_SPLITS``: kernel #1's rule (``paged_decode_splits``) with this
    kernel's own card bound: one block per ``KEYS_PER_SPLIT`` keys of the
    longest decode walk, and no more than the ``heads x decode items``
    clusters fit in :data:`DECODE_BLOCKS_PER_CARD`."""
    by_keys = -(-max(1, runs.longest_decode) // KEYS_PER_SPLIT)
    by_card = DECODE_BLOCKS_PER_CARD // max(1, heads * runs.n_decode)
    return max(1, min(MAX_SPLITS, by_keys, by_card))


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
    """The ctypes functions of ``csrc/chunked_prefill.cu`` by route
    (``"walk"``, ``"tc"``, ``"tf32"``) and its error string (``"err"``),
    built and loaded at first use."""
    global _FN
    if _FN is None:
        lib = build.load("chunked_prefill")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        walk = lib.chunked_prefill_attention_fwd
        walk.argtypes = [ptr] * 8 + [i32] * 5 + [ctypes.c_float, i32, i32,
                                                 ptr]
        fns = {"walk": walk, "tc": lib.chunked_prefill_tc_fwd,
               "tf32": lib.chunked_prefill_tf32_fwd}
        for route in ("tc", "tf32"):
            fns[route].argtypes = [ptr] * 8 + [i32] * 2 + [ptr] + [
                i32] * 5 + [ctypes.c_float, i32, i32, ptr]
        for fn in fns.values():
            fn.restype = i32
        err = lib.chunked_prefill_attention_error_string
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        _FN = dict(fns, err=err)
    return _FN


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{_kernel()['err'](rc).decode()} (cudaError "
                           f"{rc})")


def chunked_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor,
                              k_scale: Optional[torch.Tensor],
                              v_scale: Optional[torch.Tensor],
                              table: torch.Tensor, pos: torch.Tensor, *,
                              block_size: int,
                              softmax_scale: Optional[float] = None,
                              runs: Optional[ChunkedRuns] = None
                              ) -> torch.Tensor:
    """Attention of a ragged token batch ``q`` [T, H, D] over the paged
    pools through **per-token** table rows.

    ``k_pool``/``v_pool``: [N, BS, H, D] in q's dtype, or int8 with
    ``k_scale``/``v_scale`` [N, BS, H] fp32 scales (None for an fp pool).
    ``table``: [T, WB] int32, row ``t`` the table row of token ``t``'s
    sequence (pad tokens: an all-scratch row). ``pos``: [T] int32, token
    ``t``'s own position. ``runs``: the step's :func:`chunked_runs` of
    these ``table`` and ``pos``, if the caller has them (the serving
    engine finds them once per step); the run kernels otherwise find them
    from host copies (a device synchronisation). Returns [T, H, D] in
    ``q.dtype``. The batch's K/V must already be in the pools
    (``ChunkedLayerCache.update_attend`` does both). The first kernel's
    launches count here, the run kernels' in
    :func:`chunked_prefill_attention_tc` and
    :func:`chunked_prefill_attention_tf32`.
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
    _check_operands(q, k_pool, v_pool, k_scale, v_scale, table, pos,
                    block_size)
    route = _route(q.dtype, k_pool.dtype, q.shape[-1])
    if route != "walk":
        return _RUN_WRAPPERS[route](
            q, k_pool, v_pool, k_scale, v_scale, table, pos,
            block_size=block_size, softmax_scale=softmax_scale, runs=runs)
    out = _launch_walk(q, k_pool, v_pool, k_scale, v_scale, table, pos,
                       block_size, softmax_scale)
    chunked_prefill_attention.launches += 1
    return out


def _check_operands(q, k_pool, v_pool, k_scale, v_scale, table, pos,
                    block_size):
    if q.ndim != 3:
        raise ValueError(f"q must be [T, H, D], got {tuple(q.shape)}")
    t = q.shape[0]
    if not 1 <= t <= 65535:
        raise ValueError(f"chunked_prefill_attention kernel takes 1 to "
                         f"65535 tokens, got {t}")
    check_pool_operands("chunked_prefill_attention", q, k_pool, v_pool,
                        k_scale, v_scale, (table, t), pos, block_size)


def _launch_walk(q, k_pool, v_pool, k_scale, v_scale, table, pos,
                 block_size: int, softmax_scale: Optional[float]):
    """One launch of the first kernel (runs of up to 8 tokens found in each
    block, on FMAs), on operands :func:`_check_operands` accepted; any
    dtype it takes, bfloat16 included."""
    t, h, d = q.shape
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (d ** 0.5))
    out = torch.empty_like(q)
    int8 = k_scale is not None
    walk = _kernel()["walk"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = walk(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  k_scale.data_ptr() if int8 else None,
                  v_scale.data_ptr() if int8 else None,
                  table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                  t, h, d, block_size, table.shape[1], float(scale),
                  _DTYPE_CODES[q.dtype], int(int8), stream)
    _check(rc, "chunked_prefill_attention")
    return out


_RUN_DTYPES = {"tc": "bfloat16 q over bfloat16 or int8 pools",
               "tf32": "float32 q over float32 or int8 pools"}


def _launch_runs(wrapper, route: str, q, k_pool, v_pool, k_scale, v_scale,
                 table, pos, block_size: int,
                 softmax_scale: Optional[float],
                 runs: Optional[ChunkedRuns], splits: Optional[int]):
    """One call of a route's run kernels (``"tc"`` or ``"tf32"``), counted
    in ``wrapper.launches``: ValueError unless ``q`` is a CUDA tensor whose
    call ``_route`` sends to ``route``; the step's run list found from
    host copies when the caller has none (a device synchronisation),
    ``splits`` by :func:`chunked_decode_splits` by default."""
    what = wrapper.__name__
    if _route(q.dtype, k_pool.dtype, q.shape[-1]) != route:
        raise ValueError(
            f"{what}: its run kernels take {_RUN_DTYPES[route]} and "
            f"head_dim a multiple of 8 in [8, {TC_MAX_HEAD_DIM}]; got q "
            f"{q.dtype}, pools {k_pool.dtype}, head_dim {q.shape[-1]}")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: its run kernels run on CUDA tensors, "
                         f"got {q.device}")
    _check_operands(q, k_pool, v_pool, k_scale, v_scale, table, pos,
                    block_size)
    t, h, d = q.shape
    int8 = k_scale is not None
    if runs is None:
        runs = chunked_runs(table.cpu().numpy(), pos.cpu().numpy(),
                            block_size)
    if splits is None:
        splits = chunked_decode_splits(runs, h)
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (d ** 0.5))
    out = torch.empty_like(q)
    items = runs.on(q.device)
    fn = _kernel()[route]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr() if int8 else None,
                v_scale.data_ptr() if int8 else None,
                table.data_ptr(), pos.data_ptr(), items.data_ptr(),
                runs.n_chunk, runs.n_decode, out.data_ptr(), t, h, d,
                block_size, table.shape[1], float(scale), int(int8),
                int(splits), stream)
    _check(rc, what)
    wrapper.launches += 1
    return out


def chunked_prefill_attention_tc(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 k_scale: Optional[torch.Tensor],
                                 v_scale: Optional[torch.Tensor],
                                 table: torch.Tensor, pos: torch.Tensor, *,
                                 block_size: int,
                                 softmax_scale: Optional[float] = None,
                                 runs: Optional[ChunkedRuns] = None,
                                 splits: Optional[int] = None
                                 ) -> torch.Tensor:
    """The run kernels (bfloat16 q over bfloat16 pools, or int8 pools with
    their scales; ``head_dim`` a multiple of 8 up to 128; CUDA tensors;
    anything else raises ValueError): chunk items on the tensor cores
    (int8 codes widened to bfloat16, exactly, k_scale multiplying s and
    v_scale p), decode items on the one-query walk with their keys split
    over ``splits`` blocks of a cluster (:func:`chunked_decode_splits` by
    default). Inputs and output as :func:`chunked_prefill_attention`."""
    return _launch_runs(chunked_prefill_attention_tc, "tc", q, k_pool,
                        v_pool, k_scale, v_scale, table, pos, block_size,
                        softmax_scale, runs, splits)


def chunked_prefill_attention_tf32(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   k_scale: Optional[torch.Tensor],
                                   v_scale: Optional[torch.Tensor],
                                   table: torch.Tensor, pos: torch.Tensor,
                                   *, block_size: int,
                                   softmax_scale: Optional[float] = None,
                                   runs: Optional[ChunkedRuns] = None,
                                   splits: Optional[int] = None
                                   ) -> torch.Tensor:
    """The fp32 run kernels (float32 q over float32 pools, or int8 pools
    with their scales; ``head_dim`` a multiple of 8 up to 128; CUDA
    tensors; anything else raises ValueError): chunk items on the tensor
    cores as 3xTF32 (each fp32 operand split into two TF32 terms, three
    products each; int8 codes exact in TF32, so two, with k_scale
    multiplying s and v_scale p in fp32), decode items on the fp32
    one-query walk with their keys split over ``splits`` blocks of a
    cluster (:func:`chunked_decode_splits` by default). Inputs and output
    as :func:`chunked_prefill_attention`."""
    return _launch_runs(chunked_prefill_attention_tf32, "tf32", q, k_pool,
                        v_pool, k_scale, v_scale, table, pos, block_size,
                        softmax_scale, runs, splits)


_RUN_WRAPPERS = {"tc": chunked_prefill_attention_tc,
                 "tf32": chunked_prefill_attention_tf32}


chunked_prefill_attention.launches = 0
chunked_prefill_attention_tc.launches = 0
chunked_prefill_attention_tf32.launches = 0

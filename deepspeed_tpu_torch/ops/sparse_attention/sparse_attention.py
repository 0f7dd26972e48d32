"""Block-sparse attention executors.

The port of ``deepspeed_tpu/ops/sparse_attention/sparse_attention.py``.
q, k, v are [B, S, H, D]; a layout [H, NB, NB] (NB = S / block, from
``sparsity_config.py``) says which key blocks each query block attends.
Masked pairs (outside the layout, above the diagonal under ``causal``, or
a key whose ``key_mask`` [B, S] entry is 0) are selected out; a row with
no visible key gives 0 (and lse -1e30), not NaN.

- ``impl="xla"``: :func:`_xla_sparse`, dense attention under the
  layout-expanded mask in plain PyTorch, differentiated by autograd (the
  JAX package's numerics oracle, fine for modest sequence lengths).
- ``impl="pallas"`` (the JAX name) and ``"auto"``: the kernels through an
  ``autograd.Function``: :func:`sparse_attention_fwd` (TPU kernel #8),
  then in the backward :func:`sparse_attention_bwd_dq` (#9) and
  :func:`sparse_attention_bwd_dkv` (#10). Per (head, query block) they
  walk only that row's active key blocks, and dk/dv walk the transposed
  lists, so compute and memory traffic scale with the layout's density.
  :func:`_route` picks each kernel's route (``_route_bwd`` is its view
  for dq and dk/dv). bfloat16 and float16 with ``head_dim`` a multiple of
  8 up to 128 and a layout block that is a multiple of 64 run the
  tensor-core kernels of ``csrc/sparse_attention_tc.cu``
  (:func:`sparse_attention_fwd_tc`, :func:`sparse_attention_bwd_dq_tc`,
  :func:`sparse_attention_bwd_dkv_tc`), which walk the work lists of
  :meth:`SparsePlan.work` (long walks cut into pieces of at most
  :data:`SPLIT_CAP` tiles, whose fp32 partials a second pass combines in
  a fixed order). The same types and head dims at any other block that
  is a multiple of 16 (16, 32, 48, ...: the reference's default is 16)
  run the 16-row tensor-core kernels of ``csrc/sparse_attention_tc16.cu``
  (:func:`sparse_attention_fwd_tc16`, :func:`sparse_attention_bwd_dq_tc16`,
  :func:`sparse_attention_bwd_dkv_tc16`) over :meth:`SparsePlan.work16`
  (the forward walks dq's list). float32 with those head dims at any
  block that is a multiple of 16 runs the forward, dq and dk/dv as 3xTF32
  on the tensor cores (``csrc/sparse_attention_tf32.cu``:
  :func:`sparse_attention_fwd_tf32`, :func:`sparse_attention_bwd_dq_tf32`,
  :func:`sparse_attention_bwd_dkv_tf32`, over the same 16-row lists). The
  fp32-FMA kernels of ``csrc/sparse_attention.cu`` are the first versions
  of all three and run on no path: they take no input that the other
  routes refuse. On a CUDA tensor each wrapper launches its kernel
  (built at first use) or raises; it never falls back. On a CPU tensor
  each dispatching wrapper runs its plain version (:func:`sparse_fwd_reference`,
  :func:`sparse_bwd_dq_reference`, :func:`sparse_bwd_dkv_reference`),
  which the CPU tests hold against the JAX kernels and ``chip_smoke.py``
  holds the CUDA kernels against.

The index lists (``layout_kv_indices`` / ``layout_q_indices`` and the
per-row and per-column counts) and the work lists are built on the host
once per layout and kept on each device they are used on
(:func:`sparse_plan`), as the JAX package caches its closure per layout.
Each kernel wrapper counts its launches in ``.launches``: the FMA kernels
in ``sparse_attention_fwd``, ``sparse_attention_bwd_dq`` and
``sparse_attention_bwd_dkv``, the tensor-core ones in
``sparse_attention_fwd_tc``, ``sparse_attention_bwd_dq_tc``,
``sparse_attention_bwd_dkv_tc``, ``sparse_attention_fwd_tc16``,
``sparse_attention_bwd_dq_tc16``, ``sparse_attention_bwd_dkv_tc16``,
``sparse_attention_fwd_tf32``, ``sparse_attention_bwd_dq_tf32`` and
``sparse_attention_bwd_dkv_tf32``.
"""

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer.flash_attention import (_aligned,
                                                                 _ptr,
                                                                 _strides)

__all__ = ["NEG_INF", "layout_to_dense_mask", "layout_kv_indices",
           "layout_q_indices", "sparse_plan", "SparsePlan",
           "sparse_attention", "SparseSelfAttention", "pad_to_block_size",
           "sparse_fwd_reference", "sparse_bwd_dq_reference",
           "sparse_bwd_dkv_reference", "sparse_attention_fwd",
           "sparse_attention_fwd_tc", "sparse_attention_fwd_tc16",
           "sparse_attention_bwd_dq", "sparse_attention_bwd_dkv",
           "sparse_attention_bwd_dq_tc", "sparse_attention_bwd_dkv_tc",
           "sparse_attention_bwd_dq_tc16", "sparse_attention_bwd_dkv_tc16",
           "sparse_attention_fwd_tf32", "sparse_attention_bwd_dq_tf32",
           "sparse_attention_bwd_dkv_tf32",
           "SPLIT_CAP", "WorkList", "WorkList16"]

NEG_INF = -1e30
LSE_FLOOR = NEG_INF / 2          # the backward's guard for empty rows
MAX_HEAD_DIM = 128
MAX_BATCH_HEADS = 65535          # the grid's second dimension
BLOCK_MULTIPLE = 16              # the kernels' row tiles: 16, 32 or 64
TC_TILE = 64                     # the tensor-core kernels' row tile
SUB_TILE = 16                    # a warp's rows in the 16-row kernels
WARPS = TC_TILE // SUB_TILE      # sub-blocks a 16-row work item holds
# The longest run of 64-row tiles that one work item of the tensor-core
# backward walks (SparsePlan.work cuts longer walks into pieces). Taken
# from chip_smoke.py's sweep of the cap at the long-sequence path's shape
# ([1, 16384, 12, 64] bf16, BigBird block 256, causal) on an H100 (PERF.md
# section 6): the pair is fastest at 64, ahead of no split (dk/dv's
# global column walks 256 tiles alone) and of caps from 4 to 32 (more
# pieces, each re-reading its key tile and writing fp32 partials).
SPLIT_CAP = 64
IMPLS = ("auto", "pallas", "xla")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FN = {}
# the libraries that walk SparsePlan.work16's 16-row lists
_ROWS16 = ("sparse_attention_tc16", "sparse_attention_tf32")


def _tc_operands(dtype: torch.dtype, head_dim: int) -> bool:
    return (dtype in (torch.bfloat16, torch.float16) and head_dim % 8 == 0
            and 8 <= head_dim <= MAX_HEAD_DIM)


def _route(dtype: torch.dtype, head_dim: int, block: int,
           which: str = "fwd") -> str:
    """Which kernel computes the forward (o, lse), dq or dk/dv (``which``
    "fwd", "dq" or "dkv") on CUDA: ``"tc"`` (the tensor cores,
    ``csrc/sparse_attention_tc.cu``) for bfloat16 and float16 with
    ``head_dim`` a multiple of 8 in [8, 128] and a layout ``block`` that is
    a multiple of 64 (a 64-row tile never straddles two layout rows);
    ``"tc16"`` (``csrc/sparse_attention_tc16.cu``: 16-row sub-blocks on
    the tensor cores) for the same dtypes and head dims at a block that is
    a multiple of 16 and not of 64; ``"tf32"``
    (``csrc/sparse_attention_tf32.cu``: 3xTF32 on the tensor cores over
    the 16-row lists) for the float32 forward, dq and dk/dv at those head
    dims and any block that is a multiple of 16; ``"fma"``
    (``csrc/sparse_attention.cu``) for everything else, which that
    kernel refuses too (:func:`_prepare` raises first on the autograd
    path)."""
    if which not in ("fwd", "dq", "dkv"):
        raise ValueError(f"the sparse kernels are fwd, dq or dkv, got "
                         f"{which!r}")
    if dtype == torch.float32:
        on_grid = (head_dim % 8 == 0 and 8 <= head_dim <= MAX_HEAD_DIM
                   and block % SUB_TILE == 0)
        return "tf32" if on_grid else "fma"
    if not _tc_operands(dtype, head_dim):
        return "fma"
    if block % TC_TILE == 0:
        return "tc"
    return "tc16" if block % SUB_TILE == 0 else "fma"


def _route_bwd(dtype: torch.dtype, head_dim: int, block: int) -> str:
    """The backward's route: :func:`_route`'s for dq, which dk/dv share."""
    return _route(dtype, head_dim, block, "dq")


def layout_to_dense_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """[H, B, B] block layout -> [H, S, S] bool element mask."""
    return _dense_mask(layout, block, "cpu").numpy()


def layout_kv_indices(layout: np.ndarray):
    """Per (head, q-block) active kv-block ids, ascending, padded with -1:
    -> int32 [H, B, max_active]."""
    layout = np.asarray(layout)
    h, b, _ = layout.shape
    max_active = int(layout.sum(-1).max())
    idx = np.full((h, b, max_active), -1, np.int32)
    for hi in range(h):
        for qi in range(b):
            cols = np.nonzero(layout[hi, qi])[0]
            idx[hi, qi, :len(cols)] = cols
    return idx, max_active


def layout_q_indices(layout: np.ndarray):
    """Transpose layout: per (head, kv-block) active q-block ids, padded
    with -1 — the dk/dv backward's iteration order."""
    layout = np.asarray(layout)
    return layout_kv_indices(layout.transpose(0, 2, 1))


class WorkList:
    """The work of one tensor-core backward kernel for one (layout, causal,
    cap), as the kernel reads it:

    - ``items`` int32 [n, 5]: a thread block's share of one batch row, in
      launch order (longest first): the head, the first row of the 64-row
      tile it owns (queries for dq, keys for dk/dv), the offset and count
      of its run in ``tiles``, and its scratch slot if it is a piece of a
      split walk (-1 if not);
    - ``tiles`` int32: the first rows of the streamed 64-row tiles, item
      after item;
    - ``splits`` int32 [n_split, 4]: each split tile's head, first row,
      first slot and piece count (its pieces hold consecutive slots, in
      walk order); ``n_slots`` slots in all."""

    def __init__(self, items, tiles, splits, n_slots):
        self.items, self.tiles, self.splits = items, tiles, splits
        self.n_slots = int(n_slots)

    @property
    def n_items(self) -> int:
        return len(self.items)

    @property
    def n_split(self) -> int:
        return len(self.splits)

    @property
    def longest(self) -> int:
        """The longest run one item walks, in 64-row tiles."""
        return int(self.items[:, 3].max())


def _walks(layout: np.ndarray, block: int, which: str, causal: bool):
    """For each (head, 64-row tile) of the rows the ``which`` kernel owns
    (queries for "dq", keys for "dkv"), head by head, tile by tile: ``(h,
    first row, walk)``, the walk being the first rows of the other axis'
    64-row tiles that its layout row ("dq") or column ("dkv") lists, in
    ascending order, without the tiles wholly above the causal diagonal
    (keys after the tile's last query; queries before its first key)."""
    lay = layout if which == "dq" else layout.transpose(0, 2, 1)
    sub = np.arange(block // TC_TILE, dtype=np.int64) * TC_TILE
    for h in range(lay.shape[0]):
        for r in range(lay.shape[1]):
            starts = (np.nonzero(lay[h, r])[0][:, None] * block
                      + sub[None]).ravel()
            for row0 in r * block + sub:
                walk = starts
                if causal:
                    walk = (starts[starts <= row0] if which == "dq" else
                            starts[starts >= row0])
                yield h, int(row0), walk


def build_work(layout: np.ndarray, block: int, which: str, causal: bool,
               cap: int) -> WorkList:
    """The :class:`WorkList` of one backward kernel: every (head, 64-row
    tile) of :func:`_walks`, its walk (counted after the causal skip) cut
    into ``ceil(len / cap)`` pieces of consecutive entries whose lengths
    differ by at most one, so none is longer than ``cap``; an empty walk
    is one item with no tiles (its output is written as zeros). Items
    sorted longest first (then by head, row and piece: a fixed order)."""
    if cap < 1:
        raise ValueError(f"split cap must be >= 1, got {cap}")
    pieces = []                       # (len, h, row0, piece, count, run)
    for h, row0, walk in _walks(layout, block, which, causal):
        n = len(walk)
        count = max(1, -(-n // cap))
        for p in range(count):
            run = walk[p * n // count:(p + 1) * n // count]
            pieces.append((len(run), h, row0, p, count, run))
    pieces.sort(key=lambda x: (-x[0], x[1], x[2], x[3]))
    first, splits, n_slots = {}, [], 0
    for _n, h, row0, _p, count, _r in sorted(
            (x for x in pieces if x[4] > 1 and x[3] == 0),
            key=lambda x: (x[1], x[2])):
        first[(h, row0)] = n_slots
        splits.append((h, row0, n_slots, count))
        n_slots += count
    items = np.empty((len(pieces), 5), np.int32)
    off = 0
    for i, (n, h, row0, p, count, _r) in enumerate(pieces):
        items[i] = (h, row0, off, n,
                    first[(h, row0)] + p if count > 1 else -1)
        off += n
    tiles = np.concatenate([np.zeros(0, np.int64)]
                           + [x[5] for x in pieces]).astype(np.int32)
    return WorkList(items, tiles if len(tiles) else np.zeros(1, np.int32),
                    np.asarray(splits, np.int32).reshape(-1, 4), n_slots)


class WorkList16(WorkList):
    """The work of one 16-row tensor-core backward kernel
    (``csrc/sparse_attention_tc16.cu``) for one (layout, causal, cap):

    - ``items`` int32 [n, 8]: a thread block's share of one batch row, in
      launch order (longest first): the head; the first rows of the
      16-row blocks its 4 warps own (queries for dq, keys for dk/dv; -1
      where a warp owns none); the offset and count of its walk in
      ``tiles``; its scratch slot if it is a piece of a split walk (-1 if
      not);
    - ``tiles`` int32 [m, 2]: each walk entry, item after item: the first
      row of a 16-row block of the other axis and the bits of the item's
      warps whose layout row ("dq") or column ("dkv") lists it;
    - ``splits`` int32 [n_split, 7]: each split item's head, its 4 rows,
      first slot and piece count (its pieces hold consecutive slots, in
      walk order); ``n_slots`` slots in all.

    The kernel streams a walk 4 entries (64 rows) a step."""

    @property
    def longest(self) -> int:
        """The longest walk one item takes, in 64-row steps."""
        return -(-int(self.items[:, 6].max()) // WARPS)

    @property
    def walk_max(self) -> int:
        """The longest walk's entries rounded up to whole steps: the
        shared memory a thread block keeps its walk in."""
        return WARPS * self.longest

    @property
    def masked_share(self) -> float:
        """The share of (owned warp, walk entry) pairs whose warp does not
        list the entry: warp-steps masked off."""
        owned = (self.items[:, 1:5] >= 0).sum(1)
        total = int((owned * self.items[:, 6]).sum())
        if not total:
            return 0.0
        listed = int(np.unpackbits(self.tiles[:, 1].astype(np.uint8)).sum())
        return (total - listed) / total

    @property
    def fill(self) -> float:
        """The share of the items' warps that own a block."""
        return float((self.items[:, 1:5] >= 0).mean())


def _walks16(layout: np.ndarray, block: int, which: str, causal: bool):
    """For each head: ``{first row of a 16-row block of the rows the
    ``which`` kernel owns: its walk}``, the walk being the first rows of
    the other axis' 16-row blocks that its layout row ("dq") or column
    ("dkv") lists, ascending, without those wholly above the causal
    diagonal (keys after its last query; queries before its first key)."""
    lay = layout if which == "dq" else layout.transpose(0, 2, 1)
    sub = np.arange(block // SUB_TILE, dtype=np.int64) * SUB_TILE
    for h in range(lay.shape[0]):
        walks = {}
        for r in range(lay.shape[1]):
            starts = (np.nonzero(lay[h, r])[0][:, None] * block
                      + sub[None]).ravel()
            for row0 in r * block + sub:
                walk = starts
                if causal:
                    walk = (starts[starts <= row0] if which == "dq" else
                            starts[starts >= row0])
                walks[int(row0)] = tuple(int(x) for x in walk)
        yield h, walks


def _pack16(walks: dict) -> list:
    """One head's 16-row blocks packed into items of up to 4 (a list of
    row lists): blocks with equal walks together, 4 at a time; the rest
    of each group of equal walks whole, next-fit, in order of first
    appearance (a group that does not fit the open item opens a new
    one)."""
    groups = {}
    for row0, walk in walks.items():
        groups.setdefault(walk, []).append(row0)
    items, rest = [], []
    for rows in groups.values():
        full = len(rows) - len(rows) % WARPS
        items += [rows[i:i + WARPS] for i in range(0, full, WARPS)]
        if full < len(rows):
            rest.append(rows[full:])
    open_item = []
    for rows in rest:
        if len(open_item) + len(rows) > WARPS:
            items.append(open_item)
            open_item = []
        open_item = open_item + rows
    if open_item:
        items.append(open_item)
    return items


def build_work16(layout: np.ndarray, block: int, which: str, causal: bool,
                 cap: int) -> WorkList16:
    """The :class:`WorkList16` of one 16-row backward kernel: each head's
    16-row blocks of :func:`_walks16` packed by :func:`_pack16`; an
    item's walk is the union of its blocks' walks, ascending, each entry
    with the bits of the warps that list it. A walk of more than ``cap``
    steps of 4 entries is cut into ``ceil(steps / cap)`` pieces of whole
    steps whose step counts differ by at most one (only the last piece
    may end in a partial step); an empty walk is one item with no entries
    (its rows are written as zeros). Items sorted longest first (then by
    head, rows and piece: a fixed order)."""
    if cap < 1:
        raise ValueError(f"split cap must be >= 1, got {cap}")
    pieces = []               # (len, h, rows, piece, count, entries)
    for h, walks in _walks16(layout, block, which, causal):
        for rows in _pack16(walks):
            bits = {}
            for w, row0 in enumerate(rows):
                for e in walks[row0]:
                    bits[e] = bits.get(e, 0) | (1 << w)
            walk = np.array(sorted(bits.items()), np.int64).reshape(-1, 2)
            rows = tuple(rows) + (-1,) * (WARPS - len(rows))
            n = len(walk)
            steps = -(-n // WARPS)
            count = max(1, -(-steps // cap))
            for p in range(count):
                run = walk[WARPS * (p * steps // count):
                           WARPS * ((p + 1) * steps // count)]
                pieces.append((len(run), h, rows, p, count, run))
    pieces.sort(key=lambda x: (-x[0], x[1], x[2], x[3]))
    first, splits, n_slots = {}, [], 0
    for _n, h, rows, _p, count, _r in sorted(
            (x for x in pieces if x[4] > 1 and x[3] == 0),
            key=lambda x: (x[1], x[2])):
        first[(h, rows)] = n_slots
        splits.append((h, *rows, n_slots, count))
        n_slots += count
    items = np.empty((len(pieces), 8), np.int32)
    off = 0
    for i, (n, h, rows, p, count, _r) in enumerate(pieces):
        items[i] = (h, *rows, off, n,
                    first[(h, rows)] + p if count > 1 else -1)
        off += n
    tiles = np.concatenate([np.zeros((0, 2), np.int64)]
                           + [x[5] for x in pieces]).astype(np.int32)
    return WorkList16(items, tiles if len(tiles) else np.zeros((1, 2),
                                                               np.int32),
                      np.asarray(splits, np.int32).reshape(-1, 7), n_slots)


def _work_key(which: str, causal: bool, cap: Optional[int]):
    """The forward walks dq's list: both own query tiles and visit the
    key tiles of their layout row."""
    return ("dq" if which == "fwd" else which, bool(causal),
            int(SPLIT_CAP if cap is None else cap))


class SparsePlan:
    """One layout as the kernels read it: int32 ``kv_idx`` [H, NB, max_kv]
    and ``kv_cnt`` [H, NB] (``layout.sum(-1)``), ``q_idx`` [H, NB, max_q]
    and ``q_cnt`` [H, NB] (``layout.sum(-2)``), built on the host once and
    copied to a device once per device; and, for the tensor-core backward,
    each kernel's :class:`WorkList` per (causal, cap) (:meth:`work`)."""

    def __init__(self, layout: np.ndarray, block: int):
        self.layout = np.asarray(layout).astype(np.int8)
        self.block = int(block)
        self.num_heads, self.num_blocks = self.layout.shape[:2]
        kv_idx, self.max_kv = layout_kv_indices(self.layout)
        q_idx, self.max_q = layout_q_indices(self.layout)
        self._host = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            kv_idx, self.layout.sum(-1).astype(np.int32),
            q_idx, self.layout.sum(-2).astype(np.int32)))
        self._on = {}
        self._work = {}

    def on(self, device: torch.device):
        """``(kv_idx, kv_cnt, q_idx, q_cnt)`` on ``device``."""
        key = str(device)
        if key not in self._on:
            self._on[key] = tuple(t.to(device) for t in self._host)
        return self._on[key]

    def work(self, which: str, causal: bool,
             cap: Optional[int] = None) -> WorkList:
        """The :class:`WorkList` of the tensor-core ``which`` kernel ("fwd",
        "dq" or "dkv"; the forward's is dq's, the same object), its walks
        cut at ``cap`` tiles (:data:`SPLIT_CAP` by default); built once per
        (which, causal, cap)."""
        if which not in ("fwd", "dq", "dkv"):
            raise ValueError(f"no work list for kernel {which!r}")
        if self.block % TC_TILE:
            raise ValueError(f"the tensor-core kernels take a layout block "
                             f"that is a multiple of {TC_TILE}; got block "
                             f"{self.block}")
        key = _work_key(which, causal, cap)
        if key not in self._work:
            self._work[key] = build_work(self.layout, self.block, *key)
        return self._work[key]

    def work16(self, which: str, causal: bool,
               cap: Optional[int] = None) -> WorkList16:
        """The :class:`WorkList16` of the 16-row tensor-core ``which``
        kernel ("fwd", "dq" or "dkv"; the forward's is dq's, the same
        object), its walks cut at ``cap`` steps of 64 rows
        (:data:`SPLIT_CAP` by default); built once per (which, causal,
        cap). Any layout block that is a multiple of 16."""
        if which not in ("fwd", "dq", "dkv"):
            raise ValueError(f"no 16-row work list for kernel {which!r}")
        if self.block % SUB_TILE:
            raise ValueError(f"the 16-row tensor-core kernels take a layout "
                             f"block that is a multiple of {SUB_TILE}; got "
                             f"block {self.block}")
        key = ("16",) + _work_key(which, causal, cap)
        if key not in self._work:
            self._work[key] = build_work16(self.layout, self.block,
                                           *key[1:])
        return self._work[key]

    def work_on(self, device: torch.device, which: str, causal: bool,
                cap: Optional[int] = None, rows16: bool = False):
        """``(work list, items, tiles, splits)``, the arrays on
        ``device``, copied once per device: :meth:`work`'s, or with
        ``rows16`` :meth:`work16`'s."""
        w = (self.work16 if rows16 else self.work)(which, causal, cap)
        key = ((str(device), rows16) + _work_key(which, causal, cap))
        if key not in self._on:
            self._on[key] = (w,) + tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (w.items, w.tiles, w.splits))
        return self._on[key]

    def visible(self, head: int, causal: bool,
                key_mask: Optional[torch.Tensor], device) -> torch.Tensor:
        """The plain versions' bool mask of one head's visible pairs,
        [B or 1, S, S]."""
        vis = _dense_mask(self.layout[head], self.block, device)[None]
        if causal:
            vis = vis & torch.ones(vis.shape[-2:], dtype=torch.bool,
                                   device=device).tril()
        if key_mask is not None:
            vis = vis & (key_mask > 0)[:, None, :].to(device)
        return vis


def _dense_mask(layout, block: int, device) -> torch.Tensor:
    """``layout_to_dense_mask`` built on ``device``: [..., NB, NB] ->
    [..., S, S] bool."""
    m = torch.from_numpy(np.asarray(layout) != 0).to(device)
    return m.repeat_interleave(block, -2).repeat_interleave(block, -1)


@functools.lru_cache(maxsize=64)
def _plan(layout_bytes: bytes, h: int, nb: int, block: int) -> SparsePlan:
    layout = np.frombuffer(layout_bytes, np.int8).reshape(h, nb, nb)
    return SparsePlan(layout, block)


def sparse_plan(layout, block: int) -> SparsePlan:
    """The cached :class:`SparsePlan` of a layout (keyed by its bytes)."""
    layout = np.asarray(layout).astype(np.int8)
    return _plan(layout.tobytes(), layout.shape[0], layout.shape[1],
                 int(block))


def _xla_sparse(q, k, v, layout, block, causal, scale, key_mask=None):
    """Dense attention under the layout-expanded mask (the JAX package's
    ``_xla_sparse``): fp32 scores, masked entries at -1e30, rows with no
    visible key give 0, probabilities cast to q's dtype before p.V."""
    mask = _dense_mask(layout, block, q.device)             # [H, S, S]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[None], NEG_INF)
    if key_mask is not None:
        keep = key_mask.bool()[:, None, None, :].to(q.device)
        logits = logits.masked_fill(~keep, NEG_INF)
    if causal:
        s = q.shape[1]
        cm = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~cm[None, None], NEG_INF)
    rowmax = logits.amax(dim=-1, keepdim=True)
    probs = torch.where(rowmax > NEG_INF / 2, torch.softmax(logits, dim=-1),
                        torch.zeros_like(logits))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def sparse_fwd_reference(q, k, v, key_mask, plan: SparsePlan, causal: bool,
                         scale: float):
    """Plain version of the forward kernel: ``(o, lse)``, o [B, S, H, D] in
    q's dtype and lse fp32 [B, H, S], over materialised fp32 scores, one
    head at a time (so a long sequence fits on the card). p stays fp32
    through p.V, as in the kernel."""
    outs, lses = [], []
    for h in range(q.shape[2]):
        vis = plan.visible(h, causal, key_mask, q.device)
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float() * scale,
                         k[:, :, h].float())
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        seen = m > float("-inf")
        p = torch.exp(s - torch.where(seen, m, torch.zeros_like(m)))
        l = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(seen, l, torch.ones_like(l))
        outs.append(torch.einsum("bqk,bkd->bqd", p, v[:, :, h].float()))
        lses.append(torch.where(seen, m + torch.log(l),
                                torch.full_like(m, NEG_INF))[..., 0])
    return torch.stack(outs, dim=2).to(q.dtype), torch.stack(lses, dim=1)


def _bwd_heads(q, k, v, dout, key_mask, lse, delta, plan, causal, scale):
    """Shared part of the backward kernels' plain versions, per head h:
    scale * q, p = exp(s - max(lse, -5e29)) on visible pairs (0 elsewhere)
    and ds = p (dO.v - delta), fp32 [B, S, S]."""
    for h in range(q.shape[2]):
        vis = plan.visible(h, causal, key_mask, q.device)
        qs = q[:, :, h].float() * scale
        s = torch.einsum("bqd,bkd->bqk", qs, k[:, :, h].float())
        p = torch.exp(s - lse[:, h].clamp_min(LSE_FLOOR)[..., None])
        p = p.masked_fill(~vis, 0.0)
        dp = torch.einsum("bqd,bkd->bqk", dout[:, :, h].float(),
                          v[:, :, h].float())
        yield h, qs, p, p * (dp - delta[:, h, :, None])


def sparse_bwd_dq_reference(q, k, v, dout, key_mask, lse, delta,
                            plan: SparsePlan, causal: bool, scale: float):
    """Plain version of the dq kernel on the same inputs (``lse`` and
    ``delta`` fp32 [B, H, S])."""
    dq = [torch.einsum("bqk,bkd->bqd", ds, k[:, :, h].float()) * scale
          for h, _qs, _p, ds in _bwd_heads(q, k, v, dout, key_mask, lse,
                                           delta, plan, causal, scale)]
    return torch.stack(dq, dim=2).to(q.dtype)


def sparse_bwd_dkv_reference(q, k, v, dout, key_mask, lse, delta,
                             plan: SparsePlan, causal: bool, scale: float):
    """Plain version of the dk/dv kernel on the same inputs."""
    dk, dv = [], []
    for h, qs, p, ds in _bwd_heads(q, k, v, dout, key_mask, lse, delta, plan,
                                   causal, scale):
        dk.append(torch.einsum("bqk,bqd->bkd", ds, qs))
        dv.append(torch.einsum("bqk,bqd->bkd", p, dout[:, :, h].float()))
    return (torch.stack(dk, dim=2).to(k.dtype),
            torch.stack(dv, dim=2).to(v.dtype))


def _kernel(name: str = "sparse_attention"):
    """The ctypes functions of ``csrc/<name>.cu``: ``sparse_attention``
    (forward, dq, dk/dv on FMAs), ``sparse_attention_tc`` (forward, dq,
    dk/dv on the tensor cores), ``sparse_attention_tc16`` (forward, dq,
    dk/dv on the tensor cores over 16-row blocks) or
    ``sparse_attention_tf32`` (forward, dq, dk/dv for fp32 as 3xTF32 over
    16-row blocks), built and loaded at first use."""
    if name not in _FN:
        lib = build.load(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B, H, S, D, block, scale, causal (then, on the tensor-core
        # routes, part, splits, n_split, n_slots), dtype, stream
        shape = [i32] * 5 + [f32, i32]
        end = [i32, ptr]
        tail = (shape + end if name == "sparse_attention" else
                shape + [ptr, ptr, i32, i32] + end)
        # the index lists' width or n_items (then, over 16-row blocks,
        # walk_max)
        count = [i32] * (2 if name in _ROWS16 else 1)
        fns = {"fwd": (getattr(lib, f"{name}_fwd"),
                       [ptr] * 6 + count + [ptr] * 3 + tail),
               "dq": (getattr(lib, f"{name}_bwd_dq"),
                      [ptr] * 7 + count + [ptr] * 4 + tail),
               "dkv": (getattr(lib, f"{name}_bwd_dkv"),
                       [ptr] * 7 + count + [ptr] * 5 + tail)}
        out = {}
        for key, (fn, argtypes) in fns.items():
            fn.argtypes = argtypes
            fn.restype = i32
            out[key] = fn
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        out["err"] = err
        _FN[name] = out
    return _FN[name]


def _prepare(q, k, v, key_mask, plan: SparsePlan):
    """Checks the kernels rely on, on CUDA tensors; returns inputs the
    kernels can read through their strides (a misaligned view is copied
    first) and the mask as contiguous fp32 [B, S], or None."""
    b, s, h, d = q.shape
    block = plan.block
    if q.dtype not in _DTYPE_CODES or d % 8 or not 8 <= d <= MAX_HEAD_DIM \
            or b * h > MAX_BATCH_HEADS:
        raise ValueError(
            f"sparse_attention kernels take float32, bfloat16 or float16, "
            f"head_dim a multiple of 8 in [8, {MAX_HEAD_DIM}] and at most "
            f"{MAX_BATCH_HEADS} batch x heads; got {q.dtype}, q "
            f"{tuple(q.shape)}")
    if block % BLOCK_MULTIPLE:
        raise ValueError(
            f"sparse_attention kernels take a layout block that is a "
            f"multiple of {BLOCK_MULTIPLE}; got block {block}")
    if plan.num_heads != h or plan.num_blocks * block != s:
        raise ValueError(
            f"layout of {plan.num_heads} heads x {plan.num_blocks} blocks "
            f"of {block} does not fit q {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    q, k, v = (t if _aligned(t) else t.contiguous() for t in (q, k, v))
    if key_mask is not None:
        if tuple(key_mask.shape) != (b, s):
            raise ValueError(f"key_mask shape {tuple(key_mask.shape)} != "
                             f"{(b, s)}")
        key_mask = key_mask.to(device=q.device,
                               dtype=torch.float32).contiguous()
    return q, k, v, key_mask


def _check(rc, what, name="sparse_attention"):
    if rc != 0:
        err = _kernel(name)["err"]
        raise RuntimeError(f"{name} {what} kernel launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")


def _on_cuda(q: torch.Tensor, what: str) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"sparse_attention {what} runs on CUDA or CPU "
                         f"tensors, got {q.device}")
    return True


def sparse_attention_fwd(q, k, v, key_mask, plan: SparsePlan, causal: bool,
                         scale: float):
    """Forward (kernel #8) on the kernel :func:`_route` picks: returns
    ``out`` (contiguous [B, S, H, D] in q's dtype) and ``lse`` (fp32 [B,
    H, S], natural log; -1e30 for a row with no visible key). On CUDA the
    inputs are as :func:`_prepare` returns them. The FMA kernel's launches
    count here (it takes no input the other routes refuse, so none does),
    the tensor-core kernels' in :func:`sparse_attention_fwd_tc`,
    :func:`sparse_attention_fwd_tc16` and :func:`sparse_attention_fwd_tf32`;
    on the CPU, the plain version (none counts)."""
    if not _on_cuda(q, "forward"):
        return sparse_fwd_reference(q, k, v, key_mask, plan, causal, scale)
    route = _route(q.dtype, q.shape[-1], plan.block)
    if route == "tc":
        return sparse_attention_fwd_tc(q, k, v, key_mask, plan, causal, scale)
    if route == "tc16":
        return sparse_attention_fwd_tc16(q, k, v, key_mask, plan, causal,
                                         scale)
    if route == "tf32":
        return sparse_attention_fwd_tf32(q, k, v, key_mask, plan, causal,
                                         scale)
    out, lse = _launch_fma_fwd(q, k, v, key_mask, plan, causal, scale)
    sparse_attention_fwd.launches += 1
    return out, lse


def _launch_fma_fwd(q, k, v, key_mask, plan, causal, scale):
    """The forward by the FMA kernel of ``csrc/sparse_attention.cu``, over
    the layout's index lists (any dtype the kernels take)."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    kv_idx, kv_cnt, _q_idx, _q_cnt = plan.on(q.device)
    fwd = _kernel()["fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                 kv_idx.data_ptr(), kv_cnt.data_ptr(), plan.max_kv,
                 out.data_ptr(), lse.data_ptr(), _strides(q, k, v), b, h, s,
                 d, plan.block, float(scale), int(causal),
                 _DTYPE_CODES[q.dtype], stream)
    _check(rc, "forward")
    return out, lse


def sparse_attention_fwd_tc(q, k, v, key_mask, plan: SparsePlan,
                            causal: bool, scale: float,
                            cap: Optional[int] = None):
    """The forward on the tensor cores (the walls of
    :func:`sparse_attention_bwd_dq_tc`), over dq's work list at ``cap``
    tiles (:data:`SPLIT_CAP` by default): a split tile's pieces leave fp32
    partials (o, m, l) that a second pass combines in piece order. Inputs
    and outputs as :func:`sparse_attention_fwd`."""
    _require_tc(q, plan, "forward")
    out, lse = _launch_tc_fwd(q, k, v, key_mask, plan, causal, scale, cap)
    sparse_attention_fwd_tc.launches += 1
    return out, lse


def sparse_attention_fwd_tc16(q, k, v, key_mask, plan: SparsePlan,
                              causal: bool, scale: float,
                              cap: Optional[int] = None):
    """The forward on the tensor cores over 16-row blocks (the walls of
    :func:`sparse_attention_bwd_dq_tc16`): a block of 4 warps owns up to 4
    query blocks of one head (dq's list, :meth:`SparsePlan.work16`), each
    warp an online softmax over the gathered key blocks its bit lists;
    walks longer than ``cap`` steps of 64 rows (:data:`SPLIT_CAP` by
    default) split, their pieces' fp32 partials (o, m, l) combined by a
    second pass in piece order. Inputs and outputs as
    :func:`sparse_attention_fwd`."""
    _require_tc16(q, plan, "forward")
    out, lse = _launch_tc_fwd(q, k, v, key_mask, plan, causal, scale, cap,
                              "sparse_attention_tc16")
    sparse_attention_fwd_tc16.launches += 1
    return out, lse


def sparse_attention_fwd_tf32(q, k, v, key_mask, plan: SparsePlan,
                              causal: bool, scale: float,
                              cap: Optional[int] = None):
    """The forward for float32 as 3xTF32 on the tensor cores (the walls of
    :func:`sparse_attention_bwd_dq_tf32`): a block of 4 warps owns up to
    4 query blocks of 16 rows of one head (dq's list,
    :meth:`SparsePlan.work16`), each warp a base-2 online softmax over the
    gathered key blocks its bit lists, its scores computed as dq computes
    them (q unscaled, the scale in the exponent); walks longer than
    ``cap`` steps of 64 rows (:data:`SPLIT_CAP` by default) split, their
    pieces' fp32 partials (o, m, l) combined by a second pass in piece
    order. Inputs and outputs as :func:`sparse_attention_fwd`."""
    _require_tf32(q, plan, "fwd")
    out, lse = _launch_tc_fwd(q, k, v, key_mask, plan, causal, scale, cap,
                              "sparse_attention_tf32")
    sparse_attention_fwd_tf32.launches += 1
    return out, lse


def _launch_tc_fwd(q, k, v, key_mask, plan, causal, scale, cap,
                   name="sparse_attention_tc"):
    """The forward by the tensor-core kernel of ``csrc/<name>.cu``
    (``sparse_attention_tc`` over dq's 64-row work list at ``cap``,
    ``sparse_attention_tc16`` and ``sparse_attention_tf32`` over its
    16-row one); a split walk's pieces leave fp32 (o, m, l) in scratch
    allocated here (64 rows an item either way)."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rows16 = name in _ROWS16
    work, items, tiles, splits = plan.work_on(q.device, "fwd", causal, cap,
                                              rows16=rows16)
    count = (work.n_items, work.walk_max) if rows16 else (work.n_items,)
    part = (torch.empty(b * work.n_slots * TC_TILE * (d + 2),
                        dtype=torch.float32, device=q.device)
            if work.n_split else None)
    fn = _kernel(name)["fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask),
                items.data_ptr(), tiles.data_ptr(), *count,
                out.data_ptr(), lse.data_ptr(), _strides(q, k, v), b, h, s,
                d, plan.block, float(scale), int(causal), _ptr(part),
                splits.data_ptr() if work.n_split else None, work.n_split,
                work.n_slots, _DTYPE_CODES[q.dtype], stream)
    _check(rc, "forward", name)
    return out, lse


def _launch_fma(which, q, k, v, dout, key_mask, lse, delta, plan, causal,
                scale):
    """dq (``which`` "dq") or dk, dv ("dkv") by the FMA kernels of
    ``csrc/sparse_attention.cu``, over the layout's index lists."""
    b, s, h, d = q.shape
    outs = [torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
            for _ in range(1 if which == "dq" else 2)]
    kv_idx, kv_cnt, q_idx, q_cnt = plan.on(q.device)
    idx, cnt, n = ((kv_idx, kv_cnt, plan.max_kv) if which == "dq" else
                   (q_idx, q_cnt, plan.max_q))
    fn = _kernel()[which]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                _ptr(key_mask), idx.data_ptr(), cnt.data_ptr(), n,
                lse.data_ptr(), delta.data_ptr(),
                *(t.data_ptr() for t in outs), _strides(q, k, v), b, h, s,
                d, plan.block, float(scale), int(causal),
                _DTYPE_CODES[q.dtype], stream)
    _check(rc, which)
    return outs[0] if which == "dq" else tuple(outs)


def _launch_tc(which, q, k, v, dout, key_mask, lse, delta, plan, causal,
               scale, cap, name="sparse_attention_tc"):
    """dq or dk, dv by the tensor-core kernels of ``csrc/<name>.cu``
    (``sparse_attention_tc`` over the plan's 64-row work list at ``cap``,
    ``sparse_attention_tc16`` and ``sparse_attention_tf32`` over its 16-row
    one); the split walks' fp32 partials (64 rows an item either way) go to
    scratch allocated here."""
    b, s, h, d = q.shape
    nout = 1 if which == "dq" else 2
    outs = [torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
            for _ in range(nout)]
    rows16 = name in _ROWS16
    work, items, tiles, splits = plan.work_on(q.device, which, causal, cap,
                                              rows16=rows16)
    count = (work.n_items, work.walk_max) if rows16 else (work.n_items,)
    part = (torch.empty((b, work.n_slots, nout, TC_TILE, d),
                        dtype=torch.float32, device=q.device)
            if work.n_split else None)
    fn = _kernel(name)[which]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                _ptr(key_mask), items.data_ptr(), tiles.data_ptr(),
                *count, lse.data_ptr(), delta.data_ptr(),
                *(t.data_ptr() for t in outs), _strides(q, k, v), b, h, s,
                d, plan.block, float(scale), int(causal), _ptr(part),
                splits.data_ptr() if work.n_split else None, work.n_split,
                work.n_slots, _DTYPE_CODES[q.dtype], stream)
    _check(rc, which, name)
    return outs[0] if which == "dq" else tuple(outs)


def _require_tc(q, plan: SparsePlan, what: str):
    """The tensor-core wrappers' walls: inputs of their route, on CUDA."""
    if _route(q.dtype, q.shape[-1], plan.block) != "tc":
        raise ValueError(
            f"the tensor-core sparse {what} kernel takes bfloat16 or "
            f"float16 with head_dim a multiple of 8 in [8, {MAX_HEAD_DIM}] "
            f"and a layout block that is a multiple of {TC_TILE}; got "
            f"{q.dtype}, head_dim {q.shape[-1]}, block {plan.block}")
    if q.device.type != "cuda":
        raise ValueError(f"the tensor-core sparse {what} kernel runs on "
                         f"CUDA tensors, got {q.device}")


def _require_tc16(q, plan: SparsePlan, what: str):
    """The 16-row tensor-core wrappers' walls: inputs of their route, on
    CUDA."""
    if _route(q.dtype, q.shape[-1], plan.block) != "tc16":
        raise ValueError(
            f"the 16-row tensor-core sparse {what} kernel takes bfloat16 or "
            f"float16 with head_dim a multiple of 8 in [8, {MAX_HEAD_DIM}] "
            f"and a layout block that is a multiple of {SUB_TILE} and not "
            f"of {TC_TILE}; got {q.dtype}, head_dim {q.shape[-1]}, block "
            f"{plan.block}")
    if q.device.type != "cuda":
        raise ValueError(f"the 16-row tensor-core sparse {what} kernel "
                         f"runs on CUDA tensors, got {q.device}")


def _require_tf32(q, plan: SparsePlan, what: str):
    """The 3xTF32 wrappers' walls: inputs of their route, on CUDA."""
    if _route(q.dtype, q.shape[-1], plan.block, what) != "tf32":
        raise ValueError(
            f"the 3xTF32 sparse {what} kernel takes float32 with head_dim a "
            f"multiple of 8 in [8, {MAX_HEAD_DIM}] and a layout block that "
            f"is a multiple of {SUB_TILE}; got {q.dtype}, head_dim "
            f"{q.shape[-1]}, block {plan.block}")
    if q.device.type != "cuda":
        raise ValueError(f"the 3xTF32 sparse {what} kernel runs on CUDA "
                         f"tensors, got {q.device}")


def sparse_attention_bwd_dq(q, k, v, dout, key_mask, lse, delta,
                            plan: SparsePlan, causal: bool, scale: float):
    """dq (kernel #9) on the kernel :func:`_route` picks: ``dout``
    contiguous [B, S, H, D]; ``lse`` and ``delta`` fp32 [B, H, S].
    Returns dq, contiguous [B, S, H, D]. The FMA kernel's launches count
    here, the tensor-core kernels' in :func:`sparse_attention_bwd_dq_tc`,
    :func:`sparse_attention_bwd_dq_tc16` and
    :func:`sparse_attention_bwd_dq_tf32`; on the CPU, the plain version
    (none counts)."""
    if not _on_cuda(q, "dq"):
        return sparse_bwd_dq_reference(q, k, v, dout, key_mask, lse, delta,
                                       plan, causal, scale)
    route = _route(q.dtype, q.shape[-1], plan.block, "dq")
    if route == "tc":
        return sparse_attention_bwd_dq_tc(q, k, v, dout, key_mask, lse,
                                          delta, plan, causal, scale)
    if route == "tc16":
        return sparse_attention_bwd_dq_tc16(q, k, v, dout, key_mask, lse,
                                            delta, plan, causal, scale)
    if route == "tf32":
        return sparse_attention_bwd_dq_tf32(q, k, v, dout, key_mask, lse,
                                            delta, plan, causal, scale)
    dq = _launch_fma("dq", q, k, v, dout, key_mask, lse, delta, plan,
                     causal, scale)
    sparse_attention_bwd_dq.launches += 1
    return dq


def sparse_attention_bwd_dq_tc(q, k, v, dout, key_mask, lse, delta,
                               plan: SparsePlan, causal: bool, scale: float,
                               cap: Optional[int] = None):
    """dq on the tensor cores (bfloat16 or float16, ``head_dim`` a
    multiple of 8 up to 128, a layout block that is a multiple of 64, CUDA
    tensors; anything else raises ValueError). Walks cut at ``cap`` tiles
    (:data:`SPLIT_CAP` by default). Inputs and output as
    :func:`sparse_attention_bwd_dq`."""
    _require_tc(q, plan, "dq")
    dq = _launch_tc("dq", q, k, v, dout, key_mask, lse, delta, plan, causal,
                    scale, cap)
    sparse_attention_bwd_dq_tc.launches += 1
    return dq


def sparse_attention_bwd_dq_tc16(q, k, v, dout, key_mask, lse, delta,
                                 plan: SparsePlan, causal: bool,
                                 scale: float, cap: Optional[int] = None):
    """dq on the tensor cores over 16-row blocks (bfloat16 or float16,
    ``head_dim`` a multiple of 8 up to 128, a layout block that is a
    multiple of 16 and not of 64, CUDA tensors; anything else raises
    ValueError): a block of 4 warps owns up to 4 query blocks of one head
    (:meth:`SparsePlan.work16`) and streams 4 gathered key blocks a step;
    walks longer than ``cap`` steps (:data:`SPLIT_CAP` by default) split.
    Inputs and output as :func:`sparse_attention_bwd_dq`."""
    _require_tc16(q, plan, "dq")
    dq = _launch_tc("dq", q, k, v, dout, key_mask, lse, delta, plan, causal,
                    scale, cap, "sparse_attention_tc16")
    sparse_attention_bwd_dq_tc16.launches += 1
    return dq


def sparse_attention_bwd_dkv(q, k, v, dout, key_mask, lse, delta,
                             plan: SparsePlan, causal: bool, scale: float):
    """dk and dv (kernel #10) on the kernel :func:`_route` picks,
    walking the transposed lists. Returns dk, dv, contiguous [B, S, H, D].
    The FMA kernel's launches count here, the tensor-core kernels' in
    :func:`sparse_attention_bwd_dkv_tc`,
    :func:`sparse_attention_bwd_dkv_tc16` and
    :func:`sparse_attention_bwd_dkv_tf32`; on the CPU, the plain
    version."""
    if not _on_cuda(q, "dkv"):
        return sparse_bwd_dkv_reference(q, k, v, dout, key_mask, lse, delta,
                                        plan, causal, scale)
    route = _route(q.dtype, q.shape[-1], plan.block, "dkv")
    if route == "tc":
        return sparse_attention_bwd_dkv_tc(q, k, v, dout, key_mask, lse,
                                           delta, plan, causal, scale)
    if route == "tc16":
        return sparse_attention_bwd_dkv_tc16(q, k, v, dout, key_mask, lse,
                                             delta, plan, causal, scale)
    if route == "tf32":
        return sparse_attention_bwd_dkv_tf32(q, k, v, dout, key_mask, lse,
                                             delta, plan, causal, scale)
    dk, dv = _launch_fma("dkv", q, k, v, dout, key_mask, lse, delta, plan,
                         causal, scale)
    sparse_attention_bwd_dkv.launches += 1
    return dk, dv


def sparse_attention_bwd_dkv_tc(q, k, v, dout, key_mask, lse, delta,
                                plan: SparsePlan, causal: bool,
                                scale: float, cap: Optional[int] = None):
    """dk and dv on the tensor cores (the walls of
    :func:`sparse_attention_bwd_dq_tc`); a key tile's walk longer than
    ``cap`` tiles is split, its pieces summed by a second pass in piece
    order. Inputs and outputs as :func:`sparse_attention_bwd_dkv`."""
    _require_tc(q, plan, "dkv")
    dk, dv = _launch_tc("dkv", q, k, v, dout, key_mask, lse, delta, plan,
                        causal, scale, cap)
    sparse_attention_bwd_dkv_tc.launches += 1
    return dk, dv


def sparse_attention_bwd_dkv_tc16(q, k, v, dout, key_mask, lse, delta,
                                  plan: SparsePlan, causal: bool,
                                  scale: float, cap: Optional[int] = None):
    """dk and dv on the tensor cores over 16-row blocks (the walls of
    :func:`sparse_attention_bwd_dq_tc16`): a block of 4 warps owns up to 4
    key blocks of one head, grouped by equal lists, and streams gathered
    query blocks with their dO, lse and delta; a walk longer than ``cap``
    steps splits, its pieces summed by a second pass in piece order.
    Inputs and outputs as :func:`sparse_attention_bwd_dkv`."""
    _require_tc16(q, plan, "dkv")
    dk, dv = _launch_tc("dkv", q, k, v, dout, key_mask, lse, delta, plan,
                        causal, scale, cap, "sparse_attention_tc16")
    sparse_attention_bwd_dkv_tc16.launches += 1
    return dk, dv


def sparse_attention_bwd_dq_tf32(q, k, v, dout, key_mask, lse, delta,
                                 plan: SparsePlan, causal: bool,
                                 scale: float, cap: Optional[int] = None):
    """dq for float32 as 3xTF32 on the tensor cores (``head_dim`` a
    multiple of 8 up to 128, any layout block that is a multiple of 16,
    CUDA tensors; anything else raises ValueError): a block of 4 warps
    owns up to 4 query blocks of 16 rows of one head
    (:meth:`SparsePlan.work16`) and streams one gathered key block a step;
    walks longer than ``cap`` steps of 64 rows (:data:`SPLIT_CAP` by
    default) split, their pieces summed by a second pass in piece order.
    Inputs and output as :func:`sparse_attention_bwd_dq`."""
    _require_tf32(q, plan, "dq")
    dq = _launch_tc("dq", q, k, v, dout, key_mask, lse, delta, plan, causal,
                    scale, cap, "sparse_attention_tf32")
    sparse_attention_bwd_dq_tf32.launches += 1
    return dq


def sparse_attention_bwd_dkv_tf32(q, k, v, dout, key_mask, lse, delta,
                                  plan: SparsePlan, causal: bool,
                                  scale: float, cap: Optional[int] = None):
    """dk and dv for float32 as 3xTF32 on the tensor cores (the walls of
    :func:`sparse_attention_bwd_dq_tf32`): a block of 4 warps owns up to 4
    key blocks of 16 rows of one head, grouped by equal lists, and streams
    gathered query blocks with their dO, lse and delta; a walk longer than
    ``cap`` steps splits, its pieces summed by a second pass in piece
    order. Inputs and outputs as :func:`sparse_attention_bwd_dkv`."""
    _require_tf32(q, plan, "dkv")
    dk, dv = _launch_tc("dkv", q, k, v, dout, key_mask, lse, delta, plan,
                        causal, scale, cap, "sparse_attention_tf32")
    sparse_attention_bwd_dkv_tf32.launches += 1
    return dk, dv


sparse_attention_fwd.launches = 0
sparse_attention_fwd_tc.launches = 0
sparse_attention_fwd_tc16.launches = 0
sparse_attention_bwd_dq.launches = 0
sparse_attention_bwd_dq_tc.launches = 0
sparse_attention_bwd_dkv.launches = 0
sparse_attention_bwd_dkv_tc.launches = 0
sparse_attention_bwd_dq_tc16.launches = 0
sparse_attention_bwd_dkv_tc16.launches = 0
sparse_attention_fwd_tf32.launches = 0
sparse_attention_bwd_dq_tf32.launches = 0
sparse_attention_bwd_dkv_tf32.launches = 0


class _SparseAttention(torch.autograd.Function):
    """The kernels with their gradient (the JAX ``_sparse_vjp_fn``): the
    forward saves ``out`` and ``lse``; the backward takes ``delta =
    rowsum(dO * out)`` in fp32 from the output in its dtype, then runs dq
    and dk/dv on the routes :func:`_route` picks for them (for float32 all
    three on the 3xTF32 kernels, dq and dk/dv over the lse of scores
    computed as they compute them)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, plan, causal, scale):
        if q.device.type == "cuda":
            q, k, v, key_mask = _prepare(q, k, v, key_mask, plan)
        out, lse = sparse_attention_fwd(q, k, v, key_mask, plan, causal,
                                        scale)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.plan, ctx.causal, ctx.scale = plan, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()                       # [B, H, S]
        args = (key_mask, lse, delta, ctx.plan, ctx.causal, ctx.scale)
        dq = sparse_attention_bwd_dq(q, k, v, dout, *args)
        dk, dv = sparse_attention_bwd_dkv(q, k, v, dout, *args)
        return dq, dk, dv, None, None, None, None


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout, block: int, *, causal: bool = False,
                     softmax_scale: Optional[float] = None,
                     impl: str = "auto",
                     key_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Block-sparse attention over [B, S, H, D] with an [H, B, B] layout.

    ``key_mask``: optional [B, S] key-padding mask (1 = keep): masked keys
    drop out of every row. ``impl``: "auto" or "pallas" run the kernels
    (their plain versions on a CPU tensor); "xla" the dense masked path.
    Differentiable in q, k and v."""
    s = q.shape[1]
    if s % block:
        raise ValueError(f"seq {s} not divisible by block {block}")
    if np.asarray(layout).shape[1] != s // block:
        raise ValueError(f"layout has {np.asarray(layout).shape[1]} blocks, "
                         f"sequence needs {s // block}")
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / (q.shape[-1] ** 0.5))
    if impl == "xla":
        return _xla_sparse(q, k, v, layout, block, causal, scale, key_mask)
    if impl in ("auto", "pallas"):
        _on_cuda(q, "attention")
        return _SparseAttention.apply(q, k, v, key_mask,
                                      sparse_plan(layout, block),
                                      bool(causal), float(scale))
    raise ValueError(f"unknown sparse attention impl '{impl}' (one of "
                     f"{IMPLS})")


class SparseSelfAttention:
    """Layout-bound attention callable (reference
    ops/sparse_attention/sparse_self_attention.py:14): construct once with
    a SparsityConfig, call with q/k/v [B, S, H, D]. The layout of each
    sequence length is made once and kept."""

    def __init__(self, sparsity_config, max_seq_length: int = 2048,
                 attn_mask_mode: str = "mul", impl: str = "auto"):
        self.sparsity_config = sparsity_config
        self.max_seq_length = max_seq_length
        self.impl = impl
        self._layouts = {}

    def layout(self, seq_len: int):
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def __call__(self, q, k, v, *, causal: Optional[bool] = None,
                 key_mask: Optional[torch.Tensor] = None,
                 softmax_scale: Optional[float] = None):
        if causal is None:
            causal = getattr(self.sparsity_config, "attention",
                             "bidirectional") == "unidirectional"
        return sparse_attention(q, k, v, self.layout(q.shape[1]),
                                self.sparsity_config.block, causal=causal,
                                softmax_scale=softmax_scale,
                                key_mask=key_mask, impl=self.impl)


def pad_to_block_size(x: torch.Tensor, block: int, axis: int = 1):
    """Right-pad the seq axis to a block multiple with zeros; returns
    ``(padded, pad_len)``."""
    s = x.shape[axis]
    pad = (-s) % block
    if pad == 0:
        return x, 0
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis % x.dim()) + 1] = pad
    return F.pad(x, widths), pad

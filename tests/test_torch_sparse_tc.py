"""The tensor-core block-sparse backward's route, work lists and split
(deepspeed_tpu_torch.ops.sparse_attention).

``csrc/sparse_attention_tc.cu`` (dq and dk/dv for bfloat16 and float16 at
layout blocks that are multiples of 64) runs only on the card, where
``chip_smoke.py`` holds it against the plain versions. Here, on the CPU:

- the work lists the host builds for it (``SparsePlan.work``) at the long
  path's layout (BigBird block 256, causal, 12 heads, seq 16384): every
  visible (head, row tile, column tile) pair in exactly one piece, pieces
  of consecutive entries in ascending order and no longer than the cap,
  items longest first, the global column's walks split, dq's rows not;
- a plain piecewise version of the kernels' arithmetic (each item's fp32
  partial over its run of tiles, the split tiles' pieces summed in piece
  order) against the JAX kernels ``_sparse_bwd_dq_kernel`` and
  ``_sparse_bwd_dkv_kernel`` (interpret), fp32 atol 1e-5: the split
  computes the same function;
- which inputs ``_route`` sends to the tensor cores, the ``_tc``
  wrappers' walls, and the dispatching wrappers' plain path on the CPU;
- that a kernel's build is named by every ``csrc/`` header it reaches,
  nested ones too.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jax_sc
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config_from_dict

torch.set_num_threads(1)

# The packages export a function of the module's name: import the modules.
jax_ops = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.sparse_attention")
sp = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention")

ATOL = 1e-5
TILE = 64
# bench.py:bench_gpt2_long's layout (chip_smoke.py's SPARSE_LONG)
LONG = {"mode": "bigbird", "block": 256, "num_random_blocks": 1,
        "num_sliding_window_blocks": 3, "num_global_blocks": 1,
        "attention": "unidirectional"}
LONG_HEADS, LONG_SEQ = 12, 16384


@pytest.fixture(scope="module")
def long_plan():
    layout = sparsity_config_from_dict(LONG, LONG_HEADS).make_layout(
        LONG_SEQ)
    return sp.SparsePlan(layout, LONG["block"])


def _visible_tiles(layout, block, which, causal):
    """{(head, row tile's first row): sorted first rows of the column
    tiles with a visible pair}, from the layout alone."""
    lay = layout if which == "dq" else layout.transpose(0, 2, 1)
    h, nb, _ = lay.shape
    per = block // TILE
    out = {}
    for hh in range(h):
        for rt in range(nb * per):
            row0 = rt * TILE
            cols = [ct * TILE for ct in range(nb * per)
                    if lay[hh, row0 // block, ct * TILE // block]]
            if causal:   # a visible pair needs key <= query
                cols = [c for c in cols
                        if (c <= row0 if which == "dq" else c >= row0)]
            out[(hh, row0)] = cols
    return out


def _runs(work):
    """{(head, first row): [run of each piece, in piece order]} from a
    work list (a split tile's pieces hold consecutive slots)."""
    first = {(h, r): f for h, r, f, _n in work.splits.tolist()}
    runs = {}
    for h, row0, off, cnt, slot in work.items.tolist():
        piece = 0 if slot < 0 else slot - first[(h, row0)]
        runs.setdefault((h, row0), {})[piece] = work.tiles[off:off + cnt]
    return {key: [d[p] for p in sorted(d)] for key, d in runs.items()}


@pytest.mark.parametrize("cap", [4, 16, 32, sp.SPLIT_CAP])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_work_lists_cover_every_visible_tile_once(long_plan, which, cap):
    work = long_plan.work(which, True, cap)
    want = _visible_tiles(long_plan.layout, long_plan.block, which, True)
    runs = _runs(work)
    assert set(runs) == set(want)              # every (head, row tile)
    for key, pieces in runs.items():
        walk = np.concatenate(pieces).tolist()
        assert walk == want[key], key          # once each, ascending
        assert all(len(p) <= cap for p in pieces)
        assert len(pieces) == max(1, -(-len(walk) // cap))
        if len(pieces) > 1:                     # within one of each other
            assert max(map(len, pieces)) - min(map(len, pieces)) <= 1
    counts = work.items[:, 3]
    assert (np.diff(counts) <= 0).all()        # longest first
    assert work.longest <= cap
    assert work.n_slots == int(work.splits[:, 3].sum())
    slots = sorted(s for s in work.items[:, 4].tolist() if s >= 0)
    assert slots == list(range(work.n_slots))  # each slot once
    assert len(work.tiles) == sum(len(w) for w in want.values())


def test_global_column_splits_and_dq_rows_do_not(long_plan):
    """Column 0 (the global block every query block attends): its 4 key
    tiles walk 256, 255, 254 and 253 query tiles in every head, cut into
    ceil(len / C) pieces; the unidirectional layout's dq rows walk at most
    16 tiles, so at the default cap nothing splits in dq."""
    cap = sp.SPLIT_CAP
    runs = _runs(long_plan.work("dkv", True, cap))
    for h in range(LONG_HEADS):
        for t, length in enumerate((256, 255, 254, 253)):
            pieces = runs[(h, t * TILE)]
            assert sum(map(len, pieces)) == length
            assert len(pieces) == -(-length // cap)
    dq = long_plan.work("dq", True, cap)
    assert cap >= 16 and dq.longest == 16 and dq.n_split == 0
    assert (dq.items[:, 4] == -1).all()
    nosplit = long_plan.work("dkv", True, LONG_SEQ // TILE)
    assert nosplit.n_split == 0 and nosplit.longest == 256


def test_bidirectional_global_rows_split_in_dq():
    cfg = dict(LONG, block=64, attention="bidirectional")
    layout = sparsity_config_from_dict(cfg, 2).make_layout(2048)
    plan = sp.SparsePlan(layout, 64)
    work = plan.work("dq", False, 4)
    runs = _runs(work)
    assert all(len(runs[(h, 0)]) == 8 for h in range(2))   # 32 tiles / 4
    assert work.longest == 4 and work.n_split >= 2
    with pytest.raises(ValueError, match="cap"):
        plan.work("dq", False, 0)
    with pytest.raises(ValueError, match="multiple of 64"):
        sp.SparsePlan(np.ones((1, 4, 4), np.int8), 32).work("dq", True)


def test_work_lists_cached_per_cap(long_plan):
    a = long_plan.work("dkv", True)
    assert long_plan.work("dkv", True, sp.SPLIT_CAP) is a
    assert long_plan.work("dkv", True, 8) is not a
    assert long_plan.work("dkv", False) is not a


# ---------------------------------------------------------------------------
# the split computes the same function: a plain piecewise version against
# the JAX kernels
# ---------------------------------------------------------------------------

def _piecewise(which, q, k, v, do, mask, lse, delta, plan, causal, scale,
               cap):
    """The tensor-core kernels' work in plain fp32 PyTorch: each item's
    partial sums over its run of 64-row tiles (p = exp(s - max(lse,
    -5e29)) on visible pairs, ds = p (dp - delta)); an unsplit tile's sums
    are its output, a split tile's pieces go to scratch and are summed in
    piece order. dq and dk carry the scale once, at the end. q, k, v, do
    [B, S, H, D]; lse, delta [B, H, S]."""
    work = plan.work(which, causal, cap)
    b, _s, _h, d = q.shape
    nout = 1 if which == "dq" else 2
    outs = [torch.zeros_like(q) for _ in range(nout)]
    part = torch.full((b, work.n_slots, nout, TILE, d), float("nan"))
    lse = lse.clamp_min(sp.LSE_FLOOR)
    ar = torch.arange(TILE)
    for h, row0, off, cnt, slot in work.items.tolist():
        acc = torch.zeros(nout, b, TILE, d)
        for t0 in work.tiles[off:off + cnt].tolist():
            qr, kr = (row0, t0) if which == "dq" else (t0, row0)
            qi, kj = qr + ar, kr + ar
            s = torch.einsum("bid,bjd->bij", q[:, qi, h], k[:, kj, h]) * scale
            vis = torch.ones(b, TILE, TILE, dtype=torch.bool)
            if causal:
                vis &= (kj[None, :] <= qi[:, None])[None]
            if mask is not None:
                vis &= (mask[:, kj] > 0)[:, None, :]
            p = torch.where(vis, torch.exp(s - lse[:, h, qi, None]),
                            torch.zeros(()))
            dp = torch.einsum("bid,bjd->bij", do[:, qi, h], v[:, kj, h])
            ds = p * (dp - delta[:, h, qi, None])
            if which == "dq":
                acc[0] += torch.einsum("bij,bjd->bid", ds, k[:, kj, h])
            else:
                acc[0] += torch.einsum("bij,bid->bjd", ds, q[:, qi, h])
                acc[1] += torch.einsum("bij,bid->bjd", p, do[:, qi, h])
        if slot >= 0:
            part[:, slot] = acc.transpose(0, 1)
        else:
            for o in range(nout):
                outs[o][:, row0:row0 + TILE, h] = acc[o] * (
                    scale if o == 0 else 1.0)
    for h, row0, first, count in work.splits.tolist():
        total = torch.zeros(b, nout, TILE, d)
        for p in range(count):
            total = total + part[:, first + p]
        for o in range(nout):
            outs[o][:, row0:row0 + TILE, h] = total[:, o] * (
                scale if o == 0 else 1.0)
    return outs


@pytest.mark.parametrize("attention,masked", [("unidirectional", False),
                                              ("bidirectional", True)])
def test_piecewise_split_matches_jax_kernels(attention, masked):
    """S 512, block 64, H 2, D 32, cap 3 (the global row and column walk 8
    tiles: 3 pieces): dq, dk and dv of the piecewise version, fed JAX's
    forward's lse and delta, against JAX's backward kernels (interpret),
    fp32 atol 1e-5. With the key mask, batch row 1 is all padding: its
    dq, dk and dv are exactly 0."""
    b, s, h, d, block, cap = 2, 512, 2, 32, 64, 3
    causal = attention == "unidirectional"
    cfg = jax_sc.BigBirdSparsityConfig(h, block, num_random_blocks=1,
                                       attention=attention, rng_seed=21)
    layout = cfg.make_layout(s)
    rng = np.random.default_rng(12 + masked)
    q, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((b, s), np.float32)
        mask[0, s - 37:] = 0
        mask[1] = 0
    scale = 1.0 / d ** 0.5

    def bhsd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)

    def back(x):
        return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)

    kv_idx, _ = jax_ops.layout_kv_indices(layout)
    q_idx, _ = jax_ops.layout_q_indices(layout)
    kv_cnt = jnp.asarray(layout.sum(-1).astype(np.int32))
    q_cnt = jnp.asarray(layout.sum(-2).astype(np.int32))
    mf = None if mask is None else jnp.asarray(mask)[:, None, :]
    jo, jlse = jax_ops._sparse_forward(
        bhsd(q), bhsd(k), bhsd(v), mf, jnp.asarray(kv_idx), kv_cnt, block,
        causal, scale, h, True)
    jdq, jdk, jdv = jax_ops._sparse_backward(
        bhsd(q), bhsd(k), bhsd(v), mf, bhsd(do), jo, jlse,
        jnp.asarray(kv_idx), kv_cnt, jnp.asarray(q_idx), q_cnt, block,
        causal, scale, h, True)

    plan = sp.SparsePlan(layout, block)
    assert plan.work("dq" if not causal else "dkv", causal, cap).n_split
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse)[..., 0].reshape(b, h, s))
    out = torch.from_numpy(back(jo).copy())
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, tdo, tm, lse, delta, plan, causal, scale, cap)
    (dq,) = _piecewise("dq", *args)
    dk, dv = _piecewise("dkv", *args)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), back(want), atol=ATOL,
                                   rtol=0, err_msg=name)
    if masked:
        assert not any(t[1].any() for t in (dq, dk, dv))


# ---------------------------------------------------------------------------
# routing and walls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,head_dim,block,route", [
    (torch.bfloat16, 64, 256, "tc"), (torch.float16, 64, 256, "tc"),
    (torch.bfloat16, 64, 64, "tc"), (torch.float16, 128, 128, "tc"),
    (torch.bfloat16, 8, 64, "tc"), (torch.float16, 72, 192, "tc"),
    (torch.float32, 64, 256, "tf32"), (torch.float32, 128, 64, "tf32"),
    (torch.bfloat16, 64, 16, "tc16"), (torch.float16, 64, 32, "tc16"),
    (torch.bfloat16, 64, 96, "tc16"), (torch.bfloat16, 136, 256, "fma"),
    (torch.float16, 60, 64, "fma")])
def test_route(dtype, head_dim, block, route):
    """16-bit types at head dims the kernels take and blocks that are
    multiples of 64 go to the 64-row tensor-core kernels, other multiples
    of 16 (16, 32, 96; the reference's default is 16) to the 16-row ones;
    fp32 to the 3xTF32 kernels; head dims off the grid to the FMA
    kernels."""
    assert sp._route(dtype, head_dim, block) == route


def _inputs(dtype, block, s=128, h=2, d=16, b=1):
    layout = np.ones((h, s // block, s // block), np.int8)
    plan = sp.sparse_plan(layout, block)
    g = torch.Generator().manual_seed(block)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g).to(dtype)
                   for _ in range(4))
    lse = torch.zeros(b, h, s)
    delta = torch.zeros(b, h, s)
    return q, k, v, do, None, lse, delta, plan, True, d ** -0.5


WRAPPERS = ("sparse_attention_bwd_dq", "sparse_attention_bwd_dkv",
            "sparse_attention_bwd_dq_tc", "sparse_attention_bwd_dkv_tc",
            "sparse_attention_fwd")


def _counts():
    return [getattr(sp, n).launches for n in WRAPPERS]


@pytest.mark.parametrize("dtype,block,match", [
    (torch.float32, 64, "takes bfloat16 or float16"),
    (torch.bfloat16, 32, "multiple of 64"),
    (torch.bfloat16, 64, "runs on CUDA tensors")])
def test_tc_wrappers_refuse_and_count_nothing(dtype, block, match):
    """FMA-route inputs and CPU tensors raise ValueError before any launch;
    nothing falls back."""
    args = _inputs(dtype, block)
    before = _counts()
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_bwd_dq_tc(*args)
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_bwd_dkv_tc(*args, cap=4)
    assert _counts() == before


@pytest.mark.parametrize("dtype,block", [(torch.bfloat16, 64),
                                         (torch.float16, 64),
                                         (torch.float32, 64),
                                         (torch.bfloat16, 32)])
def test_dispatch_on_cpu_runs_the_plain_versions(dtype, block):
    """On CPU tensors the dispatching wrappers return the plain versions'
    results, whichever route the inputs would take on the card, and count
    neither route."""
    args = _inputs(dtype, block)
    before = _counts()
    dq = sp.sparse_attention_bwd_dq(*args)
    dk, dv = sp.sparse_attention_bwd_dkv(*args)
    assert _counts() == before
    assert torch.equal(dq, sp.sparse_bwd_dq_reference(*args))
    want_dk, want_dv = sp.sparse_bwd_dkv_reference(*args)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    assert dq.dtype == dtype and dk.dtype == dtype


def test_missing_nvcc_raises_for_tc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("sparse_attention_tc")
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the build's name follows nested headers
# ---------------------------------------------------------------------------

def test_library_path_hashes_nested_headers(monkeypatch, tmp_path):
    """k.cu includes outer.cuh, which includes inner.cuh (which includes
    outer.cuh back: a cycle): an edit to inner.cuh alone renames the
    build; the name is stable while nothing changes."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "outer.cuh"\nint k;\n')
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text('#pragma once\n#include "outer.cuh"\n'
                                    'constexpr int X = 1;\n')
    monkeypatch.setattr(build, "CSRC", str(csrc))
    first = build.library_path("k")
    assert build.library_path("k") == first
    (csrc / "inner.cuh").write_text('#pragma once\n#include "outer.cuh"\n'
                                    'constexpr int X = 2;\n')
    second = build.library_path("k")
    assert second != first
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                    '// edited\n')
    assert build.library_path("k") not in (first, second)


def test_real_sources_reach_their_nested_headers():
    """sparse_attention_tc.cu reaches attention_tile.cuh only through
    attention_tc.cuh; both enter its build's name."""
    with open(f"{build.CSRC}/sparse_attention_tc.cu", "rb") as f:
        heads = build._headers(f.read())
    names = []
    for name in ("attention_tc.cuh", "attention_tile.cuh"):
        with open(f"{build.CSRC}/{name}", "rb") as f:
            names.append(f.read())
    assert heads == names

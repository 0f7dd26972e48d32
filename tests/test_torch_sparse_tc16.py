"""The 16-row tensor-core block-sparse backward's route, work lists and split
(deepspeed_tpu_torch.ops.sparse_attention).

``csrc/sparse_attention_tc16.cu`` (dq and dk/dv for bfloat16 and float16
at layout blocks that are multiples of 16 and not of 64) runs only on the
card, where ``chip_smoke.py`` holds it against the plain versions. Here,
on the CPU:

- the work lists the host builds for it (``SparsePlan.work16``) at the
  reference documentation's fixed block-16 layout with a pattern per head
  (the sparse BERT path's), a BigBird block-16 layout and block-32
  layouts, causal and not: every visible (head, 16-row block, 16-row
  block) pair in exactly one piece, every block owned by exactly one
  item, pieces no longer than the cap, items longest first, and no warp
  masked off a step at the sparse BERT layout;
- a plain piecewise version of the kernels' arithmetic (each warp's fp32
  partials over the gathered 16-row blocks its bit lists, 4 entries a
  step, split pieces summed in piece order) against the JAX kernels
  ``_sparse_bwd_dq_kernel`` and ``_sparse_bwd_dkv_kernel`` (interpret),
  fp32 atol 1e-5, with a key mask that leaves one batch row all padding;
- which inputs ``_route_bwd`` sends to the 16-row kernels (fp32: the
  3xTF32 ones), the ``_tc16`` wrappers' walls, and the dispatching
  wrappers' plain path on the CPU (the 16-row forward:
  ``tests/test_torch_sparse_fwd_tc16.py``).
"""

import collections
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
SUB = 16
# the reference's configuration documentation's example (chip_smoke.py's
# BERT_SPARSE, trained at seq 512 with 16 heads)
BERT_SPARSE = {"mode": "fixed", "block": 16,
               "different_layout_per_head": True, "num_local_blocks": 4,
               "num_global_blocks": 1, "attention": "bidirectional",
               "horizontal_global_attention": False,
               "num_different_global_patterns": 4}
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1,
           "attention": "bidirectional"}
LAYOUTS = {"bert_sparse": (BERT_SPARSE, 16, 512),
           "bigbird16": (dict(BIGBIRD, rng_seed=161), 4, 512),
           "bigbird32": (dict(BIGBIRD, block=32, rng_seed=162), 4, 512),
           "fixed32": ({"mode": "fixed", "block": 32,
                        "num_local_blocks": 2}, 2, 512)}


@pytest.fixture(scope="module")
def plans():
    return {name: sp.SparsePlan(
        sparsity_config_from_dict(cfg, h).make_layout(s), cfg["block"])
        for name, (cfg, h, s) in LAYOUTS.items()}


def _visible(layout, block, which, causal):
    """{(head, own 16-row block's first row, other block's first row)}
    with a visible pair, from the layout alone."""
    lay = layout if which == "dq" else layout.transpose(0, 2, 1)
    h, nb, _ = lay.shape
    rows = range(0, nb * block, SUB)
    out = set()
    for hh in range(h):
        for r0 in rows:
            for c0 in rows:
                if not lay[hh, r0 // block, c0 // block]:
                    continue
                if causal and not (c0 <= r0 if which == "dq" else c0 >= r0):
                    continue
                out.add((hh, r0, c0))
    return out


@pytest.mark.parametrize("cap", [1, 2, sp.SPLIT_CAP])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_work16_covers_every_visible_pair_once(plans, name, which, causal,
                                               cap):
    plan = plans[name]
    work = plan.work16(which, causal, cap)
    got = collections.Counter()
    owners = collections.Counter()
    pieces = collections.defaultdict(list)
    for h, r0, r1, r2, r3, off, cnt, slot in work.items.tolist():
        rows = (r0, r1, r2, r3)
        ents = work.tiles[off:off + cnt]
        assert (np.diff(ents[:, 0]) > 0).all()          # ascending, once
        for row_e, bits in ents.tolist():
            assert bits and bits < 16
            for w, rw in enumerate(rows):
                if bits >> w & 1:
                    assert rw >= 0                       # owned warps only
                    got[(h, rw, row_e)] += 1
        pieces[(h, rows)].append((slot, cnt))
        assert -(-cnt // sp.WARPS) <= cap               # in 64-row steps
    for (h, rows), ps in pieces.items():
        owners.update((h, r) for r in rows if r >= 0)
        if len(ps) > 1:                                  # a split walk
            ps.sort()
            assert all(c % sp.WARPS == 0 for _s, c in ps[:-1])
            steps = [-(-c // sp.WARPS) for _s, c in ps]
            assert max(steps) - min(steps) <= 1
    want = _visible(plan.layout, plan.block, which, causal)
    assert set(got) == want and set(got.values()) <= {1}
    nb = plan.num_blocks * plan.block // SUB
    assert set(owners) == {(h, r * SUB) for h in range(plan.num_heads)
                           for r in range(nb)}
    assert set(owners.values()) == {1}                   # one owner each
    counts = work.items[:, 6]
    assert (np.diff(counts) <= 0).all()                  # longest first
    assert work.longest <= cap
    assert work.n_slots == int(work.splits[:, 6].sum())
    slots = sorted(s for s in work.items[:, 7].tolist() if s >= 0)
    assert slots == list(range(work.n_slots))            # each slot once
    if name == "bert_sparse" and not causal:
        assert work.masked_share == 0.0


def test_work16_at_the_sparse_bert_layout(plans):
    """Every query row lists 11 of 32 blocks and each aligned group of 4
    shares its list: 8 full items a head. Key blocks: the 3 local columns
    of a window share the window's 4 query blocks (an item of 3 warps), the
    8 global columns all 32 (two items of 4)."""
    plan = plans["bert_sparse"]
    dq, dkv = plan.work16("dq", False), plan.work16("dkv", False)
    assert dq.n_items == 16 * 8 and set(dq.items[:, 6]) == {11}
    assert dq.fill == 1.0 and dq.masked_share == 0.0 and dq.n_split == 0
    assert dkv.n_items == 16 * (8 + 2) and dkv.masked_share == 0.0
    assert sorted(collections.Counter(dkv.items[:, 6]).items()) == [
        (4, 16 * 8), (32, 16 * 2)]
    assert dkv.longest == 8 and dkv.n_split == 0
    assert dkv.fill == (16 * 8 * 3 + 16 * 2 * 4) / (16 * 10 * 4)


def test_work16_masks_differing_lists_and_caches(plans):
    """BigBird's random blocks make lists differ inside an item: some
    warp-steps are masked. Work lists are cached per (which, causal,
    cap); cap < 1, an unknown kernel and a block that is not a multiple
    of 16 raise."""
    plan = plans["bigbird16"]
    assert 0.0 < plan.work16("dq", True).masked_share < 1.0
    a = plan.work16("dkv", True)
    assert plan.work16("dkv", True, sp.SPLIT_CAP) is a
    assert plan.work16("dkv", True, 8) is not a
    assert plan.work16("dkv", False) is not a
    with pytest.raises(ValueError, match="cap"):
        plan.work16("dq", False, 0)
    with pytest.raises(ValueError, match="no 16-row work list"):
        plan.work16("bwd", False)
    with pytest.raises(ValueError, match="multiple of 16"):
        sp.SparsePlan(np.ones((1, 4, 4), np.int8), 24).work16("dq", True)


# ---------------------------------------------------------------------------
# the 16-row kernels compute the same function: a plain piecewise version
# against the JAX kernels
# ---------------------------------------------------------------------------

def _piecewise16(which, q, k, v, do, mask, lse, delta, plan, causal, scale,
                 cap):
    """The 16-row kernels' work in plain fp32 PyTorch: per item, each warp
    w accumulates over the walk's entries its bit lists, 4 entries a step
    (p = exp(s - max(lse, -5e29)) on visible pairs: the causal mask only
    on the warp's own block, the key mask at each gathered row; ds = p (dp
    - delta)) into rows 16 w .. 16 w + 15 of a 64-row fp32 tile; an
    unsplit item writes each warp's rows to its own block, a split item's
    pieces go to scratch and are summed in piece order. dq and dk carry
    the scale once, at the end."""
    work = plan.work16(which, causal, cap)
    b, _s, _h, d = q.shape
    nout = 1 if which == "dq" else 2
    outs = [torch.zeros_like(q) for _ in range(nout)]
    part = torch.full((b, work.n_slots, nout, sp.TC_TILE, d), float("nan"))
    lse = lse.clamp_min(sp.LSE_FLOOR)
    ar = torch.arange(SUB)

    def write(rows, h, tile):
        for w, rw in enumerate(rows):
            if rw >= 0:
                for o in range(nout):
                    outs[o][:, rw:rw + SUB, h] = tile[o][
                        :, w * SUB:(w + 1) * SUB] * (scale if o == 0 else 1.0)

    for h, *rows, off, cnt, slot in work.items.tolist():
        acc = torch.zeros(nout, b, sp.TC_TILE, d)
        ents = work.tiles[off:off + cnt].tolist()
        for step in range(0, cnt, sp.WARPS):
            for row_e, bits in ents[step:step + sp.WARPS]:
                for w, rw in enumerate(rows):
                    if not bits >> w & 1:
                        continue
                    own, other = rw + ar, row_e + ar
                    qi, kj = (own, other) if which == "dq" else (other, own)
                    s = torch.einsum("bid,bjd->bij", q[:, qi, h],
                                     k[:, kj, h]) * scale
                    vis = torch.ones(b, SUB, SUB, dtype=torch.bool)
                    if causal and row_e == rw:
                        vis &= (kj[None, :] <= qi[:, None])[None]
                    if mask is not None:
                        vis &= (mask[:, kj] > 0)[:, None, :]
                    p = torch.where(vis, torch.exp(s - lse[:, h, qi, None]),
                                    torch.zeros(()))
                    dp = torch.einsum("bid,bjd->bij", do[:, qi, h],
                                      v[:, kj, h])
                    ds = p * (dp - delta[:, h, qi, None])
                    at = slice(w * SUB, (w + 1) * SUB)
                    if which == "dq":
                        acc[0][:, at] += torch.einsum("bij,bjd->bid", ds,
                                                      k[:, kj, h])
                    else:
                        acc[0][:, at] += torch.einsum("bij,bid->bjd", ds,
                                                      q[:, qi, h])
                        acc[1][:, at] += torch.einsum("bij,bid->bjd", p,
                                                      do[:, qi, h])
        if slot >= 0:
            part[:, slot] = acc.transpose(0, 1)
        else:
            write(rows, h, acc)
    for h, *rows, first, count in work.splits.tolist():
        total = torch.zeros(b, nout, sp.TC_TILE, d)
        for p in range(count):
            total = total + part[:, first + p]
        write(rows, h, total.transpose(0, 1))
    return outs


# (layout, block, attention, key mask): the BigBird and fixed layouts at
# blocks 16 and 32, causal and not
PIECEWISE_CASES = [("bigbird", 16, "bidirectional", True),
                   ("bigbird", 16, "unidirectional", False),
                   ("fixed", 32, "bidirectional", True),
                   ("bigbird", 32, "unidirectional", True)]


@pytest.mark.parametrize("mode,block,attention,masked", PIECEWISE_CASES)
def test_piecewise16_matches_jax_kernels(mode, block, attention, masked):
    """S 256, H 2, D 32, cap 1 (one step of 4 entries: every walk longer
    than 4 blocks splits): dq, dk and dv of the piecewise version, fed
    JAX's forward's lse and delta, against JAX's backward kernels
    (interpret), fp32 atol 1e-5. With the key mask, batch row 1 is all
    padding: its dq, dk and dv are exactly 0."""
    b, s, h, d, cap = 2, 256, 2, 32, 1
    causal = attention == "unidirectional"
    if mode == "bigbird":
        cfg = jax_sc.BigBirdSparsityConfig(h, block, num_random_blocks=1,
                                           attention=attention,
                                           rng_seed=block + masked)
    else:
        cfg = jax_sc.FixedSparsityConfig(h, block, num_local_blocks=2,
                                         attention=attention)
    layout = cfg.make_layout(s)
    rng = np.random.default_rng(16 + block + masked)
    q, k, v, do = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((b, s), np.float32)
        mask[0, s - 21:] = 0
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
    assert plan.work16("dq", causal, cap).n_split
    assert plan.work16("dkv", causal, cap).n_split
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    lse = torch.from_numpy(np.array(jlse)[..., 0].reshape(b, h, s))
    out = torch.from_numpy(back(jo).copy())
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, tdo, tm, lse, delta, plan, causal, scale, cap)
    (dq,) = _piecewise16("dq", *args)
    dk, dv = _piecewise16("dkv", *args)
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
    (torch.bfloat16, 64, 16, "tc16"), (torch.float16, 64, 32, "tc16"),
    (torch.bfloat16, 128, 16, "tc16"), (torch.float16, 72, 48, "tc16"),
    (torch.bfloat16, 8, 96, "tc16"), (torch.bfloat16, 64, 64, "tc"),
    (torch.float16, 128, 256, "tc"), (torch.float32, 64, 16, "tf32"),
    (torch.float32, 64, 32, "tf32"), (torch.float32, 64, 64, "tf32"),
    (torch.bfloat16, 64, 24, "fma"), (torch.bfloat16, 136, 16, "fma"),
    (torch.float16, 60, 32, "fma")])
def test_route_bwd(dtype, head_dim, block, route):
    """16-bit types at head dims the kernels take: blocks that are
    multiples of 64 on the 64-row kernels, other multiples of 16 on the
    16-row kernels; fp32 dq and dk/dv at every multiple of 16 on the
    3xTF32 kernels. The forward takes the same route (``_route``;
    ``_route_bwd`` is its view for dq and dk/dv)."""
    assert sp._route_bwd(dtype, head_dim, block) == route
    assert sp._route(dtype, head_dim, block, "dq") == route
    assert sp._route(dtype, head_dim, block, "dkv") == route
    assert sp._route(dtype, head_dim, block) == route


def _inputs(dtype, block, s=96, h=2, d=16, b=1):
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
            "sparse_attention_bwd_dq_tc16", "sparse_attention_bwd_dkv_tc16",
            "sparse_attention_fwd", "sparse_attention_fwd_tc",
            "sparse_attention_fwd_tc16")


def _counts():
    return [getattr(sp, n).launches for n in WRAPPERS]


@pytest.mark.parametrize("dtype,block,match", [
    (torch.float32, 16, "takes bfloat16 or float16"),
    (torch.bfloat16, 64, "multiple of 16 and not of 64"),
    (torch.bfloat16, 32, "runs on CUDA tensors"),
    (torch.float16, 48, "runs on CUDA tensors")])
def test_tc16_wrappers_refuse_and_count_nothing(dtype, block, match):
    """FMA-route inputs, the 64-row route's blocks and CPU tensors raise
    ValueError before any launch; nothing falls back."""
    args = _inputs(dtype, block, s=192)
    before = _counts()
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_bwd_dq_tc16(*args)
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_bwd_dkv_tc16(*args, cap=2)
    assert _counts() == before


def test_tc16_wrappers_refuse_blocks_off_16():
    """A layout block that is not a multiple of 16 (24) is on no
    tensor-core route."""
    args = _inputs(torch.bfloat16, 24)
    before = _counts()
    for fn in (sp.sparse_attention_bwd_dq_tc16,
               sp.sparse_attention_bwd_dkv_tc16):
        with pytest.raises(ValueError, match="multiple of 16 and not of 64"):
            fn(*args)
    assert _counts() == before


@pytest.mark.parametrize("dtype,block", [(torch.bfloat16, 16),
                                         (torch.float16, 32),
                                         (torch.bfloat16, 48),
                                         (torch.float32, 16)])
def test_dispatch16_on_cpu_runs_the_plain_versions(dtype, block):
    """On CPU tensors at blocks of 16, 32 and 48 the dispatching wrappers
    return the plain versions' results and count no route."""
    args = _inputs(dtype, block)
    before = _counts()
    dq = sp.sparse_attention_bwd_dq(*args)
    dk, dv = sp.sparse_attention_bwd_dkv(*args)
    assert _counts() == before
    assert torch.equal(dq, sp.sparse_bwd_dq_reference(*args))
    want_dk, want_dv = sp.sparse_bwd_dkv_reference(*args)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    assert dq.dtype == dtype and dk.dtype == dtype


def test_missing_nvcc_raises_for_tc16(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("sparse_attention_tc16")
    assert not list(tmp_path.iterdir())


def test_tc16_source_reaches_its_nested_headers():
    """sparse_attention_tc16.cu reaches attention_tile.cuh only through
    attention_tc.cuh; both enter its build's name."""
    with open(f"{build.CSRC}/sparse_attention_tc16.cu", "rb") as f:
        heads = build._headers(f.read())
    names = []
    for name in ("attention_tc.cuh", "attention_tile.cuh"):
        with open(f"{build.CSRC}/{name}", "rb") as f:
            names.append(f.read())
    assert heads == names

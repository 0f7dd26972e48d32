"""The 16-row tensor-core block-sparse forward (kernel #8 at layout blocks
that are multiples of 16 and not of 64, deepspeed_tpu_torch.ops.
sparse_attention): its work list, its split, its route and its wrapper.

``csrc/sparse_attention_tc16.cu:sparse_fwd_tc16_kernel`` (and
``sparse_fwd_combine16_kernel``, the second pass that combines a split
item's pieces) runs only on the card, where ``chip_smoke.py`` holds it
against the plain version. Here, on the CPU:

- the forward walks dq's 16-row work list, the same object;
- a plain piecewise version of the kernel's arithmetic (each warp's base-2
  online softmax over the gathered 16-row key blocks its bit lists, 4
  entries a step; a split item's pieces leaving fp32 (m, l, o) that are
  combined in piece order, each warp's rows mapped home) against the JAX
  kernel ``_sparse_kernel`` (interpret), at the sparse BERT layout (the
  reference documentation's fixed block-16 layout with a pattern per
  head), a causal BigBird block-16 layout and a block-32 layout, at cap 1
  and with no split, with a key mask whose second batch row is all
  padding: o within 1e-5 in fp32, lse within 1e-5, the empty rows o = 0
  and lse = -1e30 exactly;
- the wrapper's walls, and the dispatching wrapper's plain path on the CPU.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config_from_dict

torch.set_num_threads(1)

# The packages export a function of the module's name: import the modules.
jax_ops = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.sparse_attention")
sp = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention")

ATOL = 1e-5
SUB = 16
LOG2E = 1.0 / math.log(2.0)
# the reference's configuration documentation's example (chip_smoke.py's
# BERT_SPARSE), here at 4 heads and seq 256
BERT_SPARSE = {"mode": "fixed", "block": 16,
               "different_layout_per_head": True, "num_local_blocks": 4,
               "num_global_blocks": 1, "attention": "bidirectional",
               "horizontal_global_attention": False,
               "num_different_global_patterns": 4}
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1}
# (layout config, causal)
LAYOUTS = {"bert_sparse": (BERT_SPARSE, False),
           "bigbird16_causal": (dict(BIGBIRD, attention="unidirectional",
                                     rng_seed=171), True),
           "bigbird32": (dict(BIGBIRD, block=32, attention="bidirectional",
                              rng_seed=172), False)}


def _plan(name, h, s):
    cfg, causal = LAYOUTS[name]
    layout = sparsity_config_from_dict(cfg, h).make_layout(s)
    return sp.SparsePlan(layout, cfg["block"]), causal


@pytest.mark.parametrize("cap", [None, 1, 2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_forward_walks_the_dq_list16(name, causal, cap):
    plan, _c = _plan(name, 2, 256)
    assert plan.work16("fwd", causal, cap) is plan.work16("dq", causal, cap)
    dev = torch.device("cpu")
    fwd = plan.work_on(dev, "fwd", causal, cap, rows16=True)
    assert fwd is plan.work_on(dev, "dq", causal, cap, rows16=True)


def _piecewise_fwd16(q, k, v, mask, plan, causal, scale, cap):
    """The 16-row forward's work in plain fp32 PyTorch. Per item, each warp
    w runs an online softmax over the walk's entries its bit lists, 4
    entries a step (base-2 scores; a masked pair, a key the mask drops or
    one above the diagonal of the warp's own block, is -inf and leaves the
    max and the sum; a step with nothing visible leaves the state as it
    was) into rows 16 w .. 16 w + 15 of a 64-row fp32 state. An unsplit
    item writes each warp's rows to its own block: o = acc / l and lse =
    m ln 2 + ln l (0 and -1e30 where it saw no key); a split item's pieces
    go to scratch as (m, l, acc) and are combined in piece order. q, k, v
    [B, S, H, D]; returns o [B, S, H, D] and lse [B, H, S]."""
    work = plan.work16("fwd", causal, cap)
    b, s, h, d = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, s), float("nan"))
    part_o = torch.full((b, work.n_slots, sp.TC_TILE, d), float("nan"))
    part_ml = torch.full((b, work.n_slots, sp.TC_TILE, 2), float("nan"))
    ar = torch.arange(SUB)
    ninf = torch.tensor(float("-inf"))

    def finish(m, l, acc, h_, rows):
        seen = l > 0
        inv = torch.where(seen, 1.0 / torch.where(seen, l, 1.0), 0.0)
        o = acc * inv[..., None]
        ls = torch.where(
            seen, m * math.log(2.0) + torch.log(torch.where(seen, l, 1.0)),
            torch.tensor(sp.NEG_INF))
        for w, rw in enumerate(rows):
            if rw >= 0:
                at = slice(w * SUB, (w + 1) * SUB)
                out[:, rw:rw + SUB, h_] = o[:, at]
                lse[:, h_, rw:rw + SUB] = ls[:, at]

    for h_, *rows, off, cnt, slot in work.items.tolist():
        m = torch.full((b, sp.TC_TILE), float("-inf"))
        l = torch.zeros(b, sp.TC_TILE)
        acc = torch.zeros(b, sp.TC_TILE, d)
        ents = work.tiles[off:off + cnt].tolist()
        for step in range(0, cnt, sp.WARPS):
            for w, rw in enumerate(rows):
                listed = [row_e for row_e, bits in ents[step:step + sp.WARPS]
                          if bits >> w & 1]
                if not listed:
                    continue
                assert rw >= 0                   # bits of owned warps only
                qi = rw + ar
                kj = torch.cat([row_e + ar for row_e in listed])
                x = torch.einsum("bid,bjd->bij", q[:, qi, h_],
                                 k[:, kj, h_]) * (scale * LOG2E)
                vis = torch.ones(b, SUB, len(kj), dtype=torch.bool)
                if causal:
                    diag = torch.cat([torch.full((SUB,), row_e == rw)
                                      for row_e in listed])
                    vis &= (~diag[None, :] | (kj[None, :] <= qi[:, None]))[
                        None]
                if mask is not None:
                    vis &= (mask[:, kj] > 0)[:, None, :]
                x = torch.where(vis, x, ninf)
                at = slice(w * SUB, (w + 1) * SUB)
                m_w = m[:, at]
                mn = torch.maximum(m_w, x.amax(-1))
                a = torch.where(mn == ninf, 1.0,
                                torch.where(m_w == ninf, 0.0,
                                            torch.exp2(m_w - mn)))
                p = torch.where(x == ninf, 0.0, torch.exp2(x - mn[..., None]))
                l[:, at] = l[:, at] * a + p.sum(-1)
                acc[:, at] = acc[:, at] * a[..., None] + torch.einsum(
                    "bij,bjd->bid", p, v[:, kj, h_])
                m[:, at] = mn
        if slot >= 0:
            part_o[:, slot] = acc
            part_ml[:, slot] = torch.stack([m, l], -1)
        else:
            finish(m, l, acc, h_, rows)
    for h_, *rows, first, count in work.splits.tolist():
        ms = part_ml[:, first:first + count, :, 0]          # [B, P, 64]
        big = ms.amax(1)
        wgt = torch.where(ms == ninf, 0.0, torch.exp2(ms - big[:, None]))
        l = (wgt * part_ml[:, first:first + count, :, 1]).sum(1)
        acc = torch.zeros(b, sp.TC_TILE, d)
        for p in range(count):                               # piece order
            acc = acc + wgt[:, p, :, None] * part_o[:, first + p]
        finish(big, l, acc, h_, rows)
    return out, lse


@pytest.mark.parametrize("cap", [1, None], ids=["cap1", "nosplit"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_piecewise16_forward_matches_jax_kernel(name, cap):
    """B 2, S 256, H 4, D 32: o and lse of the piecewise version against
    JAX's ``_sparse_kernel`` (interpret), fp32 atol 1e-5 (the same fp32
    products summed in another order, the softmax in base 2). At cap 1 (one
    step of 4 entries) every walk longer than 4 blocks splits; with no cap
    none does. A key mask with batch row 1 all padding: its o is exactly 0
    and its lse exactly -1e30; every row of the piecewise output is
    written."""
    b, s, h, d = 2, 256, 4, 32
    plan, causal = _plan(name, h, s)
    layout, block = plan.layout, plan.block
    rng = np.random.default_rng(170 + block + causal)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), np.float32)
    mask[0, s - 37:] = 0
    mask[1] = 0
    scale = 1.0 / d ** 0.5

    def bhsd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)

    kv_idx, _ = jax_ops.layout_kv_indices(layout)
    kv_cnt = jnp.asarray(layout.sum(-1).astype(np.int32))
    jo, jlse = jax_ops._sparse_forward(
        bhsd(q), bhsd(k), bhsd(v), jnp.asarray(mask)[:, None, :],
        jnp.asarray(kv_idx), kv_cnt, block, causal, scale, h, True)
    want_o = np.asarray(jo).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    want_lse = np.asarray(jlse)[..., 0].reshape(b, h, s)

    c = s // sp.TC_TILE if cap is None else cap
    work = plan.work16("fwd", causal, c)
    assert (work.n_split > 0) == (cap == 1)
    o, lse = _piecewise_fwd16(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                              plan, causal, scale, c)
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    np.testing.assert_allclose(o.numpy(), want_o, atol=ATOL, rtol=0)
    seen = want_lse > sp.NEG_INF / 2
    assert np.array_equal(lse.numpy() > sp.NEG_INF / 2, seen)
    np.testing.assert_allclose(lse.numpy()[seen], want_lse[seen], atol=ATOL,
                               rtol=0)
    assert (lse.numpy()[~seen] == np.float32(sp.NEG_INF)).all()
    assert (o[1] == 0).all() and (lse[1] == np.float32(sp.NEG_INF)).all()


def test_sparse_bert_layout_walks_without_masked_warps():
    """At the sparse BERT layout every aligned group of 4 query blocks
    shares its list, so the forward's items are full and no warp is masked
    off a step (the dq list's property, now the forward's too)."""
    plan, _c = _plan("bert_sparse", 4, 256)
    work = plan.work16("fwd", False)
    assert work.fill == 1.0 and work.masked_share == 0.0
    assert work.n_split == 0 and plan.work16("fwd", False, 1).n_split > 0


def _inputs(dtype, block, s=96, h=2, d=16, b=1):
    layout = np.ones((h, s // block, s // block), np.int8)
    plan = sp.sparse_plan(layout, block)
    g = torch.Generator().manual_seed(block + 17)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(dtype)
               for _ in range(3))
    return q, k, v, None, plan, False, d ** -0.5


WRAPPERS = ("sparse_attention_fwd", "sparse_attention_fwd_tc",
            "sparse_attention_fwd_tc16", "sparse_attention_bwd_dq_tc16",
            "sparse_attention_bwd_dkv_tc16")


def _counts():
    return [getattr(sp, n).launches for n in WRAPPERS]


@pytest.mark.parametrize("dtype,block,match", [
    (torch.float32, 16, "takes bfloat16 or float16"),
    (torch.bfloat16, 64, "multiple of 16 and not of 64"),
    (torch.bfloat16, 16, "runs on CUDA tensors"),
    (torch.float16, 32, "runs on CUDA tensors")])
def test_fwd_tc16_refuses_and_counts_nothing(dtype, block, match):
    """fp32, the 64-row route's blocks and CPU tensors raise ValueError
    before any launch; nothing falls back."""
    args = _inputs(dtype, block, s=192)
    before = _counts()
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_fwd_tc16(*args)
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_fwd_tc16(*args, cap=1)
    assert _counts() == before


@pytest.mark.parametrize("dtype,block", [(torch.bfloat16, 16),
                                         (torch.float16, 32),
                                         (torch.bfloat16, 48),
                                         (torch.float32, 16)])
def test_forward16_on_cpu_runs_the_plain_version(dtype, block):
    """On CPU tensors at blocks of 16, 32 and 48 the dispatching forward
    returns the plain version's result and counts no route."""
    args = _inputs(dtype, block)
    before = _counts()
    o, lse = sp.sparse_attention_fwd(*args)
    assert _counts() == before
    want_o, want_lse = sp.sparse_fwd_reference(*args)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert o.dtype == dtype and lse.dtype == torch.float32

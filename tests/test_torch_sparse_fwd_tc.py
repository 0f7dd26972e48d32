"""The tensor-core block-sparse forward (kernel #8 on Hopper's tensor
cores, deepspeed_tpu_torch.ops.sparse_attention): its work list, its split
and its route.

``csrc/sparse_attention_tc.cu:sparse_fwd_tc_kernel`` (and the second pass
that combines a split tile's pieces) runs only on the card, where
``chip_smoke.py`` holds it against the plain version. Here, on the CPU:

- the forward walks dq's work list, the same object;
- a plain piecewise version of the kernel's arithmetic (each item's online
  softmax over its run of 64-row key tiles in base 2, a split tile's
  pieces leaving fp32 (m, l, o) that are combined in piece order) against
  the JAX kernel ``_sparse_kernel`` (interpret), at caps 1, 4 and no
  split, on a bidirectional BigBird layout and a causal one, with a key
  mask whose second batch row is all padding: o within 1e-5 in fp32, lse
  within 1e-5, the empty rows o = 0 and lse = -1e30 exactly;
- the route, the wrapper's walls, and the dispatching wrapper's plain path
  on the CPU (the 16-row forward: ``tests/test_torch_sparse_fwd_tc16.py``).
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jax_sc

torch.set_num_threads(1)

jax_ops = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.sparse_attention")
sp = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention")

ATOL = 1e-5
TILE = 64
LOG2E = 1.0 / math.log(2.0)


def test_forward_walks_the_dq_list():
    layout = np.ones((2, 8, 8), np.int8)
    plan = sp.SparsePlan(layout, 64)
    for causal in (True, False):
        for cap in (None, 1, 4):
            assert plan.work("fwd", causal, cap) is plan.work("dq", causal,
                                                              cap)
    with pytest.raises(ValueError, match="no work list"):
        plan.work("bwd", True)


def _piecewise_fwd(q, k, v, mask, plan, causal, scale, cap):
    """The tensor-core forward's work in plain fp32 PyTorch. Per item: an
    online softmax over its run of 64-row key tiles (base-2 scores; a
    masked pair is -inf and leaves the max and the sum; a fully masked
    tile leaves the state as it was). An unsplit tile writes o = acc / l
    and lse = m ln 2 + ln l (0 and -1e30 if it saw no key); a split tile's
    pieces go to scratch as (m, l, acc) and are combined in piece order.
    q, k, v [B, S, H, D]; returns o [B, S, H, D] and lse [B, H, S]."""
    work = plan.work("fwd", causal, cap)
    b, s, h, d = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, s), float("nan"))
    part_o = torch.full((b, work.n_slots, TILE, d), float("nan"))
    part_ml = torch.full((b, work.n_slots, TILE, 2), float("nan"))
    ar = torch.arange(TILE)
    ninf = torch.tensor(float("-inf"))

    def finish(m, l, acc, h_, row0):
        seen = l > 0
        inv = torch.where(seen, 1.0 / torch.where(seen, l, 1.0), 0.0)
        out[:, row0:row0 + TILE, h_] = acc * inv[..., None]
        lse[:, h_, row0:row0 + TILE] = torch.where(
            seen, m * math.log(2.0) + torch.log(torch.where(seen, l, 1.0)),
            torch.tensor(sp.NEG_INF))

    for h_, row0, off, cnt, slot in work.items.tolist():
        m = torch.full((b, TILE), float("-inf"))
        l = torch.zeros(b, TILE)
        acc = torch.zeros(b, TILE, d)
        qi = row0 + ar
        for k0 in work.tiles[off:off + cnt].tolist():
            kj = k0 + ar
            x = torch.einsum("bid,bjd->bij", q[:, qi, h_],
                             k[:, kj, h_]) * (scale * LOG2E)
            vis = torch.ones(b, TILE, TILE, dtype=torch.bool)
            if causal:
                vis &= (kj[None, :] <= qi[:, None])[None]
            if mask is not None:
                vis &= (mask[:, kj] > 0)[:, None, :]
            x = torch.where(vis, x, ninf)
            mn = torch.maximum(m, x.amax(-1))
            a = torch.where(mn == ninf, 1.0,
                            torch.where(m == ninf, 0.0, torch.exp2(m - mn)))
            p = torch.where(x == ninf, 0.0, torch.exp2(x - mn[..., None]))
            l = l * a + p.sum(-1)
            acc = acc * a[..., None] + torch.einsum("bij,bjd->bid", p,
                                                    v[:, kj, h_])
            m = mn
        if slot >= 0:
            part_o[:, slot] = acc
            part_ml[:, slot] = torch.stack([m, l], -1)
        else:
            finish(m, l, acc, h_, row0)
    for h_, row0, first, count in work.splits.tolist():
        ms = part_ml[:, first:first + count, :, 0]          # [B, P, 64]
        big = ms.amax(1)
        w = torch.where(ms == ninf, 0.0, torch.exp2(ms - big[:, None]))
        l = (w * part_ml[:, first:first + count, :, 1]).sum(1)
        acc = torch.zeros(b, TILE, d)
        for p in range(count):                               # piece order
            acc = acc + w[:, p, :, None] * part_o[:, first + p]
        finish(big, l, acc, h_, row0)
    return out, lse


@pytest.mark.parametrize("cap", [1, 4, None], ids=["cap1", "cap4", "nosplit"])
@pytest.mark.parametrize("attention", ["bidirectional", "unidirectional"])
def test_piecewise_split_forward_matches_jax_kernel(attention, cap):
    """S 512, block 64, H 2, D 32 (bidirectional: the global rows walk 8
    tiles and split at caps 1 and 4; causal: no walk is longer than 4, so
    only cap 1 splits; nothing splits without a cap): o and lse of the
    piecewise version against JAX's ``_sparse_kernel`` (interpret), fp32
    atol 1e-5 (the same fp32 products summed in another order, the
    softmax in base 2). A key mask with batch row 1 all padding: its o is
    exactly 0 and its lse exactly -1e30."""
    b, s, h, d, block = 2, 512, 2, 32, 64
    causal = attention == "unidirectional"
    cfg = jax_sc.BigBirdSparsityConfig(h, block, num_random_blocks=1,
                                       attention=attention, rng_seed=31)
    layout = cfg.make_layout(s)
    rng = np.random.default_rng(40 + causal)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), np.float32)
    mask[0, s - 45:] = 0
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

    plan = sp.SparsePlan(layout, block)
    c = s // TILE if cap is None else cap
    work = plan.work("fwd", causal, c)
    # the bidirectional global rows walk 8 tiles; the causal rows at most 4
    assert (work.n_split > 0) == (cap == 1 or (cap == 4 and not causal))
    o, lse = _piecewise_fwd(*(torch.from_numpy(x) for x in (q, k, v, mask)),
                            plan, causal, scale, c)
    np.testing.assert_allclose(o.numpy(), want_o, atol=ATOL, rtol=0)
    seen = want_lse > sp.NEG_INF / 2
    assert np.array_equal(lse.numpy() > sp.NEG_INF / 2, seen)
    np.testing.assert_allclose(lse.numpy()[seen], want_lse[seen], atol=ATOL,
                               rtol=0)
    assert (lse.numpy()[~seen] == np.float32(sp.NEG_INF)).all()
    assert (o[1] == 0).all() and (lse[1] == np.float32(sp.NEG_INF)).all()


@pytest.mark.parametrize("dtype,head_dim,block,route", [
    (torch.bfloat16, 64, 256, "tc"), (torch.float16, 128, 64, "tc"),
    (torch.bfloat16, 72, 128, "tc"), (torch.float32, 64, 256, "tf32"),
    (torch.bfloat16, 64, 16, "tc16"), (torch.float16, 64, 32, "tc16")])
def test_forward_route(dtype, head_dim, block, route):
    """The forward takes the backward's route: 16 bits at blocks that are
    multiples of 64 on the 64-row tensor-core kernel, at blocks of 16 or
    32 on the 16-row one, fp32 on the 3xTF32 kernel."""
    assert sp._route(dtype, head_dim, block) == route


def _inputs(dtype, block, s=128, h=2, d=16, b=1):
    layout = np.ones((h, s // block, s // block), np.int8)
    plan = sp.sparse_plan(layout, block)
    g = torch.Generator().manual_seed(block + 1)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(dtype)
               for _ in range(3))
    return q, k, v, None, plan, True, d ** -0.5


def _counts():
    return (sp.sparse_attention_fwd.launches,
            sp.sparse_attention_fwd_tc.launches)


@pytest.mark.parametrize("dtype,block,match", [
    (torch.float32, 64, "takes bfloat16 or float16"),
    (torch.bfloat16, 32, "multiple of 64"),
    (torch.bfloat16, 64, "runs on CUDA tensors")])
def test_fwd_tc_refuses_and_counts_nothing(dtype, block, match):
    args = _inputs(dtype, block)
    before = _counts()
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_fwd_tc(*args)
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_fwd_tc(*args, cap=2)
    assert _counts() == before


@pytest.mark.parametrize("dtype,block", [(torch.bfloat16, 64),
                                         (torch.float16, 64),
                                         (torch.float32, 64),
                                         (torch.bfloat16, 32)])
def test_forward_on_cpu_runs_the_plain_version(dtype, block):
    args = _inputs(dtype, block)
    before = _counts()
    o, lse = sp.sparse_attention_fwd(*args)
    assert _counts() == before
    want_o, want_lse = sp.sparse_fwd_reference(*args)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert o.dtype == dtype and lse.dtype == torch.float32

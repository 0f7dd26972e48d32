"""The 3xTF32 block-sparse forward, dq and dk/dv: route and arithmetic
(deepspeed_tpu_torch).

``csrc/sparse_attention_tf32.cu`` (the forward, dq and dk/dv for float32
on the tensor cores over the 16-row work lists) runs only on the card,
where ``chip_smoke.py`` holds it against the plain versions. Here: which
kernel ``_route`` picks for the forward, dq and dk/dv of float32 by head
dim and layout block, that the 3xTF32 wrappers refuse the rest and count
nothing, that a missing ``nvcc`` raises, that CPU tensors take the plain
versions, that the source reaches its headers, and plain PyTorch models
of the kernels' arithmetic: every fp32 operand of s = q.k^T, o += p.v,
dp = dO.v^T, dq = ds.k, dk = ds^T.q and dv = p^T.dO split into hi =
tf32(x) and lo = tf32(x - hi) (``cvt.rna.tf32.f32`` emulated with int32
bit operations), each product lo.hi + hi.lo + hi.hi in fp32, over the
layout's visible pairs. The forward's model walks the kernel's 16-row
work list as the kernel does: per warp, the entries its bit lists, the
source's entries a step at a time, s with q unscaled, a base-2 online
softmax, each step's p.v folded in by an fp32 add, and a split walk's
pieces combined in piece order. On numpy-made inputs the models stay
within 1e-5 of the JAX kernels (the forward ``_sparse_kernel``, the
backward ``_sparse_bwd_dq_kernel`` and ``_sparse_bwd_dkv_kernel``;
interpret, the backward through ``jax.grad``) and of the port's plain
versions; one TF32 product (hi.hi) does not, which is why the kernels pay
for three.
"""

import importlib
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config_from_dict

torch.set_num_threads(1)

# The packages export a function of the module's name: import the modules.
jax_ops = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.sparse_attention")
sp = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_attention")

REL = 1e-5          # of the reference's largest |value|
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
WRAPPERS = ("sparse_attention_bwd_dq", "sparse_attention_bwd_dkv",
            "sparse_attention_bwd_dq_tc", "sparse_attention_bwd_dkv_tc",
            "sparse_attention_bwd_dq_tc16", "sparse_attention_bwd_dkv_tc16",
            "sparse_attention_bwd_dq_tf32", "sparse_attention_bwd_dkv_tf32",
            "sparse_attention_fwd", "sparse_attention_fwd_tc",
            "sparse_attention_fwd_tc16", "sparse_attention_fwd_tf32")


@pytest.mark.parametrize("block", [16, 32, 64, 256])
@pytest.mark.parametrize("head_dim", [8, 64, 72, 128])
def test_route_fp32(head_dim, block):
    """The fp32 forward, dq and dk/dv take 3xTF32 at head dims the kernels
    take and every block that is a multiple of 16."""
    assert sp._route(F32, head_dim, block, "dq") == "tf32"
    assert sp._route(F32, head_dim, block, "dkv") == "tf32"
    assert sp._route_bwd(F32, head_dim, block) == "tf32"
    assert sp._route(F32, head_dim, block, "fwd") == "tf32"
    assert sp._route(F32, head_dim, block) == "tf32"


@pytest.mark.parametrize("head_dim,block", [(60, 16), (136, 64), (64, 24)])
def test_route_fp32_off_the_grid(head_dim, block):
    """Head dims that are not multiples of 8 or exceed 128, and blocks
    off 16, are on no tensor-core route (the kernels refuse them,
    ``_prepare`` raises first on the autograd path)."""
    for which in ("fwd", "dq", "dkv"):
        assert sp._route(F32, head_dim, block, which) == "fma"


def test_route_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="fwd, dq or dkv"):
        sp._route(F32, 64, 16, "dk")


def _inputs(dtype, block, s=128, h=2, d=16, b=1):
    layout = np.ones((h, s // block, s // block), np.int8)
    plan = sp.sparse_plan(layout, block)
    g = torch.Generator().manual_seed(block + d)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g).to(dtype)
                   for _ in range(4))
    lse = torch.zeros(b, h, s)
    delta = torch.zeros(b, h, s)
    return q, k, v, do, None, lse, delta, plan, True, d ** -0.5


def _counts():
    return [getattr(sp, n).launches for n in WRAPPERS]


@pytest.mark.parametrize("dtype,block,d,match", [
    (BF16, 16, 16, "takes float32"), (F16, 64, 16, "takes float32"),
    (F32, 64, 136, "takes float32"), (F32, 32, 16, "runs on CUDA tensors"),
    (F32, 256, 64, "runs on CUDA tensors")])
def test_tf32_wrappers_refuse_and_count_nothing(dtype, block, d, match):
    """16-bit inputs, head dims off the grid and CPU tensors raise
    ValueError before any launch; nothing falls back."""
    args = _inputs(dtype, block, s=256, d=d)
    before = _counts()
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_fwd_tf32(*args[:3], args[4], *args[7:])
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_fwd_tf32(*args[:3], args[4], *args[7:], cap=1)
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_bwd_dq_tf32(*args)
    with pytest.raises(ValueError, match=match):
        sp.sparse_attention_bwd_dkv_tf32(*args, cap=2)
    assert _counts() == before


def test_tf32_wrappers_refuse_blocks_off_16():
    args = _inputs(F32, 16)
    plan = sp.sparse_plan(np.ones((2, 4, 4), np.int8), 24)
    args = args[:7] + (plan,) + args[8:]
    before = _counts()
    for fn in (sp.sparse_attention_bwd_dq_tf32,
               sp.sparse_attention_bwd_dkv_tf32):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(*args)
    with pytest.raises(ValueError, match="multiple of 16"):
        sp.sparse_attention_fwd_tf32(*args[:3], None, plan, True, 0.25)
    assert _counts() == before


def test_missing_nvcc_raises_for_tf32(monkeypatch, tmp_path):
    """Without ``nvcc`` the build and the library's loader raise, and so
    does the forward's launch (on meta tensors: its shapes, work list and
    scratch are set up, then the library is not there); nothing is
    written and nothing counts."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(sp, "_FN", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("sparse_attention_tf32")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sp._kernel("sparse_attention_tf32")
    plan = sp.sparse_plan(np.ones((1, 16, 16), np.int8), 16)
    q = torch.empty(1, 256, 1, 64, device="meta")
    before = _counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sp._launch_tc_fwd(q, q, q, None, plan, True, 0.125, 1,
                          "sparse_attention_tf32")
    assert _counts() == before
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("block", [16, 64, 128])
def test_dispatch_fp32_on_cpu_runs_the_plain_versions(block):
    """On CPU tensors the dispatching forward, dq and dk/dv return the
    plain versions' results and count no route."""
    args = _inputs(F32, block, s=256)
    fwd_args = (*args[:3], args[4], *args[7:])
    before = _counts()
    o, lse = sp.sparse_attention_fwd(*fwd_args)
    dq = sp.sparse_attention_bwd_dq(*args)
    dk, dv = sp.sparse_attention_bwd_dkv(*args)
    assert _counts() == before
    want_o, want_lse = sp.sparse_fwd_reference(*fwd_args)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert torch.equal(dq, sp.sparse_bwd_dq_reference(*args))
    want_dk, want_dv = sp.sparse_bwd_dkv_reference(*args)
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)


def test_tf32_sources_reach_their_headers():
    """sparse_attention_tf32.cu and flash_attention_tf32.cu both reach
    attention_tile.cuh and tf32_mma.cuh (the 3xTF32 products); both enter
    each build's name."""
    names = []
    for name in ("attention_tile.cuh", "tf32_mma.cuh"):
        with open(f"{build.CSRC}/{name}", "rb") as f:
            names.append(f.read())
    for src in ("sparse_attention_tf32", "flash_attention_tf32"):
        with open(f"{build.CSRC}/{src}.cu", "rb") as f:
            assert build._headers(f.read()) == names


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 ``x``: the nearest value with 10
    mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the kernels multiply fp32 operands: with 3 terms, lo.hi +
    hi.lo + hi.hi of hi = tf32(x) and lo = tf32(x - hi); with 1, hi.hi."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _model(q, k, v, do, mask, lse, delta, plan, causal, scale, terms):
    """dq, dk and dv as the 3xTF32 kernels compute them from q, k, v, dO
    ([B, S, H, D] fp32), the key mask and the forward's lse and delta
    ([B, H, S]): per head, s = q.k^T (q unscaled) and dp = dO.v^T; p =
    exp(scale s - max(lse, -5e29)) on the visible pairs, 0 elsewhere; ds =
    p (dp - delta); dq = scale ds.k, dk = scale ds^T.q, dv = p^T.dO."""
    dq, dk, dv = [], [], []
    for h in range(q.shape[2]):
        vis = plan.visible(h, causal, mask, "cpu")
        qh, kh, vh, doh = (t[:, :, h] for t in (q, k, v, do))
        s = _mm(qh, kh.transpose(-1, -2), terms)
        p = torch.exp(s * scale
                      - lse[:, h].clamp_min(sp.LSE_FLOOR)[..., None])
        p = p.masked_fill(~vis, 0.0)
        dp = _mm(doh, vh.transpose(-1, -2), terms)
        ds = p * (dp - delta[:, h, :, None])
        dq.append(_mm(ds, kh, terms) * scale)
        dk.append(_mm(ds.transpose(-1, -2), qh, terms) * scale)
        dv.append(_mm(p.transpose(-1, -2), doh, terms))
    return [torch.stack(t, dim=2) for t in (dq, dk, dv)]


SEQ, HEADS, HEAD_DIM = 256, 2, 64
MODEL_CASES = {  # name: (sparsity config, causal, key mask)
    "fixed16-masked": ({"mode": "fixed", "block": 16},
                       False, True),
    "bigbird32-causal": ({"mode": "bigbird", "block": 32,
                          "num_random_blocks": 1,
                          "attention": "unidirectional", "rng_seed": 29},
                         True, False)}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_3xtf32_model_matches_jax_and_plain(case):
    """The 3xTF32 model of dq, dk and dv against the JAX backward kernels
    (interpret, fp32, through ``jax.grad``) and the port's fp32 plain
    versions on the same inputs: within 1e-5 of each reference's largest
    |value|; the one-product model beyond it for every output. With the
    key mask, batch row 1 is all padding: its gradients are 0."""
    cfg, causal, masked = MODEL_CASES[case]
    block = cfg["block"]
    layout = sparsity_config_from_dict(cfg, HEADS).make_layout(SEQ)
    rng = np.random.default_rng(61 + block)
    q, k, v, do = (rng.normal(size=(2, SEQ, HEADS, HEAD_DIM))
                   .astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((2, SEQ), np.int32)
        mask[0, SEQ - 37:] = 0
        mask[1] = 0
    scale = HEAD_DIM ** -0.5

    def f(q, k, v):
        out = jax_ops.sparse_attention(
            q, k, v, layout, block, causal=causal, impl="pallas",
            interpret=True,
            key_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(do)), out

    (_, _out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    want_jax = [np.asarray(g) for g in grads]
    # the backward's inputs as the kernels receive them: lse from the
    # forward, delta = rowsum(dO * o)
    plan = sp.sparse_plan(layout, block)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask).float()
    out, lse = sp.sparse_fwd_reference(tq, tk, tv, tm, plan, causal, scale)
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, tdo, tm, lse, delta, plan, causal, scale)
    want_plain = [sp.sparse_bwd_dq_reference(*args),
                  *sp.sparse_bwd_dkv_reference(*args)]
    for ref_name, want in (("jax", want_jax), ("plain", want_plain)):
        for terms, within in ((3, True), (1, False)):
            got = _model(*args, terms)
            errs = [float(np.abs(g.numpy() - np.asarray(w)).max()
                          / np.abs(np.asarray(w)).max())
                    for g, w in zip(got, want)]
            if within:
                assert max(errs) <= REL, (ref_name, terms, errs)
            else:
                assert min(errs) > REL, (ref_name, terms, errs)
            if masked:
                assert not any(g[1].any() for g in got)


SUB = sp.SUB_TILE
LOG2E = 1.0 / math.log(2.0)
with open(f"{build.CSRC}/sparse_attention_tf32.cu") as _f:
    # the forward's walk entries a step, as the source streams them
    FEPS = int(re.search(r"constexpr int FEPS = (\d+);", _f.read()).group(1))


def _fwd_model(q, k, v, mask, plan, causal, scale, terms, cap=None):
    """o and lse as the 3xTF32 forward computes them from q, k, v ([B, S,
    H, D] fp32) and the key mask, over dq's 16-row work list at ``cap``.
    Per item, each warp w runs an online softmax over the walk's entries
    its bit lists, FEPS entries a step: s = q.k^T (q unscaled) by
    :func:`_mm`, scaled in fp32 into base 2; a masked pair (a key the mask
    drops, one above the diagonal of the warp's own block) is -inf and
    leaves the max and the sum; a step with nothing visible leaves the
    state as it was; each step's p.v (by :func:`_mm`) is folded into the
    rescaled o by an fp32 add. An unsplit item writes o = acc / l and lse
    = m ln 2 + ln l (0 and -1e30 where it saw no key); a split item's
    pieces leave (m, l, acc), combined in piece order. Returns o [B, S, H,
    D] and lse [B, H, S]."""
    work = plan.work16("fwd", causal, cap)
    b, s, h, d = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, h, s), float("nan"))
    part_o = torch.full((b, work.n_slots, sp.TC_TILE, d), float("nan"))
    part_ml = torch.full((b, work.n_slots, sp.TC_TILE, 2), float("nan"))
    ar = torch.arange(SUB)
    ninf = torch.tensor(float("-inf"))
    sl = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)

    def finish(m, l, acc, h_, rows):
        seen = l > 0
        o = torch.where(seen[..., None],
                        acc / torch.where(seen, l, 1.0)[..., None], 0.0)
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
        for step in range(0, cnt, FEPS):
            for w, rw in enumerate(rows):
                listed = [row_e for row_e, bits in ents[step:step + FEPS]
                          if bits >> w & 1]
                if not listed:
                    continue
                qi = rw + ar
                kj = torch.cat([row_e + ar for row_e in listed])
                x = _mm(q[:, qi, h_], k[:, kj, h_].transpose(-1, -2),
                        terms) * sl
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
                acc[:, at] = acc[:, at] * a[..., None] + _mm(p, v[:, kj, h_],
                                                             terms)
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
        l = torch.zeros_like(big)
        acc = torch.zeros(b, sp.TC_TILE, d)
        for p in range(count):                               # piece order
            l = l + wgt[:, p] * part_ml[:, first + p, :, 1]
            acc = acc + wgt[:, p, :, None] * part_o[:, first + p]
        finish(big, l, acc, h_, rows)
    return out, lse


def _fwd_errors(o, lse, want_o, want_lse):
    """o's max |err| over the reference's largest |value|, and lse's max
    |err| on the rows with a visible key (the rows without one must agree
    exactly: -1e30)."""
    want_o, want_lse = np.asarray(want_o), np.asarray(want_lse)
    seen = want_lse > sp.NEG_INF / 2
    assert np.array_equal(lse.numpy() > sp.NEG_INF / 2, seen)
    assert (lse.numpy()[~seen] == np.float32(sp.NEG_INF)).all()
    return (float(np.abs(o.numpy() - want_o).max() / np.abs(want_o).max()),
            float(np.abs(lse.numpy()[seen] - want_lse[seen]).max()))


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_3xtf32_forward_model_matches_jax_and_plain(case):
    """The 3xTF32 model of the forward against JAX's
    ``sparse_attention(..., impl="pallas", interpret=True)`` (o; its lse
    from the same kernel, ``_sparse_forward``) and the port's fp32 plain
    version on the same inputs: o within 1e-5 of the reference's largest
    |value|, lse within 1e-5 on the rows with a visible key, with no split
    and at cap 1 (one step of 64 rows: every longer walk splits); the
    pieces combined equal the unsplit walk to 1e-5; the one-product model
    misses 1e-5 in o and in lse. With the key mask, batch row 1 is all
    padding: its o is exactly 0 and its lse -1e30."""
    cfg, causal, masked = MODEL_CASES[case]
    block = cfg["block"]
    layout = sparsity_config_from_dict(cfg, HEADS).make_layout(SEQ)
    rng = np.random.default_rng(71 + block)
    q, k, v = (rng.normal(size=(2, SEQ, HEADS, HEAD_DIM)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((2, SEQ), np.int32)
        mask[0, SEQ - 37:] = 0
        mask[1] = 0
    scale = HEAD_DIM ** -0.5
    jmask = None if mask is None else jnp.asarray(mask)
    jo = jax_ops.sparse_attention(
        *(jnp.asarray(x) for x in (q, k, v)), layout, block, causal=causal,
        impl="pallas", interpret=True, key_mask=jmask)

    def bhsd(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(
            2 * HEADS, SEQ, HEAD_DIM)

    kv_idx, _ = jax_ops.layout_kv_indices(layout)
    _o, jlse = jax_ops._sparse_forward(
        bhsd(q), bhsd(k), bhsd(v),
        None if mask is None else jnp.asarray(mask, jnp.float32)[:, None, :],
        jnp.asarray(kv_idx), jnp.asarray(layout.sum(-1).astype(np.int32)),
        block, causal, scale, HEADS, True)
    want_jax = (np.asarray(jo),
                np.asarray(jlse)[..., 0].reshape(2, HEADS, SEQ))
    plan = sp.sparse_plan(layout, block)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask).float()
    want_plain = sp.sparse_fwd_reference(tq, tk, tv, tm, plan, causal, scale)
    assert plan.work16("fwd", causal, 1).n_split > 0
    assert plan.work16("fwd", causal).n_split == 0
    got = {(terms, cap): _fwd_model(tq, tk, tv, tm, plan, causal, scale,
                                    terms, cap)
           for terms, cap in ((3, None), (3, 1), (1, None))}
    for o, lse in got.values():
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        if masked:
            assert (o[1] == 0).all()
            assert (lse[1] == np.float32(sp.NEG_INF)).all()
    for ref_name, (want_o, want_lse) in (("jax", want_jax),
                                         ("plain", want_plain)):
        for cap in (None, 1):
            errs = _fwd_errors(*got[(3, cap)], want_o, want_lse)
            assert max(errs) <= REL, (ref_name, cap, errs)
        errs = _fwd_errors(*got[(1, None)], want_o, want_lse)
        assert min(errs) > REL, (ref_name, "one product", errs)
    errs = _fwd_errors(*got[(3, 1)], *got[(3, None)])
    assert max(errs) <= REL, ("pieces against the unsplit walk", errs)

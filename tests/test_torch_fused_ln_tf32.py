"""The 3xTF32 route of the fused LayerNorm + projection in fp32
(``csrc/fused_ln_tf32.cu``), on the CPU: which kernels ``_route`` picks,
the ``_tf32`` and ``_tc`` wrappers' walls, a missing ``nvcc``, and plain
PyTorch models of the new kernels' arithmetic and of their partition of
the sums.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain versions. Here the model of their arithmetic splits
every fp32 operand of the products (ln and W in the forward and the GELU
recompute; g and W in dln = g W; g and ln in dW = g^T ln) into hi =
tf32(x) and lo = tf32(x - hi), ``cvt.rna.tf32.f32`` emulated with int32
bit operations, takes each product as lo.hi + hi.lo + hi.hi over windows
of FOLD k-steps of 8 (the tensor cores' sum) and folds each window into
the running sum with an fp32 add, in the kernel's order; dW's rows in
the kernel's chunks, summed in chunk order. On numpy-made inputs, with
GELU and without, the model stays within 5e-5 of the RMS of both the JAX
kernels (``interpret=True``) and the port's plain versions, the limit
``chip_smoke.py`` holds the kernels to; one TF32 product (hi.hi) does
not, which is why the kernels pay for three. A second model keeps the
products in fp32 and checks the partition alone (dbias in 16-row
partials, dgamma and dbeta in 32-row ones, each set added by the reduce
kernel's eight warps; dW in 32-row windows within its chunks) against
JAX's sequential grid at 1e-5 of the largest value.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import fused as jfused
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer import fused

torch.set_num_threads(1)

EPS = 1e-5
LIMIT = 5e-5          # of each output's RMS: chip_smoke.FUSED_LN_TOL fp32
REDUCE_WARPS = 8
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
SOURCE = os.path.join(os.path.dirname(build.__file__), os.pardir, "csrc",
                      "fused_ln_tf32.cu")


def _constant(name):
    """A ``constexpr int`` of csrc/fused_ln_tf32.cu, read from its text."""
    with open(SOURCE) as fh:
        found = re.findall(rf"constexpr int {name} = (\d+);", fh.read())
    assert len(found) == 1, (name, found)
    return int(found[0])


WINDOW = _constant("FOLD") * _constant("KSTEP")   # k a fold sums: 32
BK = _constant("BK")


@pytest.mark.parametrize("dtype,d,route", [
    (F32, 8, "fused_ln_tf32"), (F32, 136, "fused_ln_tf32"),
    (F32, 768, "fused_ln_tf32"), (F32, 1600, "fused_ln_tf32"),
    (F32, 2048, "fused_ln_tf32"),
    (BF16, 768, "fused_ln_tc"), (F16, 1600, "fused_ln_tc"),
    (BF16, 2048, "fused_ln_tc"), (F16, 2048, "fused_ln_tc")])
def test_route(dtype, d, route):
    """fp32 takes the 3xTF32 kernels at every D the gate admits; 16-bit
    types keep theirs, the wgmma kernels at every D (the resident panel up
    to TC_MAX_D, the streamed product above)."""
    assert fused._route(dtype, d) == route


def test_gemm_stages_fit_shared_memory():
    """The products' ring (raw A, B hi and B lo a stage) and its barriers
    fit the 232,448 bytes a block may use, and the block's tile is the
    two warpgroups' 64 x 128 tiles."""
    bm, bn, stages = _constant("BM"), _constant("BN"), _constant("STAGES")
    assert bm == 64 + _constant("WG_ROWS") and bn == 128 + _constant(
        "WG_COLS")
    assert (bm + 2 * bn) * BK * 4 * stages + 16 * stages <= 232448
    assert WINDOW % 8 == 0 and BK == 32


def _case(dtype, n=16, d=64, f=32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(*s, generator=g).to(dtype) for s in
            ((n, d), (d,), (d,), (f, d), (f,))] + [
        torch.randn(n, f, generator=g).to(dtype)]


@pytest.mark.parametrize("dtype,d", [(BF16, 768), (F16, 136),
                                     (BF16, 2048)])
def test_tf32_wrappers_refuse_16_bits(dtype, d):
    """The _tf32 wrappers take float32 only, before building anything;
    nothing is launched or counted."""
    x, gamma, beta, w, bias, dy = _case(dtype, d=d)
    before = (fused.ln_matmul_fwd_tf32.launches,
              fused.ln_matmul_bwd_tf32.launches)
    with pytest.raises(ValueError, match="3xTF32 fused_ln kernels"):
        fused.ln_matmul_fwd_tf32(x, gamma, beta, w, bias)
    with pytest.raises(ValueError, match="3xTF32 fused_ln kernels"):
        fused.ln_matmul_bwd_tf32(x, gamma, beta, w, bias, dy,
                                 activation="gelu")
    assert (fused.ln_matmul_fwd_tf32.launches,
            fused.ln_matmul_bwd_tf32.launches) == before


@pytest.mark.parametrize("d", [768, 2048])
def test_tc_wrappers_refuse_fp32(d):
    x, gamma, beta, w, bias, dy = _case(F32, d=d)
    with pytest.raises(ValueError, match="wgmma fused_ln kernels"):
        fused.ln_matmul_fwd_tc(x, gamma, beta, w, bias)
    with pytest.raises(ValueError, match="wgmma fused_ln kernels"):
        fused.ln_matmul_bwd_tc(x, gamma, beta, w, bias, dy)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the 3xTF32 kernels cannot be built and their wrappers
    (and the routed ones) raise; nothing falls back to fused_ln.cu or the
    plain versions, and no launch is counted."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(fused, "_FN", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("fused_ln_tf32")
    x, gamma, beta, w, bias, dy = _case(F32)
    counters = (fused.ln_matmul_fwd_tf32, fused.ln_matmul_bwd_tf32,
                fused.ln_matmul_fwd, fused.ln_matmul_bwd)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused.ln_matmul_fwd_tf32(x, gamma, beta, w, bias)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused.ln_matmul_fwd(x, gamma, beta, w, bias)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused.ln_matmul_bwd(x, gamma, beta, w, bias, dy, activation="gelu")
    assert [c.launches for c in counters] == before
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the nearest value with 10 mantissa bits, ties
    away from zero (half of the dropped 13 bits' range added to the
    magnitude's bits, then those bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, terms):
    """a [M, K] @ b [K, N] as a kernel block sums it: per window of WINDOW
    k the tensor cores' lo.hi + hi.lo + hi.hi (hi.hi alone with
    ``terms`` 1), folded into the running sum by an fp32 add, windows in
    order; ``terms`` 0 multiplies in fp32 (the partition alone)."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], WINDOW):
        aw, bw = a[:, k:k + WINDOW], b[k:k + WINDOW]
        if terms == 0:
            part = aw @ bw
        else:
            ah, bh = _tf32(aw), _tf32(bw)
            part = ah @ bh
            if terms == 3:
                part = _tf32(aw - ah) @ bh + ah @ _tf32(bw - bh) + part
        out = out + part
    return out


def _reduce(parts):
    """reduce_kernel: warp w sums the partials w, w + 8, ... in order,
    then the eight warps' sums are added in warp order."""
    zero = torch.zeros_like(parts[0])
    sums = []
    for w in range(REDUCE_WARPS):
        a = zero.clone()
        for t in range(w, len(parts), REDUCE_WARPS):
            a = a + parts[t]
        sums.append(a)
    total = zero.clone()
    for a in sums:
        total = total + a
    return total


def _blocks(t, rows):
    return [t[i:i + rows].sum(0) for i in range(0, t.shape[0], rows)]


def _cdiv(a, b):
    return -(-a // b)


def _dw_split(n, d, f, sms=132):
    """csrc/fused_ln_tf32.cu:dw_split: (chunks, rows a chunk)."""
    tiles = _cdiv(f, _constant("BM")) * _cdiv(d, _constant("BN"))
    best_w, best_s = _cdiv(tiles, sms), 1
    for s in range(2, _constant("MAX_SPLIT") + 1):
        if s * _constant("MIN_CHUNK") > n:
            break
        w = _cdiv(tiles * s, sms)
        if w * best_s < best_w * s:
            best_w, best_s = w, s
    chunk = _cdiv(_cdiv(n, best_s), BK) * BK
    return _cdiv(n, chunk), chunk


def _model(x, gamma, beta, w, bias, dy, act, terms, sms=132):
    """y and (dx, dgamma, dbeta, dw [F, D], dbias) as the 3xTF32 kernels
    compute them (``terms``: as :func:`_product`), fp32, w [F, D]."""
    ln, xhat, rstd = fused._layernorm_rows(x, gamma, beta, EPS)
    pre = _product(ln, w.t(), terms) + bias
    y = fused._gelu_tanh(pre) if act == "gelu" else pre
    g = dy * fused._gelu_tanh_grad(pre) if act == "gelu" else dy
    dbias = _reduce(_blocks(g, 16))
    dln = _product(g, w, terms)
    dxhat = dln * gamma
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dgamma = _reduce(_blocks(dln * xhat, 32))
    dbeta = _reduce(_blocks(dln, 32))
    _splits, chunk = _dw_split(*x.shape, w.shape[0], sms)
    dw = _reduce([_product(g[i:i + chunk].t(), ln[i:i + chunk], terms)
                  for i in range(0, x.shape[0], chunk)])
    return y, (dx, dgamma, dbeta, dw, dbias)


def _inputs(seed, n, d, f):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, d)) * 2 + 0.5).astype(np.float32),
            (1 + 0.1 * rng.normal(size=d)).astype(np.float32),
            (0.1 * rng.normal(size=d)).astype(np.float32),
            (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.normal(size=f)).astype(np.float32),
            rng.normal(size=(n, f)).astype(np.float32))


def _jax(x, gamma, beta, w, bias, dy, act):
    """JAX's kernels (interpret): y, then (dx, dgamma, dbeta, dw [F, D],
    dbias)."""
    args = [jnp.asarray(a) for a in (x, gamma, beta, w, bias)]
    y = jfused._run_fwd(*args, EPS, act, 128, True)
    dx, dw, dbias, dg, db = jfused._run_bwd(*args, jnp.asarray(dy), EPS,
                                            act, 128, True)
    return np.asarray(y), [np.asarray(a) for a in (dx, dg, db, dw.T, dbias)]


NAMES = ("y", "dx", "dgamma", "dbeta", "dw", "dbias")


@pytest.mark.parametrize("n,d,f,act", [
    (320, 136, 200, None),         # ragged depth, rows and columns
    (320, 136, 200, "gelu"),
    (256, 256, 384, "gelu")])
def test_3xtf32_model_matches_jax_and_plain(n, d, f, act):
    """The model within 5e-5 of each output's RMS against JAX's kernels
    and the port's plain versions; one TF32 product beyond it for y, dx
    and dw, the outputs a product feeds straight."""
    x, gamma, beta, w, bias, dy = _inputs(11 + n + d, n, d, f)
    jy, jgrads = _jax(x, gamma, beta, w, bias, dy, act)
    t = [torch.from_numpy(a) for a in (x, gamma, beta, w.T.copy(), bias,
                                       dy)]
    py = fused.ln_matmul_reference(*t[:5], eps=EPS, activation=act)
    pgrads = fused.ln_matmul_bwd_reference(*t, eps=EPS, activation=act)
    refs = {"jax": [jy] + jgrads,
            "plain": [py.numpy()] + [g.numpy() for g in pgrads]}
    for terms in (3, 1):
        y, grads = _model(*t, act, terms)
        got = [y.numpy()] + [g.numpy() for g in grads]
        for ref_name, want in refs.items():
            rel = {}
            for name, g, wnt in zip(NAMES, got, want):
                assert g.shape == wnt.shape, (name, g.shape, wnt.shape)
                rms = float(np.sqrt(np.mean(np.square(wnt, dtype=np.float64))))
                rel[name] = float(np.abs(g - wnt).max()) / rms
            if terms == 3:
                assert max(rel.values()) <= LIMIT, (ref_name, rel)
            else:
                assert min(rel[k] for k in ("y", "dx", "dw")) > LIMIT, (
                    ref_name, rel)


def test_dw_split_rule():
    """dW's chunks at the path's sites on 132 SMs: 144 tiles (fc) in 8
    chunks of 1024 rows (1.125 waves a chunk, not 2); 108 (qkv) in 6 of
    1376 (5 waves over 6 chunks, not 1 over 1); no split below
    2 x MIN_CHUNK rows."""
    assert _dw_split(8192, 768, 3072) == (8, 1024)
    assert _dw_split(8192, 768, 2304) == (6, 1376)
    assert _dw_split(300, 136, 200) == (1, 320)
    assert _dw_split(2048, 64, 128) == (2, 1024)


@pytest.mark.parametrize("n,d,f,act", [
    (2048, 64, 128, None),        # two dW chunks of 1024 rows
    (2048, 64, 128, "gelu"),
    (384, 1024, 1152, "gelu")])   # 72 dW tiles, one chunk
def test_fixed_order_partition_matches_jax(n, d, f, act):
    """The kernels' partition of the sums, products in fp32: within 1e-5
    of the largest |value| of each of JAX's outputs."""
    x, gamma, beta, w, bias, dy = _inputs(7, n, d, f)
    jy, jgrads = _jax(x, gamma, beta, w, bias, dy, act)
    y, grads = _model(*(torch.from_numpy(a) for a in
                        (x, gamma, beta, w.T.copy(), bias, dy)), act, 0)
    for name, g, wnt in zip(NAMES, [y] + list(grads), [jy] + jgrads):
        g = g.numpy()
        assert g.shape == wnt.shape, name
        err = float(np.abs(g - wnt).max())
        assert err <= 1e-5 * float(np.abs(wnt).max()), (name, err)

"""The wgmma route of the fused LayerNorm + projection
(``csrc/fused_ln_tc.cu``), on the CPU: which kernels ``_route`` picks, the
``_tc`` wrappers' walls, and a plain model of how the new backward splits
and orders its sums over rows, against the JAX ``_bwd_kernel`` (Pallas,
interpret mode).

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against the plain versions there). What the CPU can check is the
arithmetic of their partition: dbias summed in 16-row partials (a warp's
rows in the GELU recompute, the panel's or above TC_MAX_D the streamed
product's, or a block of the column pass), dgamma and dbeta
in 32-row partials (the row pass), each set of partials added by the
reduce kernel's eight warps, each taking every eighth partial in order,
then the eight sums in warp order, and dW as one block a 128 x 128 tile
sums it: all the rows in 64-row boxes, in order, with no split over
rows. The model does this in fp32 and must agree with JAX's
sequential grid within 1e-5 of the largest |value| of each output: the
same sums in another order, over at most 512 rows.
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

# One intra-op thread: the tests run in several worker processes at once.
torch.set_num_threads(1)

EPS = 1e-5
REDUCE_WARPS = 8
SOURCE = os.path.join(os.path.dirname(build.__file__), os.pardir, "csrc",
                      "fused_ln_tc.cu")


def _constant(name):
    """A ``constexpr int`` of csrc/fused_ln_tc.cu, read from its text."""
    with open(SOURCE) as fh:
        found = re.findall(rf"constexpr int {name} = (\d+);", fh.read())
    assert len(found) == 1, (name, found)
    return int(found[0])


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 768, "fused_ln_tc"),       # GPT-2
    (torch.float16, 1024, "fused_ln_tc"),       # medium
    (torch.bfloat16, 1280, "fused_ln_tc"),      # large
    (torch.float16, 1600, "fused_ln_tc"),       # XL
    (torch.bfloat16, 1664, "fused_ln_tc"),      # the widest panel
    (torch.bfloat16, 1672, "fused_ln_tc"),      # streamed from here on
    (torch.float16, 2048, "fused_ln_tc"),       # GPT-3 XL
    (torch.float32, 768, "fused_ln_tf32"),
    (torch.float32, 136, "fused_ln_tf32"),
    (torch.bfloat16, 2560, "fused_ln_tc"),      # GPT-3 2.7B
    (torch.float16, 4096, "fused_ln_tc"),
    (torch.float32, 2048, "fused_ln_tf32")])
def test_route_by_dtype_and_width(dtype, d, route):
    """16-bit takes the wgmma kernels at every D the gate admits (the
    resident panel up to TC_MAX_D, the streamed product above), fp32 the
    3xTF32 ones: no D reaches csrc/fused_ln.cu."""
    assert fused._route(dtype, d) == route


def test_widest_panel_fits_shared_memory():
    """TC_MAX_D as derived, from the kernel source's own constants: the
    widest resident panel is the same in fused.py and the kernel (above
    it the kernel streams T(ln) instead), and at it the 64-row panel (128
    D bytes), two 8 KB stages of W (one warpgroup, 32 deep) and the
    barriers fit a block's 227 KB; the next multiple of 64 does not."""
    assert fused.TC_MAX_D == _constant("TC_MAX_D")
    smem, rows = _constant("SMEM_LIMIT"), _constant("PANEL_ROWS")
    bn, stages = _constant("BN"), _constant("MAX_STAGES")
    stage, bars = bn * 32 * 2, (2 * stages + 1) * 8
    assert rows * 2 * fused.TC_MAX_D + 2 * stage + bars <= smem
    assert rows * 2 * (fused.TC_MAX_D + 64) + 2 * stage + bars > smem
    assert fused.TC_MAX_D % 64 == 0


def test_streamed_ring_fits_shared_memory():
    """Above TC_MAX_D: the streamed product's ring (a 128 x 64 box of
    T(ln) and TBN / 128 boxes of W a stage) and its barriers fit a
    block's 227 KB at both tile widths, which are whole 128-column wgmma
    tiles."""
    smem, bn, k = _constant("SMEM_LIMIT"), _constant("BN"), _constant(
        "GEMM_K")
    stages = _constant("FWD_STAGES")
    for tbn in (_constant("FWD_BN"), _constant("GELU_BN")):
        assert tbn % bn == 0
        assert stages * (128 + tbn) * k * 2 + 2 * stages * 8 <= smem


def _stream_tile(block, n, f, tbn, group):
    """stream_gemm_kernel's tile order: block -> (m0, col0)."""
    mt, nt = -(-n // 128), -(-f // tbn)
    first = block // (group * nt) * group
    rows = min(group, mt - first)
    inside = block % (group * nt)
    return (first + inside % rows) * 128, inside // rows * tbn


@pytest.mark.parametrize("n,f,tbn", [(8192, 6144, 256), (8192, 8192, 128),
                                     (300, 264, 256), (8, 6144, 256),
                                     (1000, 200, 128)])
@pytest.mark.parametrize("group", [1, 8, 16, 64])
def test_stream_tile_order_covers_every_tile_once(n, f, tbn, group):
    """The 1-D grid of ceil(n / 128) x ceil(F / TBN) blocks, walked in
    groups of row tiles (the last group ragged), names every output tile
    exactly once; the source's group is among those checked."""
    assert _constant("FWD_GROUP") in (1, 8, 16, 64)
    blocks = -(-n // 128) * -(-f // tbn)
    tiles = [_stream_tile(b, n, f, tbn, group) for b in range(blocks)]
    assert len(set(tiles)) == blocks
    assert all(m0 < n and c0 < f for m0, c0 in tiles)


def _case(dtype, n=16, d=64, f=32):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(*s, generator=g).to(dtype) for s in
            ((n, d), (d,), (d,), (f, d), (f,))] + [
        torch.randn(n, f, generator=g).to(dtype)]


# (dtype, D) -> whether the _tc wrappers refuse it: fp32 and D not a
# multiple of 8 are other routes; 16-bit D above TC_MAX_D is theirs
TC_REFUSES = {(torch.float32, 64): True, (torch.bfloat16, 2048): False,
              (torch.float16, 1672): False, (torch.bfloat16, 1668): True}


@pytest.mark.parametrize("dtype,d", list(TC_REFUSES))
def test_tc_wrappers_refuse_other_routes(dtype, d, monkeypatch, tmp_path):
    """The _tc wrappers take only their route, before building anything;
    16-bit D above TC_MAX_D is theirs, so there the call goes on to the
    build (which fails here, without nvcc: nothing falls back). Nothing is
    launched or counted either way."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(fused, "_FN", {})
    x, gamma, beta, w, bias, dy = _case(dtype, d=d)
    before = (fused.ln_matmul_fwd_tc.launches,
              fused.ln_matmul_bwd_tc.launches, fused.ln_matmul_fwd.launches,
              fused.ln_matmul_bwd.launches)
    err, match = ((ValueError, "wgmma fused_ln kernels") if TC_REFUSES[
        (dtype, d)] else (RuntimeError, "nvcc not found"))
    with pytest.raises(err, match=match):
        fused.ln_matmul_fwd_tc(x, gamma, beta, w, bias)
    with pytest.raises(err, match=match):
        fused.ln_matmul_bwd_tc(x, gamma, beta, w, bias, dy,
                               activation="gelu")
    assert (fused.ln_matmul_fwd_tc.launches,
            fused.ln_matmul_bwd_tc.launches, fused.ln_matmul_fwd.launches,
            fused.ln_matmul_bwd.launches) == before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """Without nvcc the wgmma kernels cannot be built and their wrappers
    raise; nothing falls back to the other route or the plain versions,
    and no launch is counted."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fused, "_FN", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("fused_ln_tc")
    x, gamma, beta, w, bias, dy = _case(torch.bfloat16)
    before = (fused.ln_matmul_fwd_tc.launches, fused.ln_matmul_fwd.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused.ln_matmul_fwd_tc(x, gamma, beta, w, bias)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused.ln_matmul_bwd(x, gamma, beta, w, bias, dy)
    assert (fused.ln_matmul_fwd_tc.launches,
            fused.ln_matmul_fwd.launches) == before
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the backward's partition of the sums over rows
# ---------------------------------------------------------------------------

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


def _tc_bwd_model(x, gamma, beta, w, bias, dy, act):
    """The new backward's sums in its partition and order, fp32, w [F, D];
    returns (dx, dgamma, dbeta, dw [F, D], dbias)."""
    ln, xhat, rstd = fused._layernorm_rows(x, gamma, beta, EPS)
    g = dy
    if act == "gelu":
        g = dy * fused._gelu_tanh_grad(ln @ w.t() + bias)
    dbias = _reduce(_blocks(g, 16))
    dln = g @ w
    dxhat = dln * gamma
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dgamma = _reduce(_blocks(dln * xhat, 32))
    dbeta = _reduce(_blocks(dln, 32))
    dw = torch.zeros_like(w)
    for b in range(0, x.shape[0], 64):
        dw = dw + g[b:b + 64].t() @ ln[b:b + 64]
    return dx, dgamma, dbeta, dw, dbias


@pytest.mark.parametrize("n,d,f,act", [
    (512, 128, 256, None),        # eight 64-row boxes of dW's depth
    (512, 128, 256, "gelu"),
    (384, 1024, 1152, "gelu"),    # 72 dW tiles, six boxes deep
    (160, 1728, 64, "gelu")])     # above TC_MAX_D: the streamed recompute
def test_fixed_order_partition_matches_jax(n, d, f, act):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(n, d)) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    beta = (0.1 * rng.normal(size=d)).astype(np.float32)
    w = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=f)).astype(np.float32)
    dy = rng.normal(size=(n, f)).astype(np.float32)
    want = jfused._run_bwd(*(jnp.asarray(a) for a in
                             (x, gamma, beta, w, bias, dy)),
                           EPS, act, 128, True)
    want = [np.asarray(a) for a in want]     # dx, dw [D, F], dbias, dg, db
    got = _tc_bwd_model(*(torch.from_numpy(a) for a in
                          (x, gamma, beta, w.T.copy(), bias, dy)), act)
    pairs = {"dx": (got[0], want[0]), "dgamma": (got[1], want[3]),
             "dbeta": (got[2], want[4]), "dw": (got[3].t(), want[1]),
             "dbias": (got[4], want[2])}
    for name, (g, wnt) in pairs.items():
        g = g.numpy()
        assert g.shape == wnt.shape, name
        err = float(np.abs(g - wnt).max())
        assert err <= 1e-5 * float(np.abs(wnt).max()), (name, err)

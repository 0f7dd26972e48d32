"""The wgmma flash forward, dq and dk/dv at head dims in (128, 256]
(deepspeed_tpu_torch): their route and their arithmetic.

``csrc/flash_attention_tc256.cu`` (bfloat16 and float16) runs only on the
card, where ``chip_smoke.py`` holds it against the plain versions and the
FMA kernels. Here: which kernel ``_route`` picks for the forward, dq and
dk/dv around D = 128 and 256, that the wgmma wrappers refuse the rest
(fp32, narrow or too wide heads, CPU tensors), that a missing ``nvcc``
raises, that the CPU path of ``flash_attention()`` at D = 256 is the JAX
kernels' function (``interpret=True``), and a plain PyTorch model of the
kernels' arithmetic: 16-bit-exact inputs, so fp32 products; the forward's
walk over 64-query blocks and 64-key tiles with the online softmax in
base-2 units; dk/dv over 64-key blocks walking 64-query tiles, p^T made
once (the dv warpgroup's) and shared with the dk warpgroup; dq over
64-query blocks walking 64-key tiles, p made by one warpgroup, ds by the
other; p (in p.V and dv) and ds (in dk and dq) split into hi = T(x) and
lo = T(x - hi). On numpy-made inputs the model stays within 1e-5 of the
largest value of the JAX kernels' o, dq, dk and dv (fp32), at dropout 0
and 0.1; one 16-bit term does not, which is why the kernels pay for the
second.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

torch.set_num_threads(1)

B, S, H = 1, 128, 2
REL = 1e-5          # of the reference's largest |value|
ATOL = 1e-5         # fp32 plain path against the JAX kernels
TILE = 64           # the kernels' rows a warpgroup owns and streams
LOG2E = 1.4426950408889634
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
WIDE = ("tc256",) * 3
F32_WIDE = ("tf32",) * 3


@pytest.mark.parametrize("dtype,head_dim,routes", [
    (F32, 128, ("tf32",) * 3), (F32, 136, F32_WIDE),
    (F32, 256, F32_WIDE), (F32, 264, ("fma",) * 3),
    (BF16, 128, ("tc",) * 3), (BF16, 136, WIDE), (BF16, 256, WIDE),
    (BF16, 264, ("fma",) * 3),
    (F16, 128, ("tc",) * 3), (F16, 136, WIDE), (F16, 256, WIDE),
    (F16, 264, ("fma",) * 3)])
def test_route(dtype, head_dim, routes):
    """16-bit types above D = 128 take the wgmma forward, dq and dk/dv;
    fp32 there the 3xTF32 forward, dq and dk/dv; D = 264 is past every
    kernel (the FMA route, which ``flash_ok`` refuses)."""
    assert tuple(fa._route(dtype, head_dim, w)
                 for w in ("fwd", "dq", "dkv")) == routes
    assert fa.flash_ok(torch.empty(1, 8, 1, head_dim, dtype=dtype,
                                   device="meta"),
                       torch.empty(1, 8, 1, head_dim, device="meta"),
                       True) == (head_dim <= 256)


@pytest.mark.parametrize("dtype,head_dim,device", [
    (F32, 256, "meta"), (BF16, 128, "meta"), (F16, 264, "meta"),
    (BF16, 256, "cpu"), (F32, 136, "meta"), (F16, 136, "cpu"),
    (BF16, 120, "meta")])
def test_wrappers_refuse_other_routes(dtype, head_dim, device):
    """The wgmma wrappers (forward, dq and dk/dv) raise, before any
    launch, for fp32 (3xTF32's route there), D <= 128, D > 256
    and CPU tensors; nothing falls back to another kernel."""
    q = torch.empty(1, 8, 1, head_dim, dtype=dtype, device=device)
    lse = torch.empty(1, 1, 8, device=device)
    wrappers = (fa.flash_attention_fwd_tc256, fa.flash_attention_bwd_dq_tc256,
                fa.flash_attention_bwd_dkv_tc256)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="wgmma flash kernels"):
        fa.flash_attention_fwd_tc256(q, q, q, None, True, 0.0625)
    with pytest.raises(ValueError, match="wgmma flash kernels"):
        fa.flash_attention_bwd_dq_tc256(q, q, q, q, None, lse, lse, True,
                                        0.0625)
    with pytest.raises(ValueError, match="wgmma flash kernels"):
        fa.flash_attention_bwd_dkv_tc256(q, q, q, q, None, lse, lse, True,
                                         0.0625)
    assert [w.launches for w in wrappers] == before


def test_missing_nvcc_raises_for_tc256(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("flash_attention_tc256")
    assert not list(tmp_path.iterdir())


def test_kernel_binds_only_what_the_library_exports(monkeypatch):
    """``_kernel`` takes the forward, dq and dk/dv that
    ``flash_attention_tc256`` exports, and of a library without dq no
    dq."""
    def fn():
        return lambda *a: 0

    full = SimpleNamespace(flash_attention_tc256_fwd=fn(),
                           flash_attention_tc256_bwd_dq=fn(),
                           flash_attention_tc256_bwd_dkv=fn(),
                           flash_attention_tc256_error_string=fn())
    part = SimpleNamespace(flash_attention_tc256_fwd=fn(),
                           flash_attention_tc256_bwd_dkv=fn(),
                           flash_attention_tc256_error_string=fn())
    for lib, want in ((full, ["dkv", "dq", "err", "fwd"]),
                      (part, ["dkv", "err", "fwd"])):
        monkeypatch.setattr(build, "load", lambda name, lib=lib: lib)
        monkeypatch.delitem(fa._FN, "flash_attention_tc256", raising=False)
        got = fa._kernel("flash_attention_tc256")
        monkeypatch.delitem(fa._FN, "flash_attention_tc256")
        assert sorted(got) == want
        assert got["fwd"] is lib.flash_attention_tc256_fwd
    assert got.get("dq") is None
    # dq's nine pointers (q, k, v, dO, mask, lse, delta, dq, strides)
    assert len(full.flash_attention_tc256_bwd_dq.argtypes) == 9 + 12


def _seed_of(key) -> int:
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ (kd[-1] << np.uint32(1)))


def _inputs(seed, d, dtype=None):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, H, d)).astype(np.float32)
                   for _ in range(4))
    if dtype is not None:       # exact in 16 bits
        q, k, v, do = (torch.from_numpy(x).to(dtype).float().numpy()
                       for x in (q, k, v, do))
    mask = np.ones((B, S), np.float32)
    mask[0, 100:] = 0.0          # a padded tail
    return q, k, v, do, mask


def _jax(q, k, v, do, mask, causal, rate, key):
    """JAX's flash_attention (interpret, 64-blocks): o, dq, dk, dv."""
    def f(q, k, v):
        out = jax_flash_attention(
            q, k, v, causal=causal,
            kv_mask=None if mask is None else jnp.asarray(mask),
            block_q=64, block_k=64, dropout_rate=rate,
            dropout_rng=key if rate else None, interpret=True)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.array(x) for x in (out, *grads)]


@pytest.mark.parametrize("causal,masked,rate", [
    (True, False, 0.0), (False, True, 0.0), (True, True, 0.1)])
def test_cpu_path_matches_jax_at_d256(causal, masked, rate):
    """``flash_attention()`` on CPU tensors at D = 256 (the plain version)
    against the JAX kernels: o and dq, dk, dv within 1e-5 (fp32), and
    bit-equal to the plain version's own call."""
    q, k, v, do, mask = _inputs(7 + masked, 256)
    mask = mask if masked else None
    key = jax.random.PRNGKey(3)
    seed = _seed_of(key) if rate else None
    want = _jax(q, k, v, do, mask, causal, rate, key)
    tm = None if mask is None else torch.from_numpy(mask)
    outs = []
    for fn in (fa.flash_attention, fa.flash_attention_reference):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ts, causal=causal, kv_mask=tm, dropout_rate=rate,
                 dropout_seed=seed)
        out.backward(torch.from_numpy(do))
        outs.append([out.detach()] + [t.grad for t in ts])
    for name, got, ref, w in zip(("o", "dq", "dk", "dv"), *outs, want):
        np.testing.assert_allclose(got.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)
        assert torch.equal(got, ref), name


def _terms(x, dtype, n):
    """x (fp32) as the kernels multiply it: hi = T(x), plus lo = T(x - hi)
    when n == 2."""
    hi = x.to(dtype).float()
    return hi if n == 1 else hi + (x - hi).to(dtype).float()


def _keep(seed, rows, cols, rate):
    """The keep-mask [B, H, rows, cols] of absolute query rows and key
    cols (1-D int64 tensors)."""
    bh = (torch.arange(B)[:, None] * H + torch.arange(H)[None, :])
    return fa.dropout_keep_mask(seed, bh[:, :, None, None], rows[:, None],
                                cols[None, :], rate)


def _fwd_model(q, k, v, mask, scale, dtype, n, rate, seed):
    """The forward kernel's arithmetic (causal, Sq = Sk): for each block of
    64 queries (a warpgroup's), the 64-key tiles it can see, s = q.k^T in
    fp32 times scale * log2(e), masked to -inf past the diagonal, the
    online softmax in base 2 (m, the rescale exp2(m - m'), the undropped
    row sum l), p times the key mask, dropped out, and o += T-terms(p).v;
    at the end o / max(l, 1e-30) and lse = m ln 2 + log max(l, 1e-30).
    Tensors [B, H, S, D] fp32; returns o and lse."""
    sl = scale * LOG2E
    outs, lses = [], []
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, q0 + TILE)
        acc = torch.zeros(B, H, TILE, q.shape[-1])
        m = torch.full((B, H, TILE, 1), -math.inf)
        l = torch.zeros(B, H, TILE, 1)
        for k0 in range(0, q0 + TILE, TILE):
            cols = torch.arange(k0, k0 + TILE)
            x = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows],
                             k[:, :, cols]) * sl
            x = x.masked_fill(cols[None, :] > rows[:, None], -math.inf)
            mn = torch.maximum(m, x.amax(-1, keepdim=True))
            a = torch.where(mn == -math.inf, 1.0,
                            torch.where(m == -math.inf, 0.0,
                                        torch.exp2(m - mn)))
            p = torch.where(x == -math.inf, 0.0, torch.exp2(x - mn))
            p = p * mask[:, None, None, cols]
            l = l * a + p.sum(-1, keepdim=True)
            m = mn
            if rate:
                p = torch.where(_keep(seed, rows, cols, rate),
                                p * (1.0 / (1.0 - rate)), 0.0)
            acc = acc * a + torch.einsum("bhqk,bhkd->bhqd",
                                         _terms(p, dtype, n), v[:, :, cols])
        ls = l.clamp_min(1e-30)
        outs.append(acc / ls)
        lses.append((m * math.log(2.0) + torch.log(ls))[..., 0])
    return torch.cat(outs, 2), torch.cat(lses, 2)


def _dkv_model(q, k, v, do, mask, lse, delta, scale, dtype, n, rate, seed):
    """The dk/dv kernel's arithmetic (causal, Sq = Sk): for each block of
    64 keys, the 64-query tiles that can see it; the dv warpgroup's p^T =
    exp2(s^T scale log2(e) - lse_i log2(e)) times the key mask (0 past the
    diagonal), shared with the dk warpgroup as it is; dv += T-terms(D
    p^T).dO; the dk warpgroup's dp^T = v.dO^T, ds^T = p^T (D dp^T -
    delta_i), dk += T-terms(ds^T).q; dk times scale at the end. [B, H, S,
    D] fp32; lse and delta [B, H, S]."""
    sl = scale * LOG2E
    inv = 1.0 / (1.0 - rate) if rate else 1.0
    dks, dvs = [], []
    for k0 in range(0, S, TILE):
        cols = torch.arange(k0, k0 + TILE)
        dk = torch.zeros(B, H, TILE, q.shape[-1])
        dv = torch.zeros_like(dk)
        for q0 in range(k0 // TILE * TILE, S, TILE):
            rows = torch.arange(q0, q0 + TILE)
            st = torch.einsum("bhkd,bhqd->bhkq", k[:, :, cols],
                              q[:, :, rows])
            pt = torch.exp2(st * sl - (lse[:, :, rows] * LOG2E)[:, :, None])
            pt = pt.masked_fill(cols[:, None] > rows[None, :], 0.0)
            pt = pt * mask[:, None, cols, None]
            kept = (_keep(seed, rows, cols, rate).transpose(-1, -2) if rate
                    else torch.ones_like(pt, dtype=torch.bool))
            dv += torch.einsum("bhkq,bhqd->bhkd",
                               _terms(torch.where(kept, pt * inv, 0.0),
                                      dtype, n), do[:, :, rows])
            dpt = torch.einsum("bhkd,bhqd->bhkq", v[:, :, cols],
                               do[:, :, rows])
            dst = pt * (torch.where(kept, dpt * inv, 0.0)
                        - delta[:, :, None, rows])
            dk += torch.einsum("bhkq,bhqd->bhkd", _terms(dst, dtype, n),
                               q[:, :, rows])
        dks.append(dk * scale)
        dvs.append(dv)
    return torch.cat(dks, 2), torch.cat(dvs, 2)


def _dq_model(q, k, v, do, mask, lse, delta, scale, dtype, n, rate, seed):
    """The dq kernel's arithmetic (causal, Sq = Sk): for each block of 64
    queries, the 64-key tiles its last query can see; warpgroup 0's p =
    exp2(s scale log2(e) - lse_i log2(e)) from s = q.k^T in fp32 (as the
    forward scales s), times the key mask and 0 past the diagonal;
    warpgroup 1's dp = dO.v^T, dropped out, and ds = p (D dp - delta_i),
    handed back as T-terms(ds); dq += T-terms(ds).k (each warpgroup over
    half of the head dim's columns, which leaves each column's sum as it
    is); dq times scale at the end. [B, H, S, D] fp32; lse and delta [B,
    H, S]."""
    sl = scale * LOG2E
    inv = 1.0 / (1.0 - rate) if rate else 1.0
    dqs = []
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, q0 + TILE)
        dq = torch.zeros(B, H, TILE, q.shape[-1])
        for k0 in range(0, q0 + TILE, TILE):
            cols = torch.arange(k0, k0 + TILE)
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, rows], k[:, :, cols])
            p = torch.exp2(s * sl - (lse[:, :, rows] * LOG2E)[..., None])
            p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
            p = p * mask[:, None, None, cols]
            dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, rows],
                              v[:, :, cols])
            if rate:
                dp = torch.where(_keep(seed, rows, cols, rate), dp * inv,
                                 0.0)
            ds = p * (dp - delta[:, :, rows, None])
            dq += torch.einsum("bhqk,bhkd->bhqd", _terms(ds, dtype, n),
                               k[:, :, cols])
        dqs.append(dq * scale)
    return torch.cat(dqs, 2)


def _lse_delta(tq, tk, tdo, tm, o, scale):
    """The forward's lse (of the fp32 scores, causal, under the key mask)
    and delta = rowsum(dO * o), [B, H, S], from [B, H, S, D] tensors and
    o [B, S, H, D] (numpy)."""
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk) * scale
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf)
    mx = s.amax(-1, keepdim=True)
    lse = (mx + torch.log((torch.exp(s - mx) * tm[:, None, None, :])
                          .sum(-1, keepdim=True).clamp_min(1e-30)))[..., 0]
    return lse, (tdo * torch.from_numpy(o).transpose(1, 2)).sum(-1)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,d", [(BF16, 256), (F16, 256), (BF16, 136),
                                     (F16, 136)])
def test_dq_model_matches_jax(dtype, d, rate):
    """The dq model with ds in two 16-bit terms against the JAX
    ``_bwd_dq_kernel`` (interpret, fp32, causal, key-padded, through
    ``jax.grad``): within 1e-5 of its largest |dq|, at dropout 0 and 0.1,
    in bf16 and fp16 at D = 256 and 136; with one term, not."""
    q, k, v, do, mask = _inputs(53 + d + int(rate * 10), d, dtype)
    key = jax.random.PRNGKey(13)
    seed = _seed_of(key) if rate else None
    want_o, want_dq, _dk, _dv = _jax(q, k, v, do, mask, True, rate, key)
    scale = 1.0 / d ** 0.5
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    tm = torch.from_numpy(mask)
    lse, delta = _lse_delta(tq, tk, tdo, tm, want_o, scale)
    for n, within in ((2, True), (1, False)):
        dq = _dq_model(tq, tk, tv, tdo, tm, lse, delta, scale, dtype, n,
                       rate, seed)
        err = float(np.abs(dq.transpose(1, 2).numpy() - want_dq).max()
                    / np.abs(want_dq).max())
        if within:
            assert err <= REL, (n, err)
        else:
            assert err > REL, (n, err)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype,d", [(BF16, 256), (F16, 256), (BF16, 136)])
def test_split_operand_model_matches_jax(dtype, d, rate):
    """The model with p and ds in two 16-bit terms against the JAX kernels
    (interpret, fp32, causal, key-padded): o, dk and dv within 1e-5 of
    the largest |value| of each, at dropout 0 and 0.1; with one term,
    not. The backward model gets the JAX forward's lse (recomputed as its
    plain version has it) and delta = rowsum(dO * o)."""
    q, k, v, do, mask = _inputs(31 + d + int(rate * 10), d, dtype)
    key = jax.random.PRNGKey(11)
    seed = _seed_of(key) if rate else None
    want_o, _dq, want_dk, want_dv = _jax(q, k, v, do, mask, True, rate, key)
    scale = 1.0 / d ** 0.5
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    tm = torch.from_numpy(mask)
    lse, delta = _lse_delta(tq, tk, tdo, tm, want_o, scale)
    for n, within in ((2, True), (1, False)):
        o, lse_m = _fwd_model(tq, tk, tv, tm, scale, dtype, n, rate, seed)
        np.testing.assert_allclose(lse_m.numpy(), lse.numpy(), atol=1e-5,
                                   rtol=0)
        dk, dv = _dkv_model(tq, tk, tv, tdo, tm, lse, delta, scale, dtype,
                            n, rate, seed)
        errs = [float(np.abs(g.transpose(1, 2).numpy() - w).max()
                      / np.abs(w).max())
                for g, w in ((o, want_o), (dk, want_dk), (dv, want_dv))]
        if within:
            assert max(errs) <= REL, (n, errs)
        else:
            assert min(errs) > REL, (n, errs)

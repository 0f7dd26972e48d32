"""The tensor-core flash kernels' route and their one numerical choice
(deepspeed_tpu_torch).

``csrc/flash_attention_tc.cu`` (the forward, dq and dk/dv for bfloat16
and float16) runs only on the card, where ``chip_smoke.py`` holds it
against the plain versions. Here: which dtypes and head dims ``_route``
sends to it (dq exactly as dk/dv), that its wrappers refuse the rest, and
a plain PyTorch model of its arithmetic: the inputs are exact in 16 bits,
so their products are exact in fp32; p (in p.V and in dv) and ds (in dq
and dk) are fp32, and the kernel splits each into two 16-bit terms, hi =
T(x) and lo = T(x - hi), whose products it sums in fp32. The model, on
the same numpy-made inputs as the JAX kernel (``interpret=True``, fp32)
and the port's fp32 plain versions, stays within 1e-5 of the reference's
largest value, with and without dropout; one rounding of p or ds to 16
bits does not, which is why the kernel pays for the second term.
"""

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

B, S, H, D = 2, 128, 2, 16
REL = 1e-5          # of the reference's largest |value|


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "tc"), (torch.float16, 64, "tc"),
    (torch.bfloat16, 8, "tc"), (torch.float16, 72, "tc"),
    (torch.bfloat16, 128, "tc"), (torch.float16, 128, "tc"),
    (torch.float32, 64, "tf32"), (torch.float32, 128, "tf32"),
    (torch.float32, 256, "tf32"), (torch.bfloat16, 136, "tc256"),
    (torch.float16, 256, "tc256"), (torch.bfloat16, 60, "fma")])
def test_route(dtype, head_dim, route):
    """The forward's route: 16-bit types with head_dim a multiple of 8 up
    to 128 take the tensor cores, fp32 3xTF32 on them up to 256; 16-bit
    above 128 the wgmma kernels; head dims not a multiple of 8 the FMA
    kernels."""
    assert fa._route(dtype, head_dim) == route


@pytest.mark.parametrize("dtype,head_dim", [(torch.float32, 64),
                                            (torch.bfloat16, 256)])
def test_tc_wrappers_refuse_other_routes(dtype, head_dim):
    """The tensor-core wrappers raise, before any launch, for what they do
    not take; nothing falls back to another kernel."""
    q = torch.empty(1, 8, 1, head_dim, dtype=dtype, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="tensor-core flash kernels"):
        fa.flash_attention_fwd_tc(q, q, q, None, True, 0.125)
    with pytest.raises(ValueError, match="tensor-core flash kernels"):
        fa.flash_attention_bwd_dkv_tc(q, q, q, q, None, lse, lse, True,
                                      0.125)
    assert (fa.flash_attention_fwd_tc.launches,
            fa.flash_attention_bwd_dkv_tc.launches) == (0, 0)


def test_missing_nvcc_raises_for_tc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("flash_attention_tc")
    assert not list(tmp_path.iterdir())


def _terms(x, dtype, n):
    """x (fp32) as the kernel multiplies it: hi = T(x), plus lo = T(x - hi)
    when n == 2."""
    hi = x.to(dtype).float()
    return hi if n == 1 else hi + (x - hi).to(dtype).float()


def _model(q, k, v, do, mask, scale, dtype, n):
    """The kernels' arithmetic in plain PyTorch (causal): fp32 scores of
    16-bit-exact inputs, the forward's p.V and the backward's dv and dk
    with their A operand in ``n`` 16-bit terms. Returns o, dk, dv."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    keep = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * mask[:, None, None, :]
    ls = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (torch.einsum("bhqk,bkhd->bqhd", _terms(p, dtype, n), v)
         / ls.permute(0, 2, 1, 3))
    lse = m + torch.log(ls)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    pb = torch.exp(s - lse).masked_fill(~keep, 0.0) * mask[:, None, None, :]
    ds = pb * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta)
    dv = torch.einsum("bhqk,bqhd->bkhd", _terms(pb, dtype, n), do)
    dk = torch.einsum("bhqk,bqhd->bkhd", _terms(ds, dtype, n), q) * scale
    return o, dk, dv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_operand_product_matches_jax(dtype):
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, H, D))
                                    .astype(np.float32)).to(dtype).float()
                   for _ in range(4))
    mask = np.ones((B, S), np.float32)
    mask[1, 100:] = 0.0
    scale = 1.0 / D ** 0.5

    def f(q, k, v):
        out = jax_flash_attention(q, k, v, causal=True,
                                  kv_mask=jnp.asarray(mask), block_q=128,
                                  block_k=128, interpret=True)
        return jnp.sum(out * jnp.asarray(do.numpy())), out

    (_, out), (_dq, dk, dv) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [np.asarray(x) for x in (out, dk, dv)]
    # the port's fp32 plain versions agree with JAX at fp32 (as in
    # test_torch_flash_attention.py), so the model is held to both
    tm = torch.from_numpy(mask)
    ref = fa.flash_attention_reference(q, k, v, causal=True, kv_mask=tm)
    np.testing.assert_allclose(ref.numpy(), want[0], atol=1e-5, rtol=0)
    for n, within in ((2, True), (1, False)):
        got = _model(q, k, v, do, tm, scale, dtype, n)
        errs = [float(np.abs(g.numpy() - w).max() / np.abs(w).max())
                for g, w in zip(got, want)]
        if within:
            assert max(errs) <= REL, (n, errs)
        else:
            assert min(errs) > REL, (n, errs)


ROUTES = [(torch.bfloat16, 64, "tc"), (torch.float16, 64, "tc"),
          (torch.bfloat16, 8, "tc"), (torch.float16, 72, "tc"),
          (torch.bfloat16, 128, "tc"), (torch.float16, 128, "tc"),
          (torch.float32, 64, "tf32"), (torch.float32, 128, "tf32"),
          (torch.float32, 256, "tf32"), (torch.bfloat16, 136, "tc256"),
          (torch.float16, 256, "tc256")]
_LIBS = {"tc": "flash_attention_tc", "tf32": "flash_attention_tf32",
         "tc256": "flash_attention_tc256", "fma": "flash_attention"}


@pytest.mark.parametrize("dtype,head_dim,route", ROUTES)
def test_dq_routes_like_dkv(dtype, head_dim, route, monkeypatch):
    """``flash_attention_bwd_dq`` launches the kernel of the library that
    ``flash_attention_bwd_dkv`` launches (the 3xTF32 kernels for float32
    up to D = 256; the wgmma kernels above D = 128 in 16 bits); each
    counts in its routed wrapper's ``.launches`` (the
    launches are recorded, not run: the operands are meta tensors)."""
    launched = []
    monkeypatch.setattr(fa, "_launch_dq",
                        lambda name, *a: launched.append(("dq", name)))
    monkeypatch.setattr(fa, "_launch_dkv",
                        lambda name, *a: launched.append(("dkv", name))
                        or (None, None))
    wrappers = {"fma": (fa.flash_attention_bwd_dq,
                        fa.flash_attention_bwd_dkv),
                "tc": (fa.flash_attention_bwd_dq_tc,
                       fa.flash_attention_bwd_dkv_tc),
                "tf32": (fa.flash_attention_bwd_dq_tf32,
                         fa.flash_attention_bwd_dkv_tf32),
                "tc256": (fa.flash_attention_bwd_dq_tc256,
                          fa.flash_attention_bwd_dkv_tc256)}
    for pair in wrappers.values():
        for w in pair:
            if w is not None:
                monkeypatch.setattr(w, "launches", 0)
    q = torch.empty(1, 8, 1, head_dim, dtype=dtype, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    fa.flash_attention_bwd_dq(q, q, q, q, None, lse, lse, True, 0.125)
    fa.flash_attention_bwd_dkv(q, q, q, q, None, lse, lse, True, 0.125)
    dq_route = route
    assert fa._route(dtype, head_dim, "dq") == dq_route
    assert launched == [("dq", _LIBS[dq_route]), ("dkv", _LIBS[route])]
    assert {r: [w and w.launches for w in pair]
            for r, pair in wrappers.items()} \
        == {r: [None if w is None else int(r == want)
                for w, want in zip(pair, (dq_route, route))]
            for r, pair in wrappers.items()}


@pytest.mark.parametrize("dtype,head_dim,route", ROUTES)
def test_fwd_routes_like_dkv(dtype, head_dim, route, monkeypatch):
    """``flash_attention_fwd`` launches the kernel of the library that
    ``flash_attention_bwd_dkv`` launches (the 3xTF32 kernels for float32
    up to D = 256, the wgmma ones above 128 in 16 bits); it counts in the
    routed wrapper's ``.launches`` alone; the FMA wrapper's
    ``.launches_wide`` counts exactly its launches above D = 128, none
    (recorded, not run: meta tensors)."""
    launched = []
    monkeypatch.setattr(fa, "_launch_fwd",
                        lambda name, *a: launched.append(("fwd", name))
                        or (None, None))
    monkeypatch.setattr(fa, "_launch_dkv",
                        lambda name, *a: launched.append(("dkv", name))
                        or (None, None))
    wrappers = {"fma": fa.flash_attention_fwd,
                "tc": fa.flash_attention_fwd_tc,
                "tf32": fa.flash_attention_fwd_tf32,
                "tc256": fa.flash_attention_fwd_tc256}
    for w in wrappers.values():
        monkeypatch.setattr(w, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_fwd, "launches_wide", 0)
    q = torch.empty(1, 8, 1, head_dim, dtype=dtype, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    fa.flash_attention_fwd(q, q, q, None, True, 0.125)
    fa.flash_attention_bwd_dkv(q, q, q, q, None, lse, lse, True, 0.125)
    fwd_route = fa._route(dtype, head_dim, "fwd")
    assert fwd_route == route
    assert launched == [("fwd", _LIBS[fwd_route]), ("dkv", _LIBS[route])]
    assert {r: w.launches for r, w in wrappers.items()} \
        == {r: int(r == fwd_route) for r in wrappers}
    assert fa.flash_attention_fwd.launches_wide == int(
        head_dim > 128 and fwd_route == "fma")


@pytest.mark.parametrize("dtype,head_dim", [(torch.float32, 64),
                                            (torch.float16, 256),
                                            (torch.bfloat16, 136)])
def test_dq_tc_wrapper_refuses_the_fma_route(dtype, head_dim):
    """The tensor-core dq wrapper raises, before any launch, for what the
    FMA kernel takes; it never falls back to it."""
    q = torch.empty(1, 8, 1, head_dim, dtype=dtype, device="meta")
    lse = torch.empty(1, 1, 8, device="meta")
    before = fa.flash_attention_bwd_dq_tc.launches
    with pytest.raises(ValueError, match="tensor-core flash kernels"):
        fa.flash_attention_bwd_dq_tc(q, q, q, q, None, lse, lse, True,
                                     0.125)
    assert fa.flash_attention_bwd_dq_tc.launches == before


def _seed_of(key) -> int:
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ (kd[-1] << np.uint32(1)))


def _dq_model(q, k, v, do, mask, out, scale, dtype, n, rate, seed):
    """The dq kernel's arithmetic in plain PyTorch (causal): lse of the
    fp32 scores of 16-bit-exact inputs and delta = rowsum(dO * out) as
    its caller gives them; s = q.k^T and dp = dO.v^T summed in fp32, dp
    dropped out, ds = p (dp - delta) in fp32, and dq = scale * ds.k with
    ds in ``n`` 16-bit terms."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    keep = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(-1, keepdim=True)
    ls = (torch.exp(s - m) * mask[:, None, None, :]).sum(-1, keepdim=True)
    lse = m + torch.log(ls.clamp_min(1e-30))
    delta = (do * out).sum(-1).transpose(1, 2)[..., None]
    p = torch.exp(s - lse).masked_fill(~keep, 0.0) * mask[:, None, None, :]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    if rate:
        kept = fa._keep_bhqk(seed, q.shape[0], q.shape[2], sq, sk, rate,
                             "cpu")
        dp = torch.where(kept, dp * (1.0 / (1.0 - rate)), 0.0)
    ds = p * (dp - delta)
    return torch.einsum("bhqk,bkhd->bqhd", _terms(ds, dtype, n), k) * scale


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dq_split_operand_product_matches_jax(dtype, rate):
    """The dq model with ds in two 16-bit terms against the JAX
    ``_bwd_dq_kernel`` (interpret, fp32, through ``jax.grad``): within
    1e-5 of its largest |dq|, at dropout 0 and 0.1; with one term, not."""
    rng = np.random.default_rng(23 + int(rate * 10))
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, H, D))
                                    .astype(np.float32)).to(dtype).float()
                   for _ in range(4))
    mask = np.ones((B, S), np.float32)
    mask[1, 90:] = 0.0
    scale = 1.0 / D ** 0.5
    key = jax.random.PRNGKey(5)

    def f(q):
        out = jax_flash_attention(
            q, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), causal=True,
            kv_mask=jnp.asarray(mask), block_q=64, block_k=64,
            dropout_rate=rate, dropout_rng=key if rate else None,
            interpret=True)
        return jnp.sum(out * jnp.asarray(do.numpy())), out

    (_, out), dq = jax.value_and_grad(f, has_aux=True)(jnp.asarray(q.numpy()))
    want = np.asarray(dq)
    out = torch.from_numpy(np.array(out))
    seed = _seed_of(key) if rate else None
    for n, within in ((2, True), (1, False)):
        got = _dq_model(q, k, v, do, torch.from_numpy(mask), out, scale,
                        dtype, n, rate, seed)
        err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        if within:
            assert err <= REL, (n, err)
        else:
            assert err > REL, (n, err)

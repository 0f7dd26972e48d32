"""The 3xTF32 flash kernels' route and arithmetic (deepspeed_tpu_torch).

``csrc/flash_attention_tf32.cu`` (the forward, dq and dk/dv for float32 on
the tensor cores) runs only on the card, where ``chip_smoke.py`` holds it
against the plain versions. Here: which kernel ``_route`` picks for the
forward, dq and dk/dv by dtype and head dim, that the 3xTF32 wrappers
refuse the rest (each its own kernel's: float32 with head dims up to
256) and that a missing ``nvcc`` raises, and plain PyTorch models of the
kernels' arithmetic: every fp32 operand of the products (s =
q.k^T and o = p.v in the forward; s, dp = dO.v^T, dq = ds.k, dk = ds^T.q,
dv = p^T.dO in the backward) is split into hi = tf32(x) and lo = tf32(x -
hi), ``cvt.rna.tf32.f32`` emulated with int32 bit operations, and each
product is lo.hi + hi.lo + hi.hi in fp32. On numpy-made inputs the models
stay within 1e-5 of the largest value of both the JAX kernels
(``interpret=True``) and the port's fp32 plain versions, causal and
non-causal under a key mask, at dropout 0 and 0.1 (also at D = 256,
where the backward sums s and dp by halves of the head dim as its two
warps a row group do); one TF32 product (hi.hi) does not, which is why
the kernels pay for three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.flash_attention import \
    _flash_forward as jax_flash_forward
from deepspeed_tpu.ops.transformer.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

torch.set_num_threads(1)

B, S, H, D = 2, 128, 2, 16
REL = 1e-5          # of the reference's largest |value|
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("dtype,head_dim,routes", [
    (F32, 64, ("tf32", "tf32", "tf32")), (F32, 8, ("tf32", "tf32", "tf32")),
    (F32, 72, ("tf32", "tf32", "tf32")),
    (F32, 128, ("tf32", "tf32", "tf32")),
    (F32, 136, ("tf32", "tf32", "tf32")),
    (F32, 256, ("tf32", "tf32", "tf32")),
    (BF16, 64, ("tc", "tc", "tc")), (F16, 128, ("tc", "tc", "tc")),
    (BF16, 256, ("tc256", "tc256", "tc256")),
    (F16, 136, ("tc256", "tc256", "tc256"))])
def test_route(dtype, head_dim, routes):
    """The fp32 forward, dq and dk/dv take 3xTF32 up to D = 256; 16-bit
    types the tensor cores up to D = 128 and the wgmma kernels above. No
    head dim routes to the FMA kernels."""
    assert tuple(fa._route(dtype, head_dim, w)
                 for w in ("fwd", "dq", "dkv")) == routes
    assert fa._route(dtype, head_dim) == routes[0]


def test_route_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="fwd, dq or dkv"):
        fa._route(F32, 64, "dk")


@pytest.mark.parametrize("dtype,head_dim,device,takes", [
    (BF16, 64, "meta", ()), (F16, 128, "meta", ()),
    (F32, 136, "meta", ("fwd", "dq", "dkv")),
    (F32, 256, "meta", ("fwd", "dq", "dkv")),
    (F32, 264, "meta", ()), (F32, 256, "cpu", ()), (F32, 64, "cpu", ()),
    (BF16, 256, "meta", ())])
def test_tf32_wrappers_refuse_other_routes(dtype, head_dim, device, takes):
    """Each 3xTF32 wrapper raises, before any launch, for what its own
    kernel does not take (``takes``: the kernels whose wall lets these
    inputs through): float32 up to D = 256, no other dtype and no wider
    head; CPU tensors never; nothing falls back to another kernel."""
    q = torch.empty(1, 8, 1, head_dim, dtype=dtype, device=device)
    lse = torch.empty(1, 1, 8, device=device)
    calls = {"fwd": (fa.flash_attention_fwd_tf32, (q, q, q, None, True,
                                                   0.125)),
             "dq": (fa.flash_attention_bwd_dq_tf32,
                    (q, q, q, q, None, lse, lse, True, 0.125)),
             "dkv": (fa.flash_attention_bwd_dkv_tf32,
                     (q, q, q, q, None, lse, lse, True, 0.125))}
    before = [w.launches for w, _a in calls.values()]
    for which, (wrapper, args) in calls.items():
        if which in takes:
            fa._require_tf32(q, which)      # its wall lets them through
            continue
        with pytest.raises(ValueError, match="3xTF32 flash kernels"):
            wrapper(*args)
    assert [w.launches for w, _a in calls.values()] == before


def test_missing_nvcc_raises_for_tf32(monkeypatch, tmp_path):
    """Without ``nvcc`` the build raises, and so does the forward's
    wrapper, which launches (and counts) nothing."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(fa, "_FN", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("flash_attention_tf32")
    q = torch.empty(1, 8, 1, 64, device="meta")
    before = fa.flash_attention_fwd_tf32.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_attention_fwd_tf32(q, q, q, None, True, 0.125)
    assert fa.flash_attention_fwd_tf32.launches == before
    assert not list(tmp_path.iterdir())


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 ``x``: the nearest value with 10
    mantissa bits, ties away from zero (add half of the dropped 13 bits'
    range to the magnitude's bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rounding_emulation():
    """The emulation keeps 10 mantissa bits, rounds to nearest and sends
    ties away from zero in both signs."""
    one = 1.0 + 2.0 ** -10                 # a tf32 value
    half = 2.0 ** -11                      # half its last place
    x = torch.tensor([one, one + half, 1.0 + half, 1.0 + half * 0.99,
                      -(1.0 + half), 3.0e-30, 1.0e30], dtype=F32)
    got = _tf32(x)
    assert got.tolist()[:5] == [one, one + 2 * half, one, 1.0, -one]
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    rel = ((got - x).abs() / x.abs()).max().item()
    assert rel <= 2.0 ** -11


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b over the last two dims as the kernels multiply fp32
    operands: with 3 terms, lo.hi + hi.lo + hi.hi of hi = tf32(x) and lo =
    tf32(x - hi), each product in fp32; with 1, hi.hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_halves(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """:func:`_mm` summed by halves of 128 along the product's k axis (the
    head dim), the halves added after: s and dp as the D = 256 kernels'
    two warps a row group sum them."""
    return (_mm(a[..., :128], b[..., :128, :], terms)
            + _mm(a[..., 128:], b[..., 128:, :], terms))


def _model(q, k, v, do, mask, lse, delta, causal, scale, rate, seed, terms,
           halves=False):
    """dq, dk and dv as the 3xTF32 kernels compute them from q, k, v, dO
    ([B, S, H, D] fp32), the key mask and the forward's lse and delta
    ([B, H, Sq]): s = q.k^T and dp = dO.v^T (with ``halves``, summed by
    halves of the head dim); p = exp(scale s - lse) under the causal and
    key masks; dp dropped out; ds = p (dp - delta); dq = scale ds.k, dk =
    scale ds^T.q, dv = (D p)^T.dO."""
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    sq, sk = q.shape[1], k.shape[1]
    score = _mm_halves if halves else _mm
    s = score(qh, kh.transpose(-1, -2), terms)
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        vis = torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
        p = p.masked_fill(~vis, 0.0)
    p = p * mask[:, None, None, :]
    dp = score(doh, vh.transpose(-1, -2), terms)
    if rate:
        keep = fa._keep_bhqk(seed, q.shape[0], q.shape[2], sq, sk, rate,
                             "cpu")
        dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), 0.0)
        pd = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    else:
        pd = p
    ds = p * (dp - delta[..., None])
    dq = _mm(ds, kh, terms) * scale
    dk = _mm(ds.transpose(-1, -2), qh, terms) * scale
    dv = _mm(pd.transpose(-1, -2), doh, terms)
    return [t.permute(0, 2, 1, 3) for t in (dq, dk, dv)]


def _seed_of(key) -> int:
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    return int(kd[0] ^ (kd[-1] << np.uint32(1)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_model_matches_jax_and_plain(causal, rate):
    """The 3xTF32 model of dq, dk and dv against the JAX backward kernels
    (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``; interpret, fp32, through
    ``jax.grad``) and the port's fp32 plain versions on the same inputs:
    within 1e-5 of each reference's largest |value|; the one-product model
    beyond it for every output."""
    rng = np.random.default_rng(31 + 2 * causal + int(rate * 10))
    mask = np.ones((B, S), np.float32)
    if causal:
        mask[1, 90:] = 0.0
    else:
        mask[0, 100:] = 0.0
        mask[1, 40:] = 0.0
    _hold_backward_model(rng, (B, S, H, D), mask, causal, rate)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_model_matches_jax_and_plain_at_d256(causal, rate):
    """The same at D = 256, the widest head dq and dk/dv take, with s and
    dp summed by halves of the head dim as the kernels' two warps a
    16-row group sum them and add the halves: causal under a key mask and
    non-causal with two key masks, dq, dk and dv within 1e-5 of each
    reference's largest |value| with three TF32 products, beyond it with
    one."""
    rng = np.random.default_rng(71 + 2 * causal + int(rate * 10))
    mask = np.ones((2, S), np.float32)
    if causal:
        mask[1, 90:] = 0.0
    else:
        mask[0, 100:] = 0.0
        mask[1, 40:] = 0.0
    _hold_backward_model(rng, (2, S, 1, 256), mask, causal, rate,
                         halves=True)


def _hold_backward_model(rng, shape, mask, causal, rate, halves=False):
    """The backward model (:func:`_model`) on q, k, v and dO drawn from
    ``rng`` at ``shape`` [B, S, H, D], against the JAX backward kernels
    (``jax.grad`` of the interpreted kernel) and the port's plain
    versions: three products within 1e-5 of each reference's largest
    |value| for every output, one product beyond it for every output."""
    b, s_len, h, d = shape
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape)
                                    .astype(np.float32)) for _ in range(4))
    scale = 1.0 / d ** 0.5
    key = jax.random.PRNGKey(7)
    seed = _seed_of(key) if rate else None

    def f(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal,
                                  kv_mask=jnp.asarray(mask), block_q=64,
                                  block_k=64, dropout_rate=rate,
                                  dropout_rng=key if rate else None,
                                  interpret=True)
        return jnp.sum(out * jnp.asarray(do.numpy())), out

    (_, _out), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want_jax = [np.asarray(g) for g in grads]
    # the forward's lse and delta as the kernels receive them
    tm = torch.from_numpy(mask)
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        s = s.masked_fill(
            ~torch.ones(s_len, s_len, dtype=torch.bool).tril(),
            float("-inf"))
    m = s.amax(-1, keepdim=True)
    l = (torch.exp(s - m) * tm[:, None, None, :]).sum(-1, keepdim=True)
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]
    out = fa.flash_attention_reference(q, k, v, causal=causal, kv_mask=tm,
                                       dropout_rate=rate, dropout_seed=seed)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, tm, lse, delta, causal, scale, rate, seed)
    want_plain = [fa.flash_bwd_dq_reference(*args),
                  *fa.flash_bwd_dkv_reference(*args)]
    for ref_name, want in (("jax", want_jax), ("plain", want_plain)):
        for terms, within in ((3, True), (1, False)):
            got = _model(*args, terms, halves=halves)
            errs = [float(np.abs(g.numpy() - np.asarray(w)).max()
                          / np.abs(np.asarray(w)).max())
                    for g, w in zip(got, want)]
            if within:
                assert max(errs) <= REL, (ref_name, terms, errs)
            else:
                assert min(errs) > REL, (ref_name, terms, errs)


LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
TILE, KSTEP = 32, 8       # keys of a streamed tile; keys of one k-step


def _fwd_model(q, k, v, mask, causal, scale, rate, seed, terms):
    """o ([B, S, H, D]) and lse ([B, H, Sq]) as the 3xTF32 forward kernel
    computes them from q, k, v ([B, S, H, D] fp32) and the key mask: over
    tiles of 32 keys, s = q.k^T (q unscaled) in base-2 units x = s scale
    log2(e), -inf where the causal mask hides a key; the running max m
    and alpha = 2^(m_old - m_new); p = 2^(x - m) times the key mask; l =
    l alpha + sum(p); o = o alpha, then the tile's (dropped) p.v folded in
    by one fp32 add per k-step of 8 keys; at the end o / max(l, 1e-30) and
    lse = m ln(2) + log(max(l, 1e-30))."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    sl = torch.tensor(scale, dtype=F32) * torch.tensor(LOG2E, dtype=F32)
    rows = torch.arange(sq)[:, None]
    m = torch.full(qh.shape[:3], float("-inf"))
    l = torch.zeros(qh.shape[:3])
    o = torch.zeros(qh.shape)
    keep = (fa._keep_bhqk(seed, q.shape[0], q.shape[2], sq, sk, rate, "cpu")
            if rate else None)
    for k0 in range(0, sk, TILE):
        cols = torch.arange(k0, min(k0 + TILE, sk))[None, :]
        x = _mm(qh, kh[:, :, k0:k0 + TILE].transpose(-1, -2), terms) * sl
        if causal:
            x = x.masked_fill(cols > rows + (sk - sq), float("-inf"))
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.where(m == float("-inf"), 0.0, torch.exp2(m - m_new))
        p = torch.exp2(x - m_new[..., None])
        p = p * mask[:, None, None, k0:k0 + TILE]
        l = l * alpha + p.sum(-1)
        if rate:
            p = torch.where(keep[..., k0:k0 + TILE],
                            p * (1.0 / (1.0 - rate)), 0.0)
        o = o * alpha[..., None]
        for j in range(0, p.shape[-1], KSTEP):
            o = o + _mm(p[..., j:j + KSTEP],
                        vh[:, :, k0 + j:k0 + j + KSTEP], terms)
        m = m_new
    ls = l.clamp_min(1e-30)
    return (o / ls[..., None]).permute(0, 2, 1, 3), m * LN2 + torch.log(ls)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_forward_model_matches_jax_and_plain(causal, rate):
    """The forward kernel's model (3xTF32 s and p.v, the online softmax
    over 32-key tiles) against the JAX ``_fwd_kernel`` (interpret, fp32:
    o and lse) and the port's plain version (o, and the lse of its fp32
    scores) on the same inputs under a key mask: o and lse within 1e-5 of
    each reference's largest |value| (the three-product model: within
    6e-7). With one TF32 product (hi.hi) the model misses 1e-5 at this
    size in both: o by 3.5e-4 to 7.6e-4 of the largest |o|, lse by 7.9e-5
    to 1.4e-4 of the largest |lse|, which is why the kernel pays for
    three."""
    rng = np.random.default_rng(41 + 2 * causal + int(rate * 10))
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, D))
                                .astype(np.float32)) for _ in range(3))
    mask = np.ones((B, S), np.float32)
    if causal:
        mask[1, 90:] = 0.0
    else:
        mask[0, 100:] = 0.0
        mask[1, 40:] = 0.0
    scale = 1.0 / D ** 0.5
    seed = _seed_of(jax.random.PRNGKey(9)) if rate else None
    errs = _forward_errors(q, k, v, mask, causal, scale, rate, seed)
    for ref_name in ("jax", "plain"):
        assert max(errs[(ref_name, 3)]) <= REL, errs
        assert min(errs[(ref_name, 1)]) > REL, errs


def _forward_errors(q, k, v, mask, causal, scale, rate, seed):
    """The forward model's o and lse, with 3 and 1 TF32 products, against
    the JAX ``_fwd_kernel`` (interpret, fp32) and the port's plain version
    (o, and the lse of its fp32 scores): each output's max |err| over the
    reference's largest |value|, by (reference, products)."""
    b, s, h, d = q.shape

    def bhsd(t):
        return jnp.asarray(t.permute(0, 2, 1, 3).reshape(b * h, s, d)
                           .numpy())

    jseed = jnp.asarray(np.array([seed or 0], np.uint32).view(np.int32))
    out, lse = jax_flash_forward(
        bhsd(q), bhsd(k), bhsd(v), jnp.asarray(mask)[:, None, :], causal,
        scale, 64, 64, True, nheads=h, dropout_rate=rate, seed=jseed)
    want_jax = (np.asarray(out).reshape(b, h, s, d).transpose(0, 2, 1, 3),
                np.asarray(lse)[..., 0].reshape(b, h, s))
    tm = torch.from_numpy(mask)
    sc = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            float("-inf"))
    m = sc.amax(-1, keepdim=True)
    l = (torch.exp(sc - m) * tm[:, None, None, :]).sum(-1, keepdim=True)
    want_plain = (fa.flash_attention_reference(
        q, k, v, causal=causal, kv_mask=tm, dropout_rate=rate,
        dropout_seed=seed), (m + torch.log(l.clamp_min(1e-30)))[..., 0])
    errs = {}
    for ref_name, want in (("jax", want_jax), ("plain", want_plain)):
        for terms in (3, 1):
            got = _fwd_model(q, k, v, tm, causal, scale, rate, seed, terms)
            errs[(ref_name, terms)] = [
                float(np.abs(np.asarray(g) - np.asarray(w)).max()
                      / np.abs(np.asarray(w)).max())
                for g, w in zip(got, want)]
    return errs


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_3xtf32_forward_model_matches_jax_at_d256(rate):
    """The same forward model at D = 256, the widest head the kernel takes
    (its DMAX = 256 instance: the same 32-key walk, the o accumulator 256
    columns wide), causal under a key mask: o and lse within 1e-5 of each
    reference's largest |value| with three TF32 products, beyond it with
    one."""
    rng = np.random.default_rng(61 + int(rate * 10))
    q, k, v = (torch.from_numpy(rng.normal(size=(1, S, H, 256))
                                .astype(np.float32)) for _ in range(3))
    mask = np.ones((1, S), np.float32)
    mask[0, 100:] = 0.0
    seed = _seed_of(jax.random.PRNGKey(9)) if rate else None
    errs = _forward_errors(q, k, v, mask, True, 1.0 / 16.0, rate, seed)
    for ref_name in ("jax", "plain"):
        assert max(errs[(ref_name, 3)]) <= REL, errs
        assert min(errs[(ref_name, 1)]) > REL, errs

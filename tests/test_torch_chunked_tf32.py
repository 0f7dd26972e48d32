"""The fp32 chunked-prefill run kernels (kernel #2's float32 route,
deepspeed_tpu_torch.ops.transformer.chunked_prefill).

``csrc/chunked_prefill.cu``'s ``chunked_tf32_kernel`` (runs of two or more
tokens, 3xTF32 on the tensor cores) and ``chunked_decode_kernel<float>``
(runs of one token, the fp32 one-query walk split over a thread-block
cluster) run only on the card, where ``chip_smoke.py`` holds them against
the plain version. Here, on the CPU:

- ``_route``'s answers: ``"tf32"`` for float32 q over float32 or int8
  pools at head dims that are multiples of 8 up to 256, ``"walk"`` for
  what no kernel takes;
- the fp32 run wrapper's walls: another route or a CPU tensor raises, and
  nothing is counted;
- a plain model of the kernels' arithmetic against the JAX kernel
  ``chunked_prefill_attention_kernel`` (``interpret=True``) on ragged
  batches made with numpy from a seed (decode rows, a chunk crossing
  64-token and 64-key boundaries, two sequences at adjacent positions
  with different table rows, pad rows), over fp32 and int8 pools, within
  1e-5. Chunk items: keys in 64-key tiles, each tile's two halves of
  32 keys under two online softmaxes in base 2 (a warp each) combined at
  the end, half 0's first, each row masked past its own position, every
  product 3xTF32 (each fp32 operand split into hi = tf32(x) and lo =
  tf32(x - hi), ``cvt.rna.tf32.f32`` emulated with int32 bit
  operations, lo.hi + hi.lo + hi.hi in fp32);
  over an int8 pool the codes are exact in TF32, so each product is
  lo.c + hi.c, k_scale multiplies s and v_scale p before its split.
  Decode items: fp32 products, the keys cut into a cluster's shares of
  whole tiles of the walk's keys (64 at D = 64) and combined in rank
  order. The same model with one TF32 product (hi.hi) alone misses 1e-5.
  At head dim 256 (``chunked_tf32w_kernel``): 32-key tiles under one
  online softmax a row, s summed over each half of the head dim (3xTF32)
  and the two halves added, the decode walk's 16-key tiles; within 1e-5
  too.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.chunked_prefill import \
    chunked_prefill_attention as jax_chunked_prefill_attention
from deepspeed_tpu_torch.ops.transformer import chunked_prefill as cp

torch.set_num_threads(1)

BS, H, D, WB = 16, 2, 64, 12
LOG2E = 1.0 / math.log(2.0)
TOL = 1e-5
HALF = 128       # head-dim columns one warp of a pair owns above D = 128


def _layout(d):
    """The fp32 run kernels' tiles at head dim ``d``: (keys per chunk
    tile, keys one online softmax walks of each tile, the decode walk's
    keys per tile). Up to 128: 64-key tiles whose halves two warps walk;
    above: 32-key tiles, one softmax. The decode walk (paged_walk.cuh):
    NPASS = 4 passes of THREADS / TPKP keys, TPKP the power of two >= d /
    8."""
    tpkp = 1
    while tpkp * 8 < d:
        tpkp *= 2
    kt = 4 * (128 // tpkp)
    return (64, 32, kt) if d <= HALF else (32, 32, kt)


def _batch(seed, d=D):
    """A ragged mixed step as the serving engine builds it, and fp32
    pools. Sequences (first position, tokens): decode rows at 150 and 170,
    a chunk of 90 tokens from 30 (it crosses positions 64 and 128 and its
    items walk 94 and 120 keys), a chunk of 3, two sequences whose tokens
    sit at adjacent positions (40, 41 then 42, 43) with different rows, a
    decode row at position 0, then 5 pad rows (the all-scratch row at
    position 0). Every sequence owns distinct blocks; table tails and pads
    point at scratch block 0. ``d``: the head dim."""
    rng = np.random.default_rng(seed)
    seqs = [(150, 1), (30, 90), (170, 1), (8, 3), (40, 2), (42, 2), (0, 1)]
    need = [(p0 + c - 1) // BS + 1 for p0, c in seqs]
    n_blocks = sum(need) + 1
    perm = rng.permutation(np.arange(1, n_blocks))
    table, pos, used = [], [], 0
    for (p0, c), nb in zip(seqs, need):
        row = np.zeros(WB, np.int32)
        row[:nb] = perm[used:used + nb]
        used += nb
        for i in range(c):
            table.append(row)
            pos.append(p0 + i)
    for _ in range(5):
        table.append(np.zeros(WB, np.int32))
        pos.append(0)
    table = np.stack(table).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    k = rng.standard_normal((n_blocks, BS, H, d)).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, H, d)).astype(np.float32)
    q = rng.standard_normal((len(pos), H, d)).astype(np.float32)
    return q, k, v, table, pos


def _int8_pools(seed, shape):
    """int8 codes and fp32 scales [N, BS, H], as the int8 pool holds
    them."""
    rng = np.random.default_rng(seed)
    k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, shape[:3]).astype(np.float32)
              for _ in range(2))
    return k, v, ks, vs


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 ``x``: the nearest value with 10
    mantissa bits, ties away from zero (add half of the dropped 13 bits'
    range to the magnitude's bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int,
        codes: bool = False) -> torch.Tensor:
    """a @ b as the chunk kernel multiplies: with 3 terms, lo.hi + hi.lo +
    hi.hi of hi = tf32(x) and lo = tf32(x - hi), each product in fp32;
    over int8 codes ``b`` (exact in TF32: no lo part) lo.b + hi.b; with 1
    term, hi.hi alone."""
    ah = _tf32(a)
    if codes:
        return ah @ b if terms == 1 else _tf32(a - ah) @ b + ah @ b
    bh = _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _model(q, k, v, ks, vs, table, pos, runs, splits, terms=3):
    """The fp32 run kernels' output in plain PyTorch. q [T, H, D]; k, v
    fp32 pools, or int8 codes as floats with fp32 scales ks, vs [N, BS,
    H]. Chunk items (tiles as ``_layout``): keys 0 .. keys - 1 in bn-key
    tiles gathered through the first token's row, keys past the last one
    zero with scale 0; each tile's key halves (kh keys; one half above D =
    128) walked by their own online softmaxes: s = q.k^T (``_mm``; above
    D = 128 the sum of the two head-dim halves' products), scaled into
    base 2 and times k_scale in fp32, each row masked past its own
    position, p times v_scale into o += p.v (``_mm``); the halves' (m, l,
    o) combined with weights 2^(m_h - max), half 0's first; o = acc /
    max(l, 1e-30). Decode items: fp32 products, the keys cut into
    ``splits`` shares of whole tiles of the walk's keys, each share's (m,
    l, o) in natural-log units, combined in rank order."""
    t, h, d = q.shape
    bn, kh, kt = _layout(d)
    scale = 1.0 / math.sqrt(d)
    codes = ks is not None

    def scores(a, b):
        if d <= HALF:
            return _mm(a, b.T, terms, codes)
        return (_mm(a[:, :HALF], b[:, :HALF].T, terms, codes)
                + _mm(a[:, HALF:], b[:, HALF:].T, terms, codes))

    out = torch.full((t, h, d), float("nan"))
    ninf = torch.tensor(float("-inf"))

    def gather(kpos, row):
        tok = torch.from_numpy(row)[kpos // BS].long() * BS + kpos % BS
        kk, vv = k.reshape(-1, h, d)[tok], v.reshape(-1, h, d)[tok]
        if not codes:
            return kk, vv, None, None
        return kk, vv, ks.reshape(-1, h)[tok], vs.reshape(-1, h)[tok]

    for t0, n, nk, _z in runs.items[:runs.n_chunk].tolist():
        ntiles = -(-nk // bn)
        kpos = torch.arange(ntiles * bn)
        valid = kpos < nk
        kk, vv, kss, vss = gather(torch.where(valid, kpos, 0), table[t0])
        kk = torch.where(valid[:, None, None], kk, 0.0)
        vv = torch.where(valid[:, None, None], vv, 0.0)
        if codes:
            kss = torch.where(valid[:, None], kss, 0.0)
            vss = torch.where(valid[:, None], vss, 0.0)
        rpos = torch.from_numpy(pos[t0:t0 + n].astype(np.int64))
        for hh in range(h):
            halves = []
            for half in range(bn // kh):
                m = torch.full((n,), float("-inf"))
                l = torch.zeros(n)
                acc = torch.zeros(n, d)
                for j in range(ntiles):
                    sl = slice(bn * j + kh * half, bn * j + kh * half + kh)
                    x = scores(q[t0:t0 + n, hh], kk[sl, hh]) * (
                        scale * LOG2E)
                    if codes:
                        x = x * kss[sl, hh]
                    x = torch.where(kpos[sl][None, :] <= rpos[:, None], x,
                                    ninf)
                    mn = torch.maximum(m, x.amax(-1))
                    a = torch.where(mn == ninf, 1.0, torch.where(
                        m == ninf, 0.0, torch.exp2(m - mn)))
                    p = torch.where(x == ninf, 0.0,
                                    torch.exp2(x - mn[:, None]))
                    l = l * a + p.sum(-1)
                    if codes:
                        p = p * vss[sl, hh]
                    acc = acc * a[:, None] + _mm(p, vv[sl, hh], terms,
                                                 codes)
                    m = mn
                halves.append((m, l, acc))
            if len(halves) == 1:
                m, l, acc = halves[0]
                out[t0:t0 + n, hh] = acc / l.clamp_min(1e-30)[:, None]
                continue
            top = torch.maximum(halves[0][0], halves[1][0])
            w = [torch.where(m == ninf, 0.0, torch.exp2(m - top))
                 for m, _l, _a in halves]
            lsum = halves[0][1] * w[0] + halves[1][1] * w[1]
            o = halves[0][2] * w[0][:, None] + halves[1][2] * w[1][:, None]
            out[t0:t0 + n, hh] = o / lsum.clamp_min(1e-30)[:, None]
    for tok, _one, nk, _z in runs.items[runs.n_chunk:].tolist():
        nt = -(-nk // kt)
        kk, vv, kss, vss = gather(torch.arange(nk), table[tok])
        if codes:
            kk = kk * kss[..., None]
            vv = vv * vss[..., None]
        for hh in range(h):
            s = q[tok, hh] @ kk[:, hh].T * scale
            parts = []
            for r in range(splits):
                lo = min(nk, r * nt // splits * kt)
                hi = min(nk, (r + 1) * nt // splits * kt)
                if lo == hi:
                    parts.append((float("-inf"), 0.0, torch.zeros(d)))
                    continue
                mr = s[lo:hi].max()
                e = torch.exp(s[lo:hi] - mr)
                parts.append((mr, e.sum(), e @ vv[lo:hi, hh]))
            big = max(float(mr) for mr, _l, _o in parts)
            w = [0.0 if float(mr) == float("-inf") else
                 torch.exp(torch.tensor(float(mr) - big)) for mr, _l, _o in
                 parts]
            lsum = sum(wi * li for wi, (_m, li, _o) in zip(w, parts))
            o = sum(wi * oi for wi, (_m, _l, oi) in zip(w, parts))
            out[tok, hh] = o / max(float(lsum), 1e-30)
    return out


def _jax(q, k, v, ks, vs, table, pos):
    def j(a):
        return None if a is None else jnp.asarray(a)
    o = jax_chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j(ks), j(vs),
        jnp.asarray(table), jnp.asarray(pos), block_size=BS, interpret=True)
    return np.asarray(o, np.float32)


def _case(kind, d):
    """The batch at head dim ``d`` over fp32 or int8 pools (``kind``), its
    run list, the model's pools (codes as floats) and the JAX kernel's
    output."""
    q, k, v, table, pos = _batch(7, d)
    if kind == "int8":
        k, v, ks, vs = _int8_pools(8, k.shape)
        pools = tuple(torch.from_numpy(a.astype(np.float32))
                      for a in (k, v, ks, vs))
    else:
        ks = vs = None
        pools = (torch.from_numpy(k), torch.from_numpy(v), None, None)
    want = _jax(q, k, v, ks, vs, table, pos)
    return (torch.from_numpy(q), pools, table, pos,
            cp.chunked_runs(table, pos, BS), want)


@pytest.fixture(scope="module", params=["fp32", "int8"])
def case(request):
    return _case(request.param, D)


@pytest.fixture(scope="module", params=["fp32", "int8"])
def case256(request):
    """The same at head dim 256 (the JAX kernel's gate admits it)."""
    return _case(request.param, 256)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_model_matches_jax_kernel(case, splits):
    """Every real and pad row within 1e-5 of the JAX kernel at 1, 3 and 8
    decode shares, over fp32 and int8 pools: the same function, every
    product 3xTF32, summed in another order."""
    q, pools, table, pos, runs, want = case
    assert runs.n_chunk and runs.n_decode
    got = _model(q, *pools, table, pos, runs, splits).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("splits", [1, 8])
def test_model_matches_jax_kernel_d256(case256, splits):
    """At head dim 256, every real and pad row within 1e-5 of the JAX
    kernel at 1 and 8 decode shares, over fp32 and int8 pools: 32-key
    tiles, s summed by head-dim halves, one softmax a row."""
    q, pools, table, pos, runs, want = case256
    assert runs.n_chunk and runs.n_decode
    got = _model(q, *pools, table, pos, runs, splits).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_one_tf32_product_misses_the_tolerance(case):
    """hi.hi alone (a single TF32 product, about 11 bits of each operand)
    moves the outputs by more than 1e-5 on the same inputs."""
    q, pools, table, pos, runs, want = case
    got = _model(q, *pools, table, pos, runs, 1, terms=1).numpy()
    assert np.abs(got - want).max() > 10 * TOL


def test_tf32_split_is_exact_and_codes_need_no_lo():
    """hi + lo recovers an fp32 value to within 2**-22 of it (the third
    product's share), and an int8 code is its own TF32 value, so its lo
    part, and the product it would add, are 0."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    c = torch.arange(-128, 128, dtype=torch.float32)
    assert torch.equal(_tf32(c), c)
    assert torch.equal(_tf32(c - _tf32(c)), torch.zeros_like(c))


@pytest.mark.parametrize("dtype,pool,d,route", [
    (torch.float32, torch.float32, 64, "tf32"),
    (torch.float32, torch.int8, 64, "tf32"),
    (torch.float32, torch.float32, 8, "tf32"),
    (torch.float32, torch.float32, 72, "tf32"),
    (torch.float32, torch.int8, 128, "tf32"),
    (torch.float32, torch.float32, 136, "tf32"),
    (torch.float32, torch.int8, 256, "tf32"),
    (torch.float32, torch.float32, 200, "tf32"),
    (torch.float32, torch.int8, 264, "walk"),
    (torch.float32, torch.float32, 60, "walk"),
    (torch.bfloat16, torch.bfloat16, 64, "tc"),
    (torch.bfloat16, torch.int8, 64, "tc")])
def test_route(dtype, pool, d, route):
    assert cp._route(dtype, pool, d) == route


def _counters():
    return (cp.chunked_prefill_attention.launches,
            cp.chunked_prefill_attention_tc.launches,
            cp.chunked_prefill_attention_tf32.launches)


def test_tf32_wrapper_refuses_and_counts_nothing():
    """Another route (bfloat16 q, a bfloat16 pool under fp32 q, a head
    dim above 256) or a CPU tensor raises ValueError before any launch,
    and no counter moves; the bf16 run wrapper refuses fp32 q."""
    q, k, v, table, pos = (torch.from_numpy(a) for a in _batch(5))
    before = _counters()
    kw = dict(block_size=BS)
    with pytest.raises(ValueError, match="take float32 q"):
        cp.chunked_prefill_attention_tf32(q.bfloat16(), k.bfloat16(),
                                          v.bfloat16(), None, None, table,
                                          pos, **kw)
    with pytest.raises(ValueError, match="take float32 q"):
        cp.chunked_prefill_attention_tf32(q, k.bfloat16(), v.bfloat16(),
                                          None, None, table, pos, **kw)
    wide = torch.zeros(q.shape[0], H, 264)
    with pytest.raises(ValueError, match="head_dim 264"):
        cp.chunked_prefill_attention_tf32(wide, wide, wide, None, None,
                                          table, pos, **kw)
    with pytest.raises(ValueError, match="run on CUDA"):
        cp.chunked_prefill_attention_tf32(q, k, v, None, None, table, pos,
                                          **kw)
    k8, v8, ks, vs = (torch.from_numpy(a)
                      for a in _int8_pools(6, tuple(k.shape)))
    with pytest.raises(ValueError, match="run on CUDA"):
        cp.chunked_prefill_attention_tf32(q, k8, v8, ks, vs, table, pos,
                                          **kw)
    with pytest.raises(ValueError, match="take bfloat16 q"):
        cp.chunked_prefill_attention_tc(q, k, v, None, None, table, pos,
                                        **kw)
    assert _counters() == before


def test_public_call_on_cpu_runs_the_plain_version():
    """On CPU tensors ``chunked_prefill_attention`` is the plain version
    and counts nothing, whatever the route of the dtype."""
    q, k, v, table, pos = (torch.from_numpy(a) for a in _batch(4))
    before = _counters()
    got = cp.chunked_prefill_attention(q, k, v, None, None, table, pos,
                                       block_size=BS)
    want = cp.chunked_prefill_attention_reference(q, k, v, None, None,
                                                  table, pos, block_size=BS)
    assert torch.equal(got, want)
    assert _counters() == before

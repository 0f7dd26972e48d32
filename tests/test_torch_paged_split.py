"""The paged decode kernel's key split (deepspeed_tpu_torch): a plain model
of its split-and-combine against the JAX package's Pallas kernel, its
split-count rule, and the wrapper's operand checks.

``csrc/paged_attention.cu`` runs only on the card, where ``chip_smoke.py``
holds it against the plain version at every split count. It splits each
(head, sequence, query group)'s visible key tiles over a thread-block
cluster: block ``r`` walks a contiguous share (``split_shares``; a share
may hold no visible key), leaves its partial (m, l, o) in fp32, and rank
0 combines the partials in rank order. Here the same arithmetic in plain
PyTorch, fp32, on numpy-made inputs, is held to the JAX kernel
(``interpret=True``) within 1e-5: only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.paged_attention import \
    paged_decode_attention as jax_paged_decode_attention
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.serving.kv_cache import _quant_tokens

torch.set_num_threads(1)

H, WB, BS = 2, 8, 16
ATOL = 1e-5


def key_tile(head_dim: int) -> int:
    """Keys per tile of the kernel's walk (``paged_walk.cuh``: NPASS x
    THREADS / TPKP = 512 / the power of two >= head_dim / 8); a split's
    share is a whole number of tiles."""
    tpkp = 1
    while tpkp * 8 < head_dim:
        tpkp *= 2
    return 512 // tpkp


def split_shares(n_keys: int, splits: int, head_dim: int):
    """The kernel's key shares of a run that sees keys 0 .. n_keys - 1
    (``paged_attention.cu``: k_lo, k_hi): block ``r`` of the cluster walks
    tiles ``r * nt // splits`` to ``(r + 1) * nt // splits`` of the
    ``nt`` tiles; returns ``[(lo, hi)]`` per block (``lo == hi``: a share
    with no key)."""
    kt = key_tile(head_dim)
    nt = -(-n_keys // kt)
    return [(min(n_keys, r * nt // splits * kt),
             min(n_keys, (r + 1) * nt // splits * kt))
            for r in range(splits)]


def _case(seed, s, d, int8):
    """Pools [N, BS, H, D] and a decode batch of four rows whose last
    queries sit at the window's end, mid-window, in the first block and
    at position 0 (an inactive row): the short rows leave most shares of
    an 8-way split with no visible key."""
    rng = np.random.default_rng(seed)
    n = 4 * WB + 1
    k = rng.normal(size=(n, BS, H, d)).astype(np.float32)
    v = rng.normal(size=(n, BS, H, d)).astype(np.float32)
    last = np.array([WB * BS - 1, 70, s + 2, s - 1])
    pos = (last - (s - 1)).astype(np.int32)
    bt = np.zeros((4, WB), np.int32)
    perm = rng.permutation(np.arange(1, n))
    for r in range(4):
        used = last[r] // BS + 1
        bt[r, :used] = perm[r * WB:r * WB + used]
    q = rng.normal(size=(4, s, H, d)).astype(np.float32)
    scales = (None, None)
    if int8:
        (k, ks), (v, vs) = (
            (c.numpy(), sc.numpy()) for c, sc in
            (_quant_tokens(torch.from_numpy(x)) for x in (k, v)))
        scales = (ks, vs)
    return q, k, v, scales, bt, pos


def _split_model(q, k, v, scales, bt, pos, splits):
    """The kernel's split-and-combine in plain PyTorch (fp32): per query
    group of up to 8, the run's visible keys n_keys = min(WB * BS, p0 +
    ns) cut into ``split_shares``; each share's partial max m_r, sum l_r
    and unnormalised o_r; then M = max_r m_r, w_r = e^(m_r - M) (0 for a
    share that saw nothing) and o = sum_r w_r o_r / max(sum_r w_r l_r,
    1e-30), summed in rank order."""
    b, s, h, d = q.shape
    length = bt.shape[1] * BS
    k = pa.dequantized(k, scales[0], bt.long()).reshape(b, length, h, d)
    v = pa.dequantized(v, scales[1], bt.long()).reshape(b, length, h, d)
    scale = 1.0 / d ** 0.5
    out = torch.zeros(b, s, h, d)
    for row in range(b):
        for s0 in range(0, s, 8):
            ns = min(8, s - s0)
            p0 = int(pos[row]) + s0
            n_keys = min(length, p0 + ns)
            qs = q[row, s0:s0 + ns].float() * scale             # [ns, h, d]
            parts = []
            for lo, hi in split_shares(n_keys, splits, d):
                kk, vv = k[row, lo:hi], v[row, lo:hi]           # [n, h, d]
                sc = torch.einsum("ihd,jhd->hij", qs, kk)
                j = torch.arange(lo, hi)[None, :]
                vis = j <= p0 + torch.arange(ns)[:, None]       # [ns, n]
                sc = sc.masked_fill(~vis[None], float("-inf"))
                m = (sc.amax(-1) if hi > lo
                     else torch.full((h, ns), float("-inf")))
                p = torch.where(vis[None], torch.exp(sc - m[..., None]), 0.0)
                parts.append((m, p.sum(-1), torch.einsum("hij,jhd->hid", p,
                                                         vv)))
            mx = torch.stack([m for m, _l, _o in parts]).amax(0)
            l_sum = torch.zeros(h, ns)
            o_sum = torch.zeros(h, ns, d)
            for m, l_, o in parts:
                w = torch.where(m == float("-inf"), 0.0, torch.exp(m - mx))
                l_sum = l_sum + l_ * w
                o_sum = o_sum + o * w[..., None]
            out[row, s0:s0 + ns] = (o_sum / l_sum.clamp_min(1e-30)[..., None]
                                    ).transpose(0, 1)
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_split_model_matches_jax_kernel(splits, int8):
    """fp32 and int8 pools, S = 1 and 3, D = 16 and 64 (tiles of 256 and
    64 keys: at D = 16 a row's 128 keys are one tile, so an 8-way split
    leaves seven shares empty)."""
    for s, d in ((1, 64), (3, 16)):
        q, k, v, scales, bt, pos = _case(7 * splits + int8 + s, s, d, int8)
        want = np.asarray(jax_paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if scales[0] is None else jnp.asarray(scales[0]),
            None if scales[1] is None else jnp.asarray(scales[1]),
            jnp.asarray(bt), jnp.asarray(pos), block_size=BS,
            interpret=True))
        got = _split_model(*(torch.from_numpy(x) for x in (q, k, v)),
                           tuple(None if x is None else torch.from_numpy(x)
                                 for x in scales),
                           torch.from_numpy(bt), torch.from_numpy(pos),
                           splits)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        empty = [r for r in range(4) for lo, hi in split_shares(
            min(WB * BS, int(pos[r]) + s), splits, d) if lo == hi]
        assert bool(empty) == (splits > 1)


@pytest.mark.parametrize("context,heads,batch,splits", [
    (1, 12, 8, 1), (16, 12, 8, 1), (64, 12, 8, 1), (65, 12, 8, 2),
    (128, 12, 8, 2), (129, 12, 8, 3), (256, 12, 8, 4), (1024, 12, 8, 8),
    (256, 12, 1, 4), (1024, 12, 1, 8), (4096, 1, 1, 8), (1024, 12, 32, 2),
    (1024, 12, 66, 1), (1024, 12, 67, 1), (300, 4, 2, 5)])
def test_split_count_rule(context, heads, batch, splits):
    """One block per KEYS_PER_SPLIT keys of the window, no more splits
    than the heads x batch clusters fit in BLOCKS_PER_CARD, 1 to
    MAX_SPLITS."""
    assert pa.paged_decode_splits(context, heads, batch) == splits


@pytest.mark.parametrize("d,tile", [(8, 512), (16, 256), (64, 64),
                                    (72, 32), (128, 32), (256, 16)])
def test_shares_tile_the_visible_keys(d, tile):
    """The shares are whole tiles, in rank order, and cover 0 .. n_keys
    exactly once, for any split count."""
    assert key_tile(d) == tile
    for n_keys in (1, tile - 1, tile, 3 * tile + 5, 17 * tile):
        for splits in range(1, pa.MAX_SPLITS + 1):
            shares = split_shares(n_keys, splits, d)
            assert len(shares) == splits
            assert shares[0][0] == 0 and shares[-1][1] == n_keys
            for (lo, hi), (lo2, _hi2) in zip(shares, shares[1:]):
                assert lo <= hi == lo2
            assert all(lo % tile == 0 for lo, _hi in shares)


def _operands(d=64, dtype=torch.float32):
    q = torch.zeros(2, 1, H, d, dtype=dtype)
    pool = torch.zeros(5, BS, H, d, dtype=dtype)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    return dict(q=q, k_pool=pool, v_pool=pool.clone(), k_scale=None,
                v_scale=None, tables=(bt, 2), pos=pos, block_size=BS)


def _bad(**changes):
    ops = _operands()
    ops.update(changes)
    return ops


@pytest.mark.parametrize("ops,match", [
    (_operands(d=60), "head_dim a multiple of 8"),
    (_operands(dtype=torch.float16), "float32 or bfloat16"),
    (_bad(k_pool=torch.zeros(5, BS, H, 64, dtype=torch.bfloat16)),
     "k_pool dtype"),
    (_bad(v_pool=torch.zeros(5, 8, H, 64)), r"v_pool shape"),
    (_bad(k_pool=torch.zeros(5, BS, H, 64, dtype=torch.int8),
          v_pool=torch.zeros(5, BS, H, 64, dtype=torch.int8),
          k_scale=torch.ones(5, BS, H)), "both k_scale and v_scale"),
    (_bad(k_pool=torch.zeros(5, BS, H, 64, dtype=torch.int8),
          v_pool=torch.zeros(5, BS, H, 64, dtype=torch.int8),
          k_scale=torch.ones(5, BS, H, dtype=torch.float64),
          v_scale=torch.ones(5, BS, H)), "k_scale must be float32"),
    (_bad(tables=(torch.zeros(2, 2, dtype=torch.int64), 2)),
     "block table must be int32"),
    (_bad(tables=(torch.zeros(3, 2, dtype=torch.int32), 2)),
     "block table must be int32"),
    (_bad(pos=torch.zeros(3, dtype=torch.int32)), "pos must be int32"),
    (_bad(q=torch.zeros(2, H, 2, 64).transpose(1, 2)), "q must be "
     "contiguous")])
def test_operand_checks_refuse(ops, match):
    """The checks the wrapper runs on a CUDA tensor before any launch
    refuse bad operands, as before the split; the launch count stays."""
    exc = TypeError if "dtype" in match and "pool" in match else ValueError
    before = pa.paged_decode_attention.launches
    with pytest.raises(exc, match=match):
        pa.check_pool_operands("paged_decode_attention", **ops)
    assert pa.paged_decode_attention.launches == before

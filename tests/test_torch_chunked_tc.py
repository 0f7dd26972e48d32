"""The chunked-prefill run kernels (kernel #2 redesigned around runs of one
sequence, deepspeed_tpu_torch.ops.transformer.chunked_prefill).

``csrc/chunked_prefill.cu``'s ``chunked_tc_kernel`` (runs of two or more
tokens on the tensor cores) and ``chunked_decode_kernel`` (runs of one
token, the one-query walk split over a thread-block cluster) run only on
the card, where ``chip_smoke.py`` holds them against the plain version.
Here, on the CPU, on ragged batches made with numpy from a seed (decode
rows, a chunk crossing 64-token and 64-key boundaries, two sequences at
adjacent positions with different table rows, pad rows):

- the host's run-list pass (``chunked_runs``) against a Python loop over
  the tokens: the runs, their cut into items of up to 64 tokens, each
  item's keys and the order, longest walk first;
- a plain model of the kernels' output path (chunk items in 64-key tiles,
  an online softmax in base 2 with each row's own position; decode items
  cut into the key shares of a cluster and combined in rank order)
  against the JAX kernel ``chunked_prefill_attention_kernel``
  (interpret): fp32 within 1e-5; bf16 q and pools, and bf16 q over int8
  pools, as the kernels round them (p.V with p split into two bf16 terms,
  int8 codes exact in bf16 with the scales applied in fp32, the output
  rounded once) within one bf16 step of JAX's bf16 output plus 1e-3: both
  sides sum the same fp32 products in other orders and round once;
- the decode split rule, the route, and the run wrapper's walls.
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
KT = 64          # the decode walk's keys per tile at D = 64 (paged_walk.cuh)
LOG2E = 1.0 / math.log(2.0)


def _batch(seed):
    """A ragged mixed step as the serving engine builds it, and the pools.
    Sequences (first position, tokens): decode rows at 150 and 170, a
    chunk of 90 tokens from 30 (it crosses positions 64 and 128 and its
    items walk 94 and 120 keys), a chunk of 3, two sequences whose tokens
    sit at adjacent positions (40, 41 then 42, 43) with different rows, a
    decode row at position 0, then 5 pad rows (the all-scratch row at
    position 0). Every sequence owns distinct blocks; table tails and pads
    point at scratch block 0."""
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
    k = rng.standard_normal((n_blocks, BS, H, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, H, D)).astype(np.float32)
    q = rng.standard_normal((len(pos), H, D)).astype(np.float32)
    return q, k, v, table, pos


def _loop_runs(table, pos):
    """The runs by a plain loop: a token continues its predecessor when
    their table rows are equal and its position is the same or one more."""
    runs, start = [], 0
    for t in range(1, len(pos) + 1):
        if t == len(pos) or not (
                (table[t] == table[t - 1]).all()
                and pos[t] - pos[t - 1] in (0, 1)):
            runs.append((start, t - start))
            start = t
    return runs


def test_run_list_matches_a_loop():
    _q, _k, _v, table, pos = _batch(1)
    runs = _loop_runs(table, pos)
    # the chunk of 90, the two adjacent sequences apart, the pads together
    assert (1, 90) in runs
    lens = [n for _s, n in runs]
    assert lens == [1, 90, 1, 3, 2, 2, 1, 5]
    chunks, decode = [], []
    for s, n in runs:
        if n == 1:
            decode.append((s, 1, int(pos[s]) + 1, 0))
            continue
        for t0 in range(s, s + n, 64):
            c = min(64, s + n - t0)
            chunks.append((t0, c, int(pos[t0 + c - 1]) + 1, 0))
    want_c = sorted(chunks, key=lambda x: (-x[2], x[0]))
    want_d = sorted(decode, key=lambda x: (-x[2], x[0]))
    got = cp.chunked_runs(table, pos, BS)
    assert (got.n_chunk, got.n_decode) == (len(want_c), len(want_d))
    assert got.items.dtype == np.int32
    assert got.items.tolist() == [list(x) for x in want_c + want_d]
    # the 90-token chunk: items of 64 (keys 30..93) and 26 (up to 119)
    assert got.items[:2].tolist() == [[65, 26, 120, 0], [1, 64, 94, 0]]
    assert got.longest_decode == 171
    # keys never pass the table's reach
    far = cp.chunked_runs(table[:1], np.asarray([WB * BS + 7], np.int32), BS)
    assert far.items.tolist() == [[0, 1, WB * BS, 0]]


def test_run_list_of_a_torch_step_is_the_numpy_one():
    _q, _k, _v, table, pos = _batch(2)
    a = cp.chunked_runs(table, pos, BS)
    b = cp.chunked_runs(torch.from_numpy(table), torch.from_numpy(pos), BS)
    assert np.array_equal(a.items, b.items)
    assert torch.equal(b.on("cpu"), torch.from_numpy(a.items))
    assert b.on("cpu") is b.on("cpu")


def _round_bf16(x):
    return torch.from_numpy(np.asarray(x)).to(torch.bfloat16).float()


def _split16(x):
    """p as the kernel feeds it to p.V: two bf16 terms."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _model(q, k, v, ks, vs, table, pos, runs, splits, bf16):
    """The run kernels' output in plain PyTorch. q [T, H, D]; k, v fp32
    pools (int8 codes as floats, with fp32 scales ks, vs [N, BS, H]).
    Chunk items: keys 0 .. keys - 1 in 64-key tiles gathered through the
    first token's row, keys past the last one zero with scale 0; s = q.k
    (times k_scale) in base 2, each row masked past its own position, an
    online softmax, p (times v_scale) into p.V, split into two bf16 terms
    when ``bf16``; o = acc / max(l, 1e-30). Decode items: the keys cut into
    ``splits`` shares of whole KT-key tiles, each share's (m, l, o) in
    natural-log units, combined in rank order."""
    t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.full((t, h, d), float("nan"))
    ninf = torch.tensor(float("-inf"))

    def gather(kpos, row):
        tok = torch.from_numpy(row)[kpos // BS].long() * BS + kpos % BS
        kk, vv = k.reshape(-1, h, d)[tok], v.reshape(-1, h, d)[tok]
        if ks is None:
            return kk, vv, None, None
        return kk, vv, ks.reshape(-1, h)[tok], vs.reshape(-1, h)[tok]

    for t0, n, nk, _z in runs.items[:runs.n_chunk].tolist():
        ntiles = -(-nk // 64)
        kpos = torch.arange(ntiles * 64)
        valid = kpos < nk
        kk, vv, kss, vss = gather(torch.where(valid, kpos, 0), table[t0])
        kk = torch.where(valid[:, None, None], kk, 0.0)
        vv = torch.where(valid[:, None, None], vv, 0.0)
        if kss is not None:
            kss = torch.where(valid[:, None], kss, 0.0)
            vss = torch.where(valid[:, None], vss, 0.0)
        rpos = torch.from_numpy(pos[t0:t0 + n].astype(np.int64))
        for hh in range(h):
            m = torch.full((n,), float("-inf"))
            l = torch.zeros(n)
            acc = torch.zeros(n, d)
            for j in range(ntiles):
                sl = slice(64 * j, 64 * j + 64)
                x = q[t0:t0 + n, hh] @ kk[sl, hh].T * (scale * LOG2E)
                if kss is not None:
                    x = x * kss[sl, hh]
                x = torch.where(kpos[sl][None, :] <= rpos[:, None], x, ninf)
                mn = torch.maximum(m, x.amax(-1))
                a = torch.where(mn == ninf, 1.0, torch.where(
                    m == ninf, 0.0, torch.exp2(m - mn)))
                p = torch.where(x == ninf, 0.0, torch.exp2(x - mn[:, None]))
                l = l * a + p.sum(-1)
                if vss is not None:
                    p = p * vss[sl, hh]
                pv = (sum(part @ vv[sl, hh] for part in _split16(p)) if bf16
                      else p @ vv[sl, hh])
                acc = acc * a[:, None] + pv
                m = mn
            out[t0:t0 + n, hh] = acc / l.clamp_min(1e-30)[:, None]
    for tok, _one, nk, _z in runs.items[runs.n_chunk:].tolist():
        nt = -(-nk // KT)
        kk, vv, kss, vss = gather(torch.arange(nk), table[tok])
        if kss is not None:
            kk = kk * kss[..., None]
            vv = vv * vss[..., None]
        for hh in range(h):
            s = q[tok, hh] @ kk[:, hh].T * scale
            parts = []
            for r in range(splits):
                lo = min(nk, r * nt // splits * KT)
                hi = min(nk, (r + 1) * nt // splits * KT)
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


def _jax(q, k, v, ks, vs, table, pos, dtype):
    def j(a):
        return None if a is None else jnp.asarray(a)
    jq = jnp.asarray(q).astype(dtype)
    jk, jv = (jnp.asarray(a).astype(dtype) if ks is None else jnp.asarray(a)
              for a in (k, v))
    o = jax_chunked_prefill_attention(jq, jk, jv, j(ks), j(vs),
                                      jnp.asarray(table), jnp.asarray(pos),
                                      block_size=BS)
    return np.asarray(o.astype(jnp.float32))


@pytest.fixture(scope="module")
def case():
    q, k, v, table, pos = _batch(3)
    return q, k, v, table, pos, cp.chunked_runs(table, pos, BS)


def test_model_matches_jax_kernel_fp32(case):
    """fp32, atol 1e-5, at 1, 3 and 8 decode shares: the same function
    summed in another order."""
    q, k, v, table, pos, runs = case
    want = _jax(q, k, v, None, None, table, pos, jnp.float32)
    for splits in (1, 3, 8):
        got = _model(*(torch.from_numpy(a) for a in (q, k, v)), None, None,
                     table, pos, runs, splits, bf16=False)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _bf16_step(x):
    """One bf16 rounding step at |x| (8 bits of mantissa)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_model_matches_jax_kernel_bf16(case, int8):
    """bf16 q over bf16 pools, or over int8 pools (codes and fp32 scales
    from a seed): the model rounds as the kernels do; within one bf16
    step of JAX's bf16 output plus 1e-3 (both round fp32 sums of the same
    products, taken in other orders, once)."""
    q, k, v, table, pos, runs = case
    qb = _round_bf16(q)
    if int8:
        rng = np.random.default_rng(4)
        k, v = (rng.integers(-127, 128, k.shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, k.shape[:3]).astype(np.float32)
                  for _ in range(2))
        want = _jax(q, k, v, ks, vs, table, pos, jnp.bfloat16)
        pools = (torch.from_numpy(k.astype(np.float32)),
                 torch.from_numpy(v.astype(np.float32)),
                 torch.from_numpy(ks), torch.from_numpy(vs))
    else:
        want = _jax(q, k, v, None, None, table, pos, jnp.bfloat16)
        pools = (_round_bf16(k), _round_bf16(v), None, None)
    for splits in (1, 5):
        got = _model(qb, *pools, table, pos, runs, splits, bf16=True)
        got = got.to(torch.bfloat16).float().numpy()
        excess = np.abs(got - want) - _bf16_step(want)
        assert excess.max() <= 1e-3, excess.max()


@pytest.mark.parametrize("longest,n_decode,want", [
    (1001, 8, 4), (171, 2, 3), (1, 1, 1), (1024, 4, 8), (256, 8, 4),
    (1024, 64, 1), (1024, 16, 2)])
def test_decode_split_rule(longest, n_decode, want):
    """The decode items' cluster size: one block per 64 keys of the
    longest decode walk, at most 8, and at most 396 blocks over heads x
    decode items (pads, grouped into chunk items, do not count): 12
    heads. The cases chip_smoke.py timed (1-8 rows at 256 and 1,024
    keys) pick the counts that ran fastest there, or within 5%."""
    decode = np.asarray([(i, 1, longest, 0) for i in range(n_decode)])
    runs = cp.ChunkedRuns(np.zeros((0, 4), np.int64), decode)
    assert cp.chunked_decode_splits(runs, 12) == want


def test_mixed_step_decode_rows_split_four_ways():
    """chip_smoke.py's T=256 mixed step (8 decode rows up to position
    1000, a 200-token and a 40-token chunk, pads): 4 shares."""
    dpos = [100, 228, 357, 485, 614, 742, 871, 1000]
    table = np.zeros((256, 64), np.int32)
    pos = np.zeros(256, np.int32)
    r = 0
    for i, p in enumerate(dpos):
        table[r, 0] = 100 + i
        pos[r] = p
        r += 1
    for s, (p0, c) in enumerate([(0, 200), (37, 40)]):
        table[r:r + c, 0] = 200 + s
        pos[r:r + c] = np.arange(p0, p0 + c)
        r += c
    runs = cp.chunked_runs(table, pos, 16)
    assert runs.n_decode == 8 and runs.longest_decode == 1001
    assert runs.n_chunk == 4 + 1 + 1     # 200 = 64+64+64+8; 40; the pads
    assert cp.chunked_decode_splits(runs, 12) == 4


@pytest.mark.parametrize("dtype,pool,d,route", [
    (torch.bfloat16, torch.bfloat16, 64, "tc"),
    (torch.bfloat16, torch.int8, 64, "tc"),
    (torch.bfloat16, torch.bfloat16, 128, "tc"),
    (torch.bfloat16, torch.bfloat16, 72, "tc"),
    (torch.float32, torch.float32, 64, "tf32"),
    (torch.float32, torch.int8, 64, "tf32"),
    (torch.bfloat16, torch.bfloat16, 256, "walk"),
    (torch.float32, torch.float32, 256, "walk")])
def test_route(dtype, pool, d, route):
    assert cp._route(dtype, pool, d) == route


def test_run_wrapper_refuses_and_counts_nothing():
    q, k, v, table, pos = (torch.from_numpy(a) for a in _batch(5))
    before = (cp.chunked_prefill_attention.launches,
              cp.chunked_prefill_attention_tc.launches)
    with pytest.raises(ValueError, match="take bfloat16 q"):
        cp.chunked_prefill_attention_tc(q, k, v, None, None, table, pos,
                                        block_size=BS)
    with pytest.raises(ValueError, match="run on CUDA"):
        cp.chunked_prefill_attention_tc(q.bfloat16(), k.bfloat16(),
                                        v.bfloat16(), None, None, table, pos,
                                        block_size=BS)
    assert (cp.chunked_prefill_attention.launches,
            cp.chunked_prefill_attention_tc.launches) == before


def test_serving_engine_hands_every_layer_the_step_runs(monkeypatch):
    """A chunked-prefill serve on the CPU: each layer's call gets the one
    run list of its step, equal to ``chunked_runs`` of the call's own
    table and positions."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import make_gpt

    seen = []
    real = cp.chunked_prefill_attention

    def spy(q, k, v, ks, vs, table, pos, **kw):
        seen.append((kw.get("runs"), table.numpy().copy(),
                     pos.numpy().copy()))
        return real(q, k, v, ks, vs, table, pos, **kw)

    monkeypatch.setattr(cp, "chunked_prefill_attention", spy)
    torch.manual_seed(0)
    model, _cfg = make_gpt("tiny", max_seq_len=64, dtype=torch.float32)
    srv = deepspeed_tpu_torch.init_serving(model, dtype=torch.float32,
                                           device="cpu", config={
        "serving": {"max_batch_size": 2, "kv_block_size": 4,
                    "kv_num_blocks": 32, "max_model_len": 48,
                    "chunked_prefill": {"token_budget": 8}}})
    srv.submit(list(range(1, 12)), max_new_tokens=3)
    srv.submit(list(range(5, 9)), max_new_tokens=2)
    srv.run_until_complete()
    assert seen
    layers = model.cfg.num_layers
    assert len(seen) % layers == 0
    for i in range(0, len(seen), layers):
        runs = seen[i][0]
        assert all(s[0] is runs for s in seen[i:i + layers])
        want = cp.chunked_runs(seen[i][1], seen[i][2], 4)
        assert np.array_equal(runs.items, want.items)

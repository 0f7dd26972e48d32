"""Port parity: the dataloader (``deepspeed_tpu_torch/runtime/dataloader.py``)
against ``deepspeed_tpu/runtime/dataloader.py`` on the same datasets.

- ``DistributedSampler``: every rank's indices over a grid of dataset
  lengths, replica counts, shuffle, drop_last and epochs equal JAX's,
  index for index (both draw numpy's ``default_rng(seed + epoch)``);
- ``default_collate`` and ``DeepSpeedDataLoader``: batches hold the values
  of JAX's numpy stacks, as CPU tensors;
- ``RepeatingLoader``: epochs, ``skip_batches``, ``state_dict`` and exact
  replay equal JAX's;
- ``PrefetchLoader`` and ``engine.put_batch``; ``initialize(training_data=
  ...)`` returns the loader at the micro-batch size.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu_torch.runtime import dataloader as tdl

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 7, 10, 33])
@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_sampler_indices_equal_jax(n, replicas, shuffle, drop_last):
    for rank in range(replicas):
        for seed in (0, 5):
            js = jdl.DistributedSampler(n, replicas, rank, shuffle=shuffle,
                                        seed=seed, drop_last=drop_last)
            ts = tdl.DistributedSampler(n, replicas, rank, shuffle=shuffle,
                                        seed=seed, drop_last=drop_last)
            for epoch in range(3):
                js.set_epoch(epoch)
                ts.set_epoch(epoch)
                assert list(ts) == list(js)
                assert len(ts) == len(js)


def test_sampler_rejects_a_bad_rank():
    for rank in (-1, 2):
        with pytest.raises(ValueError, match="invalid rank"):
            tdl.DistributedSampler(8, 2, rank)


def _dataset(n=23, seq=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 100, seq, dtype=np.int32),
             "labels": (rng.integers(0, 100, seq, dtype=np.int32),
                        np.float32(i))} for i in range(n)]


def _same(t, j):
    """A port batch (CPU tensors) holds the values of a JAX batch (numpy
    arrays), leaf by leaf and in the same structure."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j)
        for k in j:
            _same(t[k], j[k])
    elif isinstance(j, (tuple, list)):
        assert type(t) is type(j) and len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
    else:
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.numpy(), j)


def test_default_collate_stacks_as_jax():
    ds = _dataset(4)
    _same(tdl.default_collate(ds), jdl.default_collate(ds))
    tensors = [torch.arange(3) + i for i in range(2)]
    assert torch.equal(tdl.default_collate(tensors),
                       torch.stack(tensors))


@pytest.mark.parametrize("batch_size,drop_last,shuffle", [
    (4, True, True), (4, False, True), (5, False, False), (23, True, True),
    (1, True, False)])
def test_loader_batches_equal_jax(batch_size, drop_last, shuffle):
    ds = _dataset()
    jl = jdl.DeepSpeedDataLoader(ds, batch_size, drop_last=drop_last,
                                 shuffle=shuffle, seed=3)
    tl = tdl.DeepSpeedDataLoader(ds, batch_size, drop_last=drop_last,
                                 shuffle=shuffle, seed=3)
    assert len(tl) == len(jl)
    jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) == len(tl)
    for t, j in zip(tb, jb):
        _same(t, j)


def test_repeating_loader_epochs_skip_and_replay_equal_jax():
    ds = _dataset(10)
    jr = jdl.RepeatingLoader(jdl.DeepSpeedDataLoader(ds, 3, seed=1))
    tr = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(ds, 3, seed=1))
    for _ in range(7):                  # crosses two epoch boundaries
        _same(next(tr), next(jr))
    assert tr.state_dict() == jr.state_dict() == {"epoch": 2,
                                                  "batch_in_epoch": 1}
    assert tr.skip_batches(4) == jr.skip_batches(4) == 4
    assert tr.state_dict() == jr.state_dict()
    sd = tr.state_dict()
    resumed = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(ds, 3, seed=1))
    resumed.load_state_dict(sd)
    assert resumed.state_dict() == sd
    for _ in range(5):
        a, b = next(resumed), next(tr)
        _same(a, next(jr))
        assert torch.equal(a["input_ids"], b["input_ids"])
    with pytest.raises(ValueError, match="n must be >= 0"):
        tr.skip_batches(-1)


class _CountingSampler:
    def __init__(self):
        self.epoch = 0

    def set_epoch(self, e):
        self.epoch = e


class _ListLoader:
    """Epoch-aware toy loader: its items depend on the sampler's epoch as
    a shuffling sampler's permutation does."""

    def __init__(self, n):
        self.n = n
        self.sampler = _CountingSampler()

    def __iter__(self):
        base = self.sampler.epoch * 100
        return iter(range(base, base + self.n))


def test_repeating_loader_replay_is_exact():
    src = tdl.RepeatingLoader(_ListLoader(4))
    consumed = [next(src) for _ in range(10)]
    assert consumed[4] == 100 and consumed[8] == 200
    sd = src.state_dict()
    assert sd == {"epoch": 2, "batch_in_epoch": 2}
    resumed = tdl.RepeatingLoader(_ListLoader(4))
    resumed.load_state_dict(sd)
    assert [next(resumed) for _ in range(5)] == [next(src) for _ in range(5)]
    assert resumed.state_dict() == src.state_dict()


def test_prefetch_loader_runs_put_ahead_in_order():
    calls = []

    def put(b):
        calls.append(b)
        return ("placed", b)

    pf = tdl.PrefetchLoader(list(range(5)), put, prefetch=2)
    assert len(pf) == 5
    it = iter(pf)
    assert next(it) == ("placed", 0) and calls == [0, 1, 2]
    assert list(it) == [("placed", i) for i in range(1, 5)]
    with pytest.raises(ValueError, match="prefetch"):
        tdl.PrefetchLoader([], put, prefetch=0)

    def bad_put(b):
        raise StopIteration

    with pytest.raises(RuntimeError):    # surfaces, not an empty epoch
        list(tdl.PrefetchLoader([1, 2], bad_put))


def _engine(**kw):
    from deepspeed_tpu_torch.models import init_gpt_params, make_gpt

    model, cfg = make_gpt("tiny", dtype=torch.float32)
    return deepspeed_tpu_torch.initialize(
        model=model, params=init_gpt_params(cfg, seed=0), device="cpu",
        config={"train_micro_batch_size_per_gpu": 2,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        **kw)


def test_initialize_returns_the_loader_at_the_micro_batch():
    ds = [{"input_ids": np.full(16, i, np.int32)} for i in range(9)]
    engine, _opt, loader, _sched = _engine(training_data=ds)
    assert isinstance(loader, tdl.DeepSpeedDataLoader)
    assert loader.batch_size == 2 and len(loader) == 4
    want = jdl.DeepSpeedDataLoader(ds, 2)
    for t, j in zip(loader, want):
        _same(t, j)
    seen = []
    _e, _o, custom, _s = _engine(training_data=ds, collate_fn=seen.append)
    next(iter(custom))
    assert len(seen) == 1 and len(seen[0]) == 2


def test_put_batch_and_train_from_the_loader():
    """``put_batch`` keeps CPU tensors on a CPU engine and checks the
    leading accumulation dim; a RepeatingLoader -> PrefetchLoader stream
    of [GAS, micro, S] batches trains."""
    ds = [{"input_ids": np.arange(16, dtype=np.int32) + i}
          for i in range(8)]
    engine, _opt, loader, _sched = _engine(training_data=ds)
    rep = tdl.RepeatingLoader(loader)

    def groups():
        while True:
            micro = [next(rep) for _ in range(2)]
            yield {"input_ids": torch.stack([m["input_ids"]
                                             for m in micro])}

    def put(b):
        return engine.put_batch(b, leading_gas_dim=True)

    stream = iter(tdl.PrefetchLoader(groups(), put))
    first = next(stream)
    assert first["input_ids"].device.type == "cpu"
    assert tuple(first["input_ids"].shape) == (2, 2, 16)
    losses = [float(engine.train_batch(first))]
    losses.append(float(engine.train_batch(next(stream))))
    assert all(np.isfinite(losses)) and engine.global_steps == 2
    with pytest.raises(ValueError, match="leading dim"):
        engine.put_batch({"input_ids": torch.zeros(3, 2, 16)},
                         leading_gas_dim=True)

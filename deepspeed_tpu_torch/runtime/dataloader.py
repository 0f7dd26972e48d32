"""Data pipeline: the port of ``deepspeed_tpu/runtime/dataloader.py``.

``DeepSpeedDataLoader`` wraps an indexable dataset with a distributed
sampler sized by the data-parallel world (one process so far: world 1,
rank 0); ``RepeatingLoader`` is the infinite, replayable iterator;
``PrefetchLoader`` moves the next batches to the device while the current
step computes.

The sampler draws its permutation with numpy's ``default_rng(seed +
epoch)``, as the JAX package does, so the two orders are equal index for
index (``torch.randperm`` would give another). ``default_collate`` stacks
samples into CPU tensors holding the values of the JAX package's numpy
stack.
"""

import collections
import math
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class DistributedSampler:
    """Deterministic rank-strided sampler (torch ``DistributedSampler``
    semantics: pad to a multiple of the world, stride by rank, reshuffle
    per epoch)."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"invalid rank {rank} for world {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        if not self.drop_last:
            indices += indices[:self.total_size - len(indices)]
        else:
            indices = indices[:self.total_size]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (dicts, tuples or lists of them, or arrays)
    into one batch of CPU tensors."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack([s.cpu() for s in samples])
    return torch.from_numpy(np.stack([np.asarray(s) for s in samples]))


class DeepSpeedDataLoader:
    """Batch iterator over an indexable dataset with DP-aware sampling."""

    def __init__(self, dataset, batch_size: int,
                 data_parallel_world_size: int = 1,
                 data_parallel_rank: int = 0,
                 collate_fn: Optional[Callable] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, data_sampler=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or default_collate
        if data_sampler is None:
            data_sampler = DistributedSampler(
                len(dataset), num_replicas=data_parallel_world_size,
                rank=data_parallel_rank, shuffle=shuffle, seed=seed,
                drop_last=drop_last)
        self.sampler = data_sampler
        self.drop_last = drop_last
        self.len = (len(self.sampler) // self.batch_size if drop_last
                    else math.ceil(len(self.sampler) / self.batch_size))

    def __len__(self) -> int:
        return self.len

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(self.dataset[idx])
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)


class RepeatingLoader:
    """Wraps a loader to restart it on StopIteration, advancing the
    sampler's epoch.

    Positional and replayable: it tracks (epoch, batch_in_epoch), so a
    resumed job fast-forwards the stream to where the checkpoint was
    taken (register ``loader.state_dict`` as the engine's client-state
    function). Replay redraws the same permutations, so the batches after
    a resume are those of the uninterrupted run.
    """

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)
        self.epoch = 0
        self.batch_in_epoch = 0

    def __iter__(self):
        return self

    def _set_epoch(self) -> None:
        sampler = getattr(self.loader, "sampler", None)
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(self.epoch)

    def __next__(self):
        try:
            out = next(self.data_iter)
        except StopIteration:
            self.epoch += 1
            self.batch_in_epoch = 0
            self._set_epoch()
            self.data_iter = iter(self.loader)
            out = next(self.data_iter)
        self.batch_in_epoch += 1
        return out

    def skip_batches(self, n: int) -> int:
        """Advance past ``n`` batches without yielding them, through
        ``__next__``, so epoch rollovers behave as in consumption and
        ``state_dict`` replay stays exact. Returns n."""
        if n < 0:
            raise ValueError("skip_batches: n must be >= 0")
        for _ in range(int(n)):
            next(self)
        return int(n)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "batch_in_epoch": self.batch_in_epoch}

    def load_state_dict(self, sd: dict) -> None:
        """Rewind to the start of the saved epoch, then replay forward
        through ``__next__``."""
        self.epoch = int(sd["epoch"])
        self.batch_in_epoch = 0
        self._set_epoch()
        self.data_iter = iter(self.loader)
        for _ in range(int(sd["batch_in_epoch"])):
            next(self)


class PrefetchLoader:
    """While step N computes, batches N+1.. are already on their way to
    the device: ``put`` (``engine.put_batch``, which pins the host tensors
    and copies with ``non_blocking``) is called ``prefetch`` batches
    ahead."""

    def __init__(self, loader, put: Callable[[Any], Any], prefetch: int = 2):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self.loader = loader
        self.put = put
        self.prefetch = prefetch

    def __iter__(self):
        queue = collections.deque()
        it = iter(self.loader)

        def refill():
            # next() inside the guard, put() outside: a StopIteration out
            # of the user's put must surface, not end the epoch
            try:
                batch = next(it)
            except StopIteration:
                return
            queue.append(self.put(batch))

        for _ in range(self.prefetch):
            refill()
        while queue:
            out = queue.popleft()
            refill()
            yield out

    def __len__(self):
        return len(self.loader)

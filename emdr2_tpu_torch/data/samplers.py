"""Batch samplers.

Parity with ``megatron/data/samplers.py:22-148``: an
epoch-seedable random sampler and a distributed batch sampler that splits
each global batch among data-parallel ranks either contiguously (rank r gets
rows [r*b, (r+1)*b)) or interleaved (rank r gets rows r, r+W, ...).

In the single-controller JAX model the host feeds the whole global batch and
sharding happens on device, so these are mainly used by multi-host input
pipelines (each host materializes only its slice) and for reference-exact
data-order reproduction.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class RandomSampler:
    """Epoch-seeded shuffle over dataset indices (samplers.py:22-76)."""

    def __init__(self, n: int, seed: int = 1234):
        self.n = n
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n)
        np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return iter(order.tolist())

    def __len__(self) -> int:
        return self.n


class DistributedBatchSampler:
    """Wraps a sampler into global batches and yields this rank's slice
    (samplers.py:78-148)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = True,
                 rank: int = 0, world_size: int = 1,
                 interleave: bool = False):
        assert 0 <= rank < world_size
        assert batch_size % world_size == 0
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rank = rank
        self.world_size = world_size
        self.interleave = interleave

    def _slice(self, batch: List[int]) -> List[int]:
        if self.interleave:
            return batch[self.rank:: self.world_size]
        per = self.batch_size // self.world_size
        return batch[self.rank * per: (self.rank + 1) * per]

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield self._slice(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._slice(batch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

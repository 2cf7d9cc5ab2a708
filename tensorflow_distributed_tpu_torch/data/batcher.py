"""Generic epoch-shuffled batcher (numpy): the port of ``data/batcher.py``.

Each global batch of size B is a contiguous slice of a seeded per-epoch
permutation (``np.random.default_rng((seed, epoch))``, the JAX package's
stream), so the port sees the same batches as the JAX package for the
same seed. Process p materializes rows [p*B/P, (p+1)*B/P).
``forever(start_step)`` fast-forwards without gathering skipped batches.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np


class Batcher:
    def __init__(self, n_items: int, global_batch: int,
                 gather: Callable[[np.ndarray], Any], seed: int = 0,
                 num_processes: int = 1, process_index: int = 0):
        if global_batch % max(num_processes, 1) != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{num_processes} processes")
        if n_items < global_batch:
            raise ValueError("dataset smaller than one global batch")
        self.n_items = n_items
        self.global_batch = global_batch
        self.gather = gather
        self.seed = seed
        self.num_processes = num_processes
        self.process_index = process_index
        self.local_batch = global_batch // max(num_processes, 1)
        self.steps_per_epoch = n_items // global_batch

    def _perm(self, epoch_idx: int) -> np.ndarray:
        return np.random.default_rng((self.seed, epoch_idx)).permutation(
            self.n_items)

    def epoch(self, epoch_idx: int, start: int = 0) -> Iterator[Any]:
        perm = self._perm(epoch_idx)
        for s in range(start, self.steps_per_epoch):
            lo = s * self.global_batch + self.process_index * self.local_batch
            yield self.gather(perm[lo:lo + self.local_batch])

    def forever(self, start_step: int = 0) -> Iterator[Any]:
        e, skip = divmod(start_step, self.steps_per_epoch)
        while True:
            yield from self.epoch(e, start=skip)
            skip = 0
            e += 1

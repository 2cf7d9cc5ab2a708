"""Generic epoch-shuffled batcher (numpy): the port of ``data/batcher.py``.

Each global batch of size B is a contiguous slice of a seeded per-epoch
permutation (``np.random.default_rng((seed, epoch))``, the JAX package's
stream), so the port sees the same batches as the JAX package for the
same seed. Process p materializes rows [p*B/P, (p+1)*B/P); under
gradient accumulation over A microbatches, its P-th of each microbatch
in turn (``local_rows``), which is how the JAX step splits a global
batch.
``forever(start_step)`` fast-forwards without gathering skipped batches.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np


def local_rows(global_batch: int, num_processes: int, process_index: int,
               accum_steps: int = 1) -> np.ndarray:
    """The rows of a global batch of ``global_batch`` that process
    ``process_index`` of ``num_processes`` holds, in order: for each of
    the ``accum_steps`` microbatches ``i`` (JAX's microbatch ``i`` is
    rows ``[iB/A, (i+1)B/A)`` of the global batch, split over the data
    axis), rows ``[iB/A + p*B/(AP), iB/A + (p+1)*B/(AP))``. A contiguous
    ``[p*B/P, (p+1)*B/P)`` when A is 1. The process's own split of its
    rows into A equal parts is then its part of each JAX microbatch."""
    procs, accum = max(num_processes, 1), max(accum_steps, 1)
    if global_batch % (procs * accum):
        raise ValueError(
            f"grad_accum_steps {accum} must divide the per-rank batch: "
            f"global batch {global_batch} not divisible by {procs} data "
            f"ranks x {accum} microbatches")
    micro, n = global_batch // accum, global_batch // (procs * accum)
    return np.concatenate([np.arange(i * micro + process_index * n,
                                     i * micro + (process_index + 1) * n)
                           for i in range(accum)])


class Batcher:
    def __init__(self, n_items: int, global_batch: int,
                 gather: Callable[[np.ndarray], Any], seed: int = 0,
                 num_processes: int = 1, process_index: int = 0,
                 accum_steps: int = 1):
        if global_batch % max(num_processes, 1) != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by "
                f"{num_processes} processes")
        self.rows = local_rows(global_batch, num_processes, process_index,
                               accum_steps)
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
            yield self.gather(perm[s * self.global_batch + self.rows])

    def forever(self, start_step: int = 0) -> Iterator[Any]:
        e, skip = divmod(start_step, self.steps_per_epoch)
        while True:
            yield from self.epoch(e, start=skip)
            skip = 0
            e += 1

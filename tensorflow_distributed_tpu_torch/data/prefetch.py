"""Host-to-device prefetch: the port of ``data/prefetch.py``'s
``prefetch_with`` / ``prefetch_to_mesh``.

The next batches' copies overlap the current step's compute. On a GPU
each host batch goes into pinned memory and is copied with
``non_blocking`` on a side stream, ``size`` batches ahead of the
consumer (the JAX prefetcher's order of draws); before a batch is
handed over, the compute stream waits on
that copy, and ``record_stream`` tells the caching allocator that the
compute stream reads the buffers, so none is reused while a step still
reads it. On the CPU it is a plain look-ahead.

A batch is a dict or a tuple of numpy arrays; what comes out has the
same structure, of tensors on the device.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator

import numpy as np
import torch


def map_batch(fn: Callable[[Any], Any], batch):
    """``fn`` over the arrays of a dict or tuple batch."""
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return tuple(fn(v) for v in batch)


def _host(v: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v))


def to_device(batch, device: torch.device):
    """Host batch -> device tensors (pinned, asynchronous copies on the
    current stream on a GPU)."""
    if device.type != "cuda":
        return map_batch(_host, batch)
    return map_batch(lambda v: _host(v).pin_memory().to(
        device, non_blocking=True), batch)


def prefetch(it: Iterator[Any], device: torch.device, size: int = 2
             ) -> Iterator[Any]:
    """Yield the batches of ``it`` on ``device``, ``size`` copies in
    flight ahead of the consumer. The consumer's stream is the caller's
    current stream when ``prefetch`` is called: the batches may then be
    drawn on another thread (the train loop's data watchdog), whose
    current stream is its own."""
    if device.type != "cuda":
        place, ready = (lambda b: map_batch(_host, b)), (lambda b: b)
    else:
        copy = torch.cuda.Stream(device)
        compute = torch.cuda.current_stream(device)

        def place(batch):
            with torch.cuda.stream(copy):
                batch = to_device(batch, device)
                done = torch.cuda.Event()
                done.record(copy)
            return batch, done

        def ready(placed):
            batch, done = placed
            compute.wait_event(done)
            map_batch(lambda t: t.record_stream(compute), batch)
            return batch

    return _ahead(it, place, ready, size)


def _ahead(it: Iterator[Any], place, ready, size: int) -> Iterator[Any]:
    buf = collections.deque()

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            buf.append(place(batch))

    # The JAX prefetcher's order: the next batch is drawn when the
    # consumer asks for this one, so a stream's side effects (the fault
    # plan's poisoned batches) happen at the same step in both packages.
    enqueue(size)
    while buf:
        yield ready(buf.popleft())
        enqueue(1)

"""Data and device watchdog, the port of ``resilience/watchdog.py``: a
silent hang becomes a diagnosable error.

The watchdog runs a blocking call on a worker thread with a deadline; a
breach prints a ``stall`` recovery record and raises :class:`StallError`
naming what stalled and for how long, which a restart supervisor can act
on (the CLI exits 3). It raises and never skips or retries the stalled
work: recovery from a stall is process-level (restart, then ``--resume``
or the request journal). Under more than one process a skip by one rank
would leave the others waiting in their collectives.

The train loop watches its next-batch fetch (:meth:`Watchdog.fetch`,
``data_timeout_s``, with an injected ``data_stall`` inside the watched
region) and the retirement of each step (:meth:`Watchdog.sync`,
``sync_timeout_s``); serving watches the engine's token fetch
(:meth:`Watchdog.decode`, ``sync_timeout_s``).

Threads: PyTorch's current device and current stream belong to each
thread, so a call that waits on the device from the worker must name
the stream the work was queued on: the engine passes its stream, the
train loop an event recorded on its stream, and the prefetcher the
consumer's stream. The worker is a daemon: a ``StallError`` ends the
process at once, where a joined thread still sleeping in the stalled
call would hold the exit.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

import torch

from tensorflow_distributed_tpu_torch.utils.logging import emit_event


class StallError(RuntimeError):
    """A watched blocking call exceeded its deadline."""


def _multihost() -> bool:
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def wait_for(value: Any) -> Any:
    """Block until the device work behind ``value`` is done (see
    :meth:`Watchdog.sync`); returns ``value``."""
    if isinstance(value, torch.cuda.Event):
        value.synchronize()
    return value


class Watchdog:
    # One persistent hand-rolled daemon worker, not a ThreadPoolExecutor:
    # executor workers are joined at interpreter exit, so a worker still
    # wedged in the stalled call would hold the process after the
    # StallError instead of letting it exit 3. A worker abandoned by a
    # timeout is replaced on the next call.

    def __init__(self, data_timeout_s: float = 0.0,
                 sync_timeout_s: float = 0.0):
        self.data_timeout_s = data_timeout_s
        self.sync_timeout_s = sync_timeout_s
        self._requests: Optional[queue.Queue] = None

    def _worker_loop(self, requests: queue.Queue) -> None:
        while True:
            fn, box, done = requests.get()
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["error"] = e
            finally:
                done.set()

    def _watched(self, fn: Callable[[], Any], what: str, step: int,
                 timeout: float) -> Any:
        if timeout <= 0:
            return fn()
        if self._requests is None:
            self._requests = queue.Queue()
            threading.Thread(target=self._worker_loop,
                             args=(self._requests,), daemon=True,
                             name="tfd-watchdog").start()
        box: dict = {}
        done = threading.Event()
        self._requests.put((fn, box, done))
        if not done.wait(timeout):
            # Abandon the wedged worker (it still holds the stalled
            # call); a later watched call gets a fresh one.
            self._requests = None
            multihost = _multihost()
            emit_event("recovery", kind="stall", what=what, step=step,
                       timeout_s=timeout, multihost=multihost)
            raise StallError(
                f"{what} for step {step} exceeded the "
                f"{timeout:g}s watchdog deadline"
                + (" (multi-host run: raising is the ONLY safe "
                   "disposition — an unilateral skip would desync the "
                   "peer processes' collectives; recover by restart + "
                   "--resume)" if multihost else
                   "; recover by restart + --resume (e.g. under "
                   "resilience.supervisor)"))
        if "error" in box:
            raise box["error"]
        return box["value"]

    def fetch(self, fn: Callable[[], Any], step: int) -> Any:
        """Run the next-batch fetch under the data deadline."""
        return self._watched(fn, "next-batch fetch", step,
                             self.data_timeout_s)

    def sync(self, value: Any, step: int) -> Any:
        """Wait for the device work behind ``value`` under the sync
        deadline, and return ``value``: a CUDA event (recorded on the
        stream that queued the work) is synchronised; anything else is
        ready."""
        return self._watched(lambda: wait_for(value), "device sync", step,
                             self.sync_timeout_s)

    def decode(self, fn: Callable[[], Any], step: int) -> Any:
        """Run a serving engine's token fetch under the sync deadline,
        taking a callable so that the engine folds an injected
        decode_stall inside the watched region. ``step`` is the decode
        step. Raises StallError instead of letting the engine freeze;
        the CLI maps it to exit 3."""
        return self._watched(fn, "decode step", step,
                             self.sync_timeout_s)

    def close(self) -> None:
        """Drop the worker reference; the daemon thread dies with the
        process (it blocks on a queue nobody feeds)."""
        self._requests = None

"""Preemption-aware stopping, the port of ``train/preemption.py``:
SIGTERM becomes a durable checkpoint and exit 0.

A preemptible card's notice (SIGTERM) comes before the kill. The train
loop asks the guard at each step whether to stop; after the notice it
stops at the next step, saves, prints a ``preempted`` record and exits
0, for a scheduler to restart with ``--resume``.

One process only. Under more than one process the ranks would have to
agree on the step to stop at, or a rank that stopped alone would leave
the others waiting in their collectives; the JAX package asks its
coordination service, which the port has no counterpart of yet
(ROADMAP.md A7). So under a world of more than one process the guard
installs nothing and never stops early: the cadence checkpoints remain.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

import torch


def _world() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class PreemptionGuard:
    """Decides, once a step, whether to stop for a preemption notice::

        guard = PreemptionGuard()
        for i in ...:
            if guard.should_stop(i):
                break            # then the preemption save
        guard.close()

    ``close()`` restores the handlers it replaced. ``enabled=False`` (no
    checkpoint directory to save into) installs nothing: stopping early
    would drop the work and exit 0 as if it were done."""

    def __init__(self, enabled: bool = True):
        self._flag = threading.Event()
        self._prev: dict = {}
        self._enabled = enabled and _world() == 1
        self.fired: Optional[int] = None  # the step at which it stopped
        if not self._enabled:
            return
        try:
            self._prev[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                       self._on_signal)
        except ValueError:
            # Not the main thread (a library inside a server): no handler
            # can be installed; the cadence saves remain.
            pass

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    def should_stop(self, step_id: int) -> bool:
        """True when this step is where to stop (a notice came)."""
        if self._enabled and self._flag.is_set():
            self.fired = step_id
            return True
        return False

    def close(self) -> None:
        """Restore the previous signal dispositions and drop a notice
        not acted on; idempotent."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()
        self._flag.clear()

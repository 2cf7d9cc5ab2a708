"""Preemption-aware stopping, the port of ``train/preemption.py``:
SIGTERM becomes a durable checkpoint and exit 0.

A preemptible card's notice (SIGTERM) comes before the kill. The train
loop asks the guard at each step whether to stop; after the notice it
stops, saves, prints a ``preempted`` record and exits 0, for a
scheduler to restart with ``--resume``.

One process: the notice's flag stops the run at the next step.

More than one process: the ranks must stop at the same step, or a rank
that stopped alone would leave the others waiting in their collectives.
The JAX package asks its coordination service for the sync point (the
largest step at which any process took the notice, plus one). Here the
ranks agree on the host: the guard makes a gloo group of the world, and
at each step every rank posts its notice (the step it took it at, or
-1) to one asynchronous MAX all-reduce of a CPU integer, and reads the
result of the one it posted at the step before. A notice any rank took
at step i is so seen by every rank at the same step i + 1, where every
rank stops, joins the one save and exits 0. The agreement is a host
collective only, off the step's critical path: no device sync, no NCCL
call, and no rank's host waits on its peers' at the step it posts.

A peer that died (a drill's SIGKILL, or a launcher tearing a failed
group down, which SIGTERMs the survivors) never joins the agreement: a
closed connection fails it at once, a silent peer after
``PEER_TIMEOUT_S`` (the world group's own timeout, ``mesh.PG_TIMEOUT``,
as long as a step's collectives would wait), and the rank then leaves
without saving, with a ``preempt_abandoned`` recovery record and exit
143 (the code of a SIGTERM's death), instead of waiting for the
launcher's kill.
"""

from __future__ import annotations

import datetime
import os
import signal
import threading
from typing import Optional

import torch

from tensorflow_distributed_tpu_torch.parallel.mesh import PG_TIMEOUT
from tensorflow_distributed_tpu_torch.utils.logging import emit_event

# How long a rank waits for its peers to join a step's agreement.
PEER_TIMEOUT_S = PG_TIMEOUT.total_seconds()


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
    would drop the work and exit 0 as if it were done. Under more than
    one process every rank must build the guard at the same point (it
    makes a process group) and call ``should_stop`` with the same
    consecutive step ids."""

    def __init__(self, enabled: bool = True):
        self._flag = threading.Event()
        self._prev: dict = {}
        self._enabled = enabled
        self.fired: Optional[int] = None  # the step at which it stopped
        self._group = None
        self._stop_at: Optional[int] = None
        # The agreement in flight: (its work, its tensor, its step).
        self._pending: Optional[tuple] = None
        if not self._enabled:
            return
        if _world() > 1:
            self._group = torch.distributed.new_group(
                backend="gloo",
                timeout=datetime.timedelta(seconds=PEER_TIMEOUT_S))
        try:
            self._prev[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                       self._on_signal)
        except ValueError:
            # Not the main thread (a library inside a server): no handler
            # can be installed; the cadence saves remain.
            pass

    def _on_signal(self, signum, frame) -> None:
        self._flag.set()

    def _agree(self, step_id: int) -> Optional[int]:
        """The step every rank stops at, once any rank took a notice by
        the step before: the largest step at which one took it, plus one
        (never past this step); None before. Reads the agreement posted
        at the step before, then posts this step's."""
        dist = torch.distributed
        posted = step_id
        try:
            if self._pending is not None:
                work, seen, posted = self._pending
                self._pending = None
                work.wait()
                if int(seen[0]) >= 0:
                    return int(seen[0]) + 1
            posted = step_id
            mine = torch.tensor([step_id if self._flag.is_set() else -1])
            work = dist.all_reduce(mine, op=dist.ReduceOp.MAX,
                                   group=self._group, async_op=True)
            self._pending = (work, mine, step_id)
        except Exception as e:  # a peer died: its connection or the wait
            emit_event("recovery", kind="preempt_abandoned", step=posted,
                       notice=self._flag.is_set(),
                       reason=f"{type(e).__name__}: {e}"[:300])
            os._exit(128 + signal.SIGTERM)
        return None

    def should_stop(self, step_id: int) -> bool:
        """True when this step is where to stop (a notice came; under
        more than one process, the agreed step)."""
        if not self._enabled:
            return False
        if self._group is not None:
            if self._stop_at is None:
                self._stop_at = self._agree(step_id)
            if self._stop_at is not None and step_id >= self._stop_at:
                self.fired = step_id
                return True
            return False
        if self._flag.is_set():
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
        if self._pending is not None:
            # Every rank posted it: it ends at once (or failed with a
            # peer, which no longer matters).
            try:
                self._pending[0].wait()
            except Exception:
                pass
            self._pending = None

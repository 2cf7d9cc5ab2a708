"""Bad-step policies, the port of ``resilience/policies.py``: what the
train loop does when the loss goes wrong, checked per retired step on
metrics the loop has already synchronised.

- ``halt``: raise :class:`RecoveryBudgetExceeded` (a
  ``FloatingPointError``; the CLI exits 2).
- ``skip_batch``: the train step has already discarded that batch's
  update (``train/step.py`` ``skip_nonfinite``): the params, the
  optimizer state, its count and the EMA kept their values, and only
  the step counter advanced. Here the skip is charged to a bounded
  budget, and the run halts when it is spent.
- ``rewind``: the loop restores the newest verifiable checkpoint in
  place and re-enters from there (bounded by ``max_rewinds``).

Loss spikes (:class:`LossSpikeDetector`): a finite loss above ``factor``
times the rolling-window median. By the time the host sees a spike the
update has applied, so under ``rewind`` a spike costs a budgeted rewind,
and under any other policy it is a recovery record only.

Every decision prints a ``recovery`` record (``utils/logging.emit_event``)
with the JAX package's fields.
"""

from __future__ import annotations

import collections
import statistics
from typing import Optional

from tensorflow_distributed_tpu_torch.utils.logging import emit_event


class RecoveryBudgetExceeded(FloatingPointError):
    """A bounded recovery policy ran out of budget: the run halts, with
    the recovery history in the message."""


class NonFinitePolicy:
    """Budgeted dispositions for non-finite losses (and, under
    ``rewind``, loss spikes): :meth:`on_nonfinite` returns ``"halt"``,
    ``"skip"`` or ``"rewind"``, and the loop carries it out."""

    def __init__(self, mode: str, max_skips: int = 3,
                 max_rewinds: int = 1):
        if mode not in ("halt", "skip_batch", "rewind"):
            raise ValueError(f"unknown non-finite policy {mode!r}")
        self.mode = mode
        self.max_skips = max_skips
        self.max_rewinds = max_rewinds
        self.skips_used = 0
        self.rewinds_used = 0

    def on_nonfinite(self, step: int, loss: float) -> str:
        if self.mode == "halt":
            emit_event("recovery", kind="nonfinite", step=step,
                       loss=str(loss), action="halt")
            return "halt"
        if self.mode == "skip_batch":
            # The counters count executed recoveries: the attempt that
            # finds the budget spent halts without counting, so the
            # message reads "N/N".
            if self.skips_used >= self.max_skips:
                emit_event("recovery", kind="nonfinite", step=step,
                           loss=str(loss), action="halt",
                           reason="skip budget exhausted",
                           used=self.skips_used, budget=self.max_skips)
                return "halt"
            self.skips_used += 1
            emit_event("recovery", kind="nonfinite", step=step,
                       loss=str(loss), action="skip",
                       used=self.skips_used, budget=self.max_skips)
            return "skip"
        return self._charge_rewind(step, loss=str(loss),
                                   trigger="nonfinite")

    def on_spike(self, step: int, loss: float,
                 median: float) -> Optional[str]:
        """A finite spike: a rewind under ``rewind`` (the update has
        applied, so a skip cannot help), else a record only."""
        emit_event("recovery", kind="loss_spike", step=step,
                   loss=round(loss, 6), window_median=round(median, 6))
        if self.mode != "rewind":
            return None
        return self._charge_rewind(step, loss=round(loss, 6),
                                   trigger="loss_spike")

    def _charge_rewind(self, step: int, **fields) -> str:
        if self.rewinds_used >= self.max_rewinds:
            emit_event("recovery", kind="nonfinite", step=step,
                       action="halt", reason="rewind budget exhausted",
                       used=self.rewinds_used, budget=self.max_rewinds,
                       **fields)
            return "halt"
        self.rewinds_used += 1
        emit_event("recovery", kind="nonfinite", step=step,
                   action="rewind", used=self.rewinds_used,
                   budget=self.max_rewinds, **fields)
        return "rewind"

    def halt_message(self, step: int, loss: float,
                     last_checkpoint) -> str:
        return (
            f"non-finite loss {loss} at step {step} "
            f"(resilience.nonfinite={self.mode}; skips used "
            f"{self.skips_used}/{self.max_skips}, rewinds used "
            f"{self.rewinds_used}/{self.max_rewinds}); last durable "
            f"checkpoint: {last_checkpoint}")


class LossSpikeDetector:
    """Rolling-window divergence detector for finite losses (the JAX
    package's ``observe/anomaly.py`` ``RollingMedianSpike``, which its
    ``LossSpikeDetector`` is; the port has no ``observe/`` yet and keeps
    this copy).

    ``observe(loss)`` returns the window median when ``loss > factor *
    median`` over a full window, else None. A spiking value is not added
    to the window (one outlier must not drag the baseline toward it);
    every other value is, so a shift of regime is tracked. ``reset()``
    clears the window after a rewind: the replayed steps approach the
    spike again, and a stale window would flag them."""

    def __init__(self, window: int, factor: float):
        self.factor = factor
        self._window: collections.deque = collections.deque(maxlen=window)

    def observe(self, loss: float) -> Optional[float]:
        if len(self._window) == self._window.maxlen:
            med = statistics.median(self._window)
            if loss > self.factor * max(med, 1e-12):
                return med
        self._window.append(loss)
        return None

    def reset(self) -> None:
        self._window.clear()

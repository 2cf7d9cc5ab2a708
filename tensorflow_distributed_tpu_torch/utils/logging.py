"""Structured per-step logging: the port of ``utils/logging.py``.

``MetricLogger`` prints step records as ``[step N] t=...s k=v`` lines and
other events as one JSON object per line (the JAX StdoutSink format),
keeps the step records in a bounded ring buffer, and renders the eval
records as the reference's ``performance`` table.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, TextIO


@dataclass
class StepRecord:
    step: int
    wall_time: float
    metrics: Dict[str, float]


class MetricLogger:
    def __init__(self, enabled: bool = True,
                 stream: Optional[TextIO] = None,
                 max_records: int = 100_000):
        self.enabled = enabled
        self.stream = stream if stream is not None else sys.stdout
        self.records: collections.deque = collections.deque(
            maxlen=max_records)
        self._t0 = time.time()

    def log(self, step: int, **metrics: float) -> None:
        rec = StepRecord(step=step, wall_time=time.time() - self._t0,
                         metrics={k: float(v) for k, v in metrics.items()})
        self.records.append(rec)
        if self.enabled:
            parts = " ".join(f"{k}={v:.6g}" for k, v in rec.metrics.items())
            print(f"[step {step:>6}] t={rec.wall_time:8.2f}s {parts}",
                  file=self.stream, flush=True)

    def log_json(self, payload: Dict[str, Any]) -> None:
        if self.enabled:
            print(json.dumps(payload), file=self.stream, flush=True)

    def performance_table(self, learning_rate: float) -> str:
        """The eval records (val_accuracy rows only) in the reference's
        ``performance`` file format: ``Steps, Time, Accuracy, Learning
        rate``."""
        lines = ["Steps,        Time,      Accuracy,  Learning rate"]
        for rec in self.records:
            if "val_accuracy" not in rec.metrics:
                continue
            lines.append(
                f"{rec.step},        {rec.wall_time:.0f} seconds,  "
                f"{100.0 * rec.metrics['val_accuracy']:.2f},      "
                f"{learning_rate}")
        return "\n".join(lines)


@dataclass
class Timer:
    """Wall-clock span timer."""

    _start: Optional[float] = None
    elapsed: float = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.time()
        return self

    def __exit__(self, *exc) -> None:
        if self._start is None:
            return
        self.elapsed = time.time() - self._start

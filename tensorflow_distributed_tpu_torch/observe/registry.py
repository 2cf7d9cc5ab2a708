"""Metrics registry: one emission path, pluggable sinks (the port of
``observe/registry.py``).

Every run event flows through one registry as a flat dict record,
tagged with host identity (``process_index``, mesh shape, config hash),
and fans out to whichever sinks the run configured: pretty stdout,
append-per-record JSONL (the durable artifact format), or CSV.

Emission is chief-only by construction (``enabled=False`` on non-chief
processes silences the sinks) but the in-memory ring buffer fills on
every process, so library callers can still inspect what would have
been written. The buffer is bounded (``max_records``).

Pure stdlib: ``host_tags`` reads the process index from
``torch.distributed`` only where a process group is up.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, Mapping, Optional, TextIO


def config_hash(cfg: Any) -> str:
    """Short stable hash of a config dataclass (or any JSON-able
    mapping) — lets two JSONL files be compared run-to-run without
    carrying the whole config in every record."""
    import dataclasses

    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    blob = json.dumps(cfg, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:10]


def host_tags(mesh: Any = None, cfg: Any = None) -> Dict[str, Any]:
    """Standard record tags: process identity, mesh shape, config hash.

    ``mesh`` may be a mapping of axis sizes, an object with such a
    ``.shape`` mapping (rendered compactly, e.g. ``"data=8"``), or None.
    The process index is the ``torch.distributed`` rank where a process
    group is up, else 0.
    """
    rank = 0
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
    tags: Dict[str, Any] = {"process_index": rank}
    if mesh is not None:
        shape = dict(getattr(mesh, "shape", mesh))
        tags["mesh"] = ",".join(f"{k}={v}" for k, v in shape.items()
                                if v > 1) or "data=1"
    if cfg is not None:
        tags["config_hash"] = config_hash(cfg)
    return tags


class Sink:
    """A metrics sink consumes flat dict records, one per emit."""

    def emit(self, record: Mapping[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class StdoutSink(Sink):
    """The human-facing pretty printer (the MetricLogger format —
    ``[step N] t=...s k=v``) for step records; other events print as
    one JSON line."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream if stream is not None else sys.stdout

    def emit(self, record: Mapping[str, Any]) -> None:
        if record.get("event") == "step" and "step" in record:
            skip = {"event", "step", "t", "process_index", "mesh",
                    "config_hash"}
            parts = " ".join(
                f"{k}={v:.6g}" for k, v in record.items()
                if k not in skip and isinstance(v, (int, float)))
            print(f"[step {record['step']:>6}] t={record['t']:8.2f}s "
                  f"{parts}", file=self.stream, flush=True)
        else:
            print(json.dumps(dict(record)), file=self.stream, flush=True)


class JsonlSink(Sink):
    """One JSON object per record — the durable artifact format.

    Opens lazily on first emit (a configured-but-never-used sink leaves
    no file). Fresh runs TRUNCATE any previous file (the repo-wide
    rule: reruns replace, never silently accumulate stale lines — a
    mixed file would skew observe.report's aggregates); a RESUMED run
    passes ``append=True`` so the pre-preemption records the per-record
    flushing preserved stay in the artifact (``ServeObservatory`` wires
    this to a journal resume). Flushes per record either way, so a killed run's
    JSONL is complete up to the last emission.
    """

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self.append = append
        self._f: Optional[TextIO] = None
        self._closed = False

    def emit(self, record: Mapping[str, Any]) -> None:
        if self._closed:
            # A straggler emit (e.g. a background writer's retry
            # event racing run teardown) must not LAZILY REOPEN the
            # file — mode "w" would truncate the finished artifact.
            return
        if self._f is None:
            self._f = open(self.path, "a" if self.append else "w")
        self._f.write(json.dumps(dict(record)) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._closed = True
        if self._f is not None:
            self._f.close()
            self._f = None


class CsvSink(Sink):
    """Buffered CSV: rows collect in memory and the file is written on
    ``close()`` with the UNION of all keys as the header (sorted,
    missing cells empty) — late-appearing columns like mfu (which needs
    one throughput window first) still get a column. Convenience
    format; the per-record-flushed JSONL sink is the crash-durable one.

    ``events`` restricts which event types land in the table (default
    ``("step",)`` — a clean per-step spreadsheet); ``events=None``
    takes everything. ``max_rows`` bounds the buffer like the
    registry's ``max_records`` (oldest rows drop first), keeping host
    memory bounded on multi-million-step runs.
    """

    def __init__(self, path: str, events: Optional[tuple] = ("step",),
                 max_rows: int = 100_000):
        self.path = path
        self.events = events
        self._rows: collections.deque = collections.deque(
            maxlen=max_rows)

    def emit(self, record: Mapping[str, Any]) -> None:
        if self.events is None or record.get("event") in self.events:
            self._rows.append(dict(record))

    def close(self) -> None:
        import csv

        if not self._rows:
            return
        fields = sorted({k for row in self._rows for k in row})
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fields, restval="")
            writer.writeheader()
            writer.writerows(self._rows)
        self._rows.clear()


# --- module-level indirection (resilience / train.checkpoint) ----------
#
# Deep library code (checkpoint retries, watchdog stalls, injected
# faults) must emit recovery events through the run's registry without
# the run threading a registry handle through every call. The serve
# observatory installs its registry here; utils.logging.emit_event
# prints every event and, with a registry installed, emits it there
# too, so the library modules stay importable outside a run.

_active_registry: Optional["MetricsRegistry"] = None


def set_active(registry: Optional["MetricsRegistry"]) -> None:
    """Install the run's registry (``observe.hub.ServeObservatory``
    does)."""
    global _active_registry
    _active_registry = registry


def get_active() -> Optional["MetricsRegistry"]:
    return _active_registry


class MetricsRegistry:
    """Collects records, tags them, and fans out to sinks.

    ``enabled=False`` (non-chief processes) keeps the ring buffer but
    silences every sink — chief-only emission with library-level
    inspectability everywhere.
    """

    def __init__(self, sinks: Iterable[Sink] = (), enabled: bool = True,
                 tags: Optional[Mapping[str, Any]] = None,
                 max_records: int = 100_000, clock=time.time):
        self.sinks = list(sinks)
        self.enabled = enabled
        self.tags = dict(tags or {})
        self.records: collections.deque = collections.deque(
            maxlen=max_records)
        self._clock = clock
        self._t0 = clock()
        # emit() is not main-thread-only (a watchdog's thread can emit
        # beside the loop): one lock keeps sink writes whole-line (JSONL
        # lazy-open included) and the ring buffer consistent.
        self._lock = threading.Lock()

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "event": event,
            "t": round(self._clock() - self._t0, 6),
            **self.tags, **fields,
        }
        with self._lock:
            self.records.append(rec)
            if self.enabled:
                for sink in self.sinks:
                    sink.emit(rec)
        return rec

    def close(self) -> None:
        # Under the same lock as emit(): closing a sink mid-write from
        # an exception path would raise inside the other thread's emit.
        with self._lock:
            for sink in self.sinks:
                sink.close()

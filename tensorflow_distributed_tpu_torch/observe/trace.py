"""Chrome-trace (Perfetto-compatible) span emitter: the port of
``observe/trace.py``, pure Python.

JSON trace events for host-side phases in the Trace Event Format that
chrome://tracing and https://ui.perfetto.dev open directly. Events carry
the standard keys: ``ph`` (phase: "X" complete span, "i" instant, "C"
counter, "M" metadata, "b"/"e" async span begin/end), ``ts``/``dur`` in
microseconds, ``name``, ``pid``/``tid``. The file is written tmp+rename
on ``flush()``/``close()`` (idempotent), and flushed periodically so a
killed run still leaves an openable trace.

Async events (``async_begin``/``async_end``) are for spans that do not
nest with the call stack: a serve request's lifecycle interleaves with
every other request's, so its queue/prefill/decode phases are ``b``/``e``
pairs keyed by ``id`` (Perfetto groups same-``id`` events onto one
request track). ``observe/serve_trace.py`` builds the per-request span
trees on these primitives.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from tensorflow_distributed_tpu_torch.utils.atomicio import atomic_write_json

_FLUSH_INTERVAL_S = 5.0  # min seconds between incremental rewrites:
                         # each flush rewrites the whole accumulated
                         # buffer, so an event-count trigger would go
                         # O(n^2) in IO on long runs; a pure time
                         # trigger bounds IO to runtime/5 rewrites AND
                         # keeps a killed run's trace at most ~5s
                         # stale regardless of event rate (close()
                         # always writes everything).


class ChromeTracer:
    """Span/instant/counter recorder -> one Chrome-trace JSON file.

    ``enabled=False`` (or an empty path) makes every method a no-op so
    call sites need no guards. The clock is injectable for tests.
    """

    def __init__(self, path: str = "", pid: int = 0, enabled: bool = True,
                 process_name: str = "", clock=time.perf_counter,
                 max_events: int = 200_000):
        self.path = path
        self.enabled = bool(enabled and path)
        self.pid = pid
        self._clock = clock
        self._t0 = clock()
        self._events: List[Dict[str, Any]] = []
        self._last_flush = clock()
        # Bound host memory (and the rewrite-on-flush cost) like the
        # registry's max_records: past the cap, new events are counted
        # but dropped, and the written trace carries one marker event
        # saying how many. ~3 spans/step, so the default covers ~65k
        # traced steps — far past what a human opens in Perfetto.
        self.max_events = max_events
        self.dropped = 0
        self._ts_offset = 0.0  # microseconds; preload() moves it
        # Async span balance across the max_events cap: counts of
        # RECORDED (appended) vs DROPPED "b" events per (cat, name,
        # id), so async_end can keep the file balanced — an "e" whose
        # "b" made it into the buffer is appended even past the cap
        # (bounded overflow: at most the spans open at the drop
        # point), and an "e" whose "b" was dropped is dropped with it
        # (a stray "e" would unbalance just the same).
        self._open_b: Dict[tuple, int] = {}
        self._dropped_b: Dict[tuple, int] = {}
        if self.enabled and process_name:
            self._events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": process_name}})
            # Wall-clock anchor: this tracer's ts=0 corresponds to
            # wall_ts seconds since the epoch. perf_counter timelines
            # from DIFFERENT processes share no origin; the fleet
            # stitcher (observe/fleet_trace.py) reads each file's
            # FIRST clock_sync to place every source on one absolute
            # axis (refined by the snapshot wall_ts<->mtime offsets).
            # Named-process tracers only — exactly the ones that can
            # become stitch sources.
            self._events.append({
                "ph": "M", "name": "clock_sync", "pid": pid, "tid": 0,
                "args": {"wall_ts": round(time.time(), 6)}})
        # Constructor metadata doesn't eat into the event budget —
        # max_events caps RECORDED work, not the preamble.
        self._preamble = len(self._events)

    def _ts(self) -> float:
        return (self._clock() - self._t0) * 1e6 + self._ts_offset

    def preload(self, events: List[Dict[str, Any]],
                gap_us: float = 1_000.0) -> None:
        """Seed previously-written events (trace RESUME: a restarted
        serve leg continues the dead leg's file) and shift this
        tracer's clock so every new event lands ``gap_us`` after the
        last preloaded one — one file, one monotone timeline across
        process deaths."""
        if not self.enabled or not events:
            return
        self._events = list(events) + self._events
        last = max((float(e.get("ts", 0.0)) + float(e.get("dur", 0.0))
                    for e in events), default=0.0)
        self._ts_offset = last + gap_us
        # Unmatched preloaded "b" spans count as OPEN here, so the
        # caller (ServeTracer resume) can close them with async_end.
        for ev in unbalanced_async(events):
            if ev.get("ph") == "b":
                key = self._async_key(ev.get("name"), ev.get("id"),
                                      ev.get("cat"))
                self._open_b[key] = self._open_b.get(key, 0) + 1

    def _tid(self) -> int:
        return threading.get_ident() & 0xFFFF

    def _add(self, event: Dict[str, Any], force: bool = False) -> None:
        if (len(self._events) - self._preamble >= self.max_events
                and not force):
            self.dropped += 1
            return
        self._events.append(event)
        if self._clock() - self._last_flush >= _FLUSH_INTERVAL_S:
            self.flush()

    def _async_key(self, name: str, id: Any, cat: str) -> tuple:
        return (cat, name, str(id))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host",
             **args: Any) -> Iterator[None]:
        """Complete ("X") event wrapping the with-block."""
        if not self.enabled:
            yield
            return
        start = self._ts()
        try:
            yield
        finally:
            ev: Dict[str, Any] = {
                "ph": "X", "name": name, "cat": cat, "pid": self.pid,
                "tid": self._tid(), "ts": round(start, 3),
                "dur": round(self._ts() - start, 3)}
            if args:
                ev["args"] = args
            self._add(ev)

    def async_begin(self, name: str, id: Any, cat: str = "host",
                    **args: Any) -> None:
        """Open an async ("b") span. ``id`` groups related spans onto
        one track (Perfetto renders same-(cat, id) events together);
        close with :meth:`async_end` using the SAME (name, id, cat).
        Unlike :meth:`span`, begin and end may come from different
        stack frames — the serve scheduler opens a request's queue
        span at arrival and closes it at admission, many iterations
        later."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "ph": "b", "name": name, "cat": cat, "pid": self.pid,
            "tid": 0, "id": str(id), "ts": round(self._ts(), 3)}
        if args:
            ev["args"] = args
        key = self._async_key(name, id, cat)
        before = len(self._events)
        self._add(ev)
        tally = (self._open_b if len(self._events) > before
                 else self._dropped_b)
        tally[key] = tally.get(key, 0) + 1

    def async_end(self, name: str, id: Any, cat: str = "host",
                  **args: Any) -> None:
        """Close the async span opened by ``async_begin(name, id,
        cat)``. Balance survives the ``max_events`` cap: an "e" whose
        "b" is in the buffer is recorded even past the cap, one whose
        "b" was dropped is dropped with it."""
        if not self.enabled:
            return
        key = self._async_key(name, id, cat)
        if self._dropped_b.get(key, 0) > 0:
            self._dropped_b[key] -= 1
            if not self._dropped_b[key]:
                del self._dropped_b[key]
            self.dropped += 1
            return
        if self._open_b.get(key, 0) <= 0:
            return          # no matching begin (double-end) — a stray
            #                 "e" would unbalance just like a stray "b"
        self._open_b[key] -= 1
        if not self._open_b[key]:
            del self._open_b[key]
        ev: Dict[str, Any] = {
            "ph": "e", "name": name, "cat": cat, "pid": self.pid,
            "tid": 0, "id": str(id), "ts": round(self._ts(), 3)}
        if args:
            ev["args"] = args
        self._add(ev, force=True)

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "ph": "i", "name": name, "cat": cat, "pid": self.pid,
            "tid": self._tid(), "ts": round(self._ts(), 3), "s": "p"}
        if args:
            ev["args"] = args
        self._add(ev)

    def counter(self, name: str, **values: float) -> None:
        """Counter ("C") track, e.g. ``tracer.counter("mfu", mfu=0.41)``."""
        if not self.enabled:
            return
        self._add({"ph": "C", "name": name, "pid": self.pid, "tid": 0,
                   "ts": round(self._ts(), 3), "args": dict(values)})

    def flush(self) -> None:
        """Write everything recorded so far (tmp+rename, idempotent)."""
        if not self.enabled:
            return
        events = self._events
        if self.dropped:
            events = events + [{
                "ph": "i", "name": f"{self.dropped} events dropped "
                f"(max_events={self.max_events})", "cat": "host",
                "pid": self.pid, "tid": 0,
                "ts": round(self._ts(), 3), "s": "p"}]
        atomic_write_json(self.path, {"traceEvents": events,
                                      "displayTimeUnit": "ms"})
        self._last_flush = self._clock()

    def close(self) -> None:
        self.flush()


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read back a trace file's event list (tests, tooling)."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def unbalanced_async(events: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """The async "b" events with no matching "e" (same cat/name/id,
    counted multiset-style) — the span-balance check of a serve trace,
    which :class:`~..serve_trace.ServeTracer` uses to close a dead leg's
    in-flight spans on journal resume. An "e" without a "b" also
    counts (returned with its own ``ph``) — balance means NEITHER."""
    open_spans: Dict[tuple, List[Dict[str, Any]]] = {}
    stray: List[Dict[str, Any]] = []
    for ev in events:
        key = (ev.get("cat"), ev.get("name"), ev.get("id"))
        if ev.get("ph") == "b":
            open_spans.setdefault(key, []).append(ev)
        elif ev.get("ph") == "e":
            if open_spans.get(key):
                open_spans[key].pop()
            else:
                stray.append(ev)
    for evs in open_spans.values():
        stray.extend(evs)
    return stray

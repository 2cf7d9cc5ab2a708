"""Per-request tracing for the serve path: the port of
``observe/serve_trace.py``.

One serve run -> one Perfetto/Chrome trace file in which **every
request is an async span tree**: ``request`` (arrival -> retire) with
``queue`` (arrival -> admission), ``prefill`` (bucketed prefill +
row insert), and ``decode`` (first token -> last token) children, all
keyed by the request id so Perfetto renders each request on its own
track. Engine work lands as complete ("X") spans on the host thread —
``decode_step`` / ``verify_step`` batched per engine step (NOT per
token: a 10k-token run stays a few thousand events), ``prefill_b{n}``
and ``insert_row`` per admission — and the recovery/policy machinery
drops instant markers (``slot_quarantine``, ``weight_swap``,
``preempt``, ``journal_resume``, ``slo_alert``) exactly where they
happen, so a faulted run's recovery windows line up visually with the
requests they hit. Counter tracks (``slots``, ``queue``,
``tokens_per_s``, ``accept_rate``) give the run's shape at a glance.

Built on :class:`observe.trace.ChromeTracer`'s primitives (async
``b``/``e`` pairs, instants, counters). Open the file at
https://ui.perfetto.dev.

**Resume.** A journal-resumed serve leg (a supervised restart) gets
``resume=True``: the dead leg's events are preloaded from the existing
file, its in-flight requests' unmatched async spans are CLOSED at the
resume instant (annotated ``process_death=True`` — that IS when they
stopped), and the new leg's clock starts after the old timeline, so
one file shows the whole faulted serve including the restart gap.

Every method is a no-op when disabled/unconfigured — the scheduler
and engine call unconditionally, like the training Observatory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, Optional

from tensorflow_distributed_tpu_torch.observe.trace import (
    ChromeTracer, load_trace, unbalanced_async)

_CAT = "serve"


class ServeTracer:
    """Request-tree + engine-span + counter recorder for a serve run."""

    def __init__(self, path: str = "", enabled: bool = True,
                 pid: int = 0, clock=time.perf_counter,
                 resume: bool = False, max_events: int = 200_000,
                 durable: bool = False):
        self.tracer = ChromeTracer(path, pid=pid, enabled=enabled,
                                   process_name="tfd-serve",
                                   clock=clock, max_events=max_events)
        self.enabled = self.tracer.enabled
        # durable=True flushes at every request-lifecycle edge
        # (admission, completion, eviction) instead of only on the 5s
        # cadence: a fleet replica can be SIGKILLed at any moment, and
        # the stitcher needs the moved request's spans ON DISK for the
        # failover to render — fleet runs are short and low-rate, so
        # the extra rewrites are cheap there (don't set it for a
        # 10k-request standalone serve).
        self.durable = bool(durable)
        self._open: Dict[str, set] = {}   # rid -> open child span names
        if self.enabled and resume and os.path.exists(path):
            try:
                prior = load_trace(path)
            except (OSError, ValueError, KeyError):
                prior = []   # unreadable tail from the kill — start fresh
            if prior:
                self.tracer.preload(prior)
                # The dead leg's in-flight spans end at process death;
                # close them HERE so the finished file's spans balance
                # (a serve trace must balance) and Perfetto doesn't
                # stretch them to infinity.
                for ev in unbalanced_async(prior):
                    if ev.get("ph") != "b":
                        continue
                    self.tracer.async_end(ev["name"], ev.get("id"),
                                          cat=ev.get("cat", _CAT),
                                          process_death=True)
                self.instant("journal_resume", prior_events=len(prior))

    # -- request lifecycle (scheduler) ------------------------------------

    def request_queued(self, rid: int, slo: str = "standard",
                       prompt_len: int = 0, tenant: str = "") -> None:
        if not self.enabled:
            return
        args: Dict[str, Any] = {"slo": slo, "prompt_len": prompt_len}
        if tenant:
            args["tenant"] = tenant
        self.tracer.async_begin("request", rid, cat=_CAT, **args)
        self.tracer.async_begin("queue", rid, cat=_CAT)
        self._open[str(rid)] = {"request", "queue"}

    @contextlib.contextmanager
    def prefill(self, rid: int, bucket: int, slot: int
                ) -> Iterator[None]:
        """Admission: closes the queue span, wraps the prefill+insert
        in a ``prefill`` child, opens the ``decode`` span (the first
        token exists when prefill returns)."""
        if not self.enabled:
            yield
            return
        spans = self._open.setdefault(str(rid), {"request"})
        if "queue" in spans:
            self.tracer.async_end("queue", rid, cat=_CAT)
            spans.discard("queue")
        self.tracer.async_begin("prefill", rid, cat=_CAT,
                                bucket=bucket, slot=slot)
        try:
            yield
        finally:
            self.tracer.async_end("prefill", rid, cat=_CAT)
            self.tracer.async_begin("decode", rid, cat=_CAT)
            spans.add("decode")
            if self.durable:
                self.tracer.flush()

    def request_done(self, rid: int, finish: str, tokens: int,
                     ttft_ms: float) -> None:
        if not self.enabled:
            return
        spans = self._open.pop(str(rid), set())
        if "decode" in spans:
            self.tracer.async_end("decode", rid, cat=_CAT)
        self.tracer.async_end("request", rid, cat=_CAT, finish=finish,
                              tokens=tokens,
                              ttft_ms=round(ttft_ms, 3))
        if self.durable:
            self.tracer.flush()

    def request_evicted(self, rid: int, why: str) -> None:
        """Quarantine/preemption: the request leaves its slot and goes
        back to the queue as a continuation — close decode, reopen
        queue (same request id: one track shows serve -> evict ->
        requeue -> serve)."""
        if not self.enabled:
            return
        spans = self._open.setdefault(str(rid), {"request"})
        if "decode" in spans:
            self.tracer.async_end("decode", rid, cat=_CAT, why=why)
            spans.discard("decode")
        if "queue" not in spans:
            self.tracer.async_begin("queue", rid, cat=_CAT, why=why)
            spans.add("queue")
        if self.durable:
            self.tracer.flush()

    # -- engine + recovery ------------------------------------------------

    def engine_span(self, name: str, **args: Any):
        """Complete ("X") span for one engine dispatch (decode_step /
        verify_step / prefill_b{n} / insert_row) — decode ticks are
        batched per ENGINE STEP, one span covering every live slot."""
        if not self.enabled:
            return contextlib.nullcontext()
        return self.tracer.span(name, cat="serve_engine", **args)

    def instant(self, name: str, cat: str = "recovery",
                **args: Any) -> None:
        self.tracer.instant(name, cat=cat, **args)
        if cat == "recovery":
            # Recovery markers are rare and precious: a leg that dies
            # young (SIGKILL well inside the ChromeTracer's 5s flush
            # cadence) must still leave its quarantine/swap instants
            # on disk for the resumed leg to preload — the whole
            # point of the one-file-spans-the-restart story.
            self.tracer.flush()

    def counters(self, **values: float) -> None:
        """One counter sample per track name (slots / queue /
        tokens_per_s / accept_rate)."""
        if not self.enabled:
            return
        for name, value in values.items():
            self.tracer.counter(name, **{name: value})

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Close any spans still open (a crashed run's flush already
        wrote them; a clean close balances the file) and write."""
        if self.enabled:
            for rid, spans in list(self._open.items()):
                for name in ("decode", "queue"):
                    if name in spans:
                        self.tracer.async_end(name, rid, cat=_CAT)
                self.tracer.async_end("request", rid, cat=_CAT,
                                      finish="open_at_close")
            self._open.clear()
        self.tracer.close()

    def flush(self) -> None:
        self.tracer.flush()


def null_serve_tracer() -> ServeTracer:
    """A disabled tracer (no path) — call sites skip None checks."""
    return ServeTracer("", enabled=False)

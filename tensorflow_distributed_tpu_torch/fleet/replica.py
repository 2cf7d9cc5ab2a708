"""The per-replica contract: inbox feed, workspace layout, handle (the
port of ``fleet/replica.py``).

A fleet replica is an ordinary ``--mode serve`` process with four
extra wires, all plain files under its per-epoch workspace directory:

- ``inbox.jsonl`` — append-only request/command intake the replica's
  scheduler TAILS between decode steps (``--serve.inbox``). One JSON
  object per line: either a request (``{"rid": 7, "prompt": [ids...],
  "max_new": 32, "eos": 5, "slo": "high", "tenant": "t0"}``) or a
  control command (``{"cmd": "swap" | "drain" | "cancel" |
  "hold_export", ...}``). The router/controller are the single
  writer; the replica is the single reader.
- ``journal.jsonl`` — the request journal (``--serve.journal``):
  the router tails it to learn tokens and completions, and replays it
  after a replica death to build continuations. It doubles as the
  fleet's data plane — no sockets, crash-durable by construction.
- ``snapshot.json`` — the atomic ``--observe.export-path`` rolling
  snapshot (occupancy, queue depth, per-class TTFT p95, anomaly
  state, plus the liveness triplet ``seq``/``wall_ts``/``pid``): the
  router's health feed.
- ``metrics.jsonl`` — the replica's own observe stream.

Each restart gets a FRESH epoch directory (``e0``, ``e1``, ...): a
dead replica's in-flight work is re-dispatched to its peers from the
old epoch's journal, so the restarted process must start empty — an
epoch rollover is what makes "re-dispatch elsewhere" and "restart"
compose without double-serving.

Everything here is stdlib + numpy (the scheduler's Request type is
imported lazily).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from tensorflow_distributed_tpu_torch.utils.atomicio import durable_append

#: Control commands a replica's scheduler understands (see
#: serve/scheduler.py): ``swap`` = live weight swap from the newest
#: verifiable checkpoint; ``drain`` = finish in-flight work, accept
#: nothing new, exit cleanly; ``cancel`` = drop one request (the
#: router re-dispatched it elsewhere); ``hold_export`` = freeze
#: snapshot exports for ``secs`` (the stale-snapshot drill).
COMMANDS = ("swap", "drain", "cancel", "hold_export")


def append_line(path: str, obj: Dict[str, Any]) -> None:
    """Append one JSON line, flushed to the OS — the inbox write side
    (single writer per file; the reader tolerates a torn tail).
    Delegates to the blessed :func:`durable_append` so every
    cross-process append in the repo shares one spelling."""
    durable_append(path, obj)


class InboxFeed:
    """Replica-side tail of the inbox file (the scheduler's ``feed``).

    ``poll()`` returns the items appended since the last call, IN
    FILE ORDER (scheduler Request objects interleaved with command
    dicts — order is semantic: "dispatch, cancel, re-dispatch" must
    not be reordered into double service). Only COMPLETE lines are
    consumed (a line still being written is left for the next poll),
    and polls are throttled to ``poll_s`` so a fast decode loop does
    not stat the file every step. Unknown SLO classes coerce to
    "standard"; a request without a ``rid`` is a router bug and
    raises."""

    def __init__(self, path: str, default_max_new: int = 64,
                 default_eos: int = -1, poll_s: float = 0.02,
                 clock=time.perf_counter):
        self.path = path
        self.default_max_new = int(default_max_new)
        self.default_eos = int(default_eos)
        self.poll_s = float(poll_s)
        self.clock = clock
        self._offset = 0
        self._last_poll = -1e9
        # Inbox-poll lag: the router stamps each request line with its
        # wall-clock enqueue time (enq_ts); intake-minus-stamp is the
        # dispatch-file-write -> feed-intake latency — the replica-
        # side anchor of the fleet latency decomposition, and an early
        # warning for a wedged feed. Bounded recent-window deque.
        import collections
        self._lag_ms: collections.deque = collections.deque(maxlen=256)

    def _to_request(self, obj: Dict[str, Any]):
        import numpy as np

        from tensorflow_distributed_tpu_torch.serve.scheduler import (
            Request, SLO_CLASSES)

        if "rid" not in obj:
            raise ValueError(
                f"inbox {self.path}: request line has no rid "
                f"({obj}) — the router assigns fleet-global rids")
        prompt = np.asarray([int(t) for t in obj["prompt"]], np.int32)
        if prompt.size == 0:
            raise ValueError(
                f"inbox {self.path}: rid {obj['rid']} has an empty "
                f"prompt")
        slo = str(obj.get("slo", "standard"))
        if slo not in SLO_CLASSES:
            slo = "standard"
        return Request(
            rid=int(obj["rid"]), prompt=prompt,
            max_new_tokens=int(obj.get("max_new",
                                       self.default_max_new)),
            eos_id=int(obj.get("eos", self.default_eos)),
            arrival_s=0.0, slo=slo,
            tenant=str(obj.get("tenant", "")),
            session=str(obj.get("session", "")))

    def poll(self) -> List[Any]:
        now = self.clock()
        if now - self._last_poll < self.poll_s:
            return []
        self._last_poll = now
        try:
            with open(self.path) as f:
                f.seek(self._offset)
                chunk = f.read()
        except FileNotFoundError:
            return []
        items: List[Any] = []
        for raw in chunk.splitlines(keepends=True):
            if not raw.endswith("\n"):
                break  # torn tail: the writer is mid-append
            # Consume BEFORE parsing: a malformed line raises once
            # (loudly — it is a router bug), never wedges the feed.
            self._offset += len(raw)
            line = raw.strip()
            if not line:
                continue
            obj = json.loads(line)
            if "cmd" in obj:
                if obj["cmd"] not in COMMANDS:
                    raise ValueError(
                        f"inbox {self.path}: unknown command "
                        f"{obj['cmd']!r}; have {COMMANDS}")
                items.append(obj)
            else:
                if "enq_ts" in obj:
                    lag_ms = (time.time() - float(obj["enq_ts"])) * 1e3
                    self._lag_ms.append(max(0.0, lag_ms))
                items.append(self._to_request(obj))
        return items

    def lag_stats(self) -> Dict[str, float]:
        """Recent inbox-poll lag (ms): mean + nearest-rank p95 over
        the last requests taken in. Empty dict before any stamped
        intake (pre-PR routers send no enq_ts)."""
        if not self._lag_ms:
            return {}
        from tensorflow_distributed_tpu_torch.observe.slo import percentile
        vals = sorted(self._lag_ms)
        return {
            "inbox_poll_lag_ms": round(sum(vals) / len(vals), 3),
            "inbox_poll_lag_ms_p95": round(percentile(vals, 95), 3),
        }


class ReplicaHandle:
    """The router/controller's view of one replica: its per-epoch
    workspace paths, the inbox write side, and tolerant readers for
    the snapshot and journal. Holds NO process — the controller owns
    the subprocess; fake replicas in tests implement this same
    surface (``name``/``epoch``/``send``/``read_snapshot``/
    ``read_journal``)."""

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root
        self.epoch = 0
        # Incremental journal tail state for the CURRENT epoch: byte
        # offset + accumulated replay dict, so the router's ~20/s
        # polls parse only NEW lines instead of re-reading the whole
        # (ever-growing) file each step.
        self._tail_epoch = -1
        self._tail_off = 0
        self._tail_acc: Dict[int, Dict[str, Any]] = {}

    def epoch_dir(self, epoch: Optional[int] = None) -> str:
        return os.path.join(self.root,
                            f"e{self.epoch if epoch is None else epoch}")

    @property
    def inbox(self) -> str:
        return os.path.join(self.epoch_dir(), "inbox.jsonl")

    @property
    def journal(self) -> str:
        return os.path.join(self.epoch_dir(), "journal.jsonl")

    @property
    def snapshot(self) -> str:
        return os.path.join(self.epoch_dir(), "snapshot.json")

    @property
    def metrics(self) -> str:
        return os.path.join(self.epoch_dir(), "metrics.jsonl")

    def begin_epoch(self, epoch: int) -> None:
        """Advance to a fresh epoch directory (controller restart
        path): new inbox, journal, snapshot — the restarted process
        starts empty while the old epoch's journal stays on disk for
        the router's continuation replay."""
        self.epoch = int(epoch)
        os.makedirs(self.epoch_dir(), exist_ok=True)

    def send(self, obj: Dict[str, Any]) -> None:
        append_line(self.inbox, obj)

    def read_snapshot(self) -> Optional[Dict[str, Any]]:
        """The current epoch's snapshot, or None (absent, torn, or
        not yet written — the atomic tmp+rename write side makes torn
        reads rare, but a poller must never crash on one)."""
        try:
            with open(self.snapshot) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def read_journal(self, epoch: Optional[int] = None
                     ) -> Dict[int, Dict[str, Any]]:
        """Replay the (current or a named) epoch's journal. For the
        CURRENT epoch the read is INCREMENTAL — only bytes past the
        last poll are parsed (complete lines only; a torn tail waits
        for the next poll), folded into a cached accumulator with the
        same serve.journal.replay semantics — so the router's
        per-step polls stay O(new tokens), not O(whole file). Treat
        the returned dict as read-only (it IS the cache). A named
        epoch always does a full tolerant replay."""
        from tensorflow_distributed_tpu_torch.serve import journal
        if epoch is not None:
            return journal.replay(
                os.path.join(self.epoch_dir(epoch), "journal.jsonl"))
        if self._tail_epoch != self.epoch:
            self._tail_epoch = self.epoch
            self._tail_off = 0
            self._tail_acc = {}
        try:
            with open(self.journal) as f:
                f.seek(self._tail_off)
                chunk = f.read()
        except OSError:
            return self._tail_acc
        for raw in chunk.splitlines(keepends=True):
            if not raw.endswith("\n"):
                break
            self._tail_off += len(raw)
            line = raw.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # a kill's mid-write tail, already complete
            journal.fold_record(self._tail_acc, rec)
        return self._tail_acc

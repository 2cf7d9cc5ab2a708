"""Request journal, the port of ``serve/journal.py``: serving progress
that survives a kill, at token granularity, in the JAX package's line
format (a journal written by either package replays in the other).

The scheduler appends three record kinds as it works: ``admit`` (the
whole request: id, prompt, budget, EOS), ``tok`` (one retired token of
one request) and ``done`` (the request finished), flushed to the OS once
per scheduler iteration, so a SIGKILLed serving process leaves a journal
complete up to its last decode step. A fourth kind, ``reject`` (a
request a fleet replica cannot serve), tells the fleet router to shed
it. A restarted
leg (the same ``--mode serve`` command) replays the journal and
re-admits every unfinished request as a CONTINUATION: its prompt
extended by the tokens already journaled, its budget cut by as many.
Greedy decoding is deterministic, so the continuation produces the
tokens the dead leg would have, and a kill costs re-decoding the tokens
past the last flush, never a request.

An existing non-empty file means RESUME (replay, then append): the
restart command re-admits instead of starting over. A fresh run wants a
fresh path. A truncated last line (the kill can land mid-write) is
skipped.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List

import numpy as np


class RequestJournal:
    """The append side. Opens on the first append; ``flush()`` pushes the
    buffered lines to the OS (enough for a process kill; an fsync would
    only add OS-crash cover, which serving does not promise)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def _line(self, rec: Dict[str, Any]) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps(rec) + "\n")

    def admit(self, rid: int, prompt, max_new_tokens: int,
              eos_id: int, slo: str = "standard",
              tenant: str = "", session: str = "") -> None:
        """``slo``, ``tenant`` and ``session`` make the journal
        self-describing (a resumed leg re-derives its requests from the
        run's seed; a journal read on its own keeps them)."""
        rec = {"e": "admit", "rid": int(rid),
               "prompt": [int(t) for t in np.asarray(prompt)],
               "max_new": int(max_new_tokens),
               "eos": int(eos_id)}
        if slo != "standard":
            rec["slo"] = slo
        if tenant:
            rec["tenant"] = tenant
        if session:
            rec["sess"] = session
        self._line(rec)

    def token(self, rid: int, tok: int, t_s: float) -> None:
        """One retired token (``t_s``: seconds since the run started, so
        that a killed leg's serving time can be rebuilt from its last
        journaled token)."""
        self._line({"e": "tok", "rid": int(rid), "t": int(tok),
                    "s": round(t_s, 4)})

    def done(self, rid: int) -> None:
        self._line({"e": "done", "rid": int(rid)})

    def reject(self, rid: int) -> None:
        """The request cannot be served here (it does not fit the cache,
        or it arrived while draining): a fleet router reading the journal
        sheds it instead of waiting for it. A replica never crashes over a
        bad dispatch."""
        self._line({"e": "reject", "rid": int(rid)})

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def fold_record(out: Dict[int, Dict[str, Any]],
                rec: Dict[str, Any]) -> None:
    """Fold one parsed journal record into a replay accumulator: the one
    definition of the journal's semantics, shared by :func:`replay` and
    the fleet router's incremental tail
    (``fleet.replica.ReplicaHandle.read_journal``)."""
    rid = rec.get("rid")
    if rid is None:
        return
    ent = out.setdefault(int(rid), {"req": None, "tokens": [],
                                    "done": False,
                                    "reject": False,
                                    "last_s": 0.0})
    kind = rec.get("e")
    if kind == "admit":
        ent["req"] = {"prompt": rec.get("prompt", []),
                      "max_new": rec.get("max_new", 0),
                      "eos": rec.get("eos", -1)}
    elif kind == "tok":
        ent["tokens"].append(int(rec["t"]))
        ent["last_s"] = max(ent["last_s"],
                            float(rec.get("s", 0.0)))
    elif kind == "done":
        ent["done"] = True
    elif kind == "reject":
        ent["reject"] = True


def replay(path: str) -> Dict[int, Dict[str, Any]]:
    """Read a journal back into ``{rid: {"req": {...} | None, "tokens":
    [...], "done": bool, "reject": bool, "last_s": float}}``. A missing
    file is an empty dict (a fresh run); malformed lines (the truncated
    tail of a kill) are skipped."""
    out: Dict[int, Dict[str, Any]] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # the kill's mid-write tail
            fold_record(out, rec)
    return out


def apply_replay(requests: List[Any],
                 journal: Dict[int, Dict[str, Any]]) -> List[Any]:
    """Fold a replayed journal into a fresh workload (the restarted leg
    draws its requests again from the same seed and trace, and this
    narrows them to the unfinished work):

    - ``done`` requests drop (already served and streamed);
    - partly served requests become CONTINUATIONS: the prompt extended by
      the journaled tokens, the budget cut by as many, arrival 0 (they
      were in flight), tagged with ``_base_tokens`` so that the
      completion reports the whole token list;
    - untouched requests keep their arrival offsets SHIFTED back by the
      dead leg's serving time (open-loop clients kept sending while the
      process was down: a request whose arrival passed is due at once).

    A pure function over Request-shaped dataclasses."""
    out: List[Any] = []
    elapsed = max((e["last_s"] for e in journal.values()),
                  default=0.0)
    for req in requests:
        ent = journal.get(req.rid)
        if ent is None:
            out.append(dataclasses.replace(
                req, arrival_s=max(0.0, req.arrival_s - elapsed)))
            continue
        if ent["done"]:
            continue
        toks = list(ent["tokens"])
        if not toks:
            # Admitted but no token journaled (killed inside its first
            # prefill): serve it from scratch, due at once.
            out.append(dataclasses.replace(req, arrival_s=0.0))
            continue
        if len(toks) >= req.max_new_tokens or (
                req.eos_id >= 0 and toks[-1] == req.eos_id):
            # Every budgeted token (or the EOS) was journaled but the
            # done record did not land: the request is finished.
            continue
        cont = dataclasses.replace(
            req,
            prompt=np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(toks, np.int32)]),
            max_new_tokens=req.max_new_tokens - len(toks),
            arrival_s=0.0)
        cont._base_tokens = toks
        out.append(cont)
    return out

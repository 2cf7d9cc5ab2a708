"""Health-aware replica router: SLO-class dispatch over a fleet (the
port of ``fleet/router.py``).

The router owns the fleet-level request lifecycle. Each request is
dispatched to exactly one replica at a time (an inbox append); the
replica's journal is the acknowledgement channel — tokens and
completions are read back from it, so the data plane is crash-durable
by construction and a replica death loses nothing the journal already
holds.

Health is driven entirely by each replica's ``--observe.export-path``
snapshot:

- **liveness**: the snapshot's monotonic ``seq`` must keep advancing;
  a snapshot frozen (or missing) for ``stale_s`` marks the replica
  STALE — indistinguishable from a wedged process, so it is
  quarantined (the ``seq``/``wall_ts``/``pid`` triplet exists exactly
  so a frozen file is distinguishable from a healthy idle replica,
  which keeps exporting).
- **anomaly**: an active detector from ``quarantine_detectors`` in
  the snapshot's live anomaly state (observe/anomaly.py) quarantines
  the replica. The default set is the critical containment signal
  (``slot_nonfinite``); latency-spike detectors are deliberately NOT
  in it — router-induced re-queueing shows up as TTFT spikes, and
  quarantining on them would self-amplify.

A quarantined replica takes no new admissions and its in-flight
requests are re-dispatched to peers as journal-style CONTINUATIONS
(prompt + tokens journaled so far, remaining budget, so greedy
determinism keeps the final stream token-identical); a ``cancel``
command tells the still-running replica to drop the moved work. When
its snapshot freshens and the anomaly clears, it REJOINS — quarantine
is never permanent capacity loss. Death (the controller's liveness
signal) takes the same evacuation path, minus the cancel.

Every dispatch carries a timeout: no token within
``dispatch_timeout_s`` re-dispatches with capped exponential backoff;
``retry_budget`` exhaustion sheds the request (loudly — shed, never
hang). When every healthy replica is saturated (load >=
``queue_high``), requests that have waited past ``shed_wait_s`` are
shed lowest-class-first, at most one per step — graceful degradation
with a pinned shedding order.

Pure host policy (stdlib, numpy-free), driven by ``step(now)`` from
an external loop with an injectable clock, so every scenario runs on
fake replicas (tests/test_torch_fleet.py holds it to the JAX router).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: Class rank, best first: serve.scheduler.SLO_CLASSES (a plain tuple
#: here so that this module stays import-light).
SLO_CLASSES = ("high", "standard", "batch")
_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}


@dataclasses.dataclass
class RouterConfig:
    """Dispatch/health policy knobs (seconds are router-clock)."""

    stale_s: float = 2.0            # frozen-snapshot quarantine bar
    dispatch_timeout_s: float = 20.0  # dispatch -> first token bound
    retry_budget: int = 3           # re-dispatches before shedding
    backoff_base_s: float = 0.25    # retry backoff (capped exp)
    backoff_max_s: float = 2.0
    queue_high: int = 8             # per-replica load = saturated
    shed_wait_s: float = 10.0       # waited past this + saturated -> shed
    quarantine_detectors: Tuple[str, ...] = ("slot_nonfinite",)
    redispatch_on_quarantine: bool = True
    # Anomaly-quarantine decay: the hub's active-anomaly horizon runs
    # on the replica's DECODE-step clock, which freezes once the
    # router stops sending it work — so an idle quarantined replica
    # could never clear. After this cooldown, a fresh snapshot whose
    # anomaly COUNT has not grown since the quarantine rejoins (a
    # replica still firing new anomalies stays out).
    anomaly_cooldown_s: float = 5.0

    def validate(self) -> None:
        if self.stale_s <= 0 or self.dispatch_timeout_s <= 0:
            raise ValueError(
                "router stale_s and dispatch_timeout_s must be > 0")
        if self.retry_budget < 0:
            raise ValueError(
                f"router retry_budget must be >= 0, "
                f"got {self.retry_budget}")
        if self.queue_high < 1:
            raise ValueError(
                f"router queue_high must be >= 1, got {self.queue_high}")


@dataclasses.dataclass
class _Track:
    """One request's fleet-level lifecycle."""

    rid: int
    prompt: List[int]
    max_new: int
    eos: int
    arrival_s: float              # offset from router start
    slo: str = "standard"
    tenant: str = ""
    session: str = ""             # multi-turn conversation id
    state: str = "pending"        # pending|waiting|dispatched|done|shed
    owner: Optional[Tuple[str, int]] = None   # (replica, epoch)
    base: List[int] = dataclasses.field(default_factory=list)
    cur: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0              # re-dispatches survived
    dispatches: int = 0
    dispatch_t: float = 0.0
    next_t: float = 0.0           # backoff: earliest next dispatch
    first_tok_t: Optional[float] = None
    progress_t: float = 0.0       # last time a new token was observed
    done_t: Optional[float] = None
    redispatched: bool = False
    shed_reason: str = ""
    avoid: str = ""               # replica the last attempt failed on
    # The journal identity of the CURRENT dispatch: rid * 1024 +
    # dispatch number. Each dispatch gets its OWN journal entry, so a
    # re-dispatch that lands back on a replica whose journal already
    # holds an earlier generation of this request can never fold the
    # two token streams together (that double-count corrupted the
    # assembled stream — found in review, pinned in tests).
    gen_rid: int = -1

    def next_gen(self) -> int:
        self.dispatches += 1
        self.gen_rid = self.rid * 1024 + self.dispatches
        return self.gen_rid

    @property
    def tokens(self) -> List[int]:
        return self.base + self.cur

    def finished(self) -> bool:
        toks = self.tokens
        return bool(toks) and (
            len(toks) >= self.max_new
            or (self.eos >= 0 and toks[-1] == self.eos))


class _Rep:
    """Router-side state for one replica."""

    def __init__(self, handle: Any):
        self.handle = handle
        self.health = "starting"   # starting|up|quarantined|dead
        self.last_seq: Optional[int] = None
        self.seq_t = 0.0           # when seq last advanced
        self.snap: Dict[str, Any] = {}
        self.sent_since_seq = 0    # dispatches the snapshot can't see yet
        self.inflight: set = set()
        self.reason = ""
        self.epoch_seen = handle.epoch
        self.done_count = 0
        self.q_t = 0.0             # when the quarantine began
        self.q_count = 0           # anomaly count at quarantine time


class Router:
    """Drive with ``begin(t0)`` then ``step(now)`` until ``active()``
    is False. ``emit`` receives ``fleet_dispatch`` / ``fleet_shed`` /
    ``fleet_replica`` records (observe.registry.emit-shaped)."""

    def __init__(self, replicas: Sequence[Any],
                 cfg: Optional[RouterConfig] = None,
                 emit: Optional[Callable[..., Any]] = None,
                 slo_monitor: Any = None):
        self.cfg = cfg or RouterConfig()
        self.cfg.validate()
        self.reps: Dict[str, _Rep] = {
            h.name: _Rep(h) for h in replicas}
        if len(self.reps) != len(replicas):
            raise ValueError("replica names must be unique")
        self.tracks: Dict[int, _Track] = {}
        self._arrivals: List[int] = []   # rids not yet due, by arrival
        self._waiting: List[int] = []    # due, undispatched
        self._t0: Optional[float] = None
        self._emit_fn = emit
        # Fleet observability: a fleet-level SLOMonitor scoring
        # CLIENT-PERCEIVED latency (admission -> first token across
        # retries/failovers) on the router's step clock; optional. (The
        # router's spans for the fleet trace are not ported yet:
        # ROADMAP.md A8.)
        self.slo_monitor = slo_monitor
        self._steps = 0
        self.events: List[Tuple[float, str, str]] = []  # (t, kind, rep)
        # Session stickiness: a conversation's turns land on the SAME
        # replica while it stays healthy, so the paged engine's
        # session re-attach (and the scheduler's turn ordering) keep
        # working fleet-side; a failover re-pins to the new owner
        # (turns recompute — correct, just cold).
        self._session_owner: Dict[str, str] = {}
        self.quarantines = 0
        self.rejoins = 0
        self.deaths = 0

    # -- bookkeeping -------------------------------------------------------

    def _emit(self, event: str, **fields) -> None:
        if self._emit_fn is not None:
            self._emit_fn(event, **fields)

    def _now_s(self, now: float) -> float:
        return now - (self._t0 or 0.0)

    def submit(self, requests: Sequence[Dict[str, Any]]) -> None:
        """Register the workload (dicts: rid, prompt, max_new, eos,
        arrival_s, slo, tenant). Call before ``begin``; arrivals are
        offsets from the ``begin`` clock."""
        for r in requests:
            rid = int(r["rid"])
            if rid in self.tracks:
                raise ValueError(f"duplicate rid {rid}")
            self.tracks[rid] = _Track(
                rid=rid, prompt=[int(t) for t in r["prompt"]],
                max_new=int(r.get("max_new", 64)),
                eos=int(r.get("eos", -1)),
                arrival_s=float(r.get("arrival_s", 0.0)),
                slo=str(r.get("slo", "standard")),
                tenant=str(r.get("tenant", "")),
                session=str(r.get("session", "")))
        self._arrivals = sorted(
            (rid for rid in self.tracks
             if self.tracks[rid].state == "pending"),
            key=lambda rid: (self.tracks[rid].arrival_s, rid))

    def begin(self, t0: float) -> None:
        self._t0 = t0

    def active(self) -> bool:
        return any(t.state in ("pending", "waiting", "dispatched")
                   for t in self.tracks.values())

    # -- health ------------------------------------------------------------

    def mark_dead(self, name: str, now: float) -> None:
        """Controller liveness signal: the process is gone. Evacuate
        its in-flight work from the (surviving) journal file."""
        rep = self.reps[name]
        if rep.health == "dead":
            return
        rep.health = "dead"
        rep.reason = "process_exit"
        self.deaths += 1
        self.events.append((now, "death", name))
        self._emit("fleet_replica", replica=name, state="dead",
                   reason=rep.reason, t_s=round(self._now_s(now), 4))
        self._evacuate(rep, now, cancel=False)

    def mark_restarted(self, name: str, now: float) -> None:
        """Controller respawned the replica on a fresh epoch: back to
        ``starting`` — dispatchable again once its snapshot is live."""
        rep = self.reps[name]
        rep.health = "starting"
        rep.reason = ""
        rep.last_seq = None
        rep.snap = {}
        rep.sent_since_seq = 0
        rep.epoch_seen = rep.handle.epoch
        self._emit("fleet_replica", replica=name, state="restarted",
                   epoch=rep.handle.epoch,
                   t_s=round(self._now_s(now), 4))

    def _quarantine(self, rep: _Rep, now: float, reason: str) -> None:
        rep.health = "quarantined"
        rep.reason = reason
        rep.q_t = now
        rep.q_count = int(
            (rep.snap.get("anomaly") or {}).get("anomalies", 0))
        self.quarantines += 1
        self.events.append((now, "quarantine", rep.handle.name))
        self._emit("fleet_replica", replica=rep.handle.name,
                   state="quarantined", reason=reason,
                   inflight=len(rep.inflight),
                   t_s=round(self._now_s(now), 4))
        if self.cfg.redispatch_on_quarantine:
            self._evacuate(rep, now, cancel=True)

    def _rejoin(self, rep: _Rep, now: float) -> None:
        rep.health = "up"
        rep.reason = ""
        self.rejoins += 1
        self._emit("fleet_replica", replica=rep.handle.name,
                   state="rejoined", t_s=round(self._now_s(now), 4))

    def _bad_anomaly(self, snap: Dict[str, Any]) -> str:
        active = (snap.get("anomaly") or {}).get("active") or []
        hits = sorted(set(active) & set(self.cfg.quarantine_detectors))
        return hits[0] if hits else ""

    def _poll_health(self, now: float) -> None:
        for rep in self.reps.values():
            if rep.health == "dead":
                continue
            if rep.handle.epoch != rep.epoch_seen:
                # Controller rotated the epoch under us (restart path
                # that skipped mark_restarted) — resync.
                self.mark_restarted(rep.handle.name, now)
            snap = rep.handle.read_snapshot()
            if snap is not None and snap.get("seq") != rep.last_seq:
                rep.last_seq = snap.get("seq")
                rep.seq_t = now
                rep.snap = snap
                rep.sent_since_seq = 0
            fresh = (rep.last_seq is not None
                     and now - rep.seq_t <= self.cfg.stale_s)
            if rep.health == "starting":
                if fresh:
                    rep.health = "up"
                    self._emit("fleet_replica",
                               replica=rep.handle.name, state="up",
                               epoch=rep.handle.epoch,
                               t_s=round(self._now_s(now), 4))
                continue
            bad = self._bad_anomaly(rep.snap) if fresh else ""
            count = int((rep.snap.get("anomaly") or {})
                        .get("anomalies", 0))
            if rep.health == "up":
                if not fresh:
                    self._quarantine(rep, now, "stale_snapshot")
                elif bad and count > rep.q_count:
                    # Strictly NEW anomalies since the last
                    # quarantine: a cooldown rejoin must not bounce
                    # straight back on the same stale active entry
                    # (the idle-clock problem the cooldown exists
                    # for) — only fresh firings re-quarantine.
                    self._quarantine(rep, now, f"anomaly:{bad}")
            elif rep.health == "quarantined" and fresh:
                cleared = not bad
                if bad and rep.reason.startswith("anomaly"):
                    # Cooldown decay (see RouterConfig): an idle
                    # replica's step clock is frozen, so the hub's
                    # active horizon alone cannot clear it.
                    count = int((rep.snap.get("anomaly") or {})
                                .get("anomalies", 0))
                    cleared = (now - rep.q_t
                               > self.cfg.anomaly_cooldown_s
                               and count <= rep.q_count)
                if cleared:
                    self._rejoin(rep, now)

    # -- journal absorption ------------------------------------------------

    def _absorb(self, rep: _Rep, now: float,
                journal: Optional[Dict[int, Dict[str, Any]]] = None
                ) -> None:
        if not rep.inflight:
            return
        jr = rep.handle.read_journal() if journal is None else journal
        for rid in sorted(rep.inflight):
            tr = self.tracks[rid]
            ent = jr.get(tr.gen_rid)
            if ent is None:
                continue
            if ent.get("reject"):
                rep.inflight.discard(rid)
                self._shed(tr, now, "rejected")
                continue
            toks = ent.get("tokens", [])
            if len(toks) > len(tr.cur):
                tr.cur = [int(t) for t in toks]
                tr.progress_t = now
                if tr.first_tok_t is None:
                    tr.first_tok_t = now
            if ent.get("done") or tr.finished():
                rep.inflight.discard(rid)
                rep.done_count += 1
                self._finish(tr, now)

    def _finish(self, tr: _Track, now: float) -> None:
        tr.state = "done"
        tr.done_t = now
        if tr.first_tok_t is None:   # completed within one poll
            tr.first_tok_t = now
        # Client-perceived latency, router clock: admission (arrival)
        # -> first token / completion, every retry and failover
        # included — the number no per-replica view can compute. One
        # fleet_request record per completion is the durable form;
        # summary(), the fleet snapshot, and observe/report.py all
        # derive per-class percentiles from this SAME population with
        # the shared nearest-rank percentile (snapshot == report).
        arr = (self._t0 or 0.0) + tr.arrival_s
        ttft_ms = 1e3 * (tr.first_tok_t - arr)
        e2e_ms = 1e3 * (now - arr)
        n_tok = len(tr.tokens)
        tok_ms = (1e3 * (now - tr.first_tok_t) / max(1, n_tok - 1))
        self._emit("fleet_request", rid=tr.rid, slo=tr.slo,
                   tenant=tr.tenant, ttft_ms=round(ttft_ms, 3),
                   e2e_ms=round(e2e_ms, 3), tok_ms=round(tok_ms, 4),
                   tokens=n_tok, retries=tr.retries,
                   redispatched=tr.redispatched,
                   t_s=round(self._now_s(now), 4))
        if self.slo_monitor is not None:
            self.slo_monitor.observe(tr.slo, ttft_ms, tok_ms,
                                     self._steps)

    def _shed(self, tr: _Track, now: float, reason: str) -> None:
        tr.state = "shed"
        tr.shed_reason = reason
        tr.done_t = now
        if tr.rid in self._waiting:
            self._waiting.remove(tr.rid)
        self._emit("fleet_shed", rid=tr.rid, slo=tr.slo,
                   reason=reason, retries=tr.retries,
                   t_s=round(self._now_s(now), 4))

    # -- evacuation / retry ------------------------------------------------

    def _evacuate(self, rep: _Rep, now: float, cancel: bool) -> None:
        """Move a dead/quarantined replica's in-flight requests back
        to the waiting queue as continuations: one final journal read
        freezes everything the replica managed to serve, the rest
        re-derives elsewhere (greedy determinism => token-identical)."""
        try:
            jr = rep.handle.read_journal()
        except OSError:
            jr = {}
        self._absorb(rep, now, journal=jr)   # completions first
        for rid in sorted(rep.inflight):
            tr = self.tracks[rid]
            tr.base = tr.base + tr.cur
            tr.cur = []
            tr.owner = None
            tr.avoid = rep.handle.name
            tr.redispatched = True
            tr.retries += 1
            if cancel:
                # Cancel FIRST, shed or not: a still-running replica
                # must stop burning slots on work the fleet has moved
                # (or given up on).
                try:
                    rep.handle.send({"cmd": "cancel",
                                     "rid": tr.gen_rid})
                except OSError:
                    pass  # replica may be unreachable; the restart
                    #       epoch rollover drops the work anyway
            if tr.retries > self.cfg.retry_budget:
                self._shed(tr, now, "retry_budget")
                continue
            tr.state = "waiting"
            tr.next_t = now + min(
                self.cfg.backoff_base_s * 2 ** (tr.retries - 1),
                self.cfg.backoff_max_s)
            self._waiting.append(rid)
        rep.inflight.clear()

    def _timeouts(self, now: float) -> None:
        """A dispatched request with no (new) token for
        ``dispatch_timeout_s`` re-dispatches — its replica may be
        healthy but wedged on exactly this request, which per-replica
        health cannot see."""
        for rep in self.reps.values():
            for rid in sorted(rep.inflight):
                tr = self.tracks[rid]
                if now - max(tr.dispatch_t, tr.progress_t) \
                        <= self.cfg.dispatch_timeout_s:
                    continue
                tr.base = tr.base + tr.cur
                tr.cur = []
                tr.owner = None
                tr.avoid = rep.handle.name
                tr.redispatched = True
                tr.retries += 1
                rep.inflight.discard(rid)
                self.events.append((now, "timeout", rep.handle.name))
                try:
                    # Cancel even when the retry budget is done: the
                    # replica must not keep decoding shed work.
                    rep.handle.send({"cmd": "cancel",
                                     "rid": tr.gen_rid})
                except OSError:
                    pass
                if tr.retries > self.cfg.retry_budget:
                    self._shed(tr, now, "retry_budget")
                    continue
                tr.state = "waiting"
                tr.next_t = now + min(
                    self.cfg.backoff_base_s * 2 ** (tr.retries - 1),
                    self.cfg.backoff_max_s)
                self._waiting.append(rid)

    # -- dispatch ----------------------------------------------------------

    def _load(self, rep: _Rep) -> int:
        snap = rep.snap
        return (int(snap.get("queue_depth", 0))
                + int(snap.get("requests_live", 0))
                + rep.sent_since_seq)

    def _score(self, rep: _Rep, slo: str) -> Tuple:
        """Least-loaded wins; ties break on the replica's recent
        per-class TTFT p95 (the SLO-aware part: a replica that has
        been slow for THIS class ranks behind an equally-loaded peer),
        then on name for determinism."""
        p95 = rep.snap.get(f"ttft_ms_p95_{slo}")
        return (self._load(rep),
                float(p95) if isinstance(p95, (int, float)) else 0.0,
                rep.handle.name)

    def _candidates(self, tr: _Track) -> List[_Rep]:
        out = []
        for rep in self.reps.values():
            if rep.health != "up":
                continue
            if self._load(rep) >= self.cfg.queue_high:
                continue
            max_len = rep.snap.get("max_len")
            if (isinstance(max_len, int)
                    and len(tr.prompt) + tr.max_new > max_len):
                continue
            out.append(rep)
        if tr.avoid and len(out) > 1:
            # A retry prefers any OTHER replica over the one it just
            # failed on (which may be wedged on exactly this request
            # while still reporting healthy) — unless it is the only
            # one left.
            out = [r for r in out if r.handle.name != tr.avoid] or out
        return out

    def _payload(self, tr: _Track) -> Dict[str, Any]:
        """The inbox line: a continuation re-sends prompt + everything
        served so far with the remaining budget (serve/scheduler.py's
        continuation contract, fleet-side). The wire rid is the
        DISPATCH GENERATION id (see _Track.gen_rid) — call
        ``next_gen()`` before building the payload."""
        import time as _time
        out = {"rid": tr.gen_rid, "prompt": tr.prompt + tr.base,
               "max_new": tr.max_new - len(tr.base),
               "eos": tr.eos, "slo": tr.slo, "tenant": tr.tenant,
               # Wall-clock enqueue stamp: the replica's InboxFeed
               # measures intake-minus-stamp as inbox_poll_lag_ms —
               # the latency decomposition's replica-side anchor.
               "enq_ts": round(_time.time(), 6)}
        if tr.session:
            out["session"] = tr.session
        return out

    def _dispatch(self, now: float) -> None:
        self._waiting.sort(
            key=lambda rid: (_RANK.get(self.tracks[rid].slo, 1),
                             self.tracks[rid].arrival_s, rid))
        still: List[int] = []
        for rid in self._waiting:
            tr = self.tracks[rid]
            if now < tr.next_t:
                still.append(rid)
                continue
            cands = self._candidates(tr)
            if not cands:
                still.append(rid)
                continue
            if tr.session:
                owner = self._session_owner.get(tr.session)
                sticky = [r for r in cands
                          if r.handle.name == owner]
                if sticky:
                    cands = sticky
            rep = min(cands, key=lambda r: self._score(r, tr.slo))
            if tr.session:
                self._session_owner[tr.session] = rep.handle.name
            tr.next_gen()
            rep.handle.send(self._payload(tr))
            rep.inflight.add(rid)
            rep.sent_since_seq += 1
            tr.owner = (rep.handle.name, rep.handle.epoch)
            tr.state = "dispatched"
            tr.dispatch_t = now
            self._emit("fleet_dispatch", rid=rid,
                       replica=rep.handle.name,
                       kind="redispatch" if tr.retries else "fresh",
                       retry=tr.retries, slo=tr.slo,
                       base_tokens=len(tr.base),
                       t_s=round(self._now_s(now), 4))
        self._waiting = still

    def _shed_pass(self, now: float) -> None:
        """Saturation shedding: when nothing can take new work, the
        longest-expired LOWEST class request is shed — at most one per
        step (rate-limited graceful degradation; the order is pinned:
        batch before standard before high)."""
        if not self._waiting:
            return
        if any(rep.health == "up"
               and self._load(rep) < self.cfg.queue_high
               for rep in self.reps.values()):
            return
        expired = [
            rid for rid in self._waiting
            if (self._now_s(now) - self.tracks[rid].arrival_s
                > self.cfg.shed_wait_s)]
        if not expired:
            return
        victim = max(expired, key=lambda rid: (
            _RANK.get(self.tracks[rid].slo, 1),
            -self.tracks[rid].arrival_s, -rid))
        self._shed(self.tracks[victim], now, "saturated")

    # -- the step ----------------------------------------------------------

    def step(self, now: float) -> None:
        if self._t0 is None:
            raise RuntimeError("call begin(t0) before step()")
        self._poll_health(now)
        for rep in self.reps.values():
            if rep.health != "dead":
                self._absorb(rep, now)
        self._timeouts(now)
        while self._arrivals and (
                self.tracks[self._arrivals[0]].arrival_s
                <= self._now_s(now)):
            rid = self._arrivals.pop(0)
            tr = self.tracks[rid]
            tr.state = "waiting"
            self._waiting.append(rid)
        self._dispatch(now)
        self._shed_pass(now)
        self._steps += 1
        if self.slo_monitor is not None:
            self.slo_monitor.on_step(self._steps)

    # -- summary -----------------------------------------------------------

    def _percentile(self, vals: List[float], q: float) -> float:
        from tensorflow_distributed_tpu_torch.observe.slo import percentile
        return percentile(sorted(vals), q)

    def token_streams(self) -> Dict[int, List[int]]:
        """Completed requests' assembled streams (dead-leg base +
        current-owner tokens), for a token-identity check against a
        single-replica reference run."""
        return {t.rid: t.tokens for t in self.tracks.values()
                if t.state == "done"}

    def summary(self) -> Dict[str, Any]:
        tracks = list(self.tracks.values())
        done = [t for t in tracks if t.state == "done"]
        shed = [t for t in tracks if t.state == "shed"]
        hist: Dict[str, int] = {}
        for t in tracks:
            if t.state in ("done", "shed"):
                hist[str(t.retries)] = hist.get(str(t.retries), 0) + 1
        shed_by_class: Dict[str, int] = {}
        shed_reasons: Dict[str, int] = {}
        for t in shed:
            shed_by_class[t.slo] = shed_by_class.get(t.slo, 0) + 1
            shed_reasons[t.shed_reason] = (
                shed_reasons.get(t.shed_reason, 0) + 1)
        out: Dict[str, Any] = {
            "requests": len(tracks),
            "requests_done": len(done),
            "requests_shed": len(shed),
            "requests_lost": len(tracks) - len(done) - len(shed),
            "shed_by_class": dict(sorted(shed_by_class.items())),
            "shed_reasons": dict(sorted(shed_reasons.items())),
            "dispatches": sum(t.dispatches for t in tracks),
            "redispatches": sum(t.retries for t in tracks),
            "dispatch_retry_hist": dict(
                sorted(hist.items(), key=lambda kv: int(kv[0]))),
            "quarantines": self.quarantines,
            "rejoins": self.rejoins,
            "deaths": self.deaths,
            "replica_done": {name: rep.done_count
                             for name, rep in sorted(self.reps.items())},
            "total_new_tokens": sum(len(t.tokens) for t in done),
        }
        ttfts = [1e3 * (t.first_tok_t - (self._t0 + t.arrival_s))
                 for t in done if t.first_tok_t is not None]
        if ttfts:
            for q in (50, 95, 99):
                out[f"ttft_ms_p{q}"] = round(
                    self._percentile(ttfts, q), 3)
        # Per-class END-TO-END TTFT (router clock, admission -> first
        # token, retries and failovers included — what the client
        # sees, which per-replica p95s structurally cannot). Same
        # population + same nearest-rank percentile as the fleet
        # snapshot and observe/report.py's fleet_request fold, so all
        # three agree exactly.
        by_cls: Dict[str, List[float]] = {}
        for t in done:
            if t.first_tok_t is not None:
                by_cls.setdefault(t.slo, []).append(
                    1e3 * (t.first_tok_t - (self._t0 + t.arrival_s)))
        for cls, vals in sorted(by_cls.items()):
            out[f"ttft_ms_p50_{cls}"] = round(
                self._percentile(vals, 50), 3)
            out[f"ttft_ms_p95_{cls}"] = round(
                self._percentile(vals, 95), 3)
        if self.slo_monitor is not None:
            out.update({"fleet_" + k: v
                        for k, v in self.slo_monitor.summary().items()})
        # Recovery population: a replica death/quarantine/timeout fell
        # inside the request's arrival -> first-token window, or the
        # request itself was re-dispatched (the scheduler's
        # recovery_window semantics, fleet-side).
        rec = []
        for t in done:
            if t.first_tok_t is None:
                continue
            arr = self._t0 + t.arrival_s
            window = t.redispatched or any(
                arr <= et <= t.first_tok_t
                for et, _, _ in self.events)
            if window:
                rec.append(1e3 * (t.first_tok_t - arr))
        out["recovery_requests"] = len(rec)
        if rec:
            out["ttft_ms_p99_recovery"] = round(
                self._percentile(rec, 99), 3)
        if done:
            t_last = max(t.done_t for t in done)
            out["wall_s"] = round(t_last - self._t0, 4)
            out["tokens_per_sec"] = round(
                out["total_new_tokens"] / max(out["wall_s"], 1e-9), 2)
        return out

    def fleet_snapshot(self, now: float) -> Dict[str, Any]:
        """The control-plane feed payload (``--fleet.export-path``):
        aggregate occupancy/queue, per-class end-to-end TTFT p50/p95
        (same population and percentile as :meth:`summary`), per-replica
        health with snapshot staleness, the quarantine set, and the fleet
        SLO error budget."""
        slots = slots_live = queue = 0
        per_rep: Dict[str, Any] = {}
        quarantined: List[str] = []
        for name, rep in sorted(self.reps.items()):
            snap = rep.snap or {}
            slots += int(snap.get("num_slots", 0))
            slots_live += int(snap.get("requests_live", 0))
            queue += int(snap.get("queue_depth", 0))
            if rep.health == "quarantined":
                quarantined.append(name)
            per_rep[name] = {
                "health": rep.health,
                "epoch": rep.handle.epoch,
                "load": self._load(rep),
                "inflight": len(rep.inflight),
                "done": rep.done_count,
                "reason": rep.reason,
                "stale_s": (round(now - rep.seq_t, 3)
                            if rep.last_seq is not None else None),
                "ckpt_step": snap.get("ckpt_step"),
                # PER-DEVICE capacity facts (scheduler's
                # _capacity_fields): a tensor-parallel replica's cache
                # spend per device is 1/tp_width of the logical bytes
                # — headroom math over the logical figure would
                # overcount a TP replica tp_width-fold.
                "tp_width": snap.get("tp_width", 1),
                "per_device_cache_bytes": snap.get(
                    "per_device_cache_bytes"),
            }
            if "tune_actions" in snap:
                # Autopilot-armed replica: how many knobs its
                # controller has moved — a replica self-tuning hard is
                # a replica whose workload shifted (observe/
                # autopilot.py; surfaces in fleetview).
                per_rep[name]["tune_actions"] = snap["tune_actions"]
        done = [t for t in self.tracks.values() if t.state == "done"]
        by_cls: Dict[str, List[float]] = {}
        for t in done:
            if t.first_tok_t is not None:
                by_cls.setdefault(t.slo, []).append(
                    1e3 * (t.first_tok_t
                           - ((self._t0 or 0.0) + t.arrival_s)))
        out: Dict[str, Any] = {
            "t_s": round(self._now_s(now), 4),
            "step": self._steps,
            "requests": len(self.tracks),
            "requests_done": len(done),
            "requests_shed": sum(
                1 for t in self.tracks.values() if t.state == "shed"),
            "waiting": len(self._waiting),
            "inflight": sum(len(r.inflight)
                            for r in self.reps.values()),
            "slots": slots,
            "slots_live": slots_live,
            "queue_depth": queue,
            "quarantined": quarantined,
            "deaths": self.deaths,
            "replicas": per_rep,
        }
        for cls, vals in sorted(by_cls.items()):
            out[f"ttft_ms_p50_{cls}"] = round(
                self._percentile(vals, 50), 3)
            out[f"ttft_ms_p95_{cls}"] = round(
                self._percentile(vals, 95), 3)
        if self.slo_monitor is not None:
            out["slo"] = self.slo_monitor.snapshot()
            out["slo_budget_remaining_min"] = min(
                (e["budget_remaining"]
                 for e in out["slo"].values()), default=1.0)
            out["slo_alerting"] = self.slo_monitor.any_alerting()
        return out

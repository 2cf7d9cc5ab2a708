"""Admission and prefill/decode interleaving for the slot engine: the
port of ``serve/scheduler.py``'s ``fifo`` and ``slo`` policies and its
speculative dispatch.

Policy: **decode priority with a starvation bound**. Decoding a full
batch is the throughput-optimal steady state, so the scheduler keeps
stepping while requests wait; but a queued request with a free slot is
admitted after at most ``decode_priority`` decode steps (the starvation
clock ticks only while both hold: someone waits and a slot is free). An
idle engine admits at once. Requests become visible at their
``arrival_s`` offset. Admission order is the ``policy``:

- ``fifo``: arrival order;
- ``slo``: SLO classes (``high`` > ``standard`` > ``batch``) pick the
  request admitted, so a high-class arrival never queues behind a lower
  class while a slot frees. With ``tenant_quota`` a tenant at or over
  its decoded-token quota is deferred while an under-quota request
  waits (never dropped: it is served when nothing under quota waits).
  With ``preempt`` a request of a higher class that has waited out the
  decode-priority clock with no free slot evicts the worst live
  lower-class (or over-quota) request, which re-enters the queue as a
  continuation (prompt + its tokens so far, the remaining budget) whose
  final stream equals the one it would have had (greedy determinism).

**Speculative decoding** (a ``speculator`` and an engine built with
``spec_tokens`` > 0, serve/speculate.py): each iteration proposes k
tokens a slot and one verify dispatch retires ``accepted + 1`` of them,
token-identical to plain greedy decoding; a slot short of verify headroom
takes the plain path inside the verify (``verify_fallback_slots``), and
where that is impossible the whole batch takes a plain step. The summary
counts both (``spec_fallback_slots``, ``spec_batch_fallbacks``) beside
the accept rate.

Termination is per request (its EOS id, or its ``max_new_tokens``
budget, also where a verify's chain runs past it), tokens stream to the
host as they retire (``on_token``), and each finished request reports
its time to first token, decode time and mean inter-token latency.

Over the paged engine (``serve/paging/engine.py``, ``engine.paged``) the
scheduler passes each admission its budget and ``session``, releases a
finished or preempted request through ``engine.release`` with its prompt
and tokens (they feed the prefix cache and the session store, so a
preempted request's continuation re-attaches its pages), defers
admission while ``engine.can_admit`` is False and live slots will free
pages (an idle engine that still cannot admit raises), admits a
session's turns in order, and folds ``engine.paging_stats()`` into the
summary.

Serving under faults (all optional):

- **fault plan** (resilience/faults.py): consulted between decode steps
  on the engine's decode-step clock: ``slot_nan`` poisons a slot's cache
  (a slot named but empty is redirected to the lowest live one),
  ``reload`` swaps weights, ``sigterm``/``sigkill`` self-signal
  (``decode_stall`` is consumed inside the engine's watched fetch);
- **slot retry**: a slot whose step (or verify) produced non-finite
  logits, as the engine's device flag says, is quarantined: freed
  without retention and its request re-queued at the head as a
  continuation (prompt + the good tokens, the remaining budget), so one
  poisoned slot costs one re-prefill and greedy determinism keeps the
  stream. ``slot_retries`` bounds the quarantines of one request:
  past it :class:`SlotRetryExhausted` (exit 2);
- **journal** (serve/journal.py): admits, tokens and completions
  append to a ``RequestJournal``, flushed every iteration, so a killed
  leg resumes at token granularity; a replayed continuation
  (``_base_tokens``) reports its whole stream;
- **live weight swap**: ``reload_fn`` (serve/run.py wires it to
  ``train.checkpoint.restore_params``) supplies new weights and the
  engine copies them in between steps with slots live.

Recovery records (``slot_quarantine``, ``weight_swap``) print as JSON
lines on standard output. Each completion reports its ``retries`` and
``recovery_window`` (a quarantine or swap fell between its arrival and
its first token, or it is a journal or quarantine continuation); the
summary adds ``retries``, ``swaps`` and ``swap_seconds``.

The serve observatory (all optional, nothing paid unconfigured):

- **registry** (observe/registry.py): a ``serve_request`` record a
  completion, ``preempt``, ``recovery``, ``serve_reject`` and
  ``serve_cancel`` records, the ``serve_summary``, ``metrics_snapshot``
  records on the export cadence;
- **tracer** (observe/serve_trace.py): every request an async span tree
  (queue, prefill, decode), quarantine, swap and preemption markers,
  counter tracks of occupancy, queue, tokens/s and accept rate a step;
- **slo_monitor** (observe/slo.py): window accounting a completion and
  the burn-rate evaluation a decode step (``slo_alert``/``slo_ok``);
- **anomaly_hub** (observe/anomaly.py): the TTFT, decode-dispatch wall
  and queue depth this loop holds, and a flagged slot as a critical
  anomaly;
- **metrics_snapshot() / export**: a point-in-time view of the engine
  with the liveness triplet ``seq``/``wall_ts``/``pid``, atomically
  rewritten at ``export_path`` every ``export_every`` seconds (a fleet
  router's health feed); ``status_fn``/``status_every`` print the live
  status line.

**Fleet intake** (``feed``: fleet/replica.py's ``InboxFeed``, or any
object with ``poll()``): ``run()`` serves an open-ended stream, polling
between decode steps for requests and the commands ``swap``, ``drain``,
``cancel`` and ``hold_export``, until a drain lands and the engine runs
dry; an unservable request is rejected into the journal.
``served_ckpt_step`` (the step the weights came from, kept by a swap)
rides the snapshot as the fleet controller's staleness feed. The
autopilot and its ``tune`` command are not ported yet (ROADMAP.md A8).

``clock`` is injectable so that tests can drive this scheduler and the
JAX one on one fake clock.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from tensorflow_distributed_tpu_torch.observe.slo import percentile
from tensorflow_distributed_tpu_torch.serve.buckets import pick_bucket
from tensorflow_distributed_tpu_torch.utils.atomicio import atomic_write_json
from tensorflow_distributed_tpu_torch.utils.logging import print_event

#: SLO classes, best first: admission under policy="slo" prefers the
#: lowest rank; a request without a class is "standard".
SLO_CLASSES = ("high", "standard", "batch")
_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}


def parse_slo_mix(spec: str) -> Dict[str, float]:
    """``--serve.slo-mix``: ``"high:0.25,batch:0.25"``, class:fraction
    pairs, the remainder "standard". Returns the full {class: fraction}
    map (standard filled in)."""
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"slo_mix entry {part!r} is not class:fraction")
        name, frac = (x.strip() for x in part.split(":", 1))
        if name not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {name!r}; have {SLO_CLASSES}")
        f = float(frac)
        if not 0.0 <= f <= 1.0:
            raise ValueError(
                f"slo_mix fraction for {name!r} must be in [0, 1], "
                f"got {f}")
        if name in out:
            raise ValueError(f"slo_mix names {name!r} twice")
        out[name] = f
    rest = 1.0 - sum(out.values())
    if rest < -1e-9:
        raise ValueError(
            f"slo_mix fractions sum to {sum(out.values()):g} > 1")
    out["standard"] = out.get("standard", 0.0) + max(rest, 0.0)
    return out


class SlotRetryExhausted(RuntimeError):
    """The same request was slot-quarantined past its retry budget:
    serve mode's divergence (greedy decoding would poison the same way
    again, and a restart would loop). The CLI exits 2."""


@dataclasses.dataclass
class Request:
    """One inference request. ``arrival_s`` is the open-loop offset
    (seconds from run start) at which the scheduler sees it; ``slo`` and
    ``tenant`` drive policy="slo" (FIFO ignores them)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int = -1          # -1 = run to the full budget
    arrival_s: float = 0.0
    slo: str = "standard"     # high | standard | batch
    tenant: str = ""          # quota bucket (policy="slo")
    # A multi-turn conversation's id: the paged engine retains a
    # finished turn's KV under it, and the next turn re-attaches it.
    session: str = ""


@dataclasses.dataclass
class Completion:
    """A finished request with its serving metrics."""

    rid: int
    prompt_len: int
    tokens: List[int]
    finish: str               # "eos" | "length"
    ttft_s: float             # arrival -> first token (queue + prefill)
    decode_s: float           # first token -> last token
    queue_steps: int          # decode steps endured while admittable
    retries: int = 0          # slot quarantines this request survived
    preempts: int = 0         # SLO preemptions this request survived
    slo: str = "standard"
    tenant: str = ""
    recovery_window: bool = False  # a quarantine or swap fell between
    #                                arrival and first token, or this is
    #                                a recovery continuation
    decoded: int = 0          # tokens of the last admission (a
    #                           continuation's earlier tokens excluded)

    @property
    def tok_ms(self) -> float:
        """Mean inter-token latency (ms) over the decode phase."""
        n = self.decoded or len(self.tokens)
        return 1e3 * self.decode_s / max(1, n - 1)


@dataclasses.dataclass
class _Live:
    req: Request
    slot: int
    tokens: List[int]
    t_first: float
    queue_steps: int


class Scheduler:
    """Drives a :class:`~.engine.SlotDecodeEngine` over a workload."""

    def __init__(self, engine, decode_priority: int = 8, registry=None,
                 on_token: Optional[Callable[[int, int, bool], None]] = None,
                 clock=time.perf_counter, fault_plan=None, journal=None,
                 reload_fn=None, slot_retries: int = 2, summary_extra=None,
                 policy: str = "fifo", tenant_quota: int = 0,
                 preempt: bool = True, speculator=None, tracer=None,
                 slo_monitor=None, anomaly_hub=None, autopilot=None,
                 export_every: float = 0.0, export_path: str = "",
                 status_fn=None, status_every: int = 0, feed=None,
                 served_ckpt_step=None):
        if autopilot is not None:
            raise NotImplementedError(
                "Scheduler(autopilot) is not ported to PyTorch yet (see "
                "ROADMAP.md A8)")
        if decode_priority < 1:
            raise ValueError(
                f"decode_priority must be >= 1, got {decode_priority}")
        if slot_retries < 0:
            raise ValueError(
                f"slot_retries must be >= 0, got {slot_retries}")
        if policy not in ("fifo", "slo"):
            raise ValueError(
                f"unknown policy {policy!r}; have ('fifo', 'slo')")
        if tenant_quota < 0:
            raise ValueError(
                f"tenant_quota must be >= 0, got {tenant_quota}")
        if export_every < 0:
            raise ValueError(
                f"export_every must be >= 0, got {export_every}")
        self.engine = engine
        self.decode_priority = decode_priority
        self.registry = registry
        self.on_token = on_token
        self.clock = clock
        self.fault_plan = fault_plan
        self.journal = journal
        self.reload_fn = reload_fn    # () -> (params, checkpoint step)
        self.slot_retries = slot_retries
        self.policy = policy
        self.tenant_quota = tenant_quota
        self.preempt = preempt
        self.speculator = speculator
        # The serve observatory: every hook is None-safe.
        self.tracer = tracer
        self.slo_monitor = slo_monitor
        self.anomaly_hub = anomaly_hub
        self.export_every = float(export_every)
        self.export_path = export_path
        self.status_fn = status_fn
        self.status_every = int(status_every)
        # Streaming intake: with a feed, run() serves until a drain
        # command lands and the engine runs dry.
        self.feed = feed
        # The checkpoint step the served weights came from (serve/run.py
        # sets it from the start-up restore; a swap updates it).
        self.served_ckpt_step = served_ckpt_step
        self.draining = False
        self._export_hold_until = 0.0
        # The snapshot's monotonic sequence number: a poller tells a
        # frozen snapshot file (seq stalled) from an idle replica.
        self._snap_seq = 0
        self._snap_state: Optional[dict] = None
        self._last_export = 0.0
        self.summary_extra = dict(summary_extra or {})
        self.summary: Dict = {}

    def _emit(self, event: str, **fields) -> None:
        if self.registry is not None:
            self.registry.emit(event, **fields)

    def _recovery(self, **fields) -> None:
        """A recovery record: printed on standard output, and into the
        registry when there is one."""
        print_event("recovery", **fields)
        self._emit("recovery", **fields)

    # -- SLO selection ----------------------------------------------------

    def _over_quota(self, tenant: str, tenant_tokens: Dict[str, int]) -> bool:
        return (self.tenant_quota > 0
                and tenant_tokens.get(tenant, 0) >= self.tenant_quota)

    def _pick_index(self, queue: List[Request], tenant_tokens: Dict[str, int],
                    skip: frozenset = frozenset()) -> int:
        """Which queued request admits next. FIFO: the first not in
        ``skip`` (rids not admissible now: session turns waiting on an
        earlier turn). SLO: under quota before over quota, then class
        rank, then arrival order. -1 when nothing qualifies."""
        if self.policy != "slo" or len(queue) <= 1:
            return next((i for i, r in enumerate(queue)
                         if r.rid not in skip), -1)
        best, best_key = -1, None
        for i, req in enumerate(queue):
            if req.rid in skip:
                continue
            key = (1 if self._over_quota(req.tenant, tenant_tokens) else 0,
                   _RANK.get(req.slo, 1), i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _pick_victim(self, live: Dict[int, _Live], cand: Request,
                     tenant_tokens: Dict[str, int]) -> Optional[_Live]:
        """The live request that preemption evicts for ``cand``: of a
        strictly lower class, or over quota while cand's tenant is under;
        among those the lowest class with the most tokens delivered (it
        loses the least). None = nobody preemptible (equal classes are
        never evicted: they would swap places and thrash). A victim whose
        continuation would outgrow the bucket ladder is skipped:
        preemption is elective."""
        cand_rank = _RANK.get(cand.slo, 1)
        cand_over = self._over_quota(cand.tenant, tenant_tokens)
        ladder = max(self.engine.buckets)
        victims = []
        for lv in live.values():
            lower = _RANK.get(lv.req.slo, 1) > cand_rank
            quota_evict = (not cand_over
                           and self._over_quota(lv.req.tenant, tenant_tokens)
                           and lv.req.tenant != cand.tenant)
            fits_ladder = len(lv.req.prompt) + len(lv.tokens) <= ladder
            if (lower or quota_evict) and fits_ladder:
                victims.append(lv)
        if not victims:
            return None
        return max(victims, key=lambda lv: (_RANK.get(lv.req.slo, 1),
                                            len(lv.tokens)))

    @staticmethod
    def _session_blocked(pending, queue, live) -> frozenset:
        """Queued rids whose session has an earlier unfinished turn: a
        client sends turn j + 1 only after turn j's reply, so such a turn
        waits for its predecessor (which also makes the paged engine's
        session re-attach deterministic). Requests without a session are
        never blocked."""
        earliest: Dict[str, int] = {}
        for r in list(pending) + list(queue) + [lv.req
                                                for lv in live.values()]:
            if r.session and (r.session not in earliest
                              or r.rid < earliest[r.session]):
                earliest[r.session] = r.rid
        return frozenset(r.rid for r in queue
                         if r.session and earliest.get(r.session) != r.rid)

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Serve every request to completion (with a feed: until a drain
        command lands and the engine runs dry); returns completions in
        finish order (sort by ``rid`` for submission order)."""
        eng = self.engine
        spec = self.speculator
        plan = self.fault_plan
        journal = self.journal
        tracer = self.tracer
        slo = self.slo_monitor
        hub = self.anomaly_hub
        feed = self.feed
        for r in requests:
            if not eng.fits(len(r.prompt), r.max_new_tokens):
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} + "
                    f"{r.max_new_tokens} new tokens does not fit "
                    f"(buckets up to {max(eng.buckets)}, max_len "
                    f"{eng.max_len})")
            if r.max_new_tokens < 1:
                raise ValueError(
                    f"request {r.rid}: max_new_tokens must be >= 1")
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        queue: List[Request] = []
        waited: Dict[int, int] = {}           # rid -> admittable steps
        # rid -> tokens before a continuation (journal replay, slot
        # retry or preemption): the completion reports base + tokens.
        base: Dict[int, List[int]] = {
            r.rid: list(r._base_tokens) for r in requests
            if getattr(r, "_base_tokens", None)}
        # rids whose base is a preemption's only (policy, not recovery).
        policy_base: set = set()
        first_seen: Dict[int, float] = {}     # rid -> first-token time
        preempts: Dict[int, int] = {}         # rid -> preemptions
        retries: Dict[int, int] = {}          # rid -> quarantines
        recovery_ts: List[float] = []         # quarantine and swap times
        total_retries = 0
        self._swap_seconds = 0.0
        tenant_tokens: Dict[str, int] = {}    # decoded tokens a tenant
        live: Dict[int, _Live] = {}           # slot -> _Live
        done: List[Completion] = []
        t0 = self.clock()
        steps_since_admit = 0
        # This run's decode-step tallies and decoded tokens (shared with
        # metrics_snapshot()), and the rolling (t, decoded) and
        # (t, accepted, proposed) samples of the windowed rates.
        tally = {"steps": 0, "occ_sum": 0.0, "decoded": 0}
        rate_win: collections.deque = collections.deque(maxlen=64)
        spec_win: collections.deque = collections.deque(maxlen=64)
        spec_stats = {"verify_steps": 0, "proposed": 0, "accepted": 0,
                      "fallback_slots": 0, "batch_fallbacks": 0}
        self._snap_state = {
            "t0": t0, "tally": tally, "rate_win": rate_win,
            "queue": queue, "live": live, "done": done,
            "pending": pending, "retries_map": retries,
            "preempts_map": preempts, "spec_stats": spec_stats,
            "spec_win": spec_win}
        self._last_export = t0
        paged = getattr(eng, "paged", False)
        slo_preempt = self.policy == "slo" and self.preempt
        # Turn order binds only where some request has a session.
        has_sessions = any(r.session for r in requests)

        def now() -> float:
            return self.clock() - t0

        def emit(rid: int, tok: int, last: bool) -> None:
            if self.on_token is not None:
                self.on_token(rid, tok, last)

        def pick() -> int:
            return self._pick_index(
                queue, tenant_tokens,
                skip=(self._session_blocked(pending, queue, live)
                      if has_sessions else frozenset()))

        def release(lv: _Live, retain: bool = True) -> None:
            """Free the slot; with ``retain`` the paged engine keeps the
            request's whole sequence (prefix cache, session). A
            quarantine retains nothing: poisoned pages are never
            cached."""
            del live[lv.slot]
            if paged and retain:
                eng.release(lv.slot, tokens=[int(x) for x in lv.req.prompt]
                            + lv.tokens, session=lv.req.session)
            elif paged:
                eng.release(lv.slot)
            else:
                eng.free(lv.slot)
            if spec is not None:
                spec.observe_free(lv.slot)

        def finish(lv: _Live, why: str) -> None:
            t = now()
            release(lv)
            rid = lv.req.rid
            prior = base.get(rid, [])
            t_first = first_seen[rid]
            # The recovery population: a quarantine or swap fell inside
            # arrival -> first token, or the request is a recovery
            # continuation (a preemption's base is policy, not recovery).
            window = (any(lv.req.arrival_s <= rt <= t_first
                          for rt in recovery_ts)
                      or (bool(prior) and rid not in policy_base))
            comp = Completion(
                rid=rid, prompt_len=len(lv.req.prompt) - len(prior),
                tokens=prior + lv.tokens, finish=why,
                ttft_s=t_first - lv.req.arrival_s, decode_s=t - t_first,
                queue_steps=lv.queue_steps, retries=retries.get(rid, 0),
                preempts=preempts.get(rid, 0), slo=lv.req.slo,
                tenant=lv.req.tenant, recovery_window=window,
                decoded=len(lv.tokens))
            done.append(comp)
            if slo is not None:
                slo.observe(comp.slo, 1e3 * comp.ttft_s, comp.tok_ms,
                            tally["steps"])
            if hub is not None:
                hub.observe_completion(tally["steps"], 1e3 * comp.ttft_s)
            if tracer is not None:
                tracer.request_done(rid, why, len(comp.tokens),
                                    1e3 * comp.ttft_s)
            self._emit("serve_request", rid=rid,
                       prompt_len=comp.prompt_len,
                       new_tokens=len(comp.tokens), finish=why,
                       ttft_ms=round(1e3 * comp.ttft_s, 3),
                       tok_ms=round(comp.tok_ms, 4),
                       queue_steps=comp.queue_steps,
                       retries=comp.retries, preempts=comp.preempts,
                       slo=comp.slo, tenant=comp.tenant,
                       recovery_window=window,
                       arrival_s=round(lv.req.arrival_s, 4),
                       t_first_s=round(t_first, 4))
            if journal is not None:
                journal.done(rid)
            emit(rid, lv.tokens[-1], True)

        def retire(lv: _Live, tok: int) -> bool:
            """Append one token; True when it finished the request."""
            lv.tokens.append(tok)
            tally["decoded"] += 1
            if journal is not None:
                journal.token(lv.req.rid, tok, now())
            if lv.req.tenant:
                tenant_tokens[lv.req.tenant] = (
                    tenant_tokens.get(lv.req.tenant, 0) + 1)
            if tok == lv.req.eos_id:
                finish(lv, "eos")
            elif len(lv.tokens) >= lv.req.max_new_tokens:
                finish(lv, "length")
            else:
                emit(lv.req.rid, tok, False)
                return False
            return True

        def admit(req: Request) -> None:
            slot = eng.free_slots()[0]
            ctx = (tracer.prefill(req.rid, pick_bucket(len(req.prompt),
                                                       eng.buckets), slot)
                   if tracer is not None else contextlib.nullcontext())
            with ctx:
                if paged:
                    # The budget sizes the page reservation; the session
                    # keys the conversation's re-attach.
                    first = eng.prefill(req.prompt, slot,
                                        max_new_tokens=req.max_new_tokens,
                                        session=req.session)
                else:
                    first = eng.prefill(req.prompt, slot)
            if spec is not None:
                spec.observe_admit(slot, req.prompt, first)
            lv = _Live(req=req, slot=slot, tokens=[], t_first=now(),
                       queue_steps=waited.pop(req.rid))
            if req.rid not in first_seen:
                if journal is not None and not base.get(req.rid):
                    # The first admission of a request (a replayed
                    # continuation was journaled by the leg before).
                    journal.admit(req.rid, req.prompt, req.max_new_tokens,
                                  req.eos_id, slo=req.slo,
                                  tenant=req.tenant, session=req.session)
                first_seen[req.rid] = lv.t_first
            live[slot] = lv
            retire(lv, first)

        def continuation(lv: _Live) -> Request:
            """Prompt + the tokens so far, the remaining budget, class and
            tenant kept: greedy decoding is deterministic, so the
            re-admitted continuation emits exactly the tokens the slot
            would have."""
            cont = dataclasses.replace(
                lv.req,
                prompt=np.concatenate([np.asarray(lv.req.prompt, np.int32),
                                       np.asarray(lv.tokens, np.int32)]),
                max_new_tokens=lv.req.max_new_tokens - len(lv.tokens))
            if len(cont.prompt) > max(eng.buckets):
                raise ValueError(
                    f"request {lv.req.rid}: continuation prompt "
                    f"{len(cont.prompt)} exceeds the largest bucket "
                    f"{max(eng.buckets)} — re-admission needs the ladder "
                    f"sized to prompt+new tokens (serve/run.py does this "
                    f"when a fault plan, journal resume, or policy=slo is "
                    f"armed; with --serve.buckets, cover the full "
                    f"trajectory)")
            base[lv.req.rid] = base.get(lv.req.rid, []) + lv.tokens
            waited[lv.req.rid] = lv.queue_steps
            return cont

        def preempt_one(lv: _Live) -> None:
            """Evict a live lower-class or over-quota request so that the
            waiting higher-class one gets its slot; it re-enters the
            queue as a continuation (class selection orders the queue).
            Released with retention: on the paged engine the
            continuation's re-prefill is a prefix-cache hit. No retry
            charge and no recovery record: this is policy, not
            failure."""
            release(lv)
            rid = lv.req.rid
            preempts[rid] = preempts.get(rid, 0) + 1
            served = len(base.get(rid, [])) + len(lv.tokens)
            # The base stays a recovery base if it was one already.
            if not base.get(rid) or rid in policy_base:
                policy_base.add(rid)
            queue.append(continuation(lv))
            self._emit("preempt", rid=rid, slot=lv.slot, slo=lv.req.slo,
                       tenant=lv.req.tenant, served=served,
                       t_s=round(now(), 4))
            if tracer is not None:
                tracer.instant("preempt", cat="policy", rid=rid,
                               slot=lv.slot, slo=lv.req.slo)
                tracer.request_evicted(rid, "preempt")

        def quarantine(lv: _Live) -> None:
            """Contain one poisoned slot: free it without retention and
            re-queue its request at the head as a continuation (prompt +
            the good tokens, the remaining budget), within the retry
            budget."""
            nonlocal total_retries, steps_since_admit
            release(lv, retain=False)
            rid = lv.req.rid
            n = retries[rid] = retries.get(rid, 0) + 1
            if n > self.slot_retries:
                raise SlotRetryExhausted(
                    f"request {rid} slot-quarantined {n} times "
                    f"(budget {self.slot_retries}): repeated NaN on "
                    f"the same request is a divergence, not a "
                    f"transient — halting instead of hot-looping "
                    f"re-prefills")
            total_retries += 1
            t = now()
            recovery_ts.append(t)
            if hub is not None:
                # The engine's per-slot finiteness flag is the detection.
                hub.note_slot_nonfinite(tally["steps"], slot=lv.slot,
                                        rid=rid)
            self._recovery(kind="slot_quarantine", rid=rid, slot=lv.slot,
                           retry=n, t_s=round(t, 4))
            if tracer is not None:
                tracer.instant("slot_quarantine", rid=rid, slot=lv.slot,
                               retry=n)
                tracer.request_evicted(rid, "quarantine")
            policy_base.discard(rid)
            queue.insert(0, continuation(lv))
            # Re-admit without waiting out the decode-priority clock: the
            # request was already being served.
            steps_since_admit = self.decode_priority

        def cancel_rid(rid: int) -> None:
            """The fleet router moved this request elsewhere: drop it
            wherever it is (queue, pending, or a live slot, freed with
            retention: its KV is valid) without a completion; the new
            owner derives the stream again (greedy determinism)."""
            for i, r in enumerate(queue):
                if r.rid == rid:
                    queue.pop(i)
                    waited.pop(rid, None)
                    self._emit("serve_cancel", rid=rid, where="queue")
                    return
            for i, r in enumerate(pending):
                if r.rid == rid:
                    del pending[i]
                    self._emit("serve_cancel", rid=rid, where="pending")
                    return
            for slot, lv in list(live.items()):
                if lv.req.rid == rid:
                    release(lv)
                    self._emit("serve_cancel", rid=rid, where="live",
                               slot=slot)
                    return

        def feed_cmd(cmd: Dict[str, Any]) -> None:
            kind = cmd.get("cmd")
            if kind == "drain":
                self.draining = True
            elif kind == "swap":
                self._swap(now, recovery_ts)
            elif kind == "cancel":
                cancel_rid(int(cmd.get("rid", -1)))
            elif kind == "hold_export":
                self._export_hold_until = (
                    self.clock() + float(cmd.get("secs", 0.0)))
            elif kind == "tune":
                raise NotImplementedError(
                    "the autopilot's tune command is not ported to "
                    "PyTorch yet (see ROADMAP.md A8)")

        def feed_request(r: Request) -> None:
            nonlocal has_sessions
            bad = (self.draining or r.max_new_tokens < 1
                   or not eng.fits(len(r.prompt), r.max_new_tokens))
            if not bad:
                # The paged pool: a reservation that can never fit (even
                # with the prefix cache evicted; + 1 for the worst-case
                # copy-on-write page under the radix cache) is rejected
                # here: the idle-engine admission would raise, and a
                # replica never crashes on a bad dispatch.
                pf = getattr(eng, "pages_for", None)
                if pf is not None:
                    need = pf(len(r.prompt), r.max_new_tokens)
                    if getattr(eng, "radix", None) is not None:
                        need += 1
                    bad = need > eng.pool.capacity
            if bad:
                self._emit("serve_reject", rid=r.rid,
                           prompt_len=len(r.prompt),
                           max_new=r.max_new_tokens,
                           draining=self.draining)
                if journal is not None:
                    journal.reject(r.rid)
                    journal.flush()
                return
            # A duplicate of a present rid supersedes it (a router's
            # double send must not interleave two streams in one
            # journal entry).
            cancel_rid(r.rid)
            base.pop(r.rid, None)
            policy_base.discard(r.rid)
            first_seen.pop(r.rid, None)
            r.arrival_s = now()
            pending.append(r)
            if r.session:
                has_sessions = True

        def poll_feed() -> None:
            """Streamed intake: new requests join ``pending`` due at once;
            commands act between decode steps, in file order (a stalled
            replica can read a dispatch, its cancel and the re-dispatched
            continuation in one batch)."""
            for item in feed.poll():
                if isinstance(item, dict):
                    feed_cmd(item)
                else:
                    feed_request(item)

        while pending or queue or live or (feed is not None
                                           and not self.draining):
            if feed is not None:
                poll_feed()
            while pending and pending[0].arrival_s <= now():
                req = pending.popleft()
                waited[req.rid] = 0
                queue.append(req)
                if tracer is not None:
                    tracer.request_queued(req.rid, slo=req.slo,
                                          prompt_len=len(req.prompt),
                                          tenant=req.tenant)
            if queue and eng.free_slots() and (
                    not live or steps_since_admit >= self.decode_priority):
                i = pick()
                if i >= 0:
                    head = queue[i]
                    # Page-pool pressure (paged engine): while live slots
                    # hold the shortfall, keep decoding; they free pages
                    # as they finish.
                    if not paged or eng.can_admit(len(head.prompt),
                                                  head.max_new_tokens):
                        admit(queue.pop(i))
                        steps_since_admit = 0
                        if journal is not None:
                            journal.flush()
                        continue
                    if not live:
                        raise RuntimeError(
                            f"request {head.rid}: page pool cannot hold its "
                            f"reservation even with the engine idle and "
                            f"the prefix cache fully evicted — raise "
                            f"--serve.num-pages (or lower the request "
                            f"budget)")
            if (slo_preempt and queue and live and not eng.free_slots()
                    and steps_since_admit >= self.decode_priority):
                i = pick()
                if i >= 0:
                    victim = self._pick_victim(live, queue[i], tenant_tokens)
                    if victim is not None:
                        preempt_one(victim)
                        continue   # the admission branch admits next
            if not live:
                if pending:
                    # Nothing to decode and nothing admittable: sleep to
                    # the next arrival instead of spinning (bounded with a
                    # feed: work or a command can land before it).
                    delay = max(0.0, pending[0].arrival_s - now())
                    if feed is not None:
                        delay = min(delay, 0.02)
                    time.sleep(delay)
                    continue
                if feed is not None and not self.draining:
                    # Idle but open: keep the snapshot fresh (the
                    # router's liveness signal) and poll again shortly.
                    self._maybe_export()
                    time.sleep(0.02)
                    continue
                break
            if plan:
                # The serve-phase fault points on the decode-step clock:
                # poison, swap, signal (decode_stall is consumed inside
                # the engine's watched fetch).
                nstep = eng.decode_steps + 1
                bad_slot = plan.take_slot_nan(nstep)
                if bad_slot is not None:
                    if bad_slot not in live:
                        # The drill wants a serving slot; the named one is
                        # empty (its next prefill would overwrite the
                        # poison), so the lowest live slot takes it.
                        bad_slot = min(live)
                    eng.poison_slot(bad_slot)
                if plan.take_reload(nstep):
                    self._swap(now, recovery_ts)
                plan.maybe_signal(nstep)
            # The dispatch's wall for the decode-stall detector (the
            # dispatch and its watched fetch; admission excluded).
            t_disp = self.clock() if hub is not None else 0.0
            # One dispatch, one host fetch: speculative when armed. fb,
            # the verify plan: None = the whole batch's plain step, [] =
            # a full verify, a list = a mixed dispatch (those slots take
            # the plain path inside the verify). An engine without
            # verify_fallback_slots (the tests' fakes) is all or nothing
            # by can_verify.
            fb = None
            if spec is not None:
                fb_fn = getattr(eng, "verify_fallback_slots", None)
                if fb_fn is not None:
                    fb = fb_fn()
                elif getattr(eng, "can_verify", lambda: False)():
                    fb = []
            if fb is not None:
                # Histories (prompt + tokens, host work a step) only for
                # a proposer that reads them.
                hists = ({s: [int(t) for t in lv.req.prompt] + lv.tokens
                          for s, lv in live.items()}
                         if getattr(spec, "needs_histories", True)
                         else {s: () for s in live})
                props = spec.propose(hists)
                if fb:
                    tails = {s: [int(t) for t in live[s].req.prompt]
                             + live[s].tokens for s in fb}
                    toks, acc = eng.verify_step(props, tails=tails)
                else:
                    toks, acc = eng.verify_step(props)
                fb_set = set(getattr(eng, "last_verify_fallback", fb))
                emitted = {s: [int(t) for t in toks[s, :acc[s]]]
                           for s in live}
                spec_live = [s for s in live if s not in fb_set]
                spec_stats["verify_steps"] += 1
                spec_stats["proposed"] += eng.spec_tokens * len(spec_live)
                spec_stats["accepted"] += int(sum(acc[s] - 1
                                                  for s in spec_live))
                spec_stats["fallback_slots"] += len(fb_set & set(live))
                spec.sync_from(eng)
            else:
                nxt = eng.step()
                emitted = {s: [int(nxt[s])] for s in live}
                if spec is not None:
                    spec_stats["batch_fallbacks"] += 1
                    spec.sync_from(eng)
            tally["occ_sum"] += eng.occupancy()
            tally["steps"] += 1
            if hub is not None:
                hub.observe_decode_step(
                    tally["steps"], queue_depth=len(queue),
                    step_wall_ms=1e3 * (self.clock() - t_disp))
            if queue and (eng.free_slots() or slo_preempt):
                # The starvation clock: a step taken while the request
                # the policy would admit waited with a free slot. Under
                # slo with preemption a full engine counts too (else the
                # admission that filled the last slot would freeze the
                # clock and preemption could never trigger).
                steps_since_admit += 1
                waited[queue[self._pick_index(queue, tenant_tokens)].rid] += 1
            # Containment before retirement: a flagged slot's tokens are
            # garbage, dropped here (never retired, never journaled); its
            # continuation derives them again.
            for slot in getattr(eng, "take_bad_slots", lambda: [])():
                if slot in live:
                    quarantine(live[slot])
            for slot in list(live):
                lv = live[slot]
                for tok in emitted[slot]:
                    # A chain may run past the budget or an EOS: only the
                    # tokens up to either are retired.
                    if retire(lv, tok):
                        break
            if journal is not None:
                journal.flush()
            # Live observability, on the decode-step clock.
            rate_win.append((now(), tally["decoded"]))
            if spec is not None:
                spec_win.append((now(), spec_stats["accepted"],
                                 spec_stats["proposed"]))
            if tracer is not None:
                counters = {"slots": eng.occupancy(),
                            "queue": float(len(queue))}
                rate = self._window_rate()
                if rate is not None:
                    counters["tokens_per_s"] = round(rate, 2)
                if spec is not None and spec_stats["proposed"]:
                    counters["accept_rate"] = round(
                        spec_stats["accepted"] / spec_stats["proposed"], 4)
                tracer.counters(**counters)
            if slo is not None:
                slo.on_step(tally["steps"])
            if (self.status_fn is not None and self.status_every > 0
                    and tally["steps"] % self.status_every == 0):
                self.status_fn(self.status_line())
            self._maybe_export()

        wall = now()
        total = sum(len(c.tokens) for c in done)
        decoded = sum(c.decoded or len(c.tokens) for c in done)
        self.summary = {
            "requests": len(done),
            "total_new_tokens": total,
            "decoded_tokens": decoded,
            "wall_s": round(wall, 4),
            "tokens_per_sec": round(decoded / max(wall, 1e-9), 2),
            "mean_slot_occupancy": round(
                tally["occ_sum"] / max(1, tally["steps"]), 4),
            "decode_steps": tally["steps"],
            "prefills": eng.prefills,
            "prefill_compiles": eng.prefill_compiles,
            "buckets": ",".join(str(b) for b in eng.buckets),
            "num_slots": eng.num_slots,
            "decode_priority": self.decode_priority,
            "policy": self.policy,
            "preemptions": sum(preempts.values()),
            "retries": total_retries,
            "swaps": getattr(eng, "swaps", 0),
            "swap_seconds": round(self._swap_seconds, 4),
            **self._capacity_fields(),
            **self.summary_extra,
        }
        if spec is not None:
            self.summary.update(
                spec_tokens=getattr(eng, "spec_tokens", 0),
                verify_steps=spec_stats["verify_steps"],
                spec_proposed=spec_stats["proposed"],
                spec_accepted=spec_stats["accepted"],
                spec_fallback_slots=spec_stats["fallback_slots"],
                spec_batch_fallbacks=spec_stats["batch_fallbacks"],
                accept_rate=round(spec_stats["accepted"]
                                  / max(1, spec_stats["proposed"]), 4))
        if slo is not None:
            self.summary.update(slo.summary())
        if hub is not None:
            self.summary["anomalies"] = hub.count
        if paged:
            # The pool's occupancy, the prefix hit rate, evictions and
            # copies on write.
            self.summary.update(eng.paging_stats())
        self._emit("serve_summary", **self.summary)
        # One final snapshot covering every completion, so the export's
        # last point agrees with the summary's per-class percentiles.
        if self.export_every or self.export_path:
            self._maybe_export(force=True)
        if journal is not None:
            journal.flush()
        return done

    def _capacity_fields(self) -> Dict:
        """The cache's capacity facts, per device (JAX's): a
        tensor-parallel replica's cache is cut on its head axis, so a
        device holds 1/tp_width of the whole cache's bytes. An engine
        without these attributes (the tests' fakes) reports width 1 and
        no bytes."""
        out = {"tp_width": int(getattr(self.engine, "tp_width", 1))}
        bps = getattr(self.engine, "cache_bytes_per_slot", None)
        if callable(bps):
            out["per_device_cache_bytes"] = int(
                bps() * getattr(self.engine, "num_slots", 0))
        return out

    # -- the rolling metrics export ----------------------------------------

    def _window_rate(self) -> Optional[float]:
        """Decoded tokens/s over the rolling window (None until two
        samples exist)."""
        st = self._snap_state
        if st is None or len(st["rate_win"]) < 2:
            return None
        (ta, da), (tb, db) = st["rate_win"][0], st["rate_win"][-1]
        if tb <= ta:
            return None
        return (db - da) / (tb - ta)

    def _window_accept(self) -> Optional[float]:
        """The accept rate over the rolling window (None until the
        speculator has proposed inside it)."""
        st = self._snap_state
        if st is None or len(st["spec_win"]) < 2:
            return None
        a, b = st["spec_win"][0], st["spec_win"][-1]
        dp = b[2] - a[2]
        if dp <= 0:
            return None
        return (b[1] - a[1]) / dp

    def metrics_snapshot(self) -> Dict[str, Any]:
        """A point-in-time view of the serving engine, JSON-able scalars
        only: the payload a fleet router polls (``export_path``).
        Callable between decode steps and after :meth:`run` returns. The
        per-class TTFT percentiles are nearest-rank, as the summary's."""
        st = self._snap_state
        if st is None:
            raise RuntimeError(
                "metrics_snapshot() is available once run() has "
                "started")
        tally = st["tally"]
        now = self.clock() - st["t0"]
        self._snap_seq += 1
        snap: Dict[str, Any] = {
            # The liveness triplet: a monotonic seq, the wall clock and
            # the pid tell a frozen snapshot from an idle replica, and a
            # restarted process from the one it replaced.
            "seq": self._snap_seq,
            "wall_ts": round(time.time(), 3),
            "pid": os.getpid(),
            "t_s": round(now, 4),
            "decode_steps": tally["steps"],
            "requests_done": len(st["done"]),
            "requests_live": len(st["live"]),
            "queue_depth": len(st["queue"]),
            "pending_arrivals": len(st["pending"]),
            "slot_occupancy": round(self.engine.occupancy(), 4),
            "mean_slot_occupancy": round(
                tally["occ_sum"] / max(1, tally["steps"]), 4),
            "decoded_tokens": tally["decoded"],
            "tokens_per_sec": round(tally["decoded"] / max(now, 1e-9), 2),
            "retries": sum(st["retries_map"].values()),
            "preemptions": sum(st["preempts_map"].values()),
            "swaps": getattr(self.engine, "swaps", 0),
            "policy": self.policy,
            # Capacity facts a router pre-checks a dispatch against.
            "num_slots": getattr(self.engine, "num_slots", 0),
            "max_len": getattr(self.engine, "max_len", 0),
        }
        snap.update(self._capacity_fields())
        if self.served_ckpt_step is not None:
            # The fleet controller's staleness feed.
            snap["ckpt_step"] = int(self.served_ckpt_step)
        if self.draining:
            snap["draining"] = True
        rate = self._window_rate()
        if rate is not None:
            snap["tokens_per_sec_window"] = round(rate, 2)
        spec_stats = st["spec_stats"]
        if self.speculator is not None and spec_stats["proposed"]:
            snap["accept_rate"] = round(
                spec_stats["accepted"] / spec_stats["proposed"], 4)
            snap["spec_tokens"] = int(
                getattr(self.engine, "spec_tokens", 0) or 0)
        aw = self._window_accept()
        if aw is not None:
            snap["accept_rate_window"] = round(aw, 4)
        by_cls: Dict[str, List[float]] = {}
        for c in st["done"]:
            by_cls.setdefault(c.slo, []).append(1e3 * c.ttft_s)
        for cls, vals in sorted(by_cls.items()):
            vals.sort()
            snap[f"ttft_ms_p50_{cls}"] = round(percentile(vals, 50), 3)
            snap[f"ttft_ms_p95_{cls}"] = round(percentile(vals, 95), 3)
        pstats = getattr(self.engine, "paging_stats", None)
        if pstats is not None:
            snap.update(pstats())
        lag_stats = getattr(self.feed, "lag_stats", None)
        if lag_stats is not None:
            # The inbox's poll lag (a fleet replica): the router's write
            # to this replica's intake.
            snap.update(lag_stats())
        if self.slo_monitor is not None:
            snap["slo"] = self.slo_monitor.snapshot()
        if self.anomaly_hub is not None:
            snap["anomaly"] = self.anomaly_hub.snapshot()
        return snap

    def _maybe_export(self, force: bool = False) -> None:
        """On the export cadence (or forced at the run's end): one
        ``metrics_snapshot`` record through the registry and an atomic
        rewrite of ``export_path`` (a poller never reads a torn file). A
        ``hold_export`` command freezes the cadence's exports (the
        stale-snapshot drill), not a forced one."""
        if not force and not self.export_every:
            return
        now = self.clock()
        if not force and now - self._last_export < self.export_every:
            return
        if not force and now < self._export_hold_until:
            return
        self._last_export = now
        snap = self.metrics_snapshot()
        self._emit("metrics_snapshot", **snap)
        if self.export_path:
            atomic_write_json(self.export_path, snap)

    def status_line(self) -> str:
        """The periodic one-line live status: occupancy, queue depth,
        throughput and, with the SLO monitor, each target's window
        percentile and budget burn."""
        snap = self.metrics_snapshot()
        rate = snap.get("tokens_per_sec_window",
                        snap.get("tokens_per_sec", 0.0))
        line = (f"[serve] step={snap['decode_steps']} "
                f"occ={snap['slot_occupancy']:.2f} "
                f"queue={snap['queue_depth']} "
                f"done={snap['requests_done']} "
                f"tok/s={rate:.1f}")
        if self.slo_monitor is not None:
            line += " | " + self.slo_monitor.status_bits()
        return line

    def _swap(self, now, recovery_ts: List[float]) -> None:
        """One live weight swap: new weights from ``reload_fn`` (the
        newest verifiable checkpoint), copied in by the engine between
        decode steps; the latency is summed into ``swap_seconds`` and the
        served checkpoint step follows."""
        if self.reload_fn is None:
            raise ValueError(
                "fault plan requests a reload but no reload_fn is "
                "wired (mode=serve needs --checkpoint-dir for live "
                "weight swap)")
        t0 = self.clock()
        params, ckpt_step = self.reload_fn()
        self.engine.swap_params(params)
        dt = self.clock() - t0
        self._swap_seconds += dt
        self.served_ckpt_step = ckpt_step
        t = now()
        recovery_ts.append(t)
        self._recovery(kind="weight_swap", seconds=round(dt, 4),
                       ckpt_step=ckpt_step, t_s=round(t, 4))
        if self.tracer is not None:
            self.tracer.instant("weight_swap", seconds=round(dt, 4),
                                ckpt_step=ckpt_step)

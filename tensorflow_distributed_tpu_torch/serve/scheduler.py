"""Admission and prefill/decode interleaving for the slot engine: the
port of ``serve/scheduler.py``'s FIFO policy.

Policy: **decode priority with a starvation bound**. Decoding a full
batch is the throughput-optimal steady state, so the scheduler keeps
stepping while requests wait; but a queued request with a free slot is
admitted after at most ``decode_priority`` decode steps (the starvation
clock ticks only while both hold: someone waits and a slot is free). An
idle engine admits at once. Requests become visible at their
``arrival_s`` offset and are admitted in arrival order.

Termination is per request (its EOS id, or its ``max_new_tokens``
budget; a budget of 1 or an EOS as the first token finish at
admission), tokens stream to the host as they retire (``on_token``),
and each finished request reports its time to first token, decode time
and mean inter-token latency.

Over the paged engine (``serve/paging/engine.py``, ``engine.paged``) the
scheduler passes each admission its budget and ``session``, releases a
finished request through ``engine.release`` with its prompt and tokens
(they feed the prefix cache and the session store), defers admission
while ``engine.can_admit`` is False and live slots will free pages (an
idle engine that still cannot admit raises), admits a session's turns in
order (a turn waits until the earlier ones finished), and folds
``engine.paging_stats()`` into the summary.

``clock`` is injectable so that tests can drive this scheduler and the
JAX one on one fake clock. The JAX scheduler's other policies and layers
(the ``slo`` policy, tenant quotas, preemption, speculation, fault
plans, slot retry, the journal, the fleet inbox, the autopilot's tune
commands and the metrics export) are not ported yet: passing any of
them is refused.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One inference request. ``arrival_s`` is the open-loop offset
    (seconds from run start) at which the scheduler sees it."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int = -1          # -1 = run to the full budget
    arrival_s: float = 0.0
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

    @property
    def tok_ms(self) -> float:
        """Mean inter-token latency (ms) over the decode phase."""
        return 1e3 * self.decode_s / max(1, len(self.tokens) - 1)


@dataclasses.dataclass
class _Live:
    req: Request
    slot: int
    tokens: List[int]
    t_first: float
    queue_steps: int


class Scheduler:
    """Drives a :class:`~.engine.SlotDecodeEngine` over a workload."""

    def __init__(self, engine, decode_priority: int = 8,
                 on_token: Optional[Callable[[int, int, bool], None]] = None,
                 clock=time.perf_counter, policy: str = "fifo",
                 summary_extra=None, **unported):
        if unported:
            raise NotImplementedError(
                f"Scheduler({', '.join(sorted(unported))}) is not ported "
                f"to PyTorch yet (see ROADMAP.md queue A)")
        if decode_priority < 1:
            raise ValueError(
                f"decode_priority must be >= 1, got {decode_priority}")
        if policy not in ("fifo", "slo"):
            raise ValueError(
                f"unknown policy {policy!r}; have ('fifo', 'slo')")
        if policy != "fifo":
            raise NotImplementedError(
                "the slo scheduling policy is not ported to PyTorch yet "
                "(see ROADMAP.md queue A)")
        self.engine = engine
        self.decode_priority = decode_priority
        self.on_token = on_token
        self.clock = clock
        self.policy = policy
        self.summary_extra = dict(summary_extra or {})
        self.summary: Dict = {}

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
        """Serve every request to completion; returns completions in
        finish order (sort by ``rid`` for submission order)."""
        eng = self.engine
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
        live: Dict[int, _Live] = {}           # slot -> _Live
        done: List[Completion] = []
        t0 = self.clock()
        steps_since_admit = steps = 0
        occ_sum = 0.0
        paged = getattr(eng, "paged", False)
        # Turn order binds only where some request has a session.
        has_sessions = any(r.session for r in requests)

        def now() -> float:
            return self.clock() - t0

        def emit(rid: int, tok: int, last: bool) -> None:
            if self.on_token is not None:
                self.on_token(rid, tok, last)

        def finish(lv: _Live, why: str) -> None:
            t = now()
            if paged:
                # The request's whole sequence feeds the prefix cache and
                # its session.
                eng.release(lv.slot, tokens=[int(x) for x in lv.req.prompt]
                            + lv.tokens, session=lv.req.session)
            else:
                eng.free(lv.slot)
            del live[lv.slot]
            done.append(Completion(
                rid=lv.req.rid, prompt_len=len(lv.req.prompt),
                tokens=lv.tokens, finish=why,
                ttft_s=lv.t_first - lv.req.arrival_s,
                decode_s=t - lv.t_first, queue_steps=lv.queue_steps))
            emit(lv.req.rid, lv.tokens[-1], True)

        def retire(lv: _Live, tok: int) -> None:
            lv.tokens.append(tok)
            if tok == lv.req.eos_id:
                finish(lv, "eos")
            elif len(lv.tokens) >= lv.req.max_new_tokens:
                finish(lv, "length")
            else:
                emit(lv.req.rid, tok, False)

        def admit(req: Request) -> None:
            slot = eng.free_slots()[0]
            if paged:
                # The budget sizes the page reservation; the session keys
                # the conversation's re-attach.
                first = eng.prefill(req.prompt, slot,
                                    max_new_tokens=req.max_new_tokens,
                                    session=req.session)
            else:
                first = eng.prefill(req.prompt, slot)
            lv = _Live(req=req, slot=slot, tokens=[], t_first=now(),
                       queue_steps=waited.pop(req.rid))
            live[slot] = lv
            retire(lv, first)

        while pending or queue or live:
            while pending and pending[0].arrival_s <= now():
                req = pending.popleft()
                waited[req.rid] = 0
                queue.append(req)
            if queue and eng.free_slots() and (
                    not live or steps_since_admit >= self.decode_priority):
                blocked = (self._session_blocked(pending, queue, live)
                           if has_sessions else frozenset())
                pick = next((i for i, r in enumerate(queue)
                             if r.rid not in blocked), -1)
                if pick >= 0:
                    head = queue[pick]
                    # Page-pool pressure (paged engine): while live slots
                    # hold the shortfall, keep decoding; they free pages
                    # as they finish.
                    if not paged or eng.can_admit(len(head.prompt),
                                                  head.max_new_tokens):
                        admit(queue.pop(pick))
                        steps_since_admit = 0
                        continue
                    if not live:
                        raise RuntimeError(
                            f"request {head.rid}: page pool cannot hold its "
                            f"reservation even with the engine idle and "
                            f"the prefix cache fully evicted — raise "
                            f"--serve.num-pages (or lower the request "
                            f"budget)")
            if not live:
                if not pending:
                    break
                # Nothing to decode and nothing admittable: sleep to the
                # next arrival instead of spinning.
                time.sleep(max(0.0, pending[0].arrival_s - now()))
                continue
            nxt = eng.step()
            occ_sum += eng.occupancy()
            steps += 1
            if queue and eng.free_slots():
                # The starvation clock: a step taken while the head of
                # the queue waited with a free slot.
                steps_since_admit += 1
                waited[queue[0].rid] += 1
            for slot in list(live):
                retire(live[slot], int(nxt[slot]))

        wall = now()
        total = sum(len(c.tokens) for c in done)
        self.summary = {
            "requests": len(done),
            "total_new_tokens": total,
            "decoded_tokens": total,
            "wall_s": round(wall, 4),
            "tokens_per_sec": round(total / max(wall, 1e-9), 2),
            "mean_slot_occupancy": round(occ_sum / max(1, steps), 4),
            "decode_steps": steps,
            "prefills": eng.prefills,
            "prefill_compiles": eng.prefill_compiles,
            "buckets": ",".join(str(b) for b in eng.buckets),
            "num_slots": eng.num_slots,
            "decode_priority": self.decode_priority,
            "policy": self.policy,
            **self.summary_extra,
        }
        if paged:
            # The pool's occupancy, the prefix hit rate, evictions and
            # copies on write.
            self.summary.update(eng.paging_stats())
        return done

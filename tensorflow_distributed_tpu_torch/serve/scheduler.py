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

        def now() -> float:
            return self.clock() - t0

        def emit(rid: int, tok: int, last: bool) -> None:
            if self.on_token is not None:
                self.on_token(rid, tok, last)

        def finish(lv: _Live, why: str) -> None:
            t = now()
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
                admit(queue.pop(0))
                steps_since_admit = 0
                continue
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
        return done

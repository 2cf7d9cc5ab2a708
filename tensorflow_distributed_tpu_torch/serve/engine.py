"""Slot-based continuous-batching decode engine: the port of
``serve/engine.py``'s ``SlotDecodeEngine`` in its dense layout.

The engine owns one [num_slots, max_len, nk, Dh] K and V cache per
layer (a :class:`~..models.transformer.KVCache`; nk = H, or the K/V
heads under GQA; int8 with f32 scales under ``kv_cache_quant="int8"``)
for its whole life. Slots are occupied and freed between steps, so the
request set changes while every shape stays fixed per (num_slots,
bucket):

- **prefill**: the prompt is padded to its bucket, ``prefill_cache``
  fills a fresh [1, max_len] cache row, the greedy first token is read
  at the TRUE last position, and the row replaces the slot's row
  wholesale (``KVCache.put_row``; a stale row is never written into);
- **step**: one ``decode_token`` over every slot at its own depth
  (per-row positions), then one fetch of the [num_slots] argmax;
- **free**: host bookkeeping only. A freed slot keeps riding the batched
  step, writing into its own row at position 0 with one column visible:
  garbage that the next prefill's row replaces and that no other row can
  attend;
- **verify** (``spec_tokens`` k > 0, serve/speculate.py): each slot's
  pending token and its k proposals in one forward at positions
  ``pos .. pos + k``, the argmax at every fed position fetched once, the
  host's ``accept_length`` deciding how many of them a slot retires. A
  slot without ``pos + k + 1`` headroom is re-fed its own last k + 1
  tokens at ``pos - k .. pos`` inside the same forward (the plain path;
  ``verify_fallback_slots`` names such slots).

Greedy only: the contract is token identity with one-shot greedy
``generate()`` per request, speculation included.

Serving under faults (all optional): the step and the verify compute a
per-slot flag on the device, "the logits are all finite", and fetch it
in the same single device-to-host copy as the tokens
(``take_bad_slots``, the scheduler's quarantine signal); that fetch runs
under the decode watchdog when one is given, with a plan's
``decode_stall`` inside the watched region; ``poison_slot`` NaN-fills a
slot's cache row for the ``slot_nan`` drill; ``swap_params`` copies new
weights into the serving tensors in place between steps. The live
speculation-depth change is not ported yet (ROADMAP.md A8).

Tensor parallelism (``--serve.mesh-model N``; JAX's ``tp_width``): the
model is built with a ``tp`` transport, each rank holding H/N heads and
d_ff/N columns and its heads' slice of the cache (``KVCache.zeros`` at
the rank's heads), and the decode branch gathers the logits to the
whole vocabulary. ``cache_bytes_per_slot`` is per device: the whole
cache's divided by N. Every device op of the engine is a
``@replicated`` method taking host arguments: on the chief of a
multi-process replica (an engine with a ``channel``,
``serve/tp_replica.py``) the call is sent to the worker processes
before it runs, and each worker runs the same method on its shard.
Host decisions (slots, pages, tokens, quarantines) are the chief's:
the workers keep no bookkeeping of their own, the chief sends the page
tables it decided with the step and verify calls, and only the chief
reads a step's packed tokens and finiteness flags (a worker drops its
own). They are already the group's: every block's attention and MLP
output is all-reduced (``reduce_from_tp``) and the head's logits are
all-gathered, so every rank holds the same whole logits, and a NaN on
any rank's shard of the cache reaches them all.

The paged engine (``serve/paging/engine.py``) subclasses this one (its
model's ``zero_cache`` is the page pool) and overrides four hooks:
``_prefill_forward`` (a tail written through the slot's page table),
``_page_table`` (the device-resident tables the step and the verify
read), ``_warm_prefills`` and ``_warm_drills``.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.models.generate import (
    decode_token, prefill_cache)
from tensorflow_distributed_tpu_torch.models.transformer import KVCache
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    local_ranks)
from tensorflow_distributed_tpu_torch.serve.buckets import (
    default_buckets, pick_bucket)
from tensorflow_distributed_tpu_torch.serve.speculate import accept_length


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (see ROADMAP.md queue A)")


def _host(packed: torch.Tensor, stream) -> np.ndarray:
    """The one device-to-host copy of a step: ``packed`` (the tokens and
    the finiteness flags in one int64 tensor) to a numpy array. It may
    run on the watchdog's worker thread, whose current stream is not the
    dispatching thread's: ``stream`` (the stream the step was queued
    on; None on the CPU) orders the copy after the step."""
    if stream is None:
        return packed.numpy()
    with torch.cuda.device(packed.device), torch.cuda.stream(stream):
        return packed.cpu().numpy()


def zero_cache(model, num_slots: int) -> KVCache:
    """A zeroed [num_slots, max_len, nk, Dh] decode cache for ``model``
    (with its scale leaves under int8; the pool for a paged config), on
    its device; under tensor parallelism at this process's ranks'
    heads."""
    device = next(model.parameters()).device
    return KVCache.zeros(model.cfg, num_slots, device,
                         getattr(model, "tp", None))


def replicated(fn):
    """A device op of the engine (host arguments in): on a tensor-parallel
    chief, whose engine has a ``channel``, the call is sent to the
    workers before it runs here (``serve/tp_replica.py``). A replicated
    op calls no other replicated op, so a worker runs each call once."""
    @functools.wraps(fn)
    def run(self, *args):
        if self.channel is not None:
            self.channel.send(fn.__name__, args)
        return fn(self, *args)

    return run


class SlotDecodeEngine:
    """The slot cache and its prefill and decode step, with host-side
    slot bookkeeping. The scheduler (``serve/scheduler.py``) decides
    when to prefill and when to decode; this class owns what runs on
    the device."""

    def __init__(self, model, num_slots: int,
                 buckets: Optional[Sequence[int]] = None,
                 min_bucket: int = 16, spec_tokens: int = 0,
                 fault_plan=None, watchdog=None, tracer=None):
        cfg = model.cfg
        if not cfg.causal:
            raise ValueError("SlotDecodeEngine needs a causal model")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        self.spec_tokens = spec_tokens
        self.model = model
        self.device = next(model.parameters()).device
        self.num_slots = num_slots
        self.max_len = cfg.max_len
        self.buckets: Tuple[int, ...] = (
            tuple(buckets) if buckets
            else default_buckets(cfg.max_len, min_bucket, cap=cfg.max_len))
        if max(self.buckets) > cfg.max_len:
            raise ValueError(
                f"largest bucket {max(self.buckets)} exceeds the model's "
                f"max_len {cfg.max_len}")
        self.cache = zero_cache(model, num_slots)
        self.tok = np.zeros((num_slots,), np.int64)
        self.pos = np.zeros((num_slots,), np.int64)
        self.active = np.zeros((num_slots,), bool)
        self._buckets_used: set = set()
        self.prefills = 0
        self.decode_steps = 0
        self.verify_steps = 0
        self.swaps = 0
        self._last_verify_fallback: list = []
        # Serving under faults (both optional): the plan's decode_stall
        # sleeps inside the watched token fetch, and _last_ok holds the
        # per-slot finiteness flags of the last step or verify.
        self.fault_plan = fault_plan
        self.watchdog = watchdog
        self._last_ok: Optional[np.ndarray] = None
        # Slots whose fetched flag said non-finite (the device's own
        # detection, counted where take_bad_slots hands them out).
        self.flagged_slots = 0
        # A tensor-parallel chief's link to its workers (serve/
        # tp_replica.py sets it); None on one process and on a worker.
        self.channel = None
        # The serve trace (observe/serve_trace.py): a decode or verify
        # step and a prefill each become a span on the host thread.
        self.tracer = tracer
        # The checkpoint step the weights were restored from (serve/
        # run.py's build_engine sets it; None for fresh-init weights).
        self.restored_step: Optional[int] = None

    def _span(self, name: str, **args):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.engine_span(name, **args)

    @property
    def tp_width(self) -> int:
        """The model's tensor-parallel width (1 without ``tp``)."""
        tp = getattr(self.model, "tp", None)
        return 1 if tp is None else tp.size

    def cache_bytes_per_slot(self) -> int:
        """Device memory the decode cache spends per slot on ONE device
        (the scale leaves of an int8 cache included): under tensor
        parallelism every leaf is cut on its head axis, so a device
        holds 1/tp_width of the whole cache's bytes, exactly."""
        return self.cache.nbytes() // (
            self.num_slots * local_ranks(getattr(self.model, "tp", None)))

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run (one per bucket used); the JAX
        engine compiles one program for each."""
        return len(self._buckets_used)

    @torch.no_grad()
    def warmup(self, speculator=None) -> None:
        """Run each bucket's prefill, a decode step and, with
        ``spec_tokens``, a verify (each with its finiteness flag), and the
        fire drills' device work against throwaway inputs, then zero the
        cache again: first-call costs (library handles, the allocator's
        growth) move to start-up instead of the first requests' time to
        first token. Host bookkeeping is untouched, so a warmed engine
        equals a fresh one. A ``speculator``'s own ``warmup`` (a draft
        model's mirror) runs after."""
        self._warm_device()
        if speculator is not None:
            speculator.warmup()

    @replicated
    def _warm_device(self) -> None:
        self._warm_prefills()
        self._pack(self._dispatch_step(self._h2d(self.tok),
                                       self._h2d(self.pos)))
        if self.spec_tokens:
            zeros = np.zeros((self.num_slots, self.spec_tokens + 1), np.int64)
            self._pack(self._dispatch_verify(self._h2d(zeros),
                                             self._h2d(zeros[:, 0])))
        self._warm_drills()
        self.cache.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_prefills(self) -> None:
        """Each bucket's prefill and a row insert into slot 0."""
        for b in self.buckets:
            _, row = prefill_cache(
                self.model, torch.zeros((1, b), dtype=torch.long,
                                        device=self.device))
            self.cache.put_row(row, 0)

    def _warm_drills(self) -> None:
        """The fire drills' device work against throwaway state (the
        paged engine's poison and scrub; the dense poison is a fill)."""

    def free_slots(self):
        return [s for s in range(self.num_slots) if not self.active[s]]

    def occupancy(self) -> float:
        return float(self.active.sum()) / self.num_slots

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Would this request's whole trajectory fit the cache? Without
        speculative slack, as in JAX: a tight cache still serves every
        request, the slots short of verify headroom taking the plain
        path (``verify_fallback_slots``); serve/run.py sizes the default
        cache with ``spec_tokens`` of slack so that this stays rare."""
        return (prompt_len <= max(self.buckets)
                and prompt_len + max_new_tokens <= self.max_len)

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admission(self, prompt, slot: int) -> np.ndarray:
        """The prompt as a flat int64 array, after the checks every
        engine makes."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if self.active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        return prompt

    def _prefill_tail(self, tail: np.ndarray, start: int, slot: int
                      ) -> Tuple[int, int]:
        """The bucketed prefill body: ``tail`` padded to its bucket runs
        at positions ``start ..`` into ``slot``'s cache; returns (greedy
        first token from the TRUE last position, bucket)."""
        bucket = pick_bucket(len(tail), self.buckets)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(tail)] = tail
        self._buckets_used.add(bucket)
        logits = self._prefill_device(padded, start, slot,
                                      self._slot_table(slot))
        # The time-to-first-token point: one scalar per admission.
        return int(logits[0, len(tail) - 1].argmax()), bucket

    def _slot_table(self, slot: int) -> Optional[np.ndarray]:
        """The page table row a prefill into ``slot`` writes through
        (the paged engine's); None for the dense cache."""
        return None

    @replicated
    def _prefill_device(self, padded: np.ndarray, start: int, slot: int,
                        table: Optional[np.ndarray]) -> torch.Tensor:
        return self._prefill_forward(self._h2d(padded), start, slot, table)

    def _prefill_forward(self, padded: torch.Tensor, start: int, slot: int,
                         table: Optional[np.ndarray]) -> torch.Tensor:
        """A fresh [1, max_len] row prefilled from position 0, replacing
        the slot's row wholesale (the dense engine admits at 0 only)."""
        logits, row = prefill_cache(self.model, padded)
        self.cache.put_row(row, slot)
        return logits

    def _activate(self, slot: int, first: int, plen: int) -> None:
        self.tok[slot] = first
        self.pos[slot] = plen
        self.active[slot] = True
        self.prefills += 1

    @torch.no_grad()
    def prefill(self, prompt, slot: int) -> int:
        """Admit a request into ``slot``: bucketed prefill, row insert,
        greedy first token. Returns the first generated token."""
        prompt = self._admission(prompt, slot)
        with self._span(f"prefill_b{pick_bucket(len(prompt), self.buckets)}",
                        slot=slot, prompt_len=len(prompt)):
            first, _ = self._prefill_tail(prompt, 0, slot)
        self._activate(slot, first, len(prompt))
        return first

    def _page_table(self) -> Optional[torch.Tensor]:
        """The page tables the step and the verify read (the paged
        engine's); None for the dense cache."""
        return None

    def _tables_arg(self) -> Optional[np.ndarray]:
        """The page tables a step or a verify sends to the workers when
        they changed since the last upload (the paged engine's); None
        otherwise."""
        return None

    @replicated
    def _step_device(self, tok: np.ndarray, pos: np.ndarray,
                     tables: Optional[np.ndarray]) -> torch.Tensor:
        self._set_tables(tables)
        return self._pack(self._dispatch_step(self._h2d(tok),
                                              self._h2d(pos)))

    @replicated
    def _verify_device(self, toks: np.ndarray, start: np.ndarray,
                       tables: Optional[np.ndarray]) -> torch.Tensor:
        self._set_tables(tables)
        return self._pack(self._dispatch_verify(self._h2d(toks),
                                                self._h2d(start)))

    def _set_tables(self, tables: Optional[np.ndarray]) -> None:
        """Adopt the chief's page tables (the paged engine's)."""

    def _dispatch_step(self, tok: torch.Tensor, pos: torch.Tensor
                       ) -> torch.Tensor:
        """One decode step over every slot; the last-position logits
        [num_slots, V]."""
        return decode_token(self.model, self.cache, tok, pos,
                            self._page_table())[0]

    @torch.no_grad()
    def step(self) -> np.ndarray:
        """One decode step over every slot; returns the [num_slots]
        next-token array (entries of inactive slots are garbage the
        scheduler never reads)."""
        if (self.pos[self.active] >= self.max_len).any():
            raise RuntimeError(
                "an active slot is at max_len: the scheduler admitted a "
                "request that cannot fit (fits() is the guard)")
        with self._span("decode_step", live=int(self.active.sum())):
            packed = self._step_device(self.tok, self.pos,
                                       self._tables_arg())
            # The engine's output: one [num_slots, 2] fetch a step (the
            # tokens and the finiteness flags) drives EOS/budget
            # termination, streaming and NaN containment.
            nxt, self._last_ok = self._fetch(packed)
        act = self.active
        self.tok[act] = nxt[act]
        self.pos[act] += 1
        self.decode_steps += 1
        return nxt

    def free(self, slot: int) -> None:
        """Release a slot (host bookkeeping only; the next prefill
        replaces the row wholesale)."""
        self.active[slot] = False
        self.tok[slot] = 0
        self.pos[slot] = 0

    # -- speculation ---------------------------------------------------

    def can_verify(self) -> bool:
        """Every active slot has verify write headroom (``pos + k + 1 <=
        max_len``)."""
        if not self.spec_tokens:
            return False
        act = self.active
        return bool((self.pos[act] + self.spec_tokens + 1
                     <= self.max_len).all())

    def verify_fallback_slots(self) -> Optional[list]:
        """The active slots without verify write headroom this
        iteration: ``None`` = no verify at all (``spec_tokens`` off, or
        a tight slot too shallow to re-feed k tokens: the scheduler takes
        the whole batch's plain step); ``[]`` = a full verify; a list =
        a mixed dispatch, those slots taking the plain path inside the
        verify (``verify_step``'s ``tails``) while the others
        speculate."""
        if not self.spec_tokens:
            return None
        k = self.spec_tokens
        out = []
        for s in range(self.num_slots):
            if not self.active[s] or self.pos[s] + k + 1 <= self.max_len:
                continue
            if self.pos[s] < k:
                # Only where max_len < ~2k (a tiny pinned cache): the
                # whole batch steps plainly.
                return None
            out.append(s)
        return out

    @staticmethod
    def _pack(logits: torch.Tensor) -> torch.Tensor:
        """The greedy tokens at every position of ``logits`` [S, V] or
        [S, k + 1, V], and a last column of per-slot flags, 1 where the
        slot's logits are all finite: one int64 tensor, [S, 2] or
        [S, k + 2], so that tokens and flags reach the host in one
        copy. A slot's largest magnitude is below inf exactly when its
        logits are all finite (``amax`` carries a NaN through): three
        launches, where ``isfinite(...).all()`` takes five, and unlike a
        sum it cannot overflow on finite logits."""
        if logits.ndim == 2:
            logits = logits[:, None]
        ok = logits.abs().amax(dim=(1, 2)).lt(math.inf)
        return torch.cat([logits.argmax(dim=-1), ok[:, None].long()], dim=1)

    def _fetch(self, packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Copy a packed step to the host, under the decode watchdog when
        it has a timeout, with the plan's decode_stall inside the watched
        region; returns (tokens, per-slot finite flags)."""
        step_no = self.decode_steps + 1
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def fetch():
            # An injected stall sleeps here, inside the watched region,
            # where a wedged device would hold the copy.
            if self.fault_plan:
                self.fault_plan.decode_stall_sleep(step_no)
            return _host(packed, stream)

        wd = self.watchdog
        if wd is not None and wd.sync_timeout_s > 0:
            out = wd.decode(fetch, step_no)
        else:
            out = fetch()
        toks = out[:, :-1]
        return (toks[:, 0] if toks.shape[1] == 1 else toks,
                out[:, -1].astype(bool))

    def _dispatch_verify(self, toks: torch.Tensor, start: torch.Tensor
                         ) -> torch.Tensor:
        """One verify forward: ``toks`` [num_slots, k + 1] at positions
        ``start .. start + k`` a row; the logits [num_slots, k + 1, V]."""
        positions = start[:, None] + torch.arange(toks.shape[1],
                                                  device=self.device)
        return self.model(toks, decode=True, positions=positions,
                          cache=self.cache, page_table=self._page_table())

    @torch.no_grad()
    def verify_step(self, props, tails=None) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative decode step: verify ``props`` [num_slots, k]
        for every slot in one forward. Returns ``(toks, acc)``: ``toks``
        [num_slots, k + 1] the target's greedy chain at each fed position
        and ``acc[s]`` how many of its leading entries slot ``s`` retires
        (accepted proposals + the bonus); inactive rows are garbage the
        scheduler never reads. Rollback on reject is position
        bookkeeping: a rejected proposal's row lies past the slot's new
        position, and the next write covers it.

        ``tails``: for each slot that ``verify_fallback_slots`` named,
        its last ``k + 1`` history tokens (ending in the pending token).
        Such a slot is fed them at ``pos - k .. pos``: the K/V rewritten
        are those already cached (a position's K/V depend only on its
        token and the cache below it), and the argmax at the last fed
        position is the plain step's next token. It retires one token
        (``acc == 1``, in ``toks[s, 0]``); ``last_verify_fallback``
        lists these slots."""
        if not self.spec_tokens:
            raise RuntimeError(
                "verify_step needs the engine built with spec_tokens > 0")
        k = self.spec_tokens
        props = np.asarray(props, np.int64).reshape(self.num_slots, k)
        tails = dict(tails or {})
        fallback = []
        start = self.pos.copy()
        toks_in = np.concatenate([self.tok[:, None], props], axis=1)
        for s in range(self.num_slots):
            if not self.active[s] or self.pos[s] + k + 1 <= self.max_len:
                continue
            tail = tails.get(s)
            if tail is None or len(tail) < k + 1 or self.pos[s] < k:
                raise RuntimeError(
                    f"slot {s} lacks verify headroom and no usable tail "
                    f"was provided — verify_fallback_slots() is the guard "
                    f"(the scheduler supplies tails or falls back to "
                    f"step())")
            window = np.asarray(list(tail)[-(k + 1):], np.int64)
            if window[-1] != self.tok[s]:
                raise RuntimeError(
                    f"slot {s} fallback tail must end in the pending "
                    f"token {int(self.tok[s])}, got {int(window[-1])}")
            toks_in[s] = window
            start[s] = self.pos[s] - k
            fallback.append(s)
        with self._span("verify_step", live=int(self.active.sum()),
                        fallback=len(fallback)):
            packed = self._verify_device(toks_in, start,
                                         self._tables_arg())
            # The engine's output: one [num_slots, k + 2] fetch a
            # dispatch (the chain and the finiteness flags) drives
            # acceptance, streaming and NaN containment.
            nxt, self._last_ok = self._fetch(packed)
        acc = np.zeros((self.num_slots,), np.int32)
        for s in range(self.num_slots):
            if not self.active[s]:
                continue
            if s in fallback:
                # The plain path: the next token sits at the last fed
                # index; surface it where the scheduler reads retired
                # tokens (toks[s, :acc]).
                nxt[s, 0] = nxt[s, k]
                acc[s] = 1
                self.tok[s] = nxt[s, 0]
                self.pos[s] += 1
                continue
            a = accept_length(props[s], nxt[s])
            acc[s] = a + 1                       # + the bonus token
            self.tok[s] = nxt[s, a]
            self.pos[s] += a + 1
        self.decode_steps += 1
        self.verify_steps += 1
        self._last_verify_fallback = fallback
        return nxt, acc

    @property
    def last_verify_fallback(self) -> list:
        """The slots that took the plain path in the last verify (the
        scheduler leaves them out of the speculation counts)."""
        return list(self._last_verify_fallback)

    # -- serving under faults (the scheduler's surface) ----------------

    def take_bad_slots(self):
        """The active slots whose last step or verify produced
        non-finite logits: the containment signal the scheduler acts on
        (quarantine and re-prefill of only those slots). It reads the
        flags fetched with the tokens; no extra device work. Inactive
        rows are left out: a freed slot's stale row is garbage nobody
        reads, replaced by the next prefill."""
        if self._last_ok is None:
            return []
        bad = [s for s in range(self.num_slots)
               if self.active[s] and not self._last_ok[s]]
        self.flagged_slots += len(bad)
        return bad

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(
                f"slot_nan slot {slot} out of range [0, "
                f"{self.num_slots})")
        if not any(t.is_floating_point() for t in self.cache.leaves()):
            raise ValueError(
                "slot_nan: the decode cache has no float leaves to "
                "poison")

    @torch.no_grad()
    def poison_slot(self, slot: int) -> None:
        """The slot_nan drill: NaN-fill the float leaves of ``slot``'s
        cache row on the device (K and V; under int8 only the f32 scales
        are float, and a NaN scale makes the dequantized K and V NaN), so
        the next step's logits for that slot are non-finite through the
        real attention, not a spoofed flag. Under tensor parallelism
        every rank poisons its heads of the row."""
        self._check_slot(slot)
        self._poison_row(slot)

    @replicated
    def _poison_row(self, slot: int) -> None:
        for t in self.cache.leaves():
            if t.is_floating_point():
                t[slot].fill_(float("nan"))

    @torch.no_grad()
    def swap_params(self, new_params: Mapping[str, torch.Tensor]) -> None:
        """LIVE WEIGHT SWAP: copy ``new_params`` (the serving model's
        parameter names, e.g. ``train.checkpoint.restore_params``) into
        the serving tensors in place, between decode steps, without
        draining slots. Names, shapes, dtypes and devices must equal the
        serving tensors' (the JAX engine's contract: a drift would
        change what the decode step computes with). In place, because
        the tensors are shared: the paged engine's model holds the
        caller's, and so may a draft. The caches are untouched, so a
        swap to the same weights is token-identical."""
        live: Dict[str, torch.Tensor] = dict(self.model.named_parameters())
        if set(new_params) != set(live):
            raise ValueError(
                "live weight swap: new params tree structure differs "
                "from the serving params (different architecture?)")
        drift = [f"  {name}: {tuple(old.shape)}/{old.dtype} -> "
                 f"{tuple(new_params[name].shape)}/{new_params[name].dtype}"
                 for name, old in live.items()
                 if (new_params[name].shape != old.shape
                     or new_params[name].dtype != old.dtype)]
        if drift:
            raise ValueError(
                "live weight swap: leaf shape/dtype drift (the hot "
                "decode program would retrace):\n" + "\n".join(drift[:10]))
        moved = [f"  {name}: {old.device} -> {new_params[name].device}"
                 for name, old in live.items()
                 if new_params[name].device != old.device]
        if moved:
            raise ValueError(
                "live weight swap: leaf device drift (the serving "
                "tensors' device):\n" + "\n".join(moved[:10]))
        for name, old in live.items():
            old.copy_(new_params[name])
        self.swaps += 1

    def tell(self, name: str, *args) -> None:
        """Send the workers of a tensor-parallel chief one call that runs
        on them alone (a no-op on one process)."""
        if self.channel is not None:
            self.channel.send(name, args)

    def _reload(self, ckpt_dir: str, step: int) -> None:
        """A worker's half of a live weight swap: its ranks' slices of
        the checkpoint at ``step`` (the step its chief picked), swapped
        in."""
        from tensorflow_distributed_tpu_torch.train.checkpoint import (
            restore_params)

        self.swap_params(restore_params(ckpt_dir, self.model, step)[0])

    # -- the JAX engine's live-depth surface, not ported yet ------------

    def set_spec_k(self, k: int) -> None:
        raise _not_ported("the live speculation-depth change (set_spec_k)")

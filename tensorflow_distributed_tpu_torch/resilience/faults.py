"""Deterministic fault injection, the port of ``resilience/faults.py``:
the grammar whole, and the injection points of both phases.

A fault plan is a comma-separated list of ``kind@step[:arg]`` events,
e.g. ``"nan_grad@40,ckpt_io_fail@80:2,data_stall@120:5s,sigterm@200"``.
Under ``--mode train`` the step key counts train steps, and the loop
consults the plan where real faults strike:

- ``nan_grad@K``: NaN-fill the float arrays of step K's host batch
  before it is cut to this rank's block and copied to the device, so the
  loss and gradients of that step are non-finite through the real math.
  Only float arrays carry the poison (the CNN's images, an LM batch's
  loss mask); a batch of integers alone raises ValueError;
- ``ckpt_io_fail@K[:N]``: arm N (default 1) injected ``OSError``s in the
  checkpoint writer just before the cadence save at step K;
  ``train/checkpoint.py`` consumes them inside its retry loop;
- ``data_stall@K[:Ds]``: sleep D seconds (default 5) inside step K's
  batch fetch, inside the data watchdog's window;
- ``sigterm@K`` / ``sigkill@K``: self-signal when step K is dispatched
  (the preemption notice, or the hard kill);
- ``device_loss@K[:N]``: lose N cards (default 1) when step K is
  dispatched: the chief writes ``{"lost": N, "step": K}`` to the
  device-mask file under the checkpoint dir (``device_mask_path``;
  ``TFD_DEVICE_MASK_FILE`` overrides it), and the process dies by
  SIGKILL, as a card's loss gives no notice. Under more than one
  process every rank takes the fault at the same step and waits on a
  barrier after the chief's write, so no rank dies before the file is
  durable, then every rank SIGKILLs itself. The elastic supervisor
  (``supervisor --elastic``) reads the mask, picks the best mesh of the
  surviving cards and restarts onto it (its child hides the dead cards
  through ``TFD_DEVICE_MASK``: ``parallel/mesh.alive_devices``).

Under ``--mode serve`` the step key counts DECODE steps (the serving
engine's clock: serve/scheduler.py consults the plan between steps), and
the kinds are:

- ``decode_stall@K[:Ds]``: sleep D seconds (default 1) inside decode
  step K's token fetch, exactly where a wedged device shows; the decode
  watchdog (``--resilience.sync-timeout-s``) sees the hang and raises
  StallError instead of letting the engine freeze;
- ``slot_nan@K[:slot]``: NaN-poison one slot's KV cache (default slot 0)
  before decode step K, so that slot's logits are non-finite through the
  real attention; the engine's per-slot finiteness flag, computed on the
  device with the step's tokens, names it and the scheduler quarantines
  and re-prefills only that slot;
- ``reload@K``: a live weight swap before decode step K, from the newest
  verifiable checkpoint, between decode steps, without draining slots;
- ``sigterm@K`` / ``sigkill@K`` as in training.

Signal events and ``device_loss`` fire on the first leg only (``bind``): a resumed leg is
the recovery under test, and re-firing would kill it forever. Every
injection prints an ``{"event": "recovery", "kind": "fault_injected",
...}`` record on standard output. Events are one-shot per plan object,
so a rewind past an injected NaN does not poison the replayed step.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from tensorflow_distributed_tpu_torch.data.prefetch import map_batch
from tensorflow_distributed_tpu_torch.utils.atomicio import atomic_write_json
from tensorflow_distributed_tpu_torch.utils.logging import emit_event

KINDS = ("nan_grad", "ckpt_io_fail", "data_stall", "sigterm", "sigkill",
         "device_loss", "decode_stall", "slot_nan", "reload")
# Phase validity (config.validate rejects cross-phase plans at startup,
# so that a fault never sits silently unfired): signals fire in both
# phases, keyed on the phase's own step clock.
TRAIN_KINDS = ("nan_grad", "ckpt_io_fail", "data_stall", "sigterm",
               "sigkill", "device_loss")
SERVE_KINDS = ("decode_stall", "slot_nan", "reload", "sigterm",
               "sigkill")

# Where a device_loss drill records the lost-card count for the
# supervisor's next leg: under the run's checkpoint dir, the one path
# both processes share (TFD_DEVICE_MASK_FILE overrides it).
DEVICE_MASK_FILENAME = "DEVICE_MASK"


def device_mask_path(ckpt_dir: str) -> str:
    return os.environ.get("TFD_DEVICE_MASK_FILE") or os.path.join(
        ckpt_dir, DEVICE_MASK_FILENAME)


_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<step>\d+)(?::(?P<arg>[0-9.]+s?))?$")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    step: int
    arg: Optional[float] = None  # seconds for data_stall/decode_stall,
    #                              count for ckpt_io_fail/device_loss,
    #                              slot for slot_nan; None elsewhere


def parse_fault_plan(spec: str) -> "FaultPlan":
    """Parse ``kind@step[:arg]`` comma lists; raises ValueError naming
    the offending token on any syntax problem (config.validate calls
    this, so a bad plan dies at startup, not at step K)."""
    events: List[FaultEvent] = []
    for token in filter(None, (t.strip() for t in spec.split(","))):
        m = _EVENT_RE.match(token)
        if not m:
            raise ValueError(
                f"bad fault-plan token {token!r}: want kind@step[:arg] "
                f"(e.g. nan_grad@40, data_stall@120:5s)")
        kind, step = m.group("kind"), int(m.group("step"))
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {token!r}; have "
                f"{KINDS}")
        if step < 1:
            raise ValueError(f"fault step must be >= 1 in {token!r}")
        arg_s = m.group("arg")
        arg: Optional[float] = None
        if arg_s is not None:
            if kind in ("data_stall", "decode_stall"):
                arg = float(arg_s[:-1] if arg_s.endswith("s") else arg_s)
                if arg <= 0:
                    raise ValueError(
                        f"{kind} duration must be > 0 in {token!r}")
            elif kind == "slot_nan":
                arg = float(arg_s)
                if arg != int(arg) or arg < 0:
                    raise ValueError(
                        f"slot_nan slot must be a non-negative int "
                        f"in {token!r}")
            elif kind in ("ckpt_io_fail", "device_loss"):
                arg = float(arg_s)
                if arg != int(arg) or arg < 1:
                    raise ValueError(
                        f"{kind} count must be a positive int "
                        f"in {token!r}")
            else:
                raise ValueError(
                    f"fault kind {kind!r} takes no :arg ({token!r})")
        events.append(FaultEvent(kind, step, arg))
    return FaultPlan(events)


class FaultPlan:
    """One run's bound fault schedule. Falsy when empty, so that every
    hook can be skipped at no cost."""

    def __init__(self, events: List[FaultEvent] = ()):  # type: ignore[assignment]
        self._by_step: Dict[Tuple[str, int], FaultEvent] = {
            (e.kind, e.step): e for e in events}
        self._fired: set = set()
        self._start_step = 0

    def __bool__(self) -> bool:
        return bool(self._by_step)

    def kinds(self) -> set:
        """The distinct fault kinds of the plan (config.validate's phase
        check)."""
        return {kind for (kind, _step) in self._by_step}

    def bind(self, start_step: int) -> None:
        """Pin the leg's resume point: events at or before it are
        consumed (they happened on a previous leg), and signal events
        are suppressed on a resumed leg (the restart under test must
        terminate)."""
        self._start_step = start_step
        for key, ev in self._by_step.items():
            if ev.step <= start_step:
                self._fired.add(key)

    def _take(self, kind: str, step: int) -> Optional[FaultEvent]:
        key = (kind, step)
        ev = self._by_step.get(key)
        if ev is None or key in self._fired:
            return None
        self._fired.add(key)
        return ev

    # -- train-phase injection points (step = the train step; the loop
    #    calls these, and each is a no-op off the plan) ------------------
    def wrap_stream(self, stream: Iterator[Any],
                    start_step: int) -> Iterator[Any]:
        """Apply ``nan_grad`` to a task stream whose k-th batch feeds
        train step ``start_step + k``. The loop wraps the host stream,
        before the sequence block and the prefetch, so the poison takes
        the real path to the device. An empty plan returns the stream
        as it is."""
        if not self:
            return stream

        def gen():
            step = start_step
            for batch in stream:
                step += 1
                yield self.poison_batch(step, batch)

        return gen()

    def poison_batch(self, step: int, batch: Any) -> Any:
        """NaN-fill the float arrays of step ``step``'s host batch (a
        dict or tuple of numpy arrays)."""
        if self._take("nan_grad", step) is None:
            return batch
        poisoned = [0]

        def one(x):
            if (isinstance(x, np.ndarray)
                    and np.issubdtype(x.dtype, np.floating)):
                poisoned[0] += 1
                return np.full_like(x, np.nan)
            return x

        out = map_batch(one, batch)
        if not poisoned[0]:
            raise ValueError(
                f"fault nan_grad@{step}: batch has no float leaves to "
                f"poison (integer token streams can't produce a NaN "
                f"loss this way — use a float-input task)")
        emit_event("recovery", kind="fault_injected", fault="nan_grad",
                   step=step)
        return out

    def maybe_stall(self, step: int) -> None:
        """Sleep the injected stall inside the batch fetch (the data
        watchdog wraps this call, so its deadline sees it)."""
        ev = self._take("data_stall", step)
        if ev is not None:
            emit_event("recovery", kind="fault_injected",
                       fault="data_stall", step=step,
                       seconds=ev.arg or 5.0)
            time.sleep(ev.arg if ev.arg is not None else 5.0)

    def arm_checkpoint_faults(self, step: int) -> None:
        """Arm N injected write failures in train/checkpoint.py just
        before the cadence save at ``step``."""
        ev = self._take("ckpt_io_fail", step)
        if ev is not None:
            from tensorflow_distributed_tpu_torch.train import checkpoint
            n = int(ev.arg) if ev.arg is not None else 1
            emit_event("recovery", kind="fault_injected",
                       fault="ckpt_io_fail", step=step, failures=n)
            checkpoint.arm_io_fault(n)

    def maybe_signal(self, step: int) -> None:
        """Self-SIGTERM/SIGKILL at dispatch of ``step``: first leg only
        (see bind)."""
        if self._start_step > 0:
            return
        for kind, signum in (("sigterm", signal.SIGTERM),
                             ("sigkill", signal.SIGKILL)):
            if self._take(kind, step) is not None:
                emit_event("recovery", kind="fault_injected",
                           fault=kind, step=step)
                os.kill(os.getpid(), signum)

    def maybe_device_loss(self, step: int, ckpt_dir: str) -> None:
        """The card-loss drill at dispatch of ``step``: the chief writes
        the lost count to the mask file (fsync'd and renamed before the
        kill: the supervisor never reads a torn file) and every rank
        dies without notice. First leg only, as the signals."""
        if self._start_step > 0:
            return
        ev = self._take("device_loss", step)
        if ev is None:
            return
        import torch.distributed as dist

        lost = int(ev.arg) if ev.arg is not None else 1
        path = device_mask_path(ckpt_dir)
        emit_event("recovery", kind="fault_injected", fault="device_loss",
                   step=step, lost=lost, mask_file=path)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world == 1 or dist.get_rank() == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            atomic_write_json(path, {"lost": lost, "step": step})
        if world > 1:
            # On the host (a gloo group of the ranks): no rank dies, and
            # so no launcher tears the others down, before the chief's
            # file is durable.
            dist.barrier(group=dist.new_group(backend="gloo"))
        os.kill(os.getpid(), signal.SIGKILL)

    # -- serve-phase injection points (step = the engine's decode step;
    #    serve/scheduler.py consults these between steps, the engine
    #    consumes decode_stall inside its watched token fetch) ----------
    def decode_stall_sleep(self, step: int) -> None:
        """Sleep the injected stall inside the decode step's token fetch
        (the engine runs it under the decode watchdog, so the deadline
        sees exactly the hang it guards against)."""
        ev = self._take("decode_stall", step)
        if ev is not None:
            emit_event("recovery", kind="fault_injected",
                       fault="decode_stall", step=step,
                       seconds=ev.arg or 1.0)
            time.sleep(ev.arg if ev.arg is not None else 1.0)

    def take_slot_nan(self, step: int) -> Optional[int]:
        """The slot to NaN-poison before decode step ``step`` (None off
        the plan). The engine poisons that slot's cache on the device, so
        the non-finite logits come from the real attention."""
        ev = self._take("slot_nan", step)
        if ev is None:
            return None
        slot = int(ev.arg) if ev.arg is not None else 0
        emit_event("recovery", kind="fault_injected", fault="slot_nan",
                   step=step, slot=slot)
        return slot

    def take_reload(self, step: int) -> bool:
        """True when a live weight swap is due before decode step
        ``step``."""
        ev = self._take("reload", step)
        if ev is not None:
            emit_event("recovery", kind="fault_injected",
                       fault="reload", step=step)
            return True
        return False

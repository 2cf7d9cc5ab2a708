"""Fleet controller: replica lifecycle + the continuous train→serve loop
(the port of ``fleet/controller.py``).

Owns the replica subprocesses the router dispatches to:

- **spawn/restart** with the supervisor's leg semantics
  (resilience.supervisor.build_leg_args — serve children relaunch
  with the unchanged command) and capped exponential backoff; each
  restart rotates the replica onto a FRESH epoch directory (new
  inbox/journal/snapshot), because the router re-dispatches the dead
  leg's in-flight work to peers — a restarted replica resuming its
  old journal would double-serve it. A child that exits 2 (DIVERGED —
  SlotRetryExhausted) is NOT restarted, exactly like the supervisor.
- **checkpoint watch + rolling swap**: a trainer writes checkpoints
  into ``ckpt_dir`` concurrently; when a new step lands, the
  controller rolls it across the fleet ONE replica at a time — a
  ``swap`` inbox command triggers the replica's live ``swap_params``
  (sha256-verified, EMA-preferred, slots live), and the next replica
  is told only after the previous one's snapshot reports the new
  ``ckpt_step`` — so serving capacity never drops below N-1 during an
  upgrade. Model STALENESS (latest trained step minus each replica's
  served step) is sampled continuously; a restarted replica self-heals
  (its startup restore takes the newest verifiable checkpoint).
- **drain-before-stop**: ``request_stop`` sends every live replica a
  ``drain`` command (finish in-flight work, accept nothing new, exit
  0); ``wait_stopped`` escalates TERM→KILL only past the deadline.

Host-side policy only (stdlib): process handles come from an
injectable ``spawn`` callable, so the whole lifecycle runs on fakes
with a fake clock. A replica is ``python -m
tensorflow_distributed_tpu_torch.cli --mode serve`` with its fleet
wiring appended.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from tensorflow_distributed_tpu_torch.config import child_flag
from tensorflow_distributed_tpu_torch.fleet.replica import ReplicaHandle

#: Native checkpoints are atomic dirs with a state.msgpack; orbax ones
#: count once the chief's commit marker lands. Duplicated from
#: train/checkpoint.py (available_steps) because that module needs
#: torch and the controller must stay import-light.
_STEP_PREFIX = "step_"
_COMPLETE_MARKERS = ("state.msgpack", "ORBAX_COMMITTED")


def latest_ckpt_step(ckpt_dir: str) -> Optional[int]:
    """Newest COMPLETE checkpoint step in ``ckpt_dir`` (a torch-free scan;
    None when the directory is empty/absent)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        if not name.startswith(_STEP_PREFIX):
            continue
        try:
            step = int(name[len(_STEP_PREFIX):])
        except ValueError:
            continue  # step_X.tmp staging dirs, misnamed entries
        d = os.path.join(ckpt_dir, name)
        if not os.path.isdir(d):
            continue
        if any(os.path.exists(os.path.join(d, m))
               for m in _COMPLETE_MARKERS):
            best = step if best is None else max(best, step)
    return best


@dataclasses.dataclass
class ControllerConfig:
    max_restarts: int = 3          # per replica
    backoff_base_s: float = 0.5
    backoff_max_s: float = 8.0
    export_every_s: float = 0.2    # replica snapshot cadence
    swap_timeout_s: float = 120.0  # per-replica roll acknowledgement
    drain_timeout_s: float = 60.0
    ready_timeout_s: float = 300.0

    def validate(self) -> None:
        if self.max_restarts < 0:
            raise ValueError(
                f"controller max_restarts must be >= 0, "
                f"got {self.max_restarts}")
        if self.export_every_s <= 0:
            raise ValueError(
                f"controller export_every_s must be > 0, "
                f"got {self.export_every_s}")


class _Member:
    def __init__(self, handle: ReplicaHandle,
                 extra_args: Sequence[str] = ()):
        self.handle = handle
        self.extra_args = list(extra_args)
        self.proc: Any = None
        self.restarts = 0
        self.restart_at: Optional[float] = None  # backoff deadline
        self.gone = False        # dead for good (diverged / budget)
        self.swaps = 0
        self.staleness_max = 0


class FleetController:
    """``start()`` once, then drive ``poll(now)`` from the front-end
    loop. ``base_args`` is the shared ``--mode serve`` child argv; the
    controller appends the per-replica fleet wiring (inbox, journal,
    snapshot export, metrics) — argparse last-wins, so appended flags
    override base ones. ``extra_args`` maps replica name -> extra argv
    (a fault plan for one replica goes in this way)."""

    def __init__(self, handles: Sequence[ReplicaHandle],
                 base_args: Sequence[str], ckpt_dir: str = "",
                 cfg: Optional[ControllerConfig] = None,
                 extra_args: Optional[Dict[str, Sequence[str]]] = None,
                 emit: Optional[Callable[..., Any]] = None,
                 spawn: Optional[Callable[..., Any]] = None,
                 on_death: Optional[Callable[[str, float], None]] = None,
                 on_restart: Optional[Callable[[str, float],
                                               None]] = None,
                 env: Optional[Dict[str, str]] = None):
        self.cfg = cfg or ControllerConfig()
        self.cfg.validate()
        extra_args = extra_args or {}
        self.members = {
            h.name: _Member(h, extra_args.get(h.name, ()))
            for h in handles}
        self.base_args = list(base_args)
        self.ckpt_dir = ckpt_dir
        self._emit_fn = emit
        self._spawn = spawn or self._popen
        self.on_death = on_death
        self.on_restart = on_restart
        self.env = env
        self._t0: Optional[float] = None
        # Rolling-swap state: the step being rolled, the replicas
        # still to roll (one at a time), and when the current one was
        # told to swap.
        self.rolled_step: Optional[int] = None
        self._roll_queue: List[str] = []
        self._roll_sent_t: Optional[float] = None
        self._roll_timeouts = 0    # acks missed DURING the current roll
        self.rolling_swaps = 0     # fleet-wide rollouts every live
        #                            replica ACKED (a roll with a
        #                            timed-out swap is counted below
        #                            instead — the swaps_ok gate must
        #                            not pass on a rollout that never
        #                            actually converged)
        self.partial_rolls = 0
        self.swap_timeouts = 0
        self.staleness_max = 0
        self.draining = False

    # -- spawn -------------------------------------------------------------

    def _popen(self, cmd: List[str]) -> Any:
        return subprocess.Popen(cmd, env=self.env)

    def _cmd(self, m: _Member) -> List[str]:
        # The supervisor's leg-args contract (serve children relaunch
        # unchanged; --resume stays train-only), then the per-epoch
        # fleet wiring appended — last flag wins under argparse.
        from tensorflow_distributed_tpu_torch.resilience.supervisor import (
            build_leg_args)
        h = m.handle
        args = build_leg_args(self.base_args + m.extra_args,
                              m.restarts)
        args += [
            child_flag("serve.inbox"), h.inbox,
            child_flag("serve.journal"), h.journal,
            child_flag("observe.export_path"), h.snapshot,
            child_flag("observe.export_every"),
            str(self.cfg.export_every_s),
            child_flag("observe.metrics_jsonl"), h.metrics,
        ]
        return [sys.executable, "-m",
                "tensorflow_distributed_tpu_torch.cli", *args]

    def _launch(self, m: _Member, now: float) -> None:
        m.handle.begin_epoch(m.handle.epoch)
        m.proc = self._spawn(self._cmd(m))
        m.restart_at = None
        self._emit("fleet_replica", replica=m.handle.name,
                   state="spawned", epoch=m.handle.epoch,
                   t_s=round(self._now_s(now), 4))

    def start(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._t0 = now
        # The checkpoint standing at launch is what every replica
        # restores at startup — only steps trained AFTER this roll.
        if self.ckpt_dir and self.rolled_step is None:
            self.rolled_step = latest_ckpt_step(self.ckpt_dir)
        for m in self.members.values():
            self._launch(m, now)

    # -- bookkeeping -------------------------------------------------------

    def _emit(self, event: str, **fields) -> None:
        if self._emit_fn is not None:
            self._emit_fn(event, **fields)

    def _now_s(self, now: float) -> float:
        return now - (self._t0 or 0.0)

    def alive(self, name: str) -> bool:
        m = self.members[name]
        return m.proc is not None and m.proc.poll() is None

    def wait_ready(self, timeout_s: Optional[float] = None,
                   clock=time.monotonic, sleep=time.sleep) -> bool:
        """Block until every replica has written a first snapshot (or
        the deadline passes) — the front-end starts the router clock
        only on a ready fleet, so replica cold-start (torch import, the
        engine's build and warmup) is not billed to the serving wall."""
        deadline = clock() + (timeout_s if timeout_s is not None
                              else self.cfg.ready_timeout_s)
        while clock() < deadline:
            missing = [m for m in self.members.values()
                       if m.handle.read_snapshot() is None]
            if not missing:
                return True
            if any(not self.alive(m.handle.name) for m in missing):
                return False   # a replica died before its first export
            sleep(0.1)
        return False

    # -- lifecycle ---------------------------------------------------------

    def _check_liveness(self, now: float) -> None:
        for m in self.members.values():
            if m.proc is None or m.gone:
                continue
            rc = m.proc.poll()
            if rc is None:
                continue
            if self.draining and rc == 0:
                m.proc = None    # clean drain exit, not a death
                continue
            m.proc = None
            rc_norm = 128 - rc if rc < 0 else rc
            self._emit("fleet_replica", replica=m.handle.name,
                       state="exited", rc=rc_norm,
                       epoch=m.handle.epoch,
                       t_s=round(self._now_s(now), 4))
            if self.on_death is not None:
                self.on_death(m.handle.name, now)
            if rc == 2:
                # DIVERGED (SlotRetryExhausted): deterministic — a
                # restart replays it. Same refusal as the supervisor.
                m.gone = True
                self._emit("fleet_replica", replica=m.handle.name,
                           state="diverged_no_restart",
                           t_s=round(self._now_s(now), 4))
                continue
            if m.restarts >= self.cfg.max_restarts:
                m.gone = True
                self._emit("fleet_replica", replica=m.handle.name,
                           state="restart_budget_exhausted",
                           restarts=m.restarts,
                           t_s=round(self._now_s(now), 4))
                continue
            m.restarts += 1
            delay = min(self.cfg.backoff_base_s
                        * 2 ** (m.restarts - 1),
                        self.cfg.backoff_max_s)
            m.restart_at = now + delay

    def _check_restarts(self, now: float) -> None:
        for m in self.members.values():
            if m.restart_at is None or now < m.restart_at \
                    or self.draining:
                continue
            m.handle.epoch += 1
            self._launch(m, now)
            if self.on_restart is not None:
                self.on_restart(m.handle.name, now)

    # -- train -> serve loop -----------------------------------------------

    @property
    def swap_in_progress(self) -> bool:
        return bool(self._roll_queue)

    def _check_rollout(self, now: float) -> None:
        latest = latest_ckpt_step(self.ckpt_dir)
        if latest is None:
            return
        # Staleness sampling rides the same snapshots the router
        # polls: trained-step minus each replica's served ckpt_step.
        for m in self.members.values():
            snap = m.handle.read_snapshot() or {}
            served = snap.get("ckpt_step")
            if isinstance(served, int):
                stale = max(0, latest - served)
                m.staleness_max = max(m.staleness_max, stale)
                self.staleness_max = max(self.staleness_max, stale)
        if not self._roll_queue:
            if self.rolled_step is not None \
                    and latest <= self.rolled_step:
                return
            self._roll_queue = [
                name for name, m in sorted(self.members.items())
                if self.alive(name)]
            if not self._roll_queue:
                return
            self.rolled_step = latest
            self._roll_sent_t = None
            self._roll_timeouts = 0
            self._emit("fleet_roll", state="begin",
                       ckpt_step=latest,
                       replicas=len(self._roll_queue),
                       t_s=round(self._now_s(now), 4))
        # Advance the roll as far as it can go THIS poll: an ack (or a
        # skipped dead replica) immediately tells the next replica to
        # swap — but a freshly-sent swap always waits for its ack, so
        # at most ONE replica is ever mid-swap (capacity >= N-1).
        while self._roll_queue:
            name = self._roll_queue[0]
            m = self.members[name]
            if not self.alive(name):
                # A dead replica's restart restores the newest
                # checkpoint anyway — skip it, keep the roll moving.
                self._roll_queue.pop(0)
                self._roll_sent_t = None
                continue
            if self._roll_sent_t is None:
                m.handle.send({"cmd": "swap"})
                self._roll_sent_t = now
                return
            snap = m.handle.read_snapshot() or {}
            served = snap.get("ckpt_step")
            acked = (isinstance(served, int)
                     and served >= self.rolled_step)
            if acked:
                m.swaps += 1
                self._emit("fleet_swap", replica=name,
                           ckpt_step=served,
                           t_s=round(self._now_s(now), 4))
            elif now - self._roll_sent_t > self.cfg.swap_timeout_s:
                self._roll_timeouts += 1
                self.swap_timeouts += 1
                self._emit("fleet_swap", replica=name,
                           state="timeout",
                           ckpt_step=self.rolled_step,
                           t_s=round(self._now_s(now), 4))
            else:
                return   # waiting on this replica's ack
            self._roll_queue.pop(0)
            self._roll_sent_t = None
        if self._roll_timeouts:
            self.partial_rolls += 1
        else:
            self.rolling_swaps += 1
        self._emit("fleet_roll",
                   state="done" if not self._roll_timeouts
                   else "done_partial",
                   ckpt_step=self.rolled_step,
                   timeouts=self._roll_timeouts,
                   t_s=round(self._now_s(now), 4))

    def poll(self, now: float) -> None:
        self._check_liveness(now)
        self._check_restarts(now)
        if self.ckpt_dir:
            self._check_rollout(now)

    # -- stop --------------------------------------------------------------

    def request_stop(self, now: Optional[float] = None) -> None:
        """Drain-before-stop: every live replica finishes its
        in-flight work and exits 0; nothing new is admitted (the
        router stopped dispatching — the caller sequences that)."""
        now = time.monotonic() if now is None else now
        self.draining = True
        self._roll_queue = []
        for m in self.members.values():
            if self.alive(m.handle.name):
                try:
                    m.handle.send({"cmd": "drain"})
                except OSError:
                    pass
        self._emit("fleet_roll", state="drain",
                   t_s=round(self._now_s(now), 4))

    def wait_stopped(self, clock=time.monotonic,
                     sleep=time.sleep) -> bool:
        """True when every replica exited by itself within the drain
        deadline; stragglers are escalated TERM -> KILL (and False
        returned — a drain that needed force is worth knowing)."""
        deadline = clock() + self.cfg.drain_timeout_s
        while clock() < deadline:
            if not any(self.alive(name) for name in self.members):
                return True
            sleep(0.1)
        clean = True
        for m in self.members.values():
            if not self.alive(m.handle.name):
                continue
            clean = False
            try:
                m.proc.send_signal(signal.SIGTERM)
            except (OSError, AttributeError):
                pass
        t_kill = clock() + 5.0
        while clock() < t_kill:
            if not any(self.alive(name) for name in self.members):
                return clean
            sleep(0.1)
        for m in self.members.values():
            if self.alive(m.handle.name):
                try:
                    m.proc.kill()
                except (OSError, AttributeError):
                    pass
        return clean

    def kill(self, name: str, sig: int = signal.SIGKILL) -> None:
        """Fault injection: SIGKILL one replica (the replica-death
        drill)."""
        m = self.members[name]
        if m.proc is not None:
            try:
                m.proc.send_signal(sig)
            except (OSError, AttributeError):
                pass

    def summary(self) -> Dict[str, Any]:
        return {
            "replicas": len(self.members),
            "restarts": sum(m.restarts for m in self.members.values()),
            "rolling_swaps": self.rolling_swaps,
            "partial_rolls": self.partial_rolls,
            "swap_timeouts": self.swap_timeouts,
            "rolled_step": self.rolled_step,
            "staleness_max_steps": self.staleness_max,
            "replica_swaps": {name: m.swaps for name, m in
                              sorted(self.members.items())},
            "replica_staleness_max": {
                name: m.staleness_max for name, m in
                sorted(self.members.items())},
        }

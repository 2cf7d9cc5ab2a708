"""Fleet front-end: glue the controller, router, and a workload (the
port of ``fleet/run.py``).

::

    python -m tensorflow_distributed_tpu_torch.fleet.run \\
        --replicas 2 --fleet-dir /tmp/fleet \\
        --requests workload.jsonl [--checkpoint-dir /tmp/ckpt] \\
        [--kill r1@12.5] [--hold-export r0@20:3] \\
        -- --model gpt_lm --seq-len 96 --serve.num-slots 2 ...

Everything after ``--`` is the shared replica argv (an ordinary
``--mode serve`` command line of the port's CLI; the controller appends
the per-replica inbox/journal/snapshot wiring). The workload file is the
serve request-file schema (``{"prompt": [...], "max_new_tokens": n,
"arrival_s": t, "slo": "high"}`` per line): rids are line order, so a
fleet run compares directly with a one-replica ``--mode serve
--serve.requests`` run on the same file.

``--kill NAME@T`` SIGKILLs a replica T seconds into serving;
``--hold-export NAME@T:S`` freezes its snapshot exports for S seconds
(the stale-snapshot drill). Both are also available programmatically as
``actions``: ``(t, callable(controller, router))`` pairs.

The front-end emits ``fleet_*`` records (and one ``fleet_summary``)
into ``<fleet-dir>/fleet.jsonl``. ``--fleet.slo`` declares fleet-level
burn-rate targets on client-perceived latency (``fleet_slo_alert`` /
``fleet_slo_ok``), and ``--fleet.export-path`` /
``--fleet.export-every`` write the atomically rewritten control-plane
snapshot. ``--fleet.trace`` (the router's spans stitched with the
replicas' traces) is the fleet observatory, not ported yet (ROADMAP.md
A8): it is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tensorflow_distributed_tpu_torch.utils.atomicio import atomic_write_json
from tensorflow_distributed_tpu_torch.fleet.controller import (
    ControllerConfig, FleetController)
from tensorflow_distributed_tpu_torch.fleet.replica import ReplicaHandle
from tensorflow_distributed_tpu_torch.fleet.router import Router, RouterConfig


@dataclasses.dataclass
class FleetObsConfig:
    """Fleet-observatory knobs (the ``--fleet.*`` CLI flags).

    ``trace`` (the stitched fleet trace) is not ported yet and must stay
    False (ROADMAP.md A8). ``slo`` declares FLEET-level targets
    (observe/slo.py grammar) scored on client-perceived latency —
    admission to first token across retries and failovers — emitting
    ``fleet_slo_alert`` / ``fleet_slo_ok`` records. ``export_path`` is
    the atomically rewritten control-plane snapshot (see
    Router.fleet_snapshot) on the ``export_every`` cadence (0 = one final
    snapshot only)."""

    trace: bool = False
    slo: str = ""
    slo_windows: str = "60,600"
    slo_burn: float = 1.0
    export_path: str = ""
    export_every: float = 0.0

    def validate(self) -> None:
        from tensorflow_distributed_tpu_torch.observe.slo import (
            parse_slo, parse_windows)
        if self.trace:
            raise NotImplementedError(
                "--fleet.trace (the fleet observatory's stitched trace) "
                "is not ported to PyTorch yet (see ROADMAP.md A8)")
        if self.slo:
            parse_slo(self.slo)
        parse_windows(self.slo_windows)
        if self.slo_burn <= 0:
            raise ValueError(
                f"fleet.slo_burn must be > 0, got {self.slo_burn}")
        if not self.slo and (self.slo_windows != "60,600"
                             or self.slo_burn != 1.0):
            raise ValueError(
                "fleet.slo_windows/slo_burn have no effect without "
                "fleet.slo; declare targets (--fleet.slo)")
        if self.export_every < 0:
            raise ValueError(
                f"fleet.export_every must be >= 0, "
                f"got {self.export_every}")
        if self.export_every and not self.export_path:
            raise ValueError(
                "fleet.export_every has no effect without "
                "fleet.export_path; set a snapshot file")


def load_workload(path: str) -> List[Dict[str, Any]]:
    """A serve request file as router-submittable dicts (rid = line
    order — the single-replica comparability contract)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            out.append({
                "rid": len(out),
                "prompt": [int(t) for t in obj["prompt"]],
                "max_new": int(obj.get("max_new_tokens", 64)),
                "eos": int(obj.get("eos_id", -1)),
                "arrival_s": float(obj.get("arrival_s", 0.0)),
                "slo": str(obj.get("slo", "standard")),
                "tenant": str(obj.get("tenant", "")),
                "session": str(obj.get("session", "")),
            })
    if not out:
        raise ValueError(f"{path} names no requests")
    return out


def run_fleet(*, fleet_dir: str, replicas: int,
              base_args: Sequence[str],
              workload: Sequence[Dict[str, Any]],
              ckpt_dir: str = "",
              router_cfg: Optional[RouterConfig] = None,
              controller_cfg: Optional[ControllerConfig] = None,
              extra_args: Optional[Dict[str, Sequence[str]]] = None,
              actions: Sequence[Tuple[float, Callable]] = (),
              env: Optional[Dict[str, str]] = None,
              poll_s: float = 0.05, timeout_s: float = 900.0,
              linger: Optional[Callable[..., bool]] = None,
              jsonl: str = "",
              obs: Optional[FleetObsConfig] = None) -> Dict[str, Any]:
    """Serve ``workload`` on a ``replicas``-wide fleet; returns the
    merged router+controller summary. ``actions`` fire once each at
    their offset from serving start (clock = time.monotonic);
    ``linger(controller, router)`` keeps the loop (and the fleet)
    alive past the last completion while it returns True (a trainer leg
    waited out so that its checkpoint still rolls)."""
    os.makedirs(fleet_dir, exist_ok=True)
    registry = None
    emit = None
    if jsonl:
        from tensorflow_distributed_tpu_torch.observe.registry import (
            JsonlSink, MetricsRegistry)
        registry = MetricsRegistry([JsonlSink(jsonl)],
                                   tags={"role": "fleet"})
        emit = registry.emit
    handles = [ReplicaHandle(f"r{i}", os.path.join(fleet_dir, f"r{i}"))
               for i in range(replicas)]
    obs = obs or FleetObsConfig()
    obs.validate()
    slo_monitor = None
    if obs.slo:
        from tensorflow_distributed_tpu_torch.observe.slo import (
            SLOMonitor, parse_slo, parse_windows)
        fast, slow = parse_windows(obs.slo_windows)
        slo_monitor = SLOMonitor(
            parse_slo(obs.slo), fast_window=fast, slow_window=slow,
            burn_threshold=obs.slo_burn, emit=emit,
            event_prefix="fleet_")
    router = Router(handles, router_cfg, emit=emit,
                    slo_monitor=slo_monitor)
    ctl = FleetController(handles, base_args, ckpt_dir=ckpt_dir,
                          cfg=controller_cfg, extra_args=extra_args,
                          emit=emit, env=env,
                          on_death=router.mark_dead,
                          on_restart=router.mark_restarted)

    def export_snapshot(now: float) -> None:
        """Atomic (tmp+rename) control-plane snapshot — a poller
        always reads a complete payload, never a torn write."""
        snap = router.fleet_snapshot(now)
        atomic_write_json(obs.export_path, snap)
        if emit is not None:
            emit("fleet_snapshot", **snap)
    clock = time.monotonic
    summary: Dict[str, Any] = {}
    try:
        ctl.start(clock())
        if not ctl.wait_ready():
            raise RuntimeError(
                "fleet: replicas never became ready (no snapshot "
                "within the ready deadline) — check the replica "
                "metrics/stderr under " + fleet_dir)
        router.submit(workload)
        t0 = clock()
        router.begin(t0)
        pending_actions = sorted(actions, key=lambda ta: ta[0])
        fired = 0
        timed_out = False
        last_export = t0
        while True:
            now = clock()
            while (fired < len(pending_actions)
                   and now - t0 >= pending_actions[fired][0]):
                pending_actions[fired][1](ctl, router)
                fired += 1
            ctl.poll(now)
            router.step(now)
            if (obs.export_path and obs.export_every
                    and now - last_export >= obs.export_every):
                last_export = now
                export_snapshot(now)
            if not router.active() and not ctl.swap_in_progress \
                    and fired >= len(pending_actions) \
                    and (linger is None or not linger(ctl, router)):
                break
            if now - t0 > timeout_s:
                timed_out = True
                break
            time.sleep(poll_s)
        ctl.request_stop(clock())
        drained = ctl.wait_stopped()
        summary = {**router.summary(), **ctl.summary(),
                   "drained_clean": bool(drained),
                   "timed_out": timed_out}
        if emit is not None:
            emit("fleet_summary", **summary)
        if obs.export_path:
            # The FINAL snapshot — forced, after the fleet stopped, so
            # its per-class e2e p95 is computed over the same (now
            # frozen) done population summary() uses.
            export_snapshot(clock())
        # Returned (not emitted — records stay lean): the assembled
        # per-request streams for token-identity comparisons.
        summary["tokens"] = {
            str(rid): toks
            for rid, toks in sorted(router.token_streams().items())}
        return summary
    finally:
        # Whatever happened, never leave replica processes behind.
        for m in ctl.members.values():
            if m.proc is not None and m.proc.poll() is None:
                try:
                    m.proc.kill()
                except OSError:
                    pass
        if registry is not None:
            registry.close()


def _parse_at(spec: str) -> Tuple[str, float, float]:
    """``NAME@T`` or ``NAME@T:S`` -> (name, t, s)."""
    name, _, rest = spec.partition("@")
    if not name or not rest:
        raise ValueError(
            f"{spec!r}: expected NAME@SECONDS[:DURATION]")
    t, _, dur = rest.partition(":")
    return name, float(t), float(dur) if dur else 0.0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    asks_help = bool({"-h", "--help"} & set(argv))
    if "--" not in argv and not asks_help:
        print("usage: python -m tensorflow_distributed_tpu_torch.fleet.run "
              "[options] -- <serve cli args>", file=sys.stderr)
        return 2
    split = argv.index("--") if "--" in argv else len(argv)
    parser = argparse.ArgumentParser(
        prog="tensorflow_distributed_tpu_torch.fleet.run",
        description="health-aware fleet front-end over N serve "
        "replicas of the port's CLI (the shared serve argv follows --)")
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--fleet-dir", required=True)
    parser.add_argument("--requests", required=True,
                        help="serve request-file JSONL (rid = line "
                        "order)")
    parser.add_argument("--checkpoint-dir", default="",
                        help="trainer output to watch for rolling "
                        "swaps (also pass it in the serve args so "
                        "replicas restore/swap from it)")
    parser.add_argument("--kill", action="append", default=[],
                        metavar="NAME@T",
                        help="SIGKILL replica NAME at T seconds")
    parser.add_argument("--hold-export", action="append", default=[],
                        metavar="NAME@T:S",
                        help="freeze NAME's snapshot exports for S "
                        "seconds starting at T")
    parser.add_argument("--timeout", type=float, default=900.0)
    # Fleet observatory: the SLO monitor and Router.fleet_snapshot (the
    # stitched trace is refused: ROADMAP.md A8).
    parser.add_argument("--fleet.trace", dest="fleet_trace",
                        type=lambda s: s.lower() in ("1", "true", "yes"),
                        default=False,
                        help="the fleet trace: not ported yet (ROADMAP.md "
                        "A8)")
    parser.add_argument("--fleet.slo", dest="fleet_slo", default="",
                        help="fleet-level SLO targets on client-"
                        "perceived latency (observe/slo.py grammar)")
    parser.add_argument("--fleet.slo-windows", dest="fleet_slo_windows",
                        default="60,600",
                        help="fast,slow burn windows in router steps")
    parser.add_argument("--fleet.slo-burn", dest="fleet_slo_burn",
                        type=float, default=1.0)
    parser.add_argument("--fleet.export-path", dest="fleet_export_path",
                        default="",
                        help="atomically-rewritten fleet control-plane "
                        "snapshot (occupancy, per-class e2e p95, "
                        "quarantine set, per-replica health)")
    parser.add_argument("--fleet.export-every", dest="fleet_export_every",
                        type=float, default=0.0,
                        help="snapshot cadence in seconds (0 = one "
                        "final snapshot when export-path is set)")
    opts = parser.parse_args(argv[:split])
    base_args = argv[split + 1:]
    obs = FleetObsConfig(
        trace=opts.fleet_trace, slo=opts.fleet_slo,
        slo_windows=opts.fleet_slo_windows,
        slo_burn=opts.fleet_slo_burn,
        export_path=opts.fleet_export_path,
        export_every=opts.fleet_export_every)
    try:
        obs.validate()
    except (ValueError, NotImplementedError) as e:
        parser.error(str(e))

    actions: List[Tuple[float, Callable]] = []
    for spec in opts.kill:
        name, t, _ = _parse_at(spec)
        actions.append((t, lambda ctl, router, _n=name:
                        ctl.kill(_n)))
    for spec in opts.hold_export:
        name, t, s = _parse_at(spec)
        if s <= 0:
            parser.error(f"--hold-export {spec}: needs a :DURATION")
        actions.append((t, lambda ctl, router, _n=name, _s=s:
                        ctl.members[_n].handle.send(
                            {"cmd": "hold_export", "secs": _s})))

    summary = run_fleet(
        fleet_dir=opts.fleet_dir, replicas=opts.replicas,
        base_args=base_args,
        workload=load_workload(opts.requests),
        ckpt_dir=opts.checkpoint_dir, actions=actions,
        timeout_s=opts.timeout,
        jsonl=os.path.join(opts.fleet_dir, "fleet.jsonl"),
        obs=obs)
    summary.pop("tokens", None)   # per-request streams: bulky, and
    #                               the journals already hold them
    print(json.dumps(summary))
    ok = (summary.get("requests_lost", 1) == 0
          and not summary.get("timed_out"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

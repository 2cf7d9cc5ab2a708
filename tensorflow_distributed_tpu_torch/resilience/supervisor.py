"""Restart supervisor: the port of ``resilience/supervisor.py`` (its
non-elastic half).

::

    python -m tensorflow_distributed_tpu_torch.resilience.supervisor \\
        [--max-restarts N] [--backoff-base-s B] [--backoff-max-s M] \\
        [--restart-on-diverge] -- <port cli args>

Runs ``python -m tensorflow_distributed_tpu_torch.cli <args>`` as a
child and restarts it on any abnormal exit (a crash, an OOM kill, a
SIGKILL) with capped exponential backoff (``backoff_base_s * 2 **
(restart - 1)``, at most ``backoff_max_s``). A train child gains
``--resume true`` from the second leg on, so each restart goes on from
the newest verifiable checkpoint; a SIGTERM'd leg that saved and exited
0 is not a restart. A ``--mode serve`` child restarts with the
UNCHANGED command: its continuity is the request journal, which the
same ``--serve.journal`` path makes a resume (finished requests drop,
in-flight ones re-admit as continuations). A tensor-parallel serve
child (``--serve.mesh-model N``) is one command too: its workers die
with it (``serve/tp_replica.py``), and the next leg starts its own.

Exit codes (the CLI's):

- **0**: a clean finish or a graceful preemption: stop.
- **2** DIVERGED: training halted on a non-finite loss or a spent
  recovery budget, or serving quarantined one request past its retry
  budget. The same inputs diverge the same way again: not restarted
  unless ``--restart-on-diverge``; the supervisor exits 2.
- **3** STALLED: a watchdog fired. A restart is the remedy: restarted
  like a crash; 3 comes out only when the budget is spent.
- anything else: restarted with backoff. When the budget is spent the
  supervisor exits with the child's last code (a signal's death as 128
  + the signal number).

SIGTERM and SIGINT sent to the supervisor are forwarded to the child.
Each restart prints an ``{"event": "recovery", "kind": "restart", ...}``
record on standard output. JAX also appends its records to the child's
``--observe.metrics-jsonl``; the port has no ``--observe.*`` sink yet,
and that append comes with it (ROADMAP.md A8).

Not ported: ``--elastic`` (probing the live devices and relaunching onto
a smaller mesh: ``pick_elastic_mesh``, ``plan_elastic`` and the device
probe need ``restore_resharded`` and the ``device_loss`` fault, ROADMAP.md
A7) and the dead leg's flight-recorder bundle (``_leg_bundle``: the
flight recorder is ``observe/flightrec.py``, A8).

The supervisor spells every child flag through the port's
``config.child_flag`` and runs no device work itself.
"""

from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence

from tensorflow_distributed_tpu_torch.config import child_flag

CLI = "tensorflow_distributed_tpu_torch.cli"
EXIT_DIVERGED = 2


def _child_flag_value(args: Sequence[str], flag: str) -> Optional[str]:
    """The value of ``flag`` in a child argv (``--flag v`` or
    ``--flag=v``), or None."""
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            return args[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def build_leg_args(child_args: Sequence[str], restarts: int) -> List[str]:
    """The child argv for leg ``restarts`` (JAX's): a train child with a
    checkpoint dir gains ``--resume true`` from the second leg on, never
    over an explicit setting; a serve child restarts with the unchanged
    command (its journal is its resume)."""
    args = list(child_args)
    serve = _child_flag_value(args, child_flag("mode")) == "serve"
    ckpt_dir = _child_flag_value(args, child_flag("checkpoint_dir"))
    if (restarts > 0 and not serve and ckpt_dir
            and _child_flag_value(args, child_flag("resume")) is None):
        args += [child_flag("resume"), "true"]
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("usage: python -m tensorflow_distributed_tpu_torch.resilience"
              ".supervisor [options] -- <port cli args>", file=sys.stderr)
        return 2
    split = argv.index("--")
    parser = argparse.ArgumentParser(
        prog="tensorflow_distributed_tpu_torch.resilience.supervisor",
        description="restart a crashed or killed train or serve child "
        "with capped backoff (--resume true for training; the journal "
        "for serving)")
    parser.add_argument("--max-restarts", type=int, default=5)
    parser.add_argument("--backoff-base-s", type=float, default=1.0)
    parser.add_argument("--backoff-max-s", type=float, default=60.0)
    parser.add_argument("--restart-on-diverge", action="store_true")
    parser.add_argument("--elastic", action="store_true")
    opts = parser.parse_args(argv[:split])
    child_args = argv[split + 1:]
    if opts.elastic:
        print("[supervisor] --elastic (relaunching onto the surviving "
              "devices' mesh, with restore_resharded and the device_loss "
              "fault) is not ported to PyTorch yet (see ROADMAP.md A7)",
              file=sys.stderr)
        return 2

    ckpt_dir = _child_flag_value(child_args, child_flag("checkpoint_dir"))
    serve = _child_flag_value(child_args, child_flag("mode")) == "serve"
    journal = _child_flag_value(child_args, child_flag("serve.journal"))
    if serve and not journal:
        print("[supervisor] WARNING: serve child has no --serve.journal — "
              "restarts will re-serve the whole workload from scratch "
              "(in-flight and even finished requests replay)", flush=True)
    elif not serve and not ckpt_dir:
        print("[supervisor] WARNING: no --checkpoint-dir in child args — "
              "restarts will repeat from step 0", flush=True)

    restarts = 0
    while True:
        cmd = [sys.executable, "-m", CLI,
               *build_leg_args(child_args, restarts)]
        print(f"[supervisor] leg {restarts}: {' '.join(cmd)}", flush=True)
        proc = subprocess.Popen(cmd)

        def forward(signum, frame, _p=proc):
            try:
                _p.send_signal(signum)
            except ProcessLookupError:
                pass

        prev = {s: signal.signal(s, forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            rc = proc.wait()
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
        if rc == 0:
            print(f"[supervisor] clean exit after {restarts} restart(s)",
                  flush=True)
            return 0
        if rc == EXIT_DIVERGED and not opts.restart_on_diverge:
            print("[supervisor] child diverged (rc=2); not restarting "
                  "(pass --restart-on-diverge to override)", flush=True)
            return rc
        if restarts >= opts.max_restarts:
            print(f"[supervisor] restart budget exhausted "
                  f"({opts.max_restarts}); last rc={rc}", flush=True)
            return 128 - rc if rc < 0 else rc
        restarts += 1
        delay = min(opts.backoff_base_s * 2 ** (restarts - 1),
                    opts.backoff_max_s)
        record = {"event": "recovery", "kind": "restart", "leg": restarts,
                  "rc": rc, "backoff_s": round(delay, 3),
                  "resume": bool(journal) if serve else bool(ckpt_dir)}
        print(f"[supervisor] {json.dumps(record)}", flush=True)
        time.sleep(delay)


if __name__ == "__main__":
    sys.exit(main())

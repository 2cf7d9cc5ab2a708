"""Restart supervisor: the port of ``resilience/supervisor.py``.

::

    python -m tensorflow_distributed_tpu_torch.resilience.supervisor \\
        [--max-restarts N] [--backoff-base-s B] [--backoff-max-s M] \\
        [--restart-on-diverge] [--elastic] -- <port cli args>

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
record on standard output and, as JAX's, appends it to the child's
``--observe.metrics-jsonl`` (``durable_append``), beside the
``mesh_change``, ``mesh_exhausted``, ``diverged_no_restart`` and
``restart_budget_exhausted`` records; the dead leg's flight-recorder
bundle is not ported yet (ROADMAP.md A8).

A child whose mesh (``--mesh.data`` x ``pipe`` x ``seq`` x ``model`` x
``expert``) holds more than one process runs as ``python -m
torch.distributed.run --standalone --nproc-per-node N -m
tensorflow_distributed_tpu_torch.cli ...`` (one process a card); a
child of one process runs as ``python -m
tensorflow_distributed_tpu_torch.cli ...``.

**Elastic restarts** (``--elastic``): before each leg the supervisor
probes the device count in a subprocess (it never opens a CUDA context
itself): ``torch.cuda.device_count()`` for a CUDA child, under the
environment the legs get (``CUDA_VISIBLE_DEVICES`` included); for a
``--device cpu`` child the CPU processes that ``TFD_CPU_DEVICE_COUNT``
declares (the counterpart of JAX's
``--xla_force_host_platform_device_count``; only tests set it). Less the
cards the device-mask file under the child's checkpoint dir declares
lost (the ``device_loss`` drill writes it; a real loss needs no mask),
it picks the best mesh that fits: the non-data axes (model, seq, pipe,
expert) are kept and the data axis takes the resize, the largest width
whose product fits the survivors and divides the global batch
(``parallel/mesh.pick_data_width``), so each card's share comes from
the same global batch. The child's ``--mesh.*`` flags are rewritten to
that mesh, the cards past its product are hidden from the child through
``TFD_DEVICE_MASK`` (``parallel/mesh.alive_devices``), a ``mesh_change``
record names the old and the new mesh, and the child's ``--resume``
goes through ``train/checkpoint.restore_resharded``. A card loss so
degrades to a smaller mesh and goes on, and a capacity comeback (the
mask file deleted) grows the mesh again at the next restart. When no
mesh fits, a ``mesh_exhausted`` record and the dead leg's exit code
(normalised as above) end the supervisor; when the probe fails, the leg
runs on the unchanged mesh, with a warning (JAX's).

Not ported: the dead leg's flight-recorder bundle (``_leg_bundle``: the
flight recorder is ``observe/flightrec.py``, A8), and the refusal of
``--elastic`` with a child's ``--plan auto`` (the port has no planner:
its CLI refuses ``--plan``).

The supervisor spells every child flag through the port's
``config.child_flag`` and runs no device work itself.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from tensorflow_distributed_tpu_torch.config import child_flag
from tensorflow_distributed_tpu_torch.parallel.mesh import pick_data_width
from tensorflow_distributed_tpu_torch.resilience.faults import (
    device_mask_path)
from tensorflow_distributed_tpu_torch.utils.atomicio import durable_append

CLI = "tensorflow_distributed_tpu_torch.cli"
EXIT_DIVERGED = 2
_MESH_AXES = ("data", "model", "seq", "pipe", "expert")


def _child_flag_value(args: Sequence[str], flag: str) -> Optional[str]:
    """The value of ``flag`` in a child argv (``--flag v`` or
    ``--flag=v``), or None."""
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            return args[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def parse_mesh_args(args: Sequence[str]) -> Dict[str, int]:
    """The child's mesh axes (the config's defaults where unset; ``data
    == -1`` fills the remaining devices)."""
    out = {a: (-1 if a == "data" else 1) for a in _MESH_AXES}
    for name in out:
        v = _child_flag_value(args, child_flag(f"mesh.{name}"))
        if v is not None:
            out[name] = int(v)
    return out


def pick_elastic_mesh(axes: Dict[str, int], alive: int,
                      batch: Optional[int] = None
                      ) -> Optional[Dict[str, int]]:
    """The best mesh for ``alive`` devices: the non-data axes of ``axes``
    kept, the data axis the largest width whose product fits ``alive``
    and divides the global ``batch`` (``parallel/mesh.pick_data_width``,
    the one copy of the rule). None when even data 1 does not fit."""
    data = pick_data_width(axes, alive, batch)
    if data is None:
        return None
    out = {a: max(1, int(axes.get(a, 1))) for a in _MESH_AXES}
    out["data"] = data
    return out


def rewrite_mesh_args(args: Sequence[str], mesh: Dict[str, int]
                      ) -> List[str]:
    """The child argv with every ``--mesh.*`` flag set to ``mesh`` (both
    spellings replaced in place; ``--mesh.data`` appended when absent,
    so a default ``-1`` child gets the width chosen, and another axis
    when it is not 1)."""
    out = list(args)
    for name in _MESH_AXES:
        flag = child_flag(f"mesh.{name}")
        sval = str(int(mesh[name]))
        replaced = False
        i = 0
        while i < len(out):
            if out[i] == flag and i + 1 < len(out):
                out[i + 1] = sval
                replaced = True
                i += 2
                continue
            if out[i].startswith(flag + "="):
                out[i] = f"{flag}={sval}"
                replaced = True
            i += 1
        if not replaced and (name == "data" or int(mesh[name]) != 1):
            out += [flag, sval]
    return out


def plan_elastic(child_args: Sequence[str], total: int, masked: int
                 ) -> Optional[Tuple[Dict[str, int], int]]:
    """(mesh, child_mask) for a leg: the mesh to relaunch onto, and how
    many trailing devices the child must hide (``TFD_DEVICE_MASK``) so
    that it sees the mesh's product: the lost ones and the remainder the
    mesh cannot use. None: no mesh fits. Without ``--batch-size`` the
    child runs the config's default batch, which the data width must
    divide all the same."""
    alive = total - masked
    batch = _child_flag_value(child_args, child_flag("batch_size"))
    mesh = pick_elastic_mesh(
        parse_mesh_args(child_args), alive,
        int(batch) if batch is not None else _default_batch_size())
    if mesh is None:
        return None
    return mesh, total - _mesh_product(mesh)


def _mesh_product(mesh: Dict[str, int]) -> int:
    n = 1
    for name in _MESH_AXES:
        n *= int(mesh[name])
    return n


def _default_batch_size() -> int:
    """The config's default global batch: what a child argv without
    ``--batch-size`` runs."""
    from tensorflow_distributed_tpu_torch.config import TrainConfig
    return int(TrainConfig().batch_size)


def _read_mask(path: Optional[str]) -> int:
    """The lost-device count in the mask file (0 when it is absent or
    unreadable: absence means nothing is lost, never an error)."""
    if not path:
        return 0
    try:
        with open(path) as f:
            return max(0, int(json.load(f).get("lost", 0)))
    except (OSError, ValueError, AttributeError, TypeError):
        return 0


def _probe_devices(device: str = "cuda") -> Optional[int]:
    """The device count a leg would see, probed in a SUBPROCESS under the
    supervisor's environment, which the legs inherit
    (``CUDA_VISIBLE_DEVICES`` included): the supervisor never opens a
    CUDA context, and each leg sees the current count. A CUDA child
    counts ``torch.cuda.device_count()``; a ``--device cpu`` child the
    processes ``TFD_CPU_DEVICE_COUNT`` declares. None on failure."""
    kind = "cpu" if device == "cpu" else "cuda"
    try:
        out = subprocess.run(
            [sys.executable, "-c",
             "from tensorflow_distributed_tpu_torch.parallel.mesh import "
             f"device_count; print(device_count({kind!r}))"],
            capture_output=True, text=True, timeout=120)
        return int(out.stdout.strip()) if out.returncode == 0 else None
    except (subprocess.SubprocessError, ValueError, OSError):
        return None


def leg_command(args: Sequence[str]) -> List[str]:
    """The command of a leg: torchrun of one process a mesh position when
    the child's explicit mesh holds more than one, else the CLI alone."""
    axes = parse_mesh_args(args)
    n = _mesh_product(axes) if axes["data"] > 0 else 1
    if n > 1:
        return [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", str(n), "-m", CLI,
                *args]
    return [sys.executable, "-m", CLI, *args]


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


def _append_event(jsonl_path: Optional[str], record: dict) -> None:
    """Append one record to the child's metrics JSONL (when it names
    one); the record went to standard output too, so a failed append
    never stops the supervisor."""
    if not jsonl_path:
        return
    try:
        durable_append(jsonl_path, record)
    except OSError:
        pass


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
    # Elastic restarts: probe the devices before each leg and rewrite
    # the child's mesh to the best that fits (see the module docstring).
    parser.add_argument("--elastic", action="store_true")
    opts = parser.parse_args(argv[:split])
    child_args = argv[split + 1:]

    ckpt_dir = _child_flag_value(child_args, child_flag("checkpoint_dir"))
    jsonl = _child_flag_value(child_args,
                              child_flag("observe.metrics_jsonl"))
    serve = _child_flag_value(child_args, child_flag("mode")) == "serve"
    journal = _child_flag_value(child_args, child_flag("serve.journal"))
    if serve and not journal:
        print("[supervisor] WARNING: serve child has no --serve.journal — "
              "restarts will re-serve the whole workload from scratch "
              "(in-flight and even finished requests replay)", flush=True)
    elif not serve and not ckpt_dir:
        print("[supervisor] WARNING: no --checkpoint-dir in child args — "
              "restarts will repeat from step 0", flush=True)

    # One path with the writer: the device_loss drill writes where
    # device_mask_path says.
    mask_file = (device_mask_path(ckpt_dir) if ckpt_dir
                 else os.environ.get("TFD_DEVICE_MASK_FILE"))
    device = _child_flag_value(child_args, child_flag("device")) or "cuda"
    prev_mesh: Optional[Dict[str, int]] = None
    restarts = 0
    rc = 1
    while True:
        args = build_leg_args(child_args, restarts)
        env = None
        if opts.elastic:
            total = _probe_devices(device)
            if total is None:
                print("[supervisor] WARNING: device probe failed — "
                      "launching this leg with the unchanged mesh",
                      flush=True)
            else:
                masked = _read_mask(mask_file)
                planned = plan_elastic(args, total, masked)
                if planned is None:
                    print(f"[supervisor] no compatible mesh for "
                          f"{total - masked} alive device(s) (of {total}; "
                          f"non-data axes {parse_mesh_args(args)}) — "
                          f"stopping", flush=True)
                    record = {"event": "recovery", "kind": "mesh_exhausted",
                              "leg": restarts, "alive": total - masked}
                    print(f"[supervisor] {json.dumps(record)}", flush=True)
                    _append_event(jsonl, record)
                    # The dead leg's code, a signal's death as 128 + the
                    # signal (a raw negative code would alias another
                    # exit status); 1 when no leg ran.
                    return (128 - rc if rc < 0 else rc) if restarts else 1
                mesh, child_mask = planned
                args = rewrite_mesh_args(args, mesh)
                if child_mask:
                    env = dict(os.environ)
                    env["TFD_DEVICE_MASK"] = str(child_mask)
                # "from": the previous leg's mesh, or the configured one
                # when a mask left by an earlier run resizes the first.
                configured = parse_mesh_args(child_args)
                from_mesh = prev_mesh or (
                    configured if configured["data"] != -1 else None)
                if from_mesh is not None and mesh != from_mesh:
                    record = {"event": "recovery", "kind": "mesh_change",
                              "leg": restarts, "from_mesh": from_mesh,
                              "to_mesh": mesh, "alive": total - masked,
                              "masked": masked}
                    print(f"[supervisor] {json.dumps(record)}", flush=True)
                    _append_event(jsonl, record)
                prev_mesh = mesh
        cmd = leg_command(args)
        print(f"[supervisor] leg {restarts}: {' '.join(cmd)}", flush=True)
        proc = subprocess.Popen(cmd, env=env)

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
            _append_event(jsonl, {
                "event": "recovery", "kind": "diverged_no_restart",
                "restarts": restarts, "rc": rc})
            return rc
        if restarts >= opts.max_restarts:
            print(f"[supervisor] restart budget exhausted "
                  f"({opts.max_restarts}); last rc={rc}", flush=True)
            _append_event(jsonl, {
                "event": "recovery", "kind": "restart_budget_exhausted",
                "restarts": restarts, "rc": rc})
            return 128 - rc if rc < 0 else rc
        restarts += 1
        delay = min(opts.backoff_base_s * 2 ** (restarts - 1),
                    opts.backoff_max_s)
        record = {"event": "recovery", "kind": "restart", "leg": restarts,
                  "rc": rc, "backoff_s": round(delay, 3),
                  "resume": bool(journal) if serve else bool(ckpt_dir)}
        print(f"[supervisor] {json.dumps(record)}", flush=True)
        _append_event(jsonl, record)
        time.sleep(delay)

if __name__ == "__main__":
    sys.exit(main())

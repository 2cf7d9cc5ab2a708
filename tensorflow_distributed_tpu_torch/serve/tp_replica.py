"""One serving replica over N cards (``--serve.mesh-model N``): the
port's own module, standing where the JAX package lets GSPMD run the
engine's programs over one process's N devices.

JAX serves a tensor-parallel replica from ONE process that owns N
devices: its host side (scheduler, radix tree, journal, SLO clocks,
fault plan) exists once, and every program runs SPMD over a ``[data=1,
model=N]`` mesh of the engine's own. PyTorch drives one card a process,
and the port's scheduler admits by wall clock, so lock-stepped copies of
it on N processes would diverge. Here the serving process stays the one
command a user (or the supervisor) starts, and:

- it starts N - 1 worker processes itself (``torch.multiprocessing``,
  ``spawn``), and all N join one process group over a local TCP store:
  NCCL between cards (rank r on ``cuda:K+r`` for ``--device cuda:K``),
  gloo on the CPU. The model
  group is ``parallel/mesh.bootstrap``'s, so each rank builds the model
  with a ``ProcessGroupTP`` and holds H/N heads, d_ff/N columns and its
  heads' slice of the cache;
- the chief (rank 0) runs every host decision. Each device op the
  engine runs (``serve/engine.py``'s ``@replicated`` methods: prefill,
  step, verify, the page copies and fills, the poison drill, warmup,
  and a live swap's reload) is first sent to the workers as a small
  host payload (its name and numpy arguments) over a gloo group of its
  own; each worker runs the same method on its engine, so the
  collectives inside the forward meet. Only the chief reads the tokens
  and the bad-slot flags: the forward's all-reduces and the head's
  all-gather make them the group's;
- the workers die with the chief: each asks the kernel for SIGKILL when
  its parent dies (``prctl(PR_SET_PDEATHSIG)``), so a ``sigkill@N`` of
  the serving process leaves no worker holding a card's memory for the
  next leg;
- the chief dies with a worker: a worker that raises (in its start or in
  a command) prints the traceback and exits 1, and a thread of the
  chief's watches the workers' exits. A rank gone before ``close`` never
  meets the collectives the chief would block in, so the watcher ends
  the chief's process (exit 1, after killing the other workers) rather
  than let it hang: the supervisor restarts that like any crash;
- ``close`` stops the workers within ``STOP_TIMEOUT_S`` (the shutdown
  command, the group's end, the workers' exit) and kills any still
  running at the deadline.

The replica records where its start and stop go (``start_s``,
``stop_s``): the serve summary carries the start, and the stop is
printed after it.
"""

from __future__ import annotations

import ctypes
import multiprocessing.connection
import os
import signal
import socket
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib

PR_SET_PDEATHSIG = 1  # <linux/prctl.h>
STOP_TIMEOUT_S = 30.0  # close(): the group's end and the workers' exit


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def die_with_parent(parent: int) -> None:
    """Have the kernel SIGKILL this process when its parent dies (Linux),
    and exit now if the parent ``parent`` is already gone."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass  # not Linux: the broken command stream still ends a worker
    if os.getppid() != parent:
        os._exit(1)


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:K+rank`` for a replica on
    ``cuda:K`` (``cuda`` is ``cuda:0``), the CPU otherwise."""
    return (torch.device("cuda", (device.index or 0) + rank)
            if device.type == "cuda" else torch.device("cpu"))


def peak_bytes(device: torch.device) -> int:
    """This process's peak of allocated memory on ``device`` (0 on the
    CPU)."""
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _join(rank: int, width: int, device: torch.device, port: int):
    """Join the replica's process group as ``rank`` of ``width``; returns
    (the mesh, with the model group's ``ProcessGroupTP``, the command
    group). Every rank creates the groups in the same order."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=width)
    mesh = mesh_lib.bootstrap(1, 1, device, model=width)
    return mesh, dist.new_group(backend="gloo")


def _end_group(device: torch.device) -> None:
    """``destroy_process_group`` from a thread of its own (``close``
    bounds it), on ``device`` as the thread's current card."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.destroy_process_group()


def _worker(i: int, parent: int, port: int, width: int, device: str,
            threads: int, build: Callable, build_args: Tuple) -> None:
    """Worker ``i`` (rank i + 1): join, build the engine from the
    chief's plan (``build(*build_args, device=, mesh=)``), then run the
    chief's commands until ``shutdown``; then end the group (while the
    chief ends its own: NCCL's teardown waits for every rank) and exit
    at once, skipping the interpreter's teardown. An exception prints
    its traceback and exits 1, which the chief's watcher acts on."""
    die_with_parent(parent)
    torch.set_num_threads(threads)
    rank, name = i + 1, "start"
    try:
        dev = rank_device(torch.device(device), rank)
        mesh, commands = _join(rank, width, dev, port)
        engine = build(*build_args, device=dev, mesh=mesh)
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=commands)
            name, args = box[0]
            if name == "shutdown":
                break
            if name == "peak_bytes":
                dist.gather_object(peak_bytes(dev), None, dst=0,
                                   group=commands)
                continue
            getattr(engine, name)(*args)
        dist.destroy_process_group()
    except BaseException:
        sys.stderr.write(f"[serve] tensor-parallel worker rank {rank} "
                         f"failed in {name}:\n{traceback.format_exc()}")
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)


class Replica:
    """The chief's end of a tensor-parallel replica: the worker processes,
    the command group and the watcher of the workers' exits. ``send``
    is the engine's ``channel``."""

    def __init__(self, procs: List, device: torch.device):
        self.procs = procs
        self.device = device
        self.commands = None
        # The commands sent and the host seconds their sends took (the
        # serve summary's tp_commands and tp_command_s).
        self.sent = 0
        self.send_s = 0.0
        # Seconds by part: start (spawn_join; run.py adds build and
        # warmup) and stop (close()'s shutdown, group_end, workers).
        self.start_s: Dict[str, float] = {}
        self.stop_s: Dict[str, float] = {}
        self._closing = False
        threading.Thread(target=self._watch, daemon=True,
                         name="tp-replica-watch").start()

    def _watch(self) -> None:
        """End this process when a worker exits before ``close``. The
        chief's next collective (NCCL or gloo) would wait for the dead
        rank without end, inside a call no check of the chief's could
        interrupt, so the watcher kills the other workers and exits 1
        (a crash: the supervisor restarts the command)."""
        waiting = {p.sentinel: p for p in self.procs}
        while waiting:
            for s in multiprocessing.connection.wait(list(waiting)):
                p = waiting.pop(s)
                if self._closing:
                    return
                sys.stderr.write(
                    f"[serve] tensor-parallel worker pid {p.pid} exited "
                    f"with code {p.exitcode} while serving: the replica "
                    f"cannot go on without it; ending the chief (exit 1)\n")
                sys.stderr.flush()
                for q in self.procs:
                    if q.is_alive():
                        q.kill()
                os._exit(1)

    def send(self, name: str, args: Sequence) -> None:
        """Broadcast one engine call (its method name and host
        arguments) to every worker."""
        t0 = time.perf_counter()
        dist.broadcast_object_list([(name, tuple(args))], src=0,
                                   group=self.commands)
        self.send_s += time.perf_counter() - t0
        self.sent += 1

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def peak_bytes(self, device: torch.device) -> List[int]:
        """Every rank's peak of allocated device memory, rank order (0 on
        the CPU)."""
        self.send("peak_bytes", ())
        out = [None] * (len(self.procs) + 1)
        dist.gather_object(peak_bytes(device), out, dst=0,
                           group=self.commands)
        return out

    def close(self) -> None:
        """Stop the workers within ``STOP_TIMEOUT_S``: the shutdown
        command, this rank's end of the group while the workers end
        theirs (NCCL's teardown waits for every rank; bounded here by
        the deadline), then the workers' exit; a worker still running at
        the deadline is killed. Records each part's seconds in
        ``stop_s``."""
        self._closing = True
        deadline = time.monotonic() + STOP_TIMEOUT_S
        t0 = time.perf_counter()
        if self.commands is not None:
            try:
                self.send("shutdown", ())
            except (RuntimeError, ValueError):
                pass  # a worker is gone: the kill below ends the rest
            self.commands = None
        t1 = time.perf_counter()
        ended = True
        if dist.is_initialized():
            ender = threading.Thread(target=_end_group, args=(self.device,),
                                     daemon=True)
            ender.start()
            ender.join(max(0.0, deadline - time.monotonic()))
            ended = not ender.is_alive()
        t2 = time.perf_counter()
        killed = []
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
                killed.append(p.pid)
        t3 = time.perf_counter()
        self.stop_s = {"shutdown": round(t1 - t0, 3),
                       "group_end": round(t2 - t1, 3),
                       "workers": round(t3 - t2, 3)}
        if not ended or killed:
            sys.stderr.write(
                f"[serve] tensor-parallel replica: stop past "
                f"{STOP_TIMEOUT_S} s (group ended: {ended}; workers "
                f"killed: {killed})\n")


def start(width: int, device: torch.device, build: Callable,
          build_args: Tuple) -> Tuple[mesh_lib.Mesh, Replica]:
    """Start a replica of ``width`` ranks from this process (rank 0, on
    ``rank_device(device, 0)``): spawn the ``width - 1`` workers, each
    of which builds its engine with ``build(*build_args, device=,
    mesh=)``, and join the group. Returns (this rank's mesh, the
    ``Replica``)."""
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        i, os.getpid(), port, width, str(device), torch.get_num_threads(),
        build, build_args)) for i in range(width - 1)]
    for p in procs:
        p.start()
    chief = rank_device(device, 0)
    replica = Replica(procs, chief)
    try:
        mesh, replica.commands = _join(0, width, chief, port)
    except BaseException:
        replica._closing = True
        for p in procs:
            p.kill()
        raise
    replica.start_s["spawn_join"] = round(time.perf_counter() - t0, 3)
    return mesh, replica

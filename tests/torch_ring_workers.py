"""Spawned ranks for the port's multi-process tests (imports no JAX).

``spawn_ranks`` starts ``world`` processes (the ``spawn`` start method),
each of which joins one process group through a file:// store and runs
a target defined here; it joins them under a deadline, so a deadlocked
point-to-point exchange fails the calling test instead of hanging the
suite. Results travel through files the targets write.
"""

from __future__ import annotations

import multiprocessing
import os
import time

import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 120.0


def _entry(target, rank, world, store, backend, args):
    """One rank (a failure's traceback is printed by multiprocessing and
    the exit code is non-zero)."""
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, world: int, tmp_path, *args, backend: str = "gloo",
                timeout: float = JOIN_TIMEOUT_S) -> None:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    of one process group; raise if any fails or if they have not all
    finished within ``timeout`` seconds (then every rank is killed)."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(tmp_path), "pg_store")
    procs = [ctx.Process(target=_entry,
                         args=(target, r, world, store, backend, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        stuck = [r for r, p in enumerate(procs) if p.is_alive()]
        if stuck:
            raise AssertionError(
                f"ranks {stuck} of {world} still running after {timeout} s "
                f"(a point-to-point deadlock?)")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def ring_cases(rank, world, in_path, out_dir, device="cpu"):
    """``ring_attention`` over a ``ProcessGroupRing`` for every case in
    ``in_path`` (global q, k, v and the output cotangent, plus causal
    and schedule): this rank's output block and its q, k, v grads.
    ``device`` "cuda" puts rank r on card r."""
    from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
        ProcessGroupRing, ring_attention)

    dev = torch.device("cuda", rank) if device == "cuda" else device
    # The first collective has every rank in it (NCCL wants that before
    # point-to-point calls, and a ring permute may leave a rank out).
    dist.all_reduce(torch.zeros(1, device=dev))
    ring = ProcessGroupRing()
    results = []
    for case in torch.load(in_path):
        n = case["q"].shape[1] // world

        def local(x):
            return x[:, rank * n:(rank + 1) * n].to(dev)

        q, k, v = (local(case[name]).requires_grad_()
                   for name in ("q", "k", "v"))
        out = ring_attention(q, k, v, ring, causal=case["causal"],
                             schedule=case["schedule"])
        grads = torch.autograd.grad(out, (q, k, v), local(case["g"]))
        results.append({"out": out.detach().cpu(),
                        "grads": [g.cpu() for g in grads]})
    torch.save(results, os.path.join(str(out_dir), f"rank{rank}.pt"))


def train_run(rank, world, fields, init_path, out_dir, mesh=None):
    """``train()`` with ``--device cpu`` on this rank over the mesh
    ``mesh`` ({axis: size}; ``--mesh.seq world`` when None): its logged
    losses, final eval and parameters."""
    from tensorflow_distributed_tpu_torch.config import (
        MeshConfig, TrainConfig)
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    cfg = TrainConfig(**fields, device="cpu",
                      mesh=MeshConfig(**(mesh or {"seq": world})))
    init = torch.load(init_path) if init_path else None
    res = train(cfg, logger=MetricLogger(enabled=False), init_params=init)
    torch.save({"losses": [r.metrics["loss"] for r in res.logger.records
                           if "loss" in r.metrics],
                "final": res.final_metrics,
                "params": {k: v.detach().clone()
                           for k, v in res.state.model.state_dict().items()}},
               os.path.join(str(out_dir), f"rank{rank}.pt"))


def mesh_groups(rank, world, data, seq, out_dir):
    """``bootstrap(data, seq)`` on this rank: its mesh coordinates, the
    sums of the ranks over its seq group and its data group, and the
    rank its ring's swap permute brings in."""
    from tensorflow_distributed_tpu_torch.parallel.mesh import bootstrap

    mesh = bootstrap(data, seq, torch.device("cpu"))
    sums = {}
    for name, group in (("seq", mesh.seq_group), ("data", mesh.data_group)):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=group)
        sums[name] = float(t)
    swapped = None
    if mesh.ring is not None:
        perm = [(i, i ^ 1) for i in range(seq)]
        swapped = float(mesh.ring.ppermute(torch.tensor([float(rank)]),
                                           perm))
    torch.save({"data_index": mesh.data_index, "seq_index": mesh.seq_index,
                "sums": sums, "swapped": swapped},
               os.path.join(str(out_dir), f"rank{rank}.pt"))

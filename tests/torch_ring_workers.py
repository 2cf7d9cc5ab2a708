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

import numpy as np
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


def eval_run(rank, world, fields, out_dir, mesh):
    """``evaluate_only()`` (``--mode eval``) with ``--device cpu`` on this
    rank over the mesh ``mesh``: its metrics."""
    from tensorflow_distributed_tpu_torch.config import (
        MeshConfig, TrainConfig)
    from tensorflow_distributed_tpu_torch.train.loop import evaluate_only
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    cfg = TrainConfig(**fields, device="cpu", mesh=MeshConfig(**mesh))
    metrics = evaluate_only(cfg, logger=MetricLogger(enabled=False))
    torch.save(metrics, os.path.join(str(out_dir), f"rank{rank}.pt"))


def mesh_groups(rank, world, data, seq, out_dir, model=1):
    """``bootstrap(data, seq, model)`` on this rank: its mesh
    coordinates, the sums of the ranks over its seq, data, model and
    replica groups, and the rank its ring's swap permute brings in."""
    from tensorflow_distributed_tpu_torch.parallel.mesh import bootstrap

    mesh = bootstrap(data, seq, torch.device("cpu"), model)
    sums, tp_sums = {}, {}
    for out, name, group in ((sums, "seq", mesh.seq_group),
                             (sums, "data", mesh.data_group),
                             (tp_sums, "model", mesh.model_group),
                             (tp_sums, "replica", mesh.replica_group)):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=group)
        out[name] = float(t)
    swapped = None
    if mesh.ring is not None:
        perm = [(i, i ^ 1) for i in range(seq)]
        swapped = float(mesh.ring.ppermute(torch.tensor([float(rank)]),
                                           perm))
    torch.save({"data_index": mesh.data_index, "seq_index": mesh.seq_index,
                "model_index": mesh.model_index,
                "sums": sums, "tp_sums": tp_sums, "swapped": swapped},
               os.path.join(str(out_dir), f"rank{rank}.pt"))


def train_runs(rank, world, runs, out_dir):
    """``train()`` with ``--device cpu`` for each (name, fields, mesh,
    init path or None) of ``runs`` in turn on this rank: each run's
    losses (and every logged metric by name), final eval, whole params
    (gathered from a partition's blocks, the model's shards and
    experts), the shapes this rank holds, and the bytes of the params
    and Adam slots it holds (what its tensors take, blocks included)."""
    from tensorflow_distributed_tpu_torch.config import (
        MeshConfig, TrainConfig)
    from tensorflow_distributed_tpu_torch.train.checkpoint import whole_state
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    out = {}
    for name, fields, mesh, init_path in runs:
        cfg = TrainConfig(**fields, device="cpu", mesh=MeshConfig(**mesh))
        init = torch.load(init_path) if init_path else None
        res = train(cfg, logger=MetricLogger(enabled=False),
                    init_params=init)
        state = res.state
        with whole_state(state) as whole:
            params = {k: v.detach().clone() for k, v in whole.params.items()}
        records = [r.metrics for r in res.logger.records
                   if "loss" in r.metrics]
        out[name] = {
            "losses": [m["loss"] for m in records],
            "metrics": {k: [m[k] for m in records] for k in records[0]},
            "local": {k: tuple(v.shape) for k, v in state.params.items()},
            "final": res.final_metrics, "params": params,
            "held": {"params": sum(p.numel() * 4
                                   for p in state.params.values()),
                     "slots": sum(t.numel() * 4 for k in ("mu", "nu")
                                  for t in state.opt_state[k].values())},
            "blocked": sorted(state.partition.blocked)}
    torch.save(out, os.path.join(str(out_dir), f"rank{rank}.pt"))


def explicit_steps(rank, world, init_path, batches_path, runs, out_dir):
    """The explicit-sync train step of a tiny GPT (f32, dropout 0, from
    the init at ``init_path``) over a data mesh of ``world`` gloo ranks,
    for each (name, config fields) of ``runs``: the global batches at
    ``batches_path`` in turn, this rank's rows of each (a batch whose
    index is in the fields' ``poison`` list gets a NaN mask). Saves each
    run's metrics, whole params, Adam slots and EMA, and the shapes of
    its slot tensors on this rank."""
    from tensorflow_distributed_tpu_torch.config import (
        MeshConfig, TrainConfig)
    from tensorflow_distributed_tpu_torch.data.prefetch import to_device
    from tensorflow_distributed_tpu_torch.parallel.mesh import bootstrap
    from tensorflow_distributed_tpu_torch.train.checkpoint import whole_state
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state)
    from tensorflow_distributed_tpu_torch.train.step import make_train_step
    from tensorflow_distributed_tpu_torch.train.tasks import make_mlm_loss

    cpu = torch.device("cpu")
    mesh = bootstrap(world, 1, cpu)
    init = torch.load(init_path)
    batches = torch.load(batches_path)
    out = {}
    for name, fields in runs:
        fields = dict(fields)
        poison = fields.pop("poison", ())
        cfg = TrainConfig(**fields, device="cpu",
                          mesh=MeshConfig(data=world))
        _, state = _build_model_and_state(cfg, cpu, init, mesh, min_size=256)
        step = make_train_step(
            make_mlm_loss(), cpu, cfg.seed, grad_norm_metric=True,
            mesh=mesh, ema_decay=cfg.ema_decay,
            skip_nonfinite=bool(poison), grad_sync=cfg.grad_sync,
            state_template=state, bucket_bytes=8192,
            grad_clip_norm=cfg.grad_clip_norm or 0.0)
        metrics = []
        for i, batch in enumerate(batches):
            n = len(batch["tokens"]) // world
            rows = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
            if i in poison:
                rows["mask"] = rows["mask"] * np.nan
            state, m = step(state, to_device(rows, cpu))
            metrics.append({k: float(v) for k, v in m.items()})
        with whole_state(state) as whole:
            tensors = {f"params/{k}": v.detach().clone()
                       for k, v in whole.params.items()}
            for slot in ("mu", "nu"):
                tensors.update((f"{slot}/{k}", v.clone())
                               for k, v in whole.opt_state[slot].items())
            tensors.update((f"ema/{k}", v.clone())
                           for k, v in whole.ema.items())
        out[name] = {"metrics": metrics, "tensors": tensors,
                     "slot_shapes": {k: tuple(v.shape) for k, v in
                                     state.opt_state["mu"].items()},
                     "blocked": sorted(state.partition.blocked),
                     "plan": step.bucket_plan.describe()}
    torch.save(out, os.path.join(str(out_dir), f"rank{rank}.pt"))


def pipe_runs(rank, world, runs, out_dir):
    """For each (kind, name, fields, mesh, init path or None[, the
    partition rule's threshold]) of ``runs`` in turn on this rank, with
    ``--device cpu``: ``train()`` (kind "train": its losses, final eval,
    whole params, gathered over the pipe, and the leaves its partition
    cuts) or ``evaluate_only()`` (kind "eval": its metrics)."""
    from unittest import mock

    from tensorflow_distributed_tpu_torch.config import (
        MeshConfig, TrainConfig)
    from tensorflow_distributed_tpu_torch.train import loop
    from tensorflow_distributed_tpu_torch.train.checkpoint import whole_state
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    out = {}
    for kind, name, fields, mesh, init_path, *min_size in runs:
        cfg = TrainConfig(**fields, device="cpu", mesh=MeshConfig(**mesh))
        if kind == "eval":
            out[name] = loop.evaluate_only(
                cfg, logger=MetricLogger(enabled=False))
            continue
        init = torch.load(init_path) if init_path else None
        # A lowered threshold cuts a tiny model's leaves.
        build = loop._build_model_and_state
        with mock.patch.object(loop, "_build_model_and_state", (
                lambda *a, **k: build(*a, **k, min_size=min_size[0]))
                if min_size else build):
            res = loop.train(cfg, logger=MetricLogger(enabled=False),
                             init_params=init)
        with whole_state(res.state) as whole:
            params = {k: v.detach().clone() for k, v in whole.params.items()}
        out[name] = {"losses": [r.metrics["loss"] for r in res.logger.records
                                if "loss" in r.metrics],
                     "final": res.final_metrics, "params": params,
                     "local": sorted(res.state.params),
                     "blocked": sorted(res.state.partition.blocked)}
    torch.save(out, os.path.join(str(out_dir), f"rank{rank}.pt"))

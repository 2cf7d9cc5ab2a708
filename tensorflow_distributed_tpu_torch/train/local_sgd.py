"""Local SGD (``--param-sync-every H`` > 1): the port of
``train/local_sgd.py``, the runnable form of the reference's async mode.

The reference's ``sync_replicas=False`` path (SURVEY.md N6) lets each
worker train on its own, mutually diverged parameters between trips to
the parameter server. What survives on a mesh of synchronous ranks is
that dynamics: every data-parallel replica takes optimizer steps on its
own rows with NO gradient sync, and every H-th step the replicas
average their parameters (one all-reduce every H steps instead of one a
step). The optimizer state is never averaged. At H = 1 with plain SGD
it is synchronous data parallelism: avg(p - lr g_r) = p - lr avg(g_r).

A :class:`StackedState` holds the replicas this process trains, each a
whole ``TrainState``: under torchrun (``--mesh.data D``, one process a
replica) its own, and on the stacked transport
(``parallel/mesh.stacked_data``, the tests and the one-card smoke) all
D in turn. Its checkpoint is JAX's replica-stacked ``TrainState``: a
leading [R] dim on every param and optimizer leaf (the counts too) and
``step`` of shape [R] (``train/checkpoint.py``,
``interop.stack_trees``).

Each replica's loss is its own rows' mean (the task's loss built
without a mesh); the metrics are the replicas' means on every step, as
JAX's ``pmean``. Dropout reseeds from (seed, the replica's data index,
the step), as the synchronous step seeds a data rank, so the stacked
transport and torchrun draw the same masks (JAX folds the replica index
into its key). Pure data meshes only (model, seq, pipe and expert 1),
as JAX; no BatchNorm model, EMA, accumulation or skip_batch
(``config.py``'s checks).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from tensorflow_distributed_tpu_torch.data.prefetch import map_batch
from tensorflow_distributed_tpu_torch.parallel.mesh import Mesh
from tensorflow_distributed_tpu_torch.train.optim import global_norm
from tensorflow_distributed_tpu_torch.train.state import (
    TrainState, model_extra)
from tensorflow_distributed_tpu_torch.train.step import (
    Batch, LossFn, Metrics, finish, step_seed)


@dataclasses.dataclass
class StackedState:
    """The replicas this process trains (``mesh.data_ranks`` in order),
    each a whole ``TrainState``; ``mesh`` the data mesh they sit on."""

    replicas: List[TrainState]
    mesh: Mesh

    @property
    def step(self) -> int:
        return self.replicas[0].step

    def params_finite(self) -> bool:
        """Whether every replica's params are finite (a rewind's check)."""
        return all(bool(torch.stack([torch.isfinite(p).all()
                                     for p in r.params.values()]).all())
                   for r in self.replicas)


def stack_state(state: TrainState, mesh: Mesh) -> StackedState:
    """The replicas of ``state`` (a fresh state every data rank holds
    alike): this process's own under torchrun, D copies on the stacked
    transport. Refuses mutable extra state and an EMA, with JAX's
    messages."""
    if model_extra(state.model):
        raise ValueError(
            "local SGD supports models without mutable extra state "
            "(got collections ['batch_stats']); divergent per-"
            "replica statistics have no principled average")
    if state.ema is not None:
        raise ValueError("local SGD does not compose with ema_decay "
                         "(average-of-averages ambiguity); disable one")
    replicas = [state]
    for _ in mesh.data_ranks[1:]:
        replicas.append(TrainState(
            model=copy.deepcopy(state.model), tx=state.tx,
            opt_state=copy.deepcopy(state.opt_state), step=state.step))
    return StackedState(replicas, mesh)


@torch.no_grad()
def averaged_view(stacked: StackedState, opt_state: bool = True
                  ) -> TrainState:
    """The replicas' mean for eval and reporting, as a new state: float
    params averaged over the D replicas (an all-reduce over the data
    group under torchrun), integer ones replica 0's; the optimizer state
    replica 0's, unaveraged (broadcast from data index 0 under torchrun;
    ``opt_state=False`` leaves this process's own, for a params-only
    reader such as eval)."""
    mesh = stacked.mesh
    reps = stacked.replicas
    names = list(reps[0].params)
    mean = {}
    for n in names:
        first = reps[0].params[n].detach()
        if not first.is_floating_point():
            mean[n] = first.clone()
            continue
        total = first.clone()
        for r in reps[1:]:
            total += r.params[n].detach()
        mean[n] = total
    floats = [mean[n] for n in names if mean[n].is_floating_point()]
    if mesh.distributed:
        mesh.data_all_reduce_(floats)
    torch._foreach_div_(floats, float(mesh.data))
    model = copy.deepcopy(reps[0].model)
    for n, p in model.named_parameters():
        p.copy_(mean[n])
    opt = copy.deepcopy(reps[0].opt_state)
    if opt_state and mesh.distributed:
        for group in opt.values():
            if isinstance(group, dict):
                mesh.data_broadcast_(list(group.values()))
    return TrainState(model=model, tx=reps[0].tx, opt_state=opt,
                      step=stacked.step, partition=reps[0].partition)


@torch.no_grad()
def average_params_(stacked: StackedState) -> None:
    """Every replica's float params set to the replicas' mean, in place
    (JAX's ``pmean``: the sum over the data group, then / D)."""
    mesh = stacked.mesh
    reps = stacked.replicas
    names = [n for n, p in reps[0].params.items()
             if p.is_floating_point()]
    sums = [reps[0].params[n].detach().clone() for n in names]
    for r in reps[1:]:
        torch._foreach_add_(sums, [r.params[n].detach() for n in names])
    if mesh.distributed:
        mesh.data_all_reduce_(sums)
    torch._foreach_div_(sums, float(mesh.data))
    for r in reps:
        torch._foreach_copy_([r.params[n].detach() for n in names], sums)


def make_local_sgd_train_step(loss: LossFn, device: torch.device,
                              mesh: Mesh, sync_every: int, seed: int = 0,
                              grad_norm_metric: bool = False
                              ) -> Callable[[StackedState, Batch],
                                            Tuple[StackedState, Metrics]]:
    """The local-SGD step (see the module docstring) of a
    ``StackedState``: each replica's forward, backward and update on its
    rows (``batch`` is this rank's rows, or on the stacked transport the
    global batch, data rank r's contiguous rows to replica r); after the
    update of a step with (step + 1) % ``sync_every`` == 0 the params
    are averaged over the data group. ``loss`` is each replica's own
    mean (a task loss without a mesh). ``grad_norm_metric`` adds each
    replica's pre-clip gradient norm, averaged as the other metrics."""
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    generator = torch.Generator(device=device)

    def step(stacked: StackedState, batch: Batch
             ) -> Tuple[StackedState, Metrics]:
        ranks = mesh.data_ranks
        parts = ([map_batch(lambda t, r=r: t.tensor_split(mesh.data)[r],
                            batch) for r in ranks]
                 if mesh.stacked else [batch])
        do_sync = (stacked.step + 1) % sync_every == 0
        totals: Dict[str, torch.Tensor] = {}
        for r, rep, rows in zip(ranks, stacked.replicas, parts):
            generator.manual_seed(step_seed(seed, r, rep.step))
            value, metrics = loss(rep.model, rows, train=True,
                                  generator=generator)
            value.backward()
            params = rep.params
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            if grad_norm_metric:
                metrics = dict(metrics,
                               grad_norm=global_norm(list(grads.values())))
            with torch.no_grad():
                updates = rep.tx.update(grads, rep.opt_state, params)
                torch._foreach_add_(list(params.values()),
                                    [updates[n] for n in params])
            finish(rep, True, 0.0)
            for k, v in metrics.items():
                v = v.detach().float()
                totals[k] = totals[k] + v if k in totals else v
        if do_sync:
            average_params_(stacked)
        names = sorted(totals)
        packed = torch.stack([totals[k] for k in names])
        mesh.data_all_reduce_([packed])
        packed = packed / mesh.data
        return stacked, {k: packed[i] for i, k in enumerate(names)}

    return step

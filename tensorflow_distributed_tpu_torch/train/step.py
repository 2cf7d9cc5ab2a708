"""Train and eval steps: the port of ``train/step.py``.

A loss function maps (model, batch, train, generator) to (scalar loss,
metrics dict); tasks plug in here and the step machinery stays
task-agnostic. The train step is forward, backward, the gradient sum
over the mesh, the optimizer update, the EMA and the step counter, with
the parameters updated in place. Metrics stay on the device; the loop
fetches them on its cadence.

Every rank of a replica group (the ranks of one model and expert
index: the whole world without a model or expert axis) holds the same
copy of its parameters or shards. After the backward their gradients are summed over it (one flat
all-reduce: the port's form of GSPMD's implicit psum), before clipping,
the grad-norm metric and the optimizer, so the copies stay
bit-identical. The tasks normalize each rank's loss by the global count
(``train/tasks.py``), so the sum is the gradient of the global mean.
Under tensor parallelism a replicated leaf's gradient is already whole
on every model rank (``copy_to_tp`` sums the ranks' parts of the
stream's gradient), and the pre-clip global norm counts each sharded
leaf's square sum summed over the model group (one all-reduce of a
packed vector) and each replicated leaf once (``grad_norm``). A MoE
model's experts cut over an expert group are the same: their gradients
are the rank's own experts', summed over the replica group (which holds
no other expert rank), and their squares are summed over the expert
group in the norm; its router's and the stream's gradients are whole on
every expert rank (``copy_to_tp`` in ``models/moe.py``).

``accum_steps`` A > 1 splits this rank's batch into A microbatches (its
rows of JAX's global microbatches, as the batcher draws them:
``data/batcher.local_rows``), runs each backward on its loss divided by
A, then does one all-reduce and one update: the mean of the microbatch
gradients, as the JAX scan; the metrics are microbatch means.

A model with BatchNorm (the ResNets) computes its new running averages
in the training forward and keeps them pending; the step writes them
with the update (the model's ``commit_batch_stats``): under
accumulation the last microbatch's, as JAX's scan keeps them, and none
on a skipped step.

Under ``--param-partition zero1`` (``TrainState.partition``) the update
runs on this rank's data blocks of the cut leaves against their slot
blocks, the whole gradient's norm handed to the clip, and the params are
all-gathered after it; under fsdp the params are blocks
(``parallel/fsdp.py``): their gradients arrive reduce-scattered, only
the leaves held whole are all-reduced, and the norm sums the blocks'
squares over the data group. ``grad_sync`` serial or overlap builds the
explicit step instead (``parallel/overlap.py``). On the stacked
transport (``parallel/mesh.stacked_data``) one process runs every data
rank's rows in turn (``forward_backward``).

A pipelined model (``--model pipelined_lm``) runs its GPipe schedule
through this step: its loss's backward is the schedule's, and over a
pipe of processes the gradients are summed as ``parallel/pipeline.
sync_pipe_grads_`` says (a stage's blocks over the data and seq groups,
the shell over the pipe group and then the data and seq groups, nothing
over the model group) and the norm sums the stages' blocks over the
pipe group, their cut leaves over the model group first
(``pipe_grad_norm``). Its 1F1B schedule has its own step
(``train/pipeline_step.py``).

``skip_nonfinite`` (``--resilience.nonfinite skip_batch``) discards the
update of a step whose loss or gradient norm is not finite: the params,
the optimizer state and its count, and the EMA keep their values, and
only the step counter advances, as the JAX step's ``where``. The
optimizer's count and learning rate are host numbers here, so the step
reads its verdict on the host before the update (one device sync a step,
under this policy only) and leaves the update out; the metrics carry
``skipped_nonfinite``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.data.prefetch import map_batch
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.parallel.pipeline import (
    pipe_grad_norm, sync_pipe_grads_)
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    is_expert_sharded, is_sharded)
from tensorflow_distributed_tpu_torch.resilience.watchdog import wait_for
from tensorflow_distributed_tpu_torch.train.optim import global_norm
from tensorflow_distributed_tpu_torch.train.state import (
    TrainState, ema_update)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
LossFn = Callable[..., Tuple[torch.Tensor, Metrics]]


def step_seed(seed: int, rank: int, step: int) -> int:
    """The dropout seed of one rank's step: a hash of the three, so no
    two (rank, step) pairs of a run share a stream."""
    return int(np.random.SeedSequence([seed, rank, step]).generate_state(
        1, np.uint64)[0])


def grad_norm(grads: Dict[str, torch.Tensor], mesh: Mesh,
              sharded: frozenset, blocked: frozenset = frozenset(),
              experts: frozenset = frozenset()) -> torch.Tensor:
    """optax.global_norm of the whole model's gradient. Over a model axis
    of processes the ``sharded`` leaves' square sums are summed over the
    model group, over an expert axis the ``experts`` leaves' over the
    expert group, and under fsdp the ``blocked`` leaves' (this rank's
    data blocks) over the data group too (one small all-reduce each); a
    leaf held whole counts once. Without a process group (the stacked
    transport holds every block) it is the one-process sum, leaf by leaf
    in order, so a stacked fsdp run clips as the replicated one does,
    to the bit."""
    if not mesh.distributed or ((mesh.model == 1 or not sharded)
                                and not blocked
                                and (mesh.expert == 1 or not experts)):
        return global_norm(list(grads.values()))
    squares = {n: torch.sum(g.float() ** 2) for n, g in grads.items()}
    zero = torch.zeros((), device=next(iter(squares.values())).device)

    def total(keep):
        # In the gradients' order: every rank adds the same terms in the
        # same order (a set's order differs between processes).
        return sum((v for n, v in squares.items() if keep(n)), zero)

    packed = torch.stack([
        total(lambda n: n in sharded and n in blocked),
        total(lambda n: n in blocked and n not in sharded),
        total(lambda n: n in sharded and n not in blocked)])
    mesh.data_all_reduce_([packed[:2]])
    mesh.model_all_reduce_([packed[0::2]])
    cut = torch.stack([total(lambda n: n in experts)])
    mesh.expert_all_reduce_([cut])
    return torch.sqrt(packed.sum() + cut.sum() + total(
        lambda n: n not in sharded and n not in blocked
        and n not in experts))


def to_host_async(values: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start a copy of ``values`` (a few scalars) to the host, behind the
    work queued so far: on a GPU a non-blocking copy into pinned memory
    and an event recorded after it on the current stream, which a later
    wait (``resilience/watchdog.wait_for``, on any thread) can block on
    without waiting for work queued after it. Returns (the host tensor,
    the event; None on the CPU, where the values are ready)."""
    if not values.is_cuda:
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(values.device))
    return host, done


def batch_count(batch) -> torch.Tensor:
    """The tokens or rows a batch's loss averages over: an LM batch's
    mask sum, a vision batch's rows."""
    if isinstance(batch, dict):
        return batch["mask"].sum().float()
    return torch.tensor(float(len(batch[1])), device=batch[1].device)


def forward_backward(state: TrainState, batch: Batch, loss: LossFn,
                     generator: torch.Generator, seed: int, mesh: Mesh,
                     accum_steps: int = 1, local_mean: bool = False
                     ) -> Metrics:
    """Forward and backward of this process's data ranks over ``batch``
    (this rank's rows; on the stacked transport the global batch, each
    data rank's contiguous rows in turn), leaving the gradients in the
    params' ``.grad``. Returns the metrics. Dropout reseeds ``generator``
    for each rank from (``seed``, its (data, seq) place, the step).

    ``local_mean`` (the explicit sync): each rank's loss is its own mean
    and the stacked ranks' gradients are summed (the sync divides by
    the data width); the metrics are the ranks' mean. Otherwise the
    loss is the global mean (the tasks divide by the replica group's
    count); on the stacked transport, which has no group, each rank's
    own mean is weighted by its share of the global count here.
    ``accum_steps`` > 1 (one rank a process): the microbatches' mean."""
    ranks = mesh.data_ranks if mesh.stacked else [None]
    if mesh.stacked and accum_steps > 1:
        raise ValueError("the stacked data transport runs one microbatch")
    if mesh.stacked and hasattr(state.model, "commit_batch_stats"):
        raise ValueError("the stacked data transport runs the transformer "
                         "families (BatchNorm's statistics are per rank)")
    parts = ([map_batch(lambda t, r=r: t.tensor_split(mesh.data)[r], batch)
              for r in ranks] if mesh.stacked else [batch])
    if mesh.stacked and not local_mean:
        counts = [batch_count(p) for p in parts]
        weights = [c / sum(counts) for c in counts]
    else:
        weights = [1.0 / len(ranks)] * len(ranks)
    metrics: Metrics = {}
    for r, rows, weight in zip(ranks, parts, weights):
        place = mesh.replica_index if r is None else r
        generator.manual_seed(step_seed(seed, place, state.step))
        if accum_steps == 1:
            value, m = loss(state.model, rows, train=True,
                            generator=generator)
            (value if local_mean or not mesh.stacked
             else value * weight).backward()
        else:
            m = {}
            for i in range(accum_steps):
                micro = map_batch(lambda t: t.tensor_split(accum_steps)[i],
                                  rows)
                value, mi = loss(state.model, micro, train=True,
                                 generator=generator)
                (value / accum_steps).backward()
                for k, v in mi.items():
                    m[k] = m.get(k, 0.0) + v.detach() / accum_steps
        for k, v in m.items():
            metrics[k] = metrics.get(k, 0.0) + v.detach() * weight
    return metrics


def verdict(metrics: Metrics, norm: torch.Tensor, sync, step: int):
    """The skip_nonfinite verdict of a step, read on the host: (apply
    the update?, the metrics with ``skipped_nonfinite``)."""
    ok = torch.isfinite(metrics["loss"]) & torch.isfinite(norm)
    host, done = to_host_async(ok.reshape(1))
    (sync or (lambda ev, _: wait_for(ev)))(done, step + 1)
    apply = bool(host[0])
    return apply, dict(metrics, skipped_nonfinite=torch.tensor(
        0.0 if apply else 1.0))


def finish(state: TrainState, apply: bool, ema_decay: float) -> None:
    """A step's end: the BatchNorm statistics kept with an applied
    update, the gradients freed, the EMA, the counter."""
    commit = getattr(state.model, "commit_batch_stats", None)
    if commit is not None:
        commit(keep=apply)
    state.model.zero_grad(set_to_none=True)  # frees the grads early
    if ema_decay and apply:
        ema_update(state.ema, state.params, ema_decay, state.step)
    state.step += 1


def make_train_step(loss: LossFn, device: torch.device, seed: int = 0,
                    grad_norm_metric: bool = False,
                    mesh: Mesh = ONE_PROCESS, accum_steps: int = 1,
                    ema_decay: float = 0.0, skip_nonfinite: bool = False,
                    sync: Optional[Callable[[torch.cuda.Event, int],
                                            object]] = None,
                    grad_sync: str = "implicit",
                    state_template: Optional[TrainState] = None,
                    bucket_bytes: int = 0, grad_clip_norm: float = 0.0
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Metrics]]:
    """Build the train step for a model on ``device``. Dropout draws
    from one generator, reseeded at every step from (``seed``, this
    rank's (data, seq) place, the step counter) as JAX folds the step
    into its dropout key: each rank's rows, or block of a sequence, draw
    their own mask, the model ranks of one place draw the same mask on
    their replicated stream, and a resumed run draws the masks an
    uninterrupted one would. The microbatches draw from it in order.
    ``grad_norm_metric`` reports the pre-clip global gradient norm as
    ``metrics["grad_norm"]``. ``ema_decay`` > 0 updates ``state.ema``
    (which the caller made, ``state.ema_init``) after each update.
    ``skip_nonfinite``: see the module docstring; ``sync(event, step)``,
    when given, waits for the verdict's copy (the loop passes its
    watchdog's ``sync``), else the event is waited on directly.

    ``grad_sync`` "serial" or "overlap" builds the explicit step
    (``parallel/overlap.py``) of ``state_template`` (the state the loop
    steps), with ``bucket_bytes`` (0: 4 MiB) and ``grad_clip_norm``
    (its clip; the implicit step clips in the optimizer). The implicit
    step reads the layout from the state it is given
    (``TrainState.partition``)."""
    if grad_sync != "implicit":
        if accum_steps != 1:
            raise ValueError(
                f"grad_sync={grad_sync!r} has no microbatch scan; "
                f"accum_steps must be 1, got {accum_steps}")
        if state_template is None:
            raise ValueError(
                f"grad_sync={grad_sync!r} needs state_template (the "
                f"state the loop threads: its slot layout is the one the "
                f"sharded update runs against)")
        from tensorflow_distributed_tpu_torch.parallel import overlap
        return overlap.make_explicit_train_step(
            loss, device, mesh, state_template, grad_sync=grad_sync,
            bucket_bytes=bucket_bytes or overlap.DEFAULT_BUCKET_BYTES,
            seed=seed, grad_norm_metric=grad_norm_metric,
            ema_decay=ema_decay, skip_nonfinite=skip_nonfinite,
            grad_clip_norm=grad_clip_norm, sync=sync)
    generator = torch.Generator(device=device)
    sharded = experts = None

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        nonlocal sharded, experts
        if sharded is None:
            sharded = frozenset(n for n in state.params
                                if is_sharded(n, state.model))
            experts = frozenset(n for n in state.params
                                if is_expert_sharded(n, state.model))
        part = state.partition
        params = state.params
        metrics = forward_backward(state, batch, loss, generator, seed,
                                   mesh, accum_steps)
        # fsdp's blocks arrive summed (parallel/fsdp.py's reduce-scatter).
        blocked = part.blocked if part.params_blocked else frozenset()
        piped = mesh.pipe > 1 and mesh.distributed
        if piped:
            sync_pipe_grads_(state.model, mesh)
        grads = {n: p.grad for n, p in params.items()}
        if not piped:
            mesh.replica_all_reduce_([g for n, g in grads.items()
                                      if n not in blocked])
        # Over a model axis, or the data axis under fsdp, the norm
        # (metric, verdict, clip) is one all-reduce, computed once where
        # one of them reads it; the ranks reach one verdict. Under zero1
        # the optimizer sees blocks, so the norm of the whole gradients
        # is handed to its clip; over a pipe, the stages' blocks.
        norm = None
        wanted = grad_norm_metric or skip_nonfinite or state.tx.clip_norm
        if piped and wanted:
            norm = pipe_grad_norm(grads, mesh, state.model.shell_names(),
                                  sharded)
        elif (mesh.model > 1 or mesh.expert > 1 or blocked
                or part.kind == "zero1") and wanted:
            norm = grad_norm(grads, mesh, sharded, blocked, experts)
        if grad_norm_metric:
            metrics = dict(metrics, grad_norm=(
                norm if norm is not None
                else global_norm(list(grads.values()))))
        apply = True
        if skip_nonfinite:
            # The loss sees forward-side NaNs, the global norm (f32, as
            # optax's) backward-only ones: a finite loss over overflowed
            # gradients. One multi-tensor launch for the leaves' norms.
            apply, metrics = verdict(
                metrics, norm if norm is not None else
                torch.linalg.vector_norm(torch.stack(
                    torch._foreach_norm(list(grads.values())))),
                sync, state.step)
        if apply:
            with torch.no_grad():
                views = part.slot_views(params)
                updates = state.tx.update(part.slot_views(grads),
                                          state.opt_state, views, norm=norm)
                torch._foreach_add_(list(views.values()),
                                    [updates[n] for n in views])
                if part.kind == "zero1":
                    gather_blocked_(params, part)
        finish(state, apply, ema_decay)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


@torch.no_grad()
def gather_blocked_(params: Dict[str, torch.Tensor], part) -> None:
    """zero1's all-gather: each blocked param rebuilt in place from the
    data ranks' updated blocks (one collective a leaf, all in flight at
    once; nothing to do on the stacked transport)."""
    mesh = part.mesh
    if not mesh.distributed:
        return
    works = [mesh.all_gather_(params[n].view(-1),
                              part.block(params[n]).clone(), async_op=True)
             for n in sorted(part.blocked)]
    for work in works:
        work.wait()


def _call_with(module: torch.nn.Module, params: Dict[str, torch.Tensor],
               *args, **kwargs):
    """``module(*args, **kwargs)`` with ``params`` in place of its own."""
    return torch.func.functional_call(module, params, args, kwargs)


def make_eval_step(loss: LossFn) -> Callable[[TrainState, Batch], Metrics]:
    """Eval: loss and metrics over one batch, without gradients, on the
    EMA of the params when the state has one (the EMA is params-only: a
    BatchNorm model reads its running averages either way)."""

    def step(state: TrainState, batch: Batch) -> Metrics:
        model = state.model
        if state.ema is not None:
            model = functools.partial(_call_with, state.model, state.ema)
        with torch.no_grad():
            _, metrics = loss(model, batch, train=False)
        return metrics

    return step

"""Train and eval steps: the port of ``train/step.py``.

A loss function maps (model, batch, train, generator) to (scalar loss,
metrics dict); tasks plug in here and the step machinery stays
task-agnostic. The train step is forward, backward, the gradient sum
over the mesh, the optimizer update, the EMA and the step counter, with
the parameters updated in place. Metrics stay on the device; the loop
fetches them on its cadence.

Every rank of a replica group (the ranks of one model index: the whole
world without a model axis) holds the same copy of its parameters or
shards. After the backward their gradients are summed over it (one flat
all-reduce: the port's form of GSPMD's implicit psum), before clipping,
the grad-norm metric and the optimizer, so the copies stay
bit-identical. The tasks normalize each rank's loss by the global count
(``train/tasks.py``), so the sum is the gradient of the global mean.
Under tensor parallelism a replicated leaf's gradient is already whole
on every model rank (``copy_to_tp`` sums the ranks' parts of the
stream's gradient), and the pre-clip global norm counts each sharded
leaf's square sum summed over the model group (one all-reduce of a
packed vector) and each replicated leaf once (``grad_norm``).

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
from tensorflow_distributed_tpu_torch.parallel.sharding import is_sharded
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
              sharded: frozenset) -> torch.Tensor:
    """optax.global_norm of the whole model's gradient. Over a model axis
    of processes the ``sharded`` leaves' square sums are summed over the
    model group in one all-reduce; a replicated leaf counts once."""
    if mesh.model == 1 or not sharded:
        return global_norm(list(grads.values()))
    squares = {n: torch.sum(g.float() ** 2) for n, g in grads.items()}
    packed = torch.stack([sum(squares[n] for n in sharded)])
    mesh.model_all_reduce_([packed])
    return torch.sqrt(packed[0] + sum(v for n, v in squares.items()
                                      if n not in sharded))


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


def make_train_step(loss: LossFn, device: torch.device, seed: int = 0,
                    grad_norm_metric: bool = False,
                    mesh: Mesh = ONE_PROCESS, accum_steps: int = 1,
                    ema_decay: float = 0.0, skip_nonfinite: bool = False,
                    sync: Optional[Callable[[torch.cuda.Event, int],
                                            object]] = None
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
    watchdog's ``sync``), else the event is waited on directly."""
    generator = torch.Generator(device=device)
    sharded = None

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        nonlocal sharded
        if sharded is None:
            sharded = frozenset(n for n in state.params
                                if is_sharded(n, state.model))
        generator.manual_seed(step_seed(seed, mesh.replica_index, state.step))
        params = state.params
        if accum_steps == 1:
            value, metrics = loss(state.model, batch, train=True,
                                  generator=generator)
            value.backward()
        else:
            metrics = {}
            for i in range(accum_steps):
                micro = map_batch(lambda t: t.tensor_split(accum_steps)[i],
                                  batch)
                value, m = loss(state.model, micro, train=True,
                                generator=generator)
                (value / accum_steps).backward()
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v.detach() / accum_steps
        grads = {n: p.grad for n, p in params.items()}
        mesh.replica_all_reduce_(grads.values())
        # Over a model axis the norm (metric, verdict, clip) is one
        # all-reduce, computed once where one of them reads it; the model
        # ranks reach one verdict.
        norm = None
        if mesh.model > 1 and (grad_norm_metric or skip_nonfinite
                               or state.tx.clip_norm):
            norm = grad_norm(grads, mesh, sharded)
        if grad_norm_metric:
            metrics = dict(metrics, grad_norm=(
                norm if norm is not None
                else global_norm(list(grads.values()))))
        apply = True
        if skip_nonfinite:
            # The loss sees forward-side NaNs, the global norm (f32, as
            # optax's) backward-only ones: a finite loss over overflowed
            # gradients. One multi-tensor launch for the leaves' norms.
            verdict = norm if norm is not None else torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(list(grads.values()))))
            ok = torch.isfinite(metrics["loss"]) & torch.isfinite(verdict)
            host, done = to_host_async(ok.reshape(1))
            (sync or (lambda ev, _: wait_for(ev)))(done, state.step + 1)
            apply = bool(host[0])
            metrics = dict(metrics, skipped_nonfinite=torch.tensor(
                0.0 if apply else 1.0))
        if apply:
            with torch.no_grad():
                updates = state.tx.update(grads, state.opt_state, params,
                                          norm=norm)
                torch._foreach_add_(list(params.values()),
                                    [updates[n] for n in params])
        commit = getattr(state.model, "commit_batch_stats", None)
        if commit is not None:
            commit(keep=apply)
        state.model.zero_grad(set_to_none=True)  # frees the grads early
        if ema_decay and apply:
            ema_update(state.ema, params, ema_decay, state.step)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


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

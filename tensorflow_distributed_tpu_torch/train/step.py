"""Train and eval steps: the port of ``train/step.py``.

A loss function maps (model, batch, train, generator) to (scalar loss,
metrics dict); tasks plug in here and the step machinery stays
task-agnostic. The train step is forward, backward, the gradient sum
over the mesh, the optimizer update, the EMA and the step counter, with
the parameters updated in place. Metrics stay on the device; the loop
fetches them on its cadence.

Every rank holds a copy of every parameter. After the backward their
gradients are summed over the whole world (data x seq, one flat
all-reduce: the port's form of GSPMD's implicit psum), before clipping,
the grad-norm metric and the optimizer, so the copies stay
bit-identical. The tasks normalize each rank's loss by the global count
(``train/tasks.py``), so the sum is the gradient of the global mean.

``accum_steps`` A > 1 splits this rank's batch into A microbatches,
runs each backward on its loss divided by A, then does one all-reduce
and one update: the mean of the microbatch gradients, as the JAX scan;
the metrics are microbatch means.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.data.prefetch import map_batch
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
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


def make_train_step(loss: LossFn, device: torch.device, seed: int = 0,
                    grad_norm_metric: bool = False,
                    mesh: Mesh = ONE_PROCESS, accum_steps: int = 1,
                    ema_decay: float = 0.0
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Metrics]]:
    """Build the train step for a model on ``device``. Dropout draws
    from one generator, reseeded at every step from (``seed``, this
    rank's place in the world, the step counter) as JAX folds the step
    into its dropout key: each rank's rows, or block of a sequence, draw
    their own mask, and a resumed run draws the masks an uninterrupted
    one would. The microbatches draw from it in order.
    ``grad_norm_metric`` reports the pre-clip global gradient norm as
    ``metrics["grad_norm"]``. ``ema_decay`` > 0 updates ``state.ema``
    (which the caller made, ``state.ema_init``) after each update."""
    generator = torch.Generator(device=device)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        generator.manual_seed(step_seed(seed, mesh.rank, state.step))
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
        mesh.all_reduce_sum_(grads.values())
        if grad_norm_metric:
            metrics = dict(metrics,
                           grad_norm=global_norm(list(grads.values())))
        with torch.no_grad():
            updates = state.tx.update(grads, state.opt_state, params)
            torch._foreach_add_(list(params.values()),
                                [updates[n] for n in params])
        state.model.zero_grad(set_to_none=True)  # frees the grads early
        if ema_decay:
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
    EMA of the params when the state has one."""

    def step(state: TrainState, batch: Batch) -> Metrics:
        model = state.model
        if state.ema is not None:
            model = functools.partial(_call_with, state.model, state.ema)
        with torch.no_grad():
            _, metrics = loss(model, batch, train=False)
        return metrics

    return step

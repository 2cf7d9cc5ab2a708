"""Train and eval steps: the port of ``train/step.py`` on one device.

A loss function maps (model, batch, train, generator) to (scalar loss,
metrics dict); tasks plug in here and the step machinery stays
task-agnostic. The train step is forward, backward, the optimizer
update and the step counter, with the parameters updated in place.
Metrics stay on the device; the loop fetches them on its cadence.

Under sequence parallelism every rank holds a copy of every parameter;
after the backward their gradients are summed over the seq group (the
port's form of GSPMD's implicit psum), before clipping, the grad-norm
metric and the optimizer, so the copies stay bit-identical.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tensorflow_distributed_tpu_torch.parallel import mesh
from tensorflow_distributed_tpu_torch.train.optim import global_norm
from tensorflow_distributed_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
LossFn = Callable[..., Tuple[torch.Tensor, Metrics]]


def make_train_step(loss: LossFn, device: torch.device, seed: int = 0,
                    grad_norm_metric: bool = False, ring=None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Metrics]]:
    """Build the train step for a model on ``device``. Dropout draws
    from one generator, seeded with ``seed`` (plus the ring position
    under sequence parallelism, so each block of a sequence draws its
    own mask) and advanced by every step. ``grad_norm_metric`` reports
    the pre-clip global gradient norm as ``metrics["grad_norm"]``.
    ``ring``: the seq group's ring; the gradients are summed over it."""
    generator = torch.Generator(device=device).manual_seed(
        seed + (ring.index if ring is not None else 0))

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        params = state.params
        value, metrics = loss(state.model, batch, train=True,
                              generator=generator)
        value.backward()
        grads = {n: p.grad for n, p in params.items()}
        if ring is not None:
            mesh.all_reduce_sum_(grads.values(), ring.group)
        if grad_norm_metric:
            metrics = dict(metrics,
                           grad_norm=global_norm(list(grads.values())))
        with torch.no_grad():
            updates = state.tx.update(grads, state.opt_state, params)
            torch._foreach_add_(list(params.values()),
                                [updates[n] for n in params])
        state.model.zero_grad(set_to_none=True)  # frees the grads early
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(loss: LossFn) -> Callable[[TrainState, Batch], Metrics]:
    """Eval: loss and metrics over one batch, without gradients."""

    def step(state: TrainState, batch: Batch) -> Metrics:
        with torch.no_grad():
            _, metrics = loss(state.model, batch, train=False)
        return metrics

    return step

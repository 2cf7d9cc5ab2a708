"""Train state: the port of ``train/state.py``.

The JAX package threads an immutable pytree through a jitted step; here
the parameters live in an ``nn.Module`` that the step updates in place,
and :class:`TrainState` keeps it together with the optimizer, its state,
the step counter and, with ``ema_decay``, the EMA of the params.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from tensorflow_distributed_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module          # holds the params (f32)
    tx: Optimizer
    opt_state: dict
    step: int = 0
    # f32 exponential moving average of the params by name (eval runs on
    # it), or None.
    ema: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx: Optimizer, seed: int = 0,
                       init_params: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    """Initialize the model's params from a generator seeded with
    ``seed`` on the model's device (the model's ``init_weights``: the
    flax initializers), or copy them from ``init_params`` (a state dict,
    e.g. ``interop.params_from_flax`` of a JAX init), and build the
    optimizer state."""
    device = next(model.parameters()).device
    if init_params is None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(init_params, strict=True)
    params = dict(model.named_parameters())
    return TrainState(model=model, tx=tx, opt_state=tx.init(params))


def ema_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The EMA's start: f32 copies of the params."""
    return {n: p.detach().float().clone() for n, p in params.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               new_params: Dict[str, torch.Tensor], decay: float,
               step: int) -> None:
    """One Polyak step, in place, with the JAX package's warm-up debias:
    the effective decay is min(decay, (1 + step) / (10 + step)), so the
    early steps track the params instead of averaging in the init.
    ``step`` is the step counter before this step's increment, as the
    JAX step passes it."""
    # d and 1 - d in f32, as the JAX step computes them
    d = min(np.float32(decay), np.float32(1.0 + step) / np.float32(10.0 + step))
    names = list(ema)
    torch._foreach_mul_([ema[n] for n in names], float(d))
    torch._foreach_add_([ema[n] for n in names], torch._foreach_mul(
        [new_params[n].float() for n in names], float(np.float32(1.0) - d)))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

"""Train state: the port of ``train/state.py``.

The JAX package threads an immutable pytree through a jitted step; here
the parameters live in an ``nn.Module`` that the step updates in place,
and :class:`TrainState` keeps it together with the optimizer, its state
and the step counter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from tensorflow_distributed_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module          # holds the params (f32)
    tx: Optimizer
    opt_state: dict
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx: Optimizer, seed: int = 0,
                       init_params: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    """Initialize the model's params from a generator seeded with
    ``seed`` on the model's device (the flax initializers, see
    ``TransformerLM.init_weights``), or copy them from ``init_params``
    (a state dict, e.g. ``interop.params_from_flax`` of a JAX init), and
    build the optimizer state."""
    device = next(model.parameters()).device
    if init_params is None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(init_params, strict=True)
    params = dict(model.named_parameters())
    return TrainState(model=model, tx=tx, opt_state=tx.init(params))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

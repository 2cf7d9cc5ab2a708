"""Optimizer construction: optax's update rules as plain tensor code.

The port of ``train/optim.py``. ``make_optimizer`` returns an
:class:`Optimizer` whose ``update`` reproduces the optax chain the JAX
package builds:

- ``clip_by_global_norm`` ahead of everything when grad_clip_norm is set;
- adam: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, bias correction at
  count + 1; adamw adds ``weight_decay * param`` for the leaves
  ``decay_mask`` selects (Linear and Embedding weights, by name — never
  biases or LayerNorm);
- sgd: momentum 0.9 trace;
- scaling by ``-schedule(count)`` with the schedule read at the count
  before this update.

The optimizer state (moments) is updated in place to save memory; the
step adds the returned updates to the params.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
from torch import nn

from tensorflow_distributed_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]
Tensors = Dict[str, torch.Tensor]


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t
                                                    / decay_steps)) + alpha
        return init_value * decayed

    return schedule


def make_schedule(cfg: TrainConfig) -> Schedule:
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        return _cosine(cfg.learning_rate, cfg.train_steps)
    if cfg.lr_schedule == "warmup_cosine":
        # optax.warmup_cosine_decay_schedule(0, peak, warmup, decay):
        # a linear ramp joined to a cosine over decay - warmup steps.
        warmup = max(cfg.warmup_steps, 1)
        decay = max(cfg.train_steps, cfg.warmup_steps + 1)
        peak = cfg.learning_rate
        cosine = _cosine(peak, decay - warmup)

        def schedule(count: int) -> float:
            if count < warmup:
                return peak * count / warmup
            return cosine(count - warmup)

        return schedule
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Weight-decay mask by parameter name: the flax leaves named
    ``kernel`` or ``embedding`` are the ``weight`` of a Linear, a Conv2d
    or an Embedding here; biases and LayerNorm scales/offsets never
    decay."""
    mask = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[full] = (p_name == "weight" and isinstance(
                module, (nn.Linear, nn.Conv2d, nn.Embedding)))
    return mask


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class Optimizer:
    """The optax chain of ``make_optimizer`` over a dict of named f32
    tensors. ``init(params)`` makes the state; ``update(grads, state,
    params)`` advances the state in place and returns the updates."""

    def __init__(self, kind: str, schedule: Schedule,
                 weight_decay: float = 0.0, mask: Dict[str, bool] = None,
                 clip_norm: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, momentum: float = 0.9):
        if kind not in ("adam", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.mask = mask or {}
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum

    def init(self, params: Tensors) -> dict:
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros}
        return {"count": 0, "mu": zeros,
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads: Tensors, state: dict, params: Tensors
               ) -> Tensors:
        names = list(grads)
        g = [grads[n] for n in names]
        if self.clip_norm:
            norm = global_norm(g)
            keep = norm < self.clip_norm
            g = [torch.where(keep, t, t / norm * self.clip_norm) for t in g]
        lr = self.schedule(state["count"])
        state["count"] += 1
        if self.kind == "sgd":
            trace = [state["trace"][n] for n in names]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            u = torch._foreach_mul(trace, -lr)
            return dict(zip(names, u))
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = state["count"]
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(u, denom)
        if self.weight_decay:
            for i, n in enumerate(names):
                if self.mask.get(n, False):
                    u[i].add_(params[n], alpha=self.weight_decay)
        torch._foreach_mul_(u, -lr)
        return dict(zip(names, u))


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> Optimizer:
    """The optimizer of ``cfg`` for ``model``'s parameters (the decay
    mask is read from the model's module types)."""
    return Optimizer(cfg.optimizer, make_schedule(cfg),
                     weight_decay=(cfg.weight_decay
                                   if cfg.optimizer == "adam" else 0.0),
                     mask=decay_mask(model),
                     clip_norm=cfg.grad_clip_norm or 0.0)

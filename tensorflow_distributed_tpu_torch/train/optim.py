"""Optimizer construction: optax's update rules as plain tensor code.

The port of ``train/optim.py``. ``make_optimizer`` returns an
:class:`Optimizer` whose ``update`` reproduces the optax chain the JAX
package builds:

- ``clip_by_global_norm`` ahead of everything when grad_clip_norm is set
  (under tensor parallelism, and under zero1 and fsdp, by the whole
  model's norm, which the step hands in; adam and sgd are elementwise,
  so each rank updates its shards and data blocks alone; adafactor is
  refused there); under the explicit gradient sync (``--grad-sync
  serial|overlap``) the chain has no clip: the step clips by its
  rebuilt norm before the update, as the JAX package's does;
- adam: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, bias correction at
  count + 1; adamw adds ``weight_decay * param`` for the leaves
  ``decay_mask`` selects (Linear and Embedding weights, by name — never
  biases or LayerNorm);
- sgd: momentum 0.9 trace;
- adafactor (``optax.adafactor(sched, weight_decay_rate=…,
  weight_decay_mask=…)`` with optax's defaults: decay_rate 0.8,
  min_dim_size_to_factor 128, clipping_threshold 1.0,
  multiply_by_parameter_scale, eps 1e-30, no momentum): factored RMS
  scaling, block-RMS clip, the learning rate, the param-block-RMS
  scale, the decayed weights (masked), then -1. optax factors a leaf
  over its two largest axes when the second largest is >= 128, on the
  FLAX leaf's shape (``qkv`` [D, 3, H, dh] is not factored, ``mlp/up``
  [D, d_ff] is), so this optimizer decides, and keeps its statistics,
  on each parameter's flax-shaped view (``interop.flax_layout``); a
  ``pipelined_lm``'s JAX leaf stacks every layer ([S, lps, ...]), so its
  layers' tensors form ``groups`` whose block RMS (the clip's and the
  param scale's) is taken over the whole group, summed over the pipe's
  processes by ``group_sum`` (the factoring decision and statistics
  stay per layer, as optax's on a stacked leaf whose S and lps are under
  128);
- scaling by ``-schedule(count)`` with the schedule read at the count
  before this update.

The optimizer state (moments) is updated in place to save memory; the
step adds the returned updates to the params.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models.moe import MoeMlp

Schedule = Callable[[int], float]
Tensors = Dict[str, torch.Tensor]
# Per parameter name: (to_flax, from_flax), its tensors' map to the flax
# leaf's layout and back (``interop.flax_layout``).
Layouts = Dict[str, Tuple[Callable, Callable]]

# optax.adafactor's defaults.
FACTOR_DECAY = 0.8
MIN_DIM_TO_FACTOR = 128
CLIP_BLOCK_RMS = 1.0
PARAM_SCALE_MIN = 1e-3
FACTOR_EPS = 1e-30


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
    or an Embedding here, and a MoE block's ``gate``, ``wi`` and ``wo``
    keep their flax names (JAX decays all five); biases and LayerNorm
    scales/offsets never decay."""
    mask = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[full] = isinstance(module, MoeMlp) or (
                p_name == "weight" and isinstance(
                    module, (nn.Linear, nn.Conv2d, nn.Embedding)))
    return mask


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second largest, largest) axes of
    ``shape`` to factor the second moment over, or None when the leaf
    has fewer than two axes or its second largest is under 128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _decay_rate(count: int) -> float:
    """optax's ``_decay_rate_pow`` at step ``count``: 1 - (count + 1) **
    -0.8 in f32 (the power correctly rounded, as XLA's pow is)."""
    t = np.float32(np.float64(count + 1) ** -FACTOR_DECAY)
    return float(np.float32(1.0) - t)


def _block_rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t * t))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class Optimizer:
    """The optax chain of ``make_optimizer`` over a dict of named f32
    tensors. ``init(params)`` makes the state; ``update(grads, state,
    params)`` advances the state in place and returns the updates.
    Adafactor needs ``layouts`` (every parameter's flax layout)."""

    def __init__(self, kind: str, schedule: Schedule,
                 weight_decay: float = 0.0, mask: Dict[str, bool] = None,
                 clip_norm: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, momentum: float = 0.9,
                 layouts: Optional[Layouts] = None,
                 groups: Optional[Dict[str, str]] = None,
                 group_sum: Optional[Callable[[torch.Tensor], None]] = None):
        """Adafactor's ``groups`` (name -> the JAX leaf it is a slice
        of) share one block RMS; ``group_sum`` sums a tensor of their
        statistics over the processes that hold the group's other
        slices, in place (None: this process holds them all)."""
        if kind not in ("adam", "sgd", "adafactor"):
            raise ValueError(f"unknown optimizer {kind!r}")
        if kind == "adafactor" and layouts is None:
            raise ValueError("adafactor factors on the flax leaves' shapes: "
                             "pass layouts (interop.flax_layout)")
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.mask = mask or {}
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum
        self.layouts = layouts
        self.groups = groups or {}
        self.group_sum = group_sum

    def init(self, params: Tensors) -> dict:
        zeros = {n: torch.zeros_like(p) for n, p in params.items()}
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros}
        if self.kind == "adafactor":
            return self._adafactor_init(params)
        return {"count": 0, "mu": zeros,
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def _adafactor_init(self, params: Tensors) -> dict:
        """optax's ``FactoredState`` per leaf, in the flax leaf's layout:
        a factored leaf keeps v_row and v_col (its shape without the
        largest, and without the second largest, axis) and a (1,)
        placeholder v; any other keeps v (the leaf's shape) and (1,)
        placeholders for v_row and v_col."""
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for n, p in params.items():
            shape = list(self.layouts[n][0](p).shape)
            one = p.new_zeros((1,))
            dims = factored_dims(shape)
            if dims is None:
                state["v_row"][n], state["v_col"][n] = one, one.clone()
                state["v"][n] = p.new_zeros(shape)
            else:
                d1, d0 = dims
                state["v_row"][n] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                state["v_col"][n] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
                state["v"][n] = one
        return state

    def update(self, grads: Tensors, state: dict, params: Tensors,
               norm: Optional[torch.Tensor] = None) -> Tensors:
        """``norm``: the gradient's global norm where the caller has it
        (a tensor-parallel step: ``train/step.grad_norm``); else computed
        here from ``grads``."""
        names = list(grads)
        g = [grads[n] for n in names]
        if self.clip_norm:
            if norm is None:
                norm = global_norm(g)
            keep = norm < self.clip_norm
            g = [torch.where(keep, t, t / norm * self.clip_norm) for t in g]
        if self.kind == "adafactor":
            return self._adafactor_update(dict(zip(names, g)), state, params)
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

    def _adafactor_update(self, grads: Tensors, state: dict,
                          params: Tensors) -> Tensors:
        """optax.adafactor's chain, leaf by leaf in the flax layout, each
        update mapped back to the parameter's layout."""
        count = state["count"]
        decay = _decay_rate(count)
        keep = float(np.float32(1.0) - np.float32(decay))
        lr = self.schedule(count)
        state["count"] += 1
        out, us = {}, {}
        for n, grad in grads.items():
            to_flax = self.layouts[n][0]
            g = to_flax(grad)
            g_sq = g * g + FACTOR_EPS
            dims = factored_dims(list(g.shape))
            if dims is None:
                v = state["v"][n]
                v.mul_(decay).add_(g_sq, alpha=keep)
                u = g * v.pow(-0.5)
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][n], state["v_col"][n]
                v_row.mul_(decay).add_(g_sq.mean(dim=d0), alpha=keep)
                v_col.mul_(decay).add_(g_sq.mean(dim=d1), alpha=keep)
                row_col_mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1,
                                          keepdim=True)
                row_factor = (v_row / row_col_mean).pow(-0.5)
                u = (g * row_factor.unsqueeze(d0)
                     * v_col.pow(-0.5).unsqueeze(d1))
            if n in self.groups:
                us[n] = u  # finished below, by its group's RMS
                continue
            p = to_flax(params[n])
            out[n] = self._finish(n, u, p, lr, _block_rms(u), _block_rms(p))
        flax_params = {n: self.layouts[n][0](params[n]) for n in us}
        rms = self._group_rms(us, flax_params)
        for n, u in us.items():
            out[n] = self._finish(n, u, flax_params[n], lr, *rms[n])
        return {n: out[n] for n in grads}

    def _finish(self, n: str, u: torch.Tensor, p: torch.Tensor, lr: float,
                u_rms: torch.Tensor, p_rms: torch.Tensor) -> torch.Tensor:
        """The chain after the factored scaling, given the update's and
        the param's block RMS: the clip, the learning rate, the param
        scale, the decayed weights, -1; back in the param's layout."""
        # clip_by_block_rms(1.0)
        u = u / torch.clamp(u_rms / CLIP_BLOCK_RMS, min=1.0)
        u = u * lr
        # scale_by_param_block_rms(1e-3)
        u = u * torch.clamp(p_rms, min=PARAM_SCALE_MIN)
        if self.weight_decay and self.mask.get(n, False):
            u = u + self.weight_decay * p
        return self.layouts[n][1](-u)

    def _group_rms(self, us: Tensors, flax_params: Tensors):
        """name -> (the update's, the param's) block RMS over its group,
        for every grouped name: the sums of squares and sizes of the
        group's slices in this process, summed by ``group_sum`` (in f64:
        a stacked leaf's size passes 2^24)."""
        keys = sorted({self.groups[n] for n in us if n in self.groups})
        if not keys:
            return {}
        at = {k: i for i, k in enumerate(keys)}
        zero = torch.zeros((), dtype=torch.float64,
                           device=next(iter(us.values())).device)
        sums = [[zero, zero, 0] for _ in keys]
        for n, u in us.items():
            if n in self.groups:
                row = sums[at[self.groups[n]]]
                row[0] = row[0] + torch.sum(u.double() ** 2)
                row[1] = row[1] + torch.sum(flax_params[n].double() ** 2)
                row[2] += u.numel()
        packed = torch.stack([torch.stack([a, b, zero + c])
                              for a, b, c in sums])
        if self.group_sum is not None:
            self.group_sum(packed)
        means = torch.sqrt(packed[:, :2] / packed[:, 2:]).float()
        return {n: (means[at[k], 0], means[at[k], 1])
                for n, k in self.groups.items() if n in us}


def make_optimizer(cfg: TrainConfig, model: nn.Module,
                   group_sum: Optional[Callable[[torch.Tensor], None]] = None
                   ) -> Optimizer:
    """The optimizer of ``cfg`` for ``model``'s parameters (the decay
    mask is read from the model's module types; adafactor's layouts from
    ``interop.flax_layout``, and for a pipelined model its groups: each
    block parameter's JAX leaf, summed over the pipe by ``group_sum``)."""
    layouts, groups = None, None
    if cfg.optimizer == "adafactor":
        # interop reaches this module through train/state.py: import it
        # here, once the package is loaded.
        from tensorflow_distributed_tpu_torch.interop import flax_layout

        layouts = {n: flax_layout(model, n)[1:]
                   for n, _ in model.named_parameters()}
        if getattr(model, "is_pipelined", False):
            shell = set(model.shell_names())
            groups = {n: "/".join(flax_layout(model, n)[0][1:])
                      for n, _ in model.named_parameters()
                      if n not in shell}
    return Optimizer(cfg.optimizer, make_schedule(cfg),
                     weight_decay=(cfg.weight_decay
                                   if cfg.optimizer != "sgd" else 0.0),
                     mask=decay_mask(model),
                     clip_norm=((cfg.grad_clip_norm or 0.0)
                                if cfg.grad_sync == "implicit" else 0.0),
                     layouts=layouts, groups=groups, group_sum=group_sum)

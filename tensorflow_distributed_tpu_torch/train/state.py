"""Train state: the port of ``train/state.py``.

The JAX package threads an immutable pytree through a jitted step; here
the parameters live in an ``nn.Module`` that the step updates in place,
and :class:`TrainState` keeps it together with the optimizer, its state,
the step counter and, with ``ema_decay``, the EMA of the params. The
JAX state's ``extra`` (the non-param collections: a ResNet's BatchNorm
``batch_stats``) are the model's BN buffers here (``TrainState.extra``,
the model's ``batch_stats()``); the train step writes them, and
checkpoints carry them (``interop.extra_to_flax``).

``TrainState.partition`` says which tensors live as data blocks
(``--param-partition``; ``partition_state_``), as the JAX
``create_train_state(fsdp=, opt_fsdp=)`` places them: under zero1 the
optimizer slots of every param that ``parallel/sharding.data_blocked``
names are this process's data blocks of them (``[1, numel / data]``, or
``[data, numel / data]`` on the stacked transport) and the params and
the EMA stay whole; under fsdp the params (``parallel/fsdp.py``), and so
their slots and EMA, are blocks too. The buffers (BatchNorm's
statistics) are never cut.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    FSDP_MIN_SIZE, data_block, data_blocked)
from tensorflow_distributed_tpu_torch.train.optim import Optimizer

PARTITIONS = ("replicated", "zero1", "fsdp")


@dataclasses.dataclass(frozen=True)
class Partition:
    """The data-axis layout of a train state (``--param-partition``):
    ``blocked`` names the params whose slots (zero1), or whose params,
    slots and EMA (fsdp), are this process's data blocks of ``mesh``;
    ``shapes`` their whole (local) shapes; ``min_size`` the rule's
    threshold (JAX's ``fsdp_min_size``)."""

    kind: str = "replicated"
    mesh: Mesh = ONE_PROCESS
    blocked: frozenset = frozenset()
    shapes: Mapping[str, torch.Size] = dataclasses.field(
        default_factory=dict)
    min_size: int = FSDP_MIN_SIZE

    @property
    def params_blocked(self) -> bool:
        return self.kind == "fsdp" and bool(self.blocked)

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This process's blocks of a blocked param's whole tensor (a
        view of a contiguous one)."""
        return data_block(t.contiguous(), self.mesh.data,
                          self.mesh.data_ranks)

    def _cut(self, tensors: Dict[str, torch.Tensor], kinds
             ) -> Dict[str, torch.Tensor]:
        """``tensors`` with the blocked ones' blocks (views) under the
        layouts ``kinds``."""
        if self.kind not in kinds:
            return dict(tensors)
        return {n: self.block(t) if n in self.blocked else t
                for n, t in tensors.items()}

    def slot_views(self, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Param-shaped tensors (params, gradients) as the optimizer's
        slots are laid out: a blocked leaf's blocks under zero1 (fsdp's
        params and gradients are blocks already)."""
        return self._cut(tensors, ("zero1",))

    def cut_params(self, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Whole params (or EMA tensors, a restore's) as this layout
        holds them: the blocked ones' blocks under fsdp."""
        return self._cut(tensors, ("fsdp",))

    def cut_slots(self, tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Whole slot tensors (a restore's) as this layout holds them:
        the blocked ones' blocks under zero1 and fsdp."""
        return self._cut(tensors, ("zero1", "fsdp"))

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` (a param's, slot's or EMA's tensor) whole: a blocked
        one gathered over the data group (every data rank calls it)."""
        if name not in self.blocked or tuple(t.shape) == tuple(
                self.shapes[name]):
            return t
        from tensorflow_distributed_tpu_torch.parallel.fsdp import (
            gather_param)
        return gather_param(t, self.shapes[name], self.mesh)

    def resident_bytes(self, params: Dict[str, torch.Tensor],
                       slots: int) -> Dict[str, int]:
        """The bytes one data rank holds between steps: its params, its
        synced gradient (the blocks under fsdp) and its ``slots``
        optimizer slots per param (f32)."""
        out = {"params": 0, "grads": 0, "slots": 0}
        for n, p in params.items():
            whole = self.shapes.get(n, p.shape).numel() * 4
            cut = whole // self.mesh.data if n in self.blocked else whole
            fsdp = cut if self.kind == "fsdp" else whole
            out["params"] += fsdp
            out["grads"] += fsdp
            out["slots"] += slots * (whole if self.kind == "replicated"
                                     else cut)
        return out


REPLICATED = Partition()


@dataclasses.dataclass
class TrainState:
    model: nn.Module          # holds the params (f32)
    tx: Optimizer
    opt_state: dict
    step: int = 0
    # f32 exponential moving average of the params by name (eval runs on
    # it), or None.
    ema: Optional[Dict[str, torch.Tensor]] = None
    partition: Partition = REPLICATED

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def extra(self) -> Dict[str, torch.Tensor]:
        return model_extra(self.model)


def model_extra(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The non-param state by buffer name: a BatchNorm model's running
    means and variances (its ``batch_stats``), empty for the other
    families."""
    stats = getattr(model, "batch_stats", None)
    return {} if stats is None else stats()


def create_train_state(model: nn.Module, tx: Optimizer, seed: int = 0,
                       init_params: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    """Initialize the model's params from a generator seeded with
    ``seed`` on the model's device (the model's ``init_weights``: the
    flax initializers), or copy them from ``init_params`` (a state dict,
    e.g. ``interop.params_from_flax`` of a JAX init, buffers optional),
    and build the optimizer state."""
    device = next(model.parameters()).device
    if init_params is None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    else:
        # Every param; a buffer left out (BatchNorm's running averages)
        # keeps its init (mean 0, variance 1: flax's).
        missing, unexpected = model.load_state_dict(init_params,
                                                    strict=False)
        stray = set(missing) - set(dict(model.named_buffers()))
        if unexpected or stray:
            raise ValueError(f"init_params do not match the model: missing "
                             f"{sorted(stray)}, unexpected {unexpected}")
    params = dict(model.named_parameters())
    return TrainState(model=model, tx=tx, opt_state=tx.init(params))


def partition_state_(state: TrainState, kind: str, mesh: Mesh,
                     min_size: int = FSDP_MIN_SIZE) -> None:
    """Lay ``state`` (a fresh one, every rank holding the same whole
    params, no EMA yet) out as ``--param-partition kind`` over ``mesh``'s
    data axis: under fsdp the blocked params become this process's
    blocks (``parallel/fsdp.shard_params_``); the optimizer state is
    made again on the slots' layout (zero1 and fsdp: the blocked
    leaves' blocks). ``min_size``: the rule's threshold (tests lower it
    to cut a tiny model)."""
    if kind not in PARTITIONS:
        raise ValueError(f"unknown param_partition {kind!r}")
    if kind == "replicated" or mesh.data == 1:
        # The threshold still sizes the explicit sync's plan.
        state.partition = dataclasses.replace(REPLICATED, min_size=min_size)
        return
    if mesh.stacked and (mesh.tp is not None or mesh.seq > 1):
        raise ValueError("the stacked data transport holds data ranks "
                         "only (no model or seq axis)")
    blocked = data_blocked(state.model, mesh.data, min_size)
    shapes = {n: p.shape for n, p in state.params.items() if n in blocked}
    if kind == "fsdp":
        from tensorflow_distributed_tpu_torch.parallel.fsdp import (
            shard_params_)
        shard_params_(state.model, blocked, mesh)
    state.partition = Partition(kind, mesh, blocked, shapes, min_size)
    state.opt_state = state.tx.init(state.partition.slot_views(state.params))


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

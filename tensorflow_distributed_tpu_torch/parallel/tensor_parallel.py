"""Megatron tensor parallelism's transport: the port's form of what
GSPMD inserts around the JAX model's ``nn.with_partitioning`` layout
(``models/transformer.py``) over the mesh's ``model`` axis.

Each of M model ranks holds H/M query heads and d_ff/M hidden columns of
every block (and, under ``--shard-vocab`` or with the untied head, V/M
vocab rows). The residual stream is replicated over the M ranks. Two
``torch.autograd.Function``s, the Megatron conjugate pair, carry it in
and out of the sharded layers:

- ``copy_to_tp``: identity forward, sum over the model ranks backward.
  In front of the column-parallel layers (qkv or q, the MLP's up and
  gate, the sharded head): each rank's input gradient is only its
  columns' part.
- ``reduce_from_tp``: sum over the model ranks forward, identity
  backward. After the row-parallel layers (out, down) and the
  vocab-parallel lookups: each rank holds a partial sum.

They are written once against a transport, as the ring's bodies are
(``parallel/ring_attention.py``):

- ``ProcessGroupTP(group)``: one model rank per process (NCCL between
  cards, gloo on the CPU). This process holds one rank's shard.
- ``StackedTP(M)``: all M ranks in one process, for the tests and the
  one-card smoke. The replicated stream is one tensor; a sharded
  parameter holds the M ranks' shards on a leading dim.

Either way a sharded activation is a list of this process's ranks'
parts (one under ``ProcessGroupTP``, M under ``StackedTP``), and
``split`` gives a sharded parameter's parts. No collective runs inside
a hand kernel: the kernels see one rank's shapes.

Inference (the decode branch, ``models/generate.py`` and the serving
engines) adds two helpers: ``full_logits`` gathers vocab-parallel
logits to the whole vocabulary (an all-gather under ``ProcessGroupTP``,
a concatenation under ``StackedTP``), and ``head_part`` gives a rank
its slice of a decode-cache leaf, whose head axis (dim 2) holds this
process's ranks' K/V heads side by side. ``broadcast_`` hands every
rank the first rank's value of a host decision (a sampled token).
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import List, Optional

import torch
import torch.distributed as dist

Parts = List[torch.Tensor]


@torch.no_grad()
def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ProcessGroupTP:
    """One model rank per process of ``group`` (the default group when
    None): the rank is this process's place in the group."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.indices = [self.index]

    def split(self, param: torch.Tensor) -> Parts:
        return [param]

    def copy_to_tp(self, x: torch.Tensor) -> Parts:
        return [_CopyToTP.apply(x, self.group)]

    def reduce_from_tp(self, parts: Parts) -> torch.Tensor:
        return _ReduceFromTP.apply(parts[0], self.group)

    def sum(self, parts: Parts) -> torch.Tensor:
        """The ranks' parts summed, outside autograd."""
        return _all_reduce(parts[0], self.group)

    def max(self, parts: Parts) -> torch.Tensor:
        return _all_reduce(parts[0], self.group, dist.ReduceOp.MAX)

    def min(self, parts: Parts) -> torch.Tensor:
        return _all_reduce(parts[0], self.group, dist.ReduceOp.MIN)

    @torch.no_grad()
    def gather(self, parts: Parts) -> Parts:
        """Every rank's part, in rank order."""
        part = parts[0].contiguous()
        out = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(out, part, group=self.group)
        return out

    @torch.no_grad()
    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` overwritten in place with the group's first rank's value
        (and returned)."""
        dist.broadcast(t, dist.get_global_rank(self.group or
                                               dist.group.WORLD, 0),
                       group=self.group)
        return t


class StackedTP:
    """All M model ranks in one process: a sharded parameter is [M, ...]
    (``split`` unbinds it), the replicated stream one tensor, and the
    collectives are sums, maxima and minima over the parts. Feeding one
    replicated tensor to the M ranks' layers makes autograd sum their
    gradients: that is ``copy_to_tp``'s backward."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"model axis must be >= 1, got {size}")
        self.size = size
        self.index = 0
        self.indices = list(range(size))

    def split(self, param: torch.Tensor) -> Parts:
        return list(param.unbind(0))

    def copy_to_tp(self, x: torch.Tensor) -> Parts:
        return [x] * self.size

    def reduce_from_tp(self, parts: Parts) -> torch.Tensor:
        return functools.reduce(operator.add, parts)

    @torch.no_grad()
    def sum(self, parts: Parts) -> torch.Tensor:
        return functools.reduce(operator.add, parts)

    def max(self, parts: Parts) -> torch.Tensor:
        return torch.stack(parts).amax(0)

    def min(self, parts: Parts) -> torch.Tensor:
        return torch.stack(parts).amin(0)

    def gather(self, parts: Parts) -> Parts:
        return list(parts)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        return t  # one process: every rank already holds its value


def local_ranks(tp) -> int:
    """How many model ranks this process holds (1 without TP)."""
    return 1 if tp is None else len(tp.indices)


def head_part(leaf: torch.Tensor, tp, i: int) -> torch.Tensor:
    """This process's ``i``-th rank's slice (a view) of a decode-cache
    leaf whose dim 2 is the head axis ([rows, len, heads, Dh] K/V, or
    [rows, len, heads] int8 scales; a paged pool's [pages, page_size,
    ...] alike): the leaf holds its ranks' heads side by side, JAX's
    ``shard_cache`` layout (``P(None, None, "model")``) in one
    process."""
    n = leaf.shape[2] // local_ranks(tp)
    return leaf.narrow(2, i * n, n)


def full_logits(out) -> torch.Tensor:
    """Logits over the whole vocabulary: a ``VocabShards`` gathered and
    cut to the real ids (``shard_vocab``'s padding dropped), anything
    else (whole logits) as it is. For inference only: the training
    losses never build the full [B, L, V]."""
    return out.gathered() if isinstance(out, VocabShards) else out


@dataclasses.dataclass
class VocabShards:
    """A vocab-sharded head or its logits: each model rank holds
    ``rows`` consecutive vocab ids, rank m ids ``[m*rows, (m+1)*rows)``;
    ids at or past ``vocab_size`` are padding (and the [MASK] sentinel),
    which every loss masks. ``parts``: this process's ranks' logits
    [..., rows] or head rows [rows, D]; ``biases``: the head's bias
    rows, or None."""

    parts: Parts
    rows: int
    vocab_size: int
    tp: object
    biases: Optional[Parts] = None

    def offsets(self) -> List[int]:
        """The first vocab id of each part."""
        return [m * self.rows for m in self.tp.indices]

    def gathered(self) -> torch.Tensor:
        """Every rank's logits joined on the last axis and cut to the
        real vocabulary (a test's view; the loss never builds it)."""
        full = torch.cat(self.tp.gather([p.contiguous()
                                         for p in self.parts]), dim=-1)
        return full[..., :self.vocab_size]

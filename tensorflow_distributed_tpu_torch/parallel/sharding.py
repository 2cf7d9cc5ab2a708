"""Which parameter each model rank holds which part of: the port of
``parallel/sharding.py``'s tensor-parallel rule (``param_sharding``)
over the port's ``nn.Linear`` ``[out, in]`` layout.

The JAX model marks each leaf with ``nn.with_partitioning``; here a
table by parameter name says along which dim, and in which view, a full
tensor is cut into M equal parts:

===========================  ==========  =============================
parameter                    flax leaf   cut of the port's tensor
===========================  ==========  =============================
``attn.qkv.weight`` / bias   [D,3,H,Dh]  rows viewed (3, H*Dh): H
``attn.q.weight`` / bias     [D,H,Dh]    rows (H)
``attn.kv.*``                [D,2,nk,Dh] replicated
``attn.out.weight``          [H,Dh,D]    columns (H); its bias replicated
``mlp.up``, ``mlp.gate``     [D,d_ff]    rows (d_ff), bias too
``mlp.down.weight``          [d_ff,D]    columns (d_ff); bias replicated
``lm_head.weight`` / bias    [D,V(+p)]   rows (vocab), padded to M*R
``tok_emb.weight``           [V+e+p,D]   rows, with ``--shard-vocab``
===========================  ==========  =============================

Everything else (norms, positions, the replicated biases) is whole on
every rank. ``shard_state_dict`` cuts a full state dict (an init, a
checkpoint's params or moments) to this process's ranks;
``gather_state_dict`` joins the ranks' parts back into the full
tensors (a collective over the model group under ``ProcessGroupTP``),
which is what a checkpoint holds. FSDP and ZeRO (``--param-partition``)
are not ported (ROADMAP.md A5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    StackedTP)

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Cut:
    """A full tensor's dim ``dim`` viewed as (``groups``, n / groups)
    and cut in M along the second; ``pad_rows`` > 0: dim 0 holds that
    many real rows and is zero-padded to a multiple of M first (the
    gather drops the padding)."""

    dim: int = 0
    groups: int = 1
    pad_rows: int = 0


ROWS, COLS, QKV = Cut(0), Cut(1), Cut(0, groups=3)
_BLOCK_CUTS = {"attn.qkv.weight": QKV, "attn.qkv.bias": QKV,
               "attn.q.weight": ROWS, "attn.q.bias": ROWS,
               "attn.out.weight": COLS,
               "mlp.up.weight": ROWS, "mlp.up.bias": ROWS,
               "mlp.gate.weight": ROWS, "mlp.gate.bias": ROWS,
               "mlp.down.weight": COLS}


def param_cut(name: str, model) -> Optional[Cut]:
    """The cut of the TP model ``model``'s parameter ``name``, or None
    when every rank holds all of it."""
    if name.startswith("layer_"):
        return _BLOCK_CUTS.get(name.split(".", 1)[1])
    if name.startswith("lm_head."):
        # The param has head_rows rows; without --shard-vocab V is not
        # padded in the param, only in the ranks' parts.
        return Cut(pad_rows=model.head_rows)
    if name == "tok_emb.weight" and model.cfg.shard_vocab:
        return ROWS
    return None


def _view(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    shape = list(t.shape)
    d = cut.dim
    return t.reshape(shape[:d] + [cut.groups, shape[d] // cut.groups]
                     + shape[d + 1:])


def cut_part(full: torch.Tensor, cut: Cut, m: int, size: int
             ) -> torch.Tensor:
    """Rank ``m``'s part of ``full`` (a copy) of ``size`` ranks."""
    if cut.pad_rows:
        pad = (-cut.pad_rows) % size
        full = F.pad(full, (0, 0) * (full.dim() - 1) + (0, pad))
    part = _view(full, cut).chunk(size, cut.dim + 1)[m]
    shape = list(full.shape)
    shape[cut.dim] //= size
    return part.reshape(shape).clone()


def join_parts(parts, cut: Cut) -> torch.Tensor:
    """The full tensor from every rank's part, in rank order."""
    full = torch.cat([_view(p, cut) for p in parts], dim=cut.dim + 1)
    shape = list(parts[0].shape)
    shape[cut.dim] *= len(parts)
    full = full.reshape(shape)
    return full[:cut.pad_rows] if cut.pad_rows else full


def shard_state_dict(full: Tensors, model) -> Tensors:
    """This process's part of a full state dict (names of ``model``, a
    TP model): a sharded tensor becomes this rank's part under
    ``ProcessGroupTP``, the M parts stacked under ``StackedTP``; the
    others stay whole."""
    tp = model.tp
    out = {}
    for name, t in full.items():
        cut = param_cut(name, model)
        if cut is None:
            out[name] = t
            continue
        parts = [cut_part(t, cut, m, tp.size) for m in tp.indices]
        out[name] = (torch.stack(parts) if isinstance(tp, StackedTP)
                     else parts[0])
    return out


def gather_state_dict(local: Tensors, model) -> Tensors:
    """The full tensors of this process's parts (``shard_state_dict``'s
    inverse). Under ``ProcessGroupTP`` every rank of the model group
    must call it (an all-gather a sharded tensor)."""
    tp = model.tp
    out = {}
    for name, t in local.items():
        cut = param_cut(name, model)
        if cut is None:
            out[name] = t
            continue
        parts = tp.gather(tp.split(t))
        out[name] = join_parts(parts, cut)
    return out


# The flax leaves' PartitionSpecs over the model axis, by (module, leaf)
# (JAX's ``nn.with_partitioning`` names), for a checkpoint's mesh.json.
_FLAX_SPECS = {("qkv", "kernel"): (None, None, "model", None),
               ("qkv", "bias"): (None, "model", None),
               ("q", "kernel"): (None, "model", None),
               ("q", "bias"): ("model", None),
               ("out", "kernel"): ("model", None, None),
               ("up", "kernel"): (None, "model"), ("up", "bias"): ("model",),
               ("gate", "kernel"): (None, "model"),
               ("gate", "bias"): ("model",),
               ("down", "kernel"): ("model", None),
               ("lm_head", "kernel"): (None, "model"),
               ("lm_head", "bias"): ("model",)}


def flax_spec(path, shard_vocab: bool) -> str:
    """The ``PartitionSpec`` string of a checkpoint leaf (its ``/``
    path's parts) written under a model axis."""
    key = tuple(path[-2:])
    spec = _FLAX_SPECS.get(key)
    if key == ("tok_emb", "embedding") and shard_vocab:
        spec = ("model", None)
    if spec is None:
        return "PartitionSpec()"
    return "PartitionSpec(" + ", ".join(
        "'model'" if a else "None" for a in spec) + ")"


def is_sharded(name: str, model) -> bool:
    return getattr(model, "tp", None) is not None and \
        param_cut(name, model) is not None

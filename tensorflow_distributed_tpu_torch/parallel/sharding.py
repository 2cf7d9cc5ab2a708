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
``moe_mlp.wi``, ``.wo``      [E,D,F]...  dim 0 (experts), over the
                                         expert group
===========================  ==========  =============================

Everything else (norms, positions, the replicated biases, a MoE
block's ``gate``) is whole on every rank. The experts are cut over the
model's ``ep`` transport (the expert group, or the model group where
the experts take the model axis), every other cut over ``tp``
(``param_transport``). ``shard_state_dict`` cuts a full state dict (an
init, a checkpoint's params or moments) to this process's ranks;
``gather_state_dict`` joins the ranks' parts back into the full
tensors (a collective over the group under ``ProcessGroupTP``), which
is what a checkpoint holds.

Over the data axis (``--param-partition fsdp|zero1``) a leaf is cut into
``data`` blocks exactly where the JAX package's rule cuts it
(``param_sharding(fsdp=True)``: ``FSDP_MIN_SIZE``, ``fsdp_scatter_dim``
and ``_fsdp_axis_choice``, kept here as the port's own copies). The rule
runs on the flax leaf's shape (``interop.flax_layout``) at the whole
model's size, with the dims tensor parallelism takes, so the set of cut
leaves (``data_blocked``) is JAX's for every family. Where a block sits
is the port's choice: data rank i holds row i of the rank's local
tensor viewed as ``[data, numel / data]`` (``data_block``), a flat
1/data slice, so the blocks of a bucket of leaves are contiguous. A
pipelined model's leaves follow the rule on JAX's stacked leaves
(``_pipelined_data_blocked``): a block's [S, lps, ...] stack of every
layer, with the pipe on its first dim and its ``_TP_SUFFIX`` names, and
the shell's whole, unnamed leaves; the shell is never cut over the
model axis (``param_cut``).
"""

from __future__ import annotations

import dataclasses
import math
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
               "mlp.down.weight": COLS,
               "moe_mlp.wi": ROWS, "moe_mlp.wo": ROWS}
_EXPERT_CUTS = ("moe_mlp.wi", "moe_mlp.wo")


def param_transport(name: str, model):
    """The transport that cuts ``model``'s parameter ``name`` (if any
    does): the expert group's for a MoE block's experts, the model
    group's otherwise; None without one."""
    if name.startswith("layer_") and name.split(".", 1)[1] in _EXPERT_CUTS:
        return getattr(model, "ep", None)
    return getattr(model, "tp", None)


def is_split(model) -> bool:
    """Whether ``model`` holds a part of any parameter (a model or an
    expert transport)."""
    return (getattr(model, "tp", None) is not None
            or getattr(model, "ep", None) is not None)


def param_cut(name: str, model) -> Optional[Cut]:
    """The cut of the TP or EP model ``model``'s parameter ``name`` by the
    table (``param_transport`` says over which group, or None where the
    model has none), or None when every rank holds all of it."""
    if name.startswith("layer_"):
        return _BLOCK_CUTS.get(name.split(".", 1)[1])
    if getattr(model, "is_pipelined", False):
        return None  # JAX's pipelined shell carries no TP names
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
    TP or EP model): a sharded tensor becomes this rank's part under
    ``ProcessGroupTP``, the M parts stacked under ``StackedTP``; the
    others stay whole."""
    out = {}
    for name, t in full.items():
        cut, tp = param_cut(name, model), param_transport(name, model)
        if cut is None or tp is None:
            out[name] = t
            continue
        parts = [cut_part(t, cut, m, tp.size) for m in tp.indices]
        out[name] = (torch.stack(parts) if isinstance(tp, StackedTP)
                     else parts[0])
    return out


def gather_state_dict(local: Tensors, model) -> Tensors:
    """The full tensors of this process's parts (``shard_state_dict``'s
    inverse). Under ``ProcessGroupTP`` every rank of the model and
    expert groups must call it (an all-gather a sharded tensor)."""
    out = {}
    for name, t in local.items():
        cut, tp = param_cut(name, model), param_transport(name, model)
        if cut is None or tp is None:
            out[name] = t
            continue
        parts = tp.gather(tp.split(t))
        out[name] = join_parts(parts, cut)
    return out


# Leaves smaller than this stay whole under fsdp and zero1 (the JAX
# package's threshold: a handful of bias and norm vectors cost more in
# collective latency than in memory).
FSDP_MIN_SIZE = 2 ** 14
AXIS_DATA, AXIS_MODEL, AXIS_PIPE = "data", "model", "pipe"


def fsdp_scatter_dim(shape: tuple, axis_size: int,
                     taken: tuple = ()) -> int:
    """The dim a leaf cuts over the data axis under fsdp/zero1: the
    largest dim not in ``taken`` that ``axis_size`` divides (ties keep
    the earliest); -1 when none does (the JAX package's rule)."""
    best = -1
    for d, n in enumerate(shape):
        if d not in taken and n % axis_size == 0:
            if best < 0 or n > shape[best]:
                best = d
    return best


def _fsdp_axis_choice(spec: list, shape: tuple, axis_size: int) -> list:
    """``spec`` (a leaf's mesh axis names by dim, None where whole) with
    the data axis added on ``fsdp_scatter_dim`` of the dims still whole;
    unchanged when the leaf already names the data axis or no dim
    qualifies (the JAX package's rule)."""
    if any(AXIS_DATA in (e if isinstance(e, tuple) else (e,))
           for e in spec):
        return spec
    best = fsdp_scatter_dim(
        tuple(shape), axis_size,
        taken=tuple(d for d, e in enumerate(spec) if e is not None))
    if best >= 0:
        spec = list(spec)
        spec[best] = AXIS_DATA
    return spec


def data_blocked(model, data: int,
                 min_size: int = FSDP_MIN_SIZE) -> frozenset:
    """The names of ``model``'s params that fsdp and zero1 cut into
    ``data`` blocks: JAX's ``param_sharding(fsdp=True)`` on each flax
    leaf's shape at the whole model's size (elements >= ``min_size``,
    a dim ``data`` divides that tensor parallelism leaves whole). The
    JAX model names its TP dims (of kernels and tables, never a bias's)
    only under a model axis or ``shard_vocab``, and so does this
    rule."""
    if data <= 1:
        return frozenset()
    # interop reaches this module through models/transformer.py.
    from tensorflow_distributed_tpu_torch.interop import flax_layout

    if getattr(model, "is_pipelined", False):
        return _pipelined_data_blocked(model, data, min_size, flax_layout)

    cfg = getattr(model, "cfg", None)
    tp_named = (getattr(model, "tp", None) is not None
                or bool(getattr(cfg, "shard_vocab", False)))
    whole = model.whole("meta") if getattr(model, "tp", None) else model
    out = set()
    for name, p in whole.named_parameters():
        path, to_flax, _ = flax_layout(whole, name)
        shape = tuple(to_flax(torch.empty(p.shape, device="meta")).shape)
        if math.prod(shape) < min_size:
            continue
        spec = [None] * len(shape)
        if tp_named and path[-1] != "bias":  # JAX names no bias's dims
            spec = list(_model_spec(path, cfg.shard_vocab) or spec)
        if AXIS_DATA in _fsdp_axis_choice(spec, shape, data):
            out.add(name)
    return frozenset(out)


def _pipelined_data_blocked(model, data: int, min_size: int,
                            flax_layout) -> frozenset:
    """``data_blocked`` of a pipelined model: JAX's rule on its stacked
    leaves. A block leaf is JAX's [S, lps, ...] (or [S, V, lps, ...])
    stack of every layer's flax leaf, named (pipe, None, ..., its TP
    names by ``_TP_SUFFIX``: every kernel's and the column-parallel
    biases'); a shell leaf is the whole model's, unnamed. The threshold
    is on the stacked leaf, and a leaf is cut when the rule puts the
    data axis on one of its dims and this process's tensor of it (one
    layer's, the model rank's part) divides into ``data`` blocks."""
    whole = model.whole("meta")
    S, V = model.num_stages, model.virtual_stages
    lead = (S,) + ((V,) if V > 1 else ()) + (
        model.cfg.n_layers // (S * V),)
    mine = dict(model.named_parameters())
    out = set()
    for name, p in whole.named_parameters():
        if name not in mine:
            continue
        path, to_flax, _ = flax_layout(whole, name)
        shape = tuple(to_flax(torch.empty(p.shape, device="meta")).shape)
        spec = [None] * len(shape)
        if name.startswith("layer_"):
            names = _STACKED_TP.get(tuple(path[-2:]))
            spec = [AXIS_PIPE] + [None] * (len(lead) - 1) + list(
                names or spec)
            shape = lead + shape
        if math.prod(shape) < min_size:
            continue
        if (AXIS_DATA in _fsdp_axis_choice(spec, shape, data)
                and mine[name].numel() % data == 0):
            out.add(name)
    return frozenset(out)


def data_block(t: torch.Tensor, data: int, ranks) -> torch.Tensor:
    """The blocks of ``t`` (a blocked leaf's local tensor, or any tensor
    of its shape) that the data ranks ``ranks`` (consecutive) hold: a
    view ``[len(ranks), numel / data]`` of its rows viewed as ``[data,
    numel / data]``."""
    return t.view(data, -1)[ranks[0]:ranks[-1] + 1]


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
_EXPERT_LEAVES = (("moe_mlp", "wi"), ("moe_mlp", "wo"))
# JAX's pipelined ``_TP_SUFFIX``: the stacked block leaves' TP names
# (the kernels' and the column-parallel biases'; the experts over the
# model axis).
_STACKED_TP = {k: v for k, v in _FLAX_SPECS.items() if k[0] != "lm_head"}
_STACKED_TP.update({k: (AXIS_MODEL, None, None) for k in _EXPERT_LEAVES})


def _model_spec(path, shard_vocab: bool) -> Optional[tuple]:
    """A flax leaf's mesh axes by dim under tensor parallelism ("model"
    or None), or None for a leaf every model rank holds whole."""
    key = tuple(path[-2:])
    if key == ("tok_emb", "embedding") and shard_vocab:
        return (AXIS_MODEL, None)
    return _FLAX_SPECS.get(key)


def flax_spec(path, shard_vocab: bool, model_axis: bool = True,
              expert_axis: Optional[str] = None) -> str:
    """The ``PartitionSpec`` string of a checkpoint leaf (its ``/``
    path's parts): its tensor-parallel dims when written under a model
    axis (``model_axis``), a MoE block's expert dim over ``expert_axis``
    ("model" or "expert") when its experts were cut."""
    if tuple(path[-2:]) in _EXPERT_LEAVES:
        spec = (expert_axis, None, None) if expert_axis else None
    else:
        spec = _model_spec(path, shard_vocab) if model_axis else None
    if spec is None:
        return "PartitionSpec()"
    return "PartitionSpec(" + ", ".join(
        f"'{a}'" if a else "None" for a in spec) + ")"


def is_sharded(name: str, model) -> bool:
    """Whether ``name`` is cut over ``model``'s model group."""
    tp = getattr(model, "tp", None)
    return (tp is not None and param_transport(name, model) is tp
            and param_cut(name, model) is not None)


def is_expert_sharded(name: str, model) -> bool:
    """Whether ``name`` is cut over an expert group of its own (not the
    model group)."""
    ep = getattr(model, "ep", None)
    return (ep is not None and ep is not getattr(model, "tp", None)
            and param_transport(name, model) is ep)

"""``--param-partition fsdp``: parameters resident as data blocks,
gathered at use. The port's form of what GSPMD does for the JAX
package's ``param_sharding(fsdp=True)`` layout.

Each param that ``parallel/sharding.data_blocked`` names is replaced in
its module by this process's blocks of it (``sharding.data_block``:
``[1, numel / data]`` over a process group, ``[data, numel / data]`` on
the stacked transport), so ``model.named_parameters()``, the optimizer,
the EMA and the checkpoint code see the blocks under the usual names.
The model's forward runs in units: each transformer block and ResNet
block is one, the rest of the model (embeddings, final norm, head, or a
whole CNN) the root. A unit's forward pre-hook gathers its blocked
params into whole tensors and puts them in place of the blocks; its
forward hook puts the blocks back, so a gathered param lives only while
its unit runs.

Over a process group the gather is ``_Gather``: an all-gather over the
data group forward; backward, the gradient summed over the seq group
(whose ranks hold the same params) and reduce-scattered over the data
group, so the block's ``.grad`` is its summed gradient. Inside a unit a
tensor that autograd saves for the backward and that is a gathered
param (a view of one, or its cast to the compute dtype) is packed as
the block instead and gathered again when the backward unpacks it
(``torch.autograd.graph.saved_tensors_hooks``): the backward re-gathers
what it needs, from the same blocks, so the values are the forward's.
Under ``--remat`` the block units leave that to the recompute (whose
pre-hook gathers again). On the stacked transport the blocks of all
ranks are in this process: the gather is a view, and the ranks'
backward passes accumulate the blocks' gradients in rank order.

The gather hooks read whatever tensor the module holds when the unit
starts, so ``torch.func.functional_call`` with the EMA's blocks (the
eval step) gathers the EMA.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import torch
from torch import nn

from tensorflow_distributed_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass
class _Leaf:
    """A blocked param: where it lives and its whole (local) shape."""

    owner: nn.Module
    kind: str                     # its attribute name in ``owner``
    shape: torch.Size
    mesh: Mesh

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor of ``block`` (this process's blocks)."""
        if not self.mesh.distributed:
            return block.view(self.shape)
        return _Gather.apply(block, self)


class _Gather(torch.autograd.Function):
    """All-gather over the data group forward; the gradient summed over
    the seq group and reduce-scattered over the data group backward."""

    @staticmethod
    def forward(ctx, block, leaf):
        ctx.leaf = leaf
        return gather_param(block, leaf.shape, leaf.mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.leaf.mesh
        flat = grad.contiguous().view(-1)
        if mesh.seq > 1:
            flat = flat.clone()
            mesh.seq_all_reduce_([flat])
        blocks, _ = mesh.reduce_scatter(flat)
        return blocks, None


class _Unit:
    """One unit's blocked params, and while it runs their gathered
    tensors and the saved-tensor hooks."""

    def __init__(self, leaves: List[_Leaf], pack_saved: bool):
        self.leaves = leaves
        self.pack_saved = pack_saved
        self.held: List[Tuple[_Leaf, torch.Tensor, torch.Tensor]] = []
        self.hooks = None

    def enter(self, *_) -> None:
        for leaf in self.leaves:
            block = leaf.owner._parameters[leaf.kind]
            full = leaf.gather(block)
            leaf.owner._parameters[leaf.kind] = full
            self.held.append((leaf, block, full))
        if self.pack_saved and self.held and torch.is_grad_enabled():
            self.hooks = torch.autograd.graph.saved_tensors_hooks(
                self._pack, _unpack)
            self.hooks.__enter__()

    def exit(self, *_) -> None:
        if self.hooks is not None:
            self.hooks.__exit__(None, None, None)
            self.hooks = None
        for leaf, block, _ in self.held:
            leaf.owner._parameters[leaf.kind] = block
        self.held = []

    def _pack(self, t: torch.Tensor):
        """A gathered param (or a view or a direct cast of one) as the
        block to gather it from again; any other tensor as itself."""
        for leaf, block, full in self.held:
            if full.grad_fn is None:
                continue
            cast = (t.grad_fn is not None and t.dtype != full.dtype
                    and t.grad_fn.next_functions
                    and t.grad_fn.next_functions[0][0] is full.grad_fn)
            if cast or (t.dtype == full.dtype and t.untyped_storage(
                    ).data_ptr() == full.untyped_storage().data_ptr()):
                return _Saved(leaf, block.detach(), t.dtype, t.size(),
                              t.stride(), t.storage_offset())
        return t


@dataclasses.dataclass
class _Saved:
    leaf: _Leaf
    block: torch.Tensor
    dtype: torch.dtype
    size: torch.Size
    stride: Tuple[int, ...]
    offset: int


def _unpack(saved):
    if not isinstance(saved, _Saved):
        return saved
    full = gather_param(saved.block, saved.leaf.shape,
                        saved.leaf.mesh).to(saved.dtype)
    return full.as_strided(saved.size, saved.stride, saved.offset)


def _units(model: nn.Module) -> Dict[str, nn.Module]:
    """The model's units below the root, by child name: its transformer
    and ResNet blocks."""
    from tensorflow_distributed_tpu_torch.models.resnet import (
        BasicBlock, BottleneckBlock)
    from tensorflow_distributed_tpu_torch.models.transformer import Block

    return {name: m for name, m in model.named_children()
            if isinstance(m, (Block, BasicBlock, BottleneckBlock))}


def shard_params_(model: nn.Module, blocked, mesh: Mesh
                  ) -> Dict[str, torch.Size]:
    """Replace each param of ``model`` named in ``blocked`` by this
    process's data blocks of it (a new ``nn.Parameter``, the values
    copied) and install the gather hooks. Returns the whole (local)
    shape of each blocked param."""
    from tensorflow_distributed_tpu_torch.parallel.sharding import data_block

    remat = bool(getattr(getattr(model, "cfg", None), "remat", False))
    units = _units(model)
    shapes, leaves = {}, {name: [] for name in [""] + list(units)}
    for name in sorted(blocked):
        *path, kind = name.split(".")
        owner = model.get_submodule(".".join(path))
        full = owner._parameters[kind]
        block = data_block(full.detach(), mesh.data, mesh.data_ranks)
        owner._parameters[kind] = nn.Parameter(block.clone())
        shapes[name] = full.shape
        unit = path[0] if path and path[0] in units else ""
        leaves[unit].append(_Leaf(owner, kind, full.shape, mesh))
    for name, unit in [("", model)] + list(units.items()):
        if not leaves[name]:
            continue
        hooks = _Unit(leaves[name], pack_saved=mesh.distributed and not (
            remat and unit is not model))
        unit.register_forward_pre_hook(hooks.enter)
        unit.register_forward_hook(hooks.exit, always_call=True)
    return shapes


@torch.no_grad()
def gather_param(block: torch.Tensor, shape: torch.Size,
                 mesh: Mesh) -> torch.Tensor:
    """The whole (local) tensor of a blocked param's, slot's or EMA's
    ``block`` outside autograd (every data rank must call it over a
    process group; the stacked transport holds every block)."""
    if not mesh.distributed:
        return block.reshape(shape)
    flat = block.new_empty(shape.numel())
    mesh.all_gather_(flat, block)
    return flat.view(shape)


@contextlib.contextmanager
def swapped_params(model: nn.Module, tensors: Dict[str, torch.Tensor]):
    """``model`` holding ``tensors`` (by param name) in place of its
    params while the context is open (a save's whole tensors)."""
    held = []
    try:
        for name, t in tensors.items():
            *path, kind = name.split(".")
            owner = model.get_submodule(".".join(path))
            held.append((owner, kind, owner._parameters[kind]))
            owner._parameters[kind] = t
        yield model
    finally:
        for owner, kind, old in held:
            owner._parameters[kind] = old

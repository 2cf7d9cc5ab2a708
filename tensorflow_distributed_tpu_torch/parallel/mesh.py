"""Process groups for data and sequence parallelism: the port of
``parallel/mesh.py``.

The JAX package builds one SPMD program over a device mesh after
``bootstrap()`` (``jax.distributed.initialize`` from environment
variables). Here every process runs its own copy of the program, one
card each: ``bootstrap()`` starts ``torch.distributed`` from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) with NCCL between cards or gloo on the
CPU, and returns the :class:`Mesh`.

The ranks are laid out as the JAX package lays out its devices,
row-major over (data, pipe, seq, model, expert); with pipe, model and
expert 1, rank r sits at data index ``r // S`` and seq index ``r % S``.
The seq group (S contiguous ranks) carries the ring; the data group
(the ranks that share a seq index) holds one sequence block of every
data shard. The flat collectives below are the port's form of GSPMD's
implicit ones: the loss sums, and the gradients of the parameters every
rank holds a copy of, are summed over the whole world.

``is_chief()`` elects rank 0 for logging, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    ProcessGroupRing)

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
MESH_AXES = (AXIS_DATA, AXIS_PIPE, AXIS_SEQ, AXIS_MODEL, AXIS_EXPERT)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
LAUNCH = ("torchrun --nproc-per-node {N} -m "
          "tensorflow_distributed_tpu_torch.cli --mesh.data {D} "
          "--mesh.seq {S} ...")


# --- mesh-feasibility rules (pure helpers; the JAX package's own) --------

def nondata_product(axes) -> int:
    """Product of the non-data axis sizes in ``axes`` (a {name: size}
    mapping; missing axes count 1): the processes one data coordinate
    consumes."""
    denom = 1
    for name in (AXIS_MODEL, AXIS_SEQ, AXIS_PIPE, AXIS_EXPERT):
        denom *= max(1, int(axes.get(name, 1)))
    return denom


def pick_data_width(axes, alive: int, batch: Optional[int] = None
                    ) -> Optional[int]:
    """The largest data-axis width for ``alive`` processes: non-data
    axes of ``axes`` preserved, data = the biggest d whose product fits
    ``alive`` and divides the global ``batch``. None when even data=1
    does not fit."""
    denom = nondata_product(axes)
    if denom > alive or alive < 1:
        return None
    return next((d for d in range(alive // denom, 0, -1)
                 if batch is None or batch % d == 0), None)


def mesh_infeasible(axes, devices: int,
                    batch: Optional[int] = None) -> Optional[str]:
    """Why an explicit factorization can't run on ``devices`` with
    global ``batch``; None when it can: every axis >= 1, the axis
    product equals the device count, and the data width divides the
    batch."""
    sizes = {a: int(axes.get(a, 1)) for a in MESH_AXES}
    bad = [f"{a}={v}" for a, v in sizes.items() if v < 1]
    if bad:
        return f"axis sizes must be >= 1 ({', '.join(bad)})"
    product = sizes[AXIS_DATA] * nondata_product(sizes)
    if product != devices:
        return f"mesh product {product} != {devices} device(s)"
    if batch is not None and batch % sizes[AXIS_DATA]:
        return (f"global batch {batch} not divisible by data width "
                f"{sizes[AXIS_DATA]}")
    return None


# --- the mesh ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, seq) mesh. ``distributed``:
    a process group is up, so the collectives run (also for a world of
    one under torchrun); without one they are no-ops."""

    data: int = 1
    seq: int = 1
    rank: int = 0
    data_group: Any = None
    seq_group: Any = None
    ring: Optional[ProcessGroupRing] = None  # over seq_group when seq > 1
    distributed: bool = False

    @property
    def data_index(self) -> int:
        return self.rank // self.seq

    @property
    def seq_index(self) -> int:
        return self.rank % self.seq

    def all_reduce_sum_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the whole world, in place."""
        if self.distributed:
            all_reduce_sum_(tensors)

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite same-dtype tensors with rank 0's values."""
        if self.distributed:
            broadcast_(tensors, 0)

    def barrier(self) -> None:
        """Wait for every rank of the world."""
        if self.distributed:
            dist.barrier()


ONE_PROCESS = Mesh()


def process_batch_role(mesh: Mesh):
    """(effective_count, effective_index) for batch-row distribution:
    the processes that share a data coordinate (the seq ranks of one
    data index) supply identical rows. One process holds one device, so
    this is (data width, data index)."""
    return mesh.data, mesh.data_index


def _torchrun_world() -> Optional[int]:
    env = os.environ
    if not all(k in env for k in TORCHRUN_ENV):
        return None
    return int(env["WORLD_SIZE"])


def rank_device(device: str) -> str:
    """The device of this rank: ``cuda:{LOCAL_RANK}`` for a CUDA run
    under torchrun, ``device`` itself otherwise."""
    if device == "cpu" or _torchrun_world() is None:
        return device
    if device != "cuda":
        raise ValueError(f"under torchrun rank r runs on cuda:LOCAL_RANK; "
                         f"pass --device cuda (got {device!r})")
    return f"cuda:{os.environ['LOCAL_RANK']}"


def mesh_shape(data: int, seq: int) -> Tuple[int, int]:
    """(data, seq) for ``--mesh.data data --mesh.seq seq`` in this
    world: the process group's when one is up (a caller that set up its
    own, such as a test with a file:// store), else torchrun's
    WORLD_SIZE, else 1. ``data = -1`` takes every process that ``seq``
    leaves over. Raises, naming the torchrun line, when the sizes do not
    multiply to the world. Starts nothing."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else (_torchrun_world() or 1)
    if data == -1:
        data = pick_data_width({AXIS_SEQ: seq}, world) or 1
    if data * seq != world:
        have = (f"the process group has {world}" if up else
                f"torchrun started WORLD_SIZE={world}" if _torchrun_world()
                else "this is one process")
        raise RuntimeError(
            f"--mesh.data {data} --mesh.seq {seq} runs one process per "
            f"mesh position ({data * seq}) but {have}; launch it as "
            f"`{LAUNCH.format(N=data * seq, D=data, S=seq)}`")
    return data, seq


def bootstrap(data: int, seq: int, device: torch.device) -> Mesh:
    """The mesh for ``--mesh.data data --mesh.seq seq`` (``mesh_shape``
    resolves and checks the sizes).

    Without torchrun and a world of one there is no process group.
    Otherwise the default group starts from torchrun's environment
    unless one is up (NCCL for a CUDA ``device``, gloo for the CPU; also
    for a world of one, so that run takes the collective path), every
    rank creates the seq groups and then the data groups in the same
    order, and one all-reduce runs on the world and on each of this
    rank's groups: NCCL wants every rank of a group in its first
    collective before point-to-point calls."""
    data, seq = mesh_shape(data, seq)
    up = dist.is_initialized()
    if not up and _torchrun_world() is None:
        return ONE_PROCESS
    if not up:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://")
    rank, world = dist.get_rank(), data * seq
    seq_groups = [dist.new_group(list(range(d * seq, (d + 1) * seq)))
                  for d in range(data)]
    data_groups = [dist.new_group(list(range(s, world, seq)))
                   for s in range(seq)]
    mesh = Mesh(data=data, seq=seq, rank=rank,
                data_group=data_groups[rank % seq],
                seq_group=seq_groups[rank // seq], distributed=True)
    for group in (None, mesh.seq_group, mesh.data_group):
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    if seq > 1:
        mesh = dataclasses.replace(mesh, ring=ProcessGroupRing(mesh.seq_group))
    return mesh


def is_chief() -> bool:
    """True on the process elected for logging (rank 0, or a run
    without a process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Tear down the default process group if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _flat(tensors: Iterable[torch.Tensor]):
    tensors = list(tensors)
    return tensors, torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(tensors, flat: torch.Tensor) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def all_reduce_sum_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Sum same-dtype tensors over ``group`` in place, as one flat
    all-reduce."""
    tensors, flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    _unflat_(tensors, flat)


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Overwrite same-dtype tensors with ``src``'s values, as one flat
    broadcast."""
    tensors, flat = _flat(tensors)
    dist.broadcast(flat, src, group=group)
    _unflat_(tensors, flat)

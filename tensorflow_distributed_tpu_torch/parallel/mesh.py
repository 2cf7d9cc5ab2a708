"""Process groups for sequence parallelism: the part of
``parallel/mesh.py`` that ``--mesh.seq`` needs.

The JAX package builds one SPMD program over a device mesh after
``bootstrap()`` (``jax.distributed.initialize`` from environment
variables). Here every process runs its own copy of the program, one
card each: ``bootstrap()`` starts ``torch.distributed`` from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) with NCCL between cards or gloo on the
CPU, and returns the seq group's ring. The only axis is "seq", so the
seq group is the whole world; ``--mesh.seq S`` must equal the number of
processes.

``is_chief()`` elects rank 0 for logging, as in the JAX package. The
flat collectives below are the port's form of GSPMD's implicit ones:
the loss sums, and the gradients of the parameters every rank holds a
copy of, are summed over the group.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    ProcessGroupRing)

LAUNCH = ("torchrun --nproc-per-node {S} -m "
          "tensorflow_distributed_tpu_torch.cli --mesh.seq {S} ...")


def _launched_by_torchrun(seq: int) -> int:
    """This process's LOCAL_RANK, after checking that torchrun started
    ``seq`` processes."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        raise RuntimeError(
            f"--mesh.seq {seq} runs one process per ring position; launch "
            f"it as `{LAUNCH.format(S=seq)}`")
    if int(env["WORLD_SIZE"]) != seq:
        raise RuntimeError(
            f"--mesh.seq {seq} needs {seq} processes but torchrun started "
            f"WORLD_SIZE={env['WORLD_SIZE']}; launch it as "
            f"`{LAUNCH.format(S=seq)}`")
    return int(env["LOCAL_RANK"])


def rank_device(device: str, seq: int) -> str:
    """The device of this rank: ``cuda:{LOCAL_RANK}`` for a CUDA run
    over several processes, ``device`` itself otherwise."""
    if seq == 1 or device == "cpu":
        return device
    if device != "cuda":
        raise ValueError(f"--mesh.seq {seq} puts rank r on cuda:LOCAL_RANK; "
                         f"pass --device cuda (got {device!r})")
    return f"cuda:{_launched_by_torchrun(seq)}"


def bootstrap(seq: int, device: torch.device) -> Optional[ProcessGroupRing]:
    """The seq group's ring for ``--mesh.seq seq`` (None for 1).

    Starts the default process group from torchrun's environment (NCCL
    for a CUDA ``device``, gloo for the CPU) unless one is already up
    (a caller that set up its own, such as a test with a file:// store),
    then checks that the world has ``seq`` processes and runs one
    all-reduce on ``device``: NCCL wants every rank in the first
    collective before point-to-point calls."""
    if seq == 1:
        return None
    if not dist.is_initialized():
        _launched_by_torchrun(seq)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://")
    if dist.get_world_size() != seq:
        raise RuntimeError(
            f"--mesh.seq {seq} needs a world of {seq} processes, this one "
            f"has {dist.get_world_size()}; launch it as "
            f"`{LAUNCH.format(S=seq)}`")
    dist.all_reduce(torch.zeros(1, device=device))
    return ProcessGroupRing()


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

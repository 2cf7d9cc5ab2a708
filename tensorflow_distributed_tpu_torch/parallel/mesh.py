"""Process groups for data, pipeline, sequence, tensor and expert
parallelism: the port of ``parallel/mesh.py``.

The JAX package builds one SPMD program over a device mesh after
``bootstrap()`` (``jax.distributed.initialize`` from environment
variables). Here every process runs its own copy of the program, one
card each: ``bootstrap()`` starts ``torch.distributed`` from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) with NCCL between cards or gloo on the
CPU, and returns the :class:`Mesh`.

The ranks are laid out as the JAX package lays out its devices,
row-major over (data, pipe, seq, model, expert), expert innermost: rank
r sits at expert index ``r % X``, model index ``(r // X) % M``, seq
index ``(r // (X * M)) % S``, pipe index ``(r // (X * M * S)) % P`` and
data index ``r // (P * S * M * X)``. The batch shards over data only, so
every rank of a data index reads the same rows. These groups carry the
collectives:

- the model group (M ranks, stride X) carries tensor parallelism's
  ``ProcessGroupTP`` (``parallel/tensor_parallel.py``);
- the expert group (X contiguous ranks) carries a MoE model's experts
  (``ep``, a ``ProcessGroupTP`` over it); without an expert axis a MoE
  model takes the model group's transport, as JAX's experts take the
  model axis;
- the seq group (S ranks, stride M * X) carries the ring
  (``ProcessGroupRing``);
- the replica group (the D * S ranks that share a (model, expert)
  index) holds the same shard of every parameter: the loss sums and the
  gradients are summed over it (``replica_all_reduce_``), the port's
  form of GSPMD's implicit psums. Without a model or expert axis it is
  the whole world;
- the pipe group (P ranks, stride S * M * X: the same (data, seq,
  model, expert) place in every stage) carries the pipeline's
  stage-to-stage hops (``ProcessGroupPipe``: one ``batch_isend_irecv``
  a tick, activations down and cotangents up, as the ring's permutes).
  The pipe ranks of a data index hold different blocks and the same
  shell (embedding, final norm, head): a block's gradient is summed over
  the data and seq groups, the shell's over the pipe group and then the
  data and seq groups (``pipe_all_reduce_``, ``data_all_reduce_``,
  ``seq_all_reduce_``), and the loss sums over the replica group (only
  the last stage holds any). A stage's model and seq groups carry its
  Megatron blocks and its ring as they do without a pipe.

The data group (the ranks that share a (seq, model, expert) index) is the group
of sync BatchNorm, and of ``--param-partition fsdp|zero1`` and
``--grad-sync serial|overlap``: ``reduce_scatter`` sums a flat tensor
over it and hands each data rank its 1/data block, ``all_gather_``
joins the ranks' blocks back, ``data_all_reduce_`` sums (the seq ranks
of one data index hold the same params, so under ``--mesh.seq`` a
gradient is summed over the seq group first: ``seq_all_reduce_``).

``stacked_data(D)`` is the one-process form of D data ranks, as
``StackedTP`` is of the model ranks (the tests and the one-card smoke):
the train step runs each data rank's forward and backward in turn, so
the ranks' gradients accumulate in rank order and are already their
sum; ``reduce_scatter`` then only views the sum as the D blocks, all of
which this process holds, and ``all_gather_`` joins the D blocks.
``stacked_pipe(P, M, S)`` is the one-process form of P pipe ranks
(``StackedPipe``), each stage's M model ranks (``StackedTP``) and S ring
positions (``StackedRing``) with it: every stage lives in this process
and a hop hands the tensor over.

``is_chief()`` elects rank 0 for logging, as in the JAX package.

``alive_devices()`` is the device list less the drill mask:
``TFD_DEVICE_MASK=N`` hides the LAST N devices (the elastic supervisor's
``device_loss`` drill, ``resilience/supervisor.py``), and ``bootstrap()``
refuses a rank whose card the mask hides. The devices are the cards
``torch.cuda.device_count()`` shows (under ``CUDA_VISIBLE_DEVICES``);
for the CPU they are the processes that ``TFD_CPU_DEVICE_COUNT``
declares (1 when unset), the counterpart of JAX's
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    ProcessGroupRing, StackedRing)
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    ProcessGroupTP, StackedTP)

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"
MESH_AXES = (AXIS_DATA, AXIS_PIPE, AXIS_SEQ, AXIS_MODEL, AXIS_EXPERT)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
# How long a collective of the world group waits for its peers (NCCL's
# own default, given to gloo too): the preemption guard's host agreement
# waits as long as a step's collectives would.
PG_TIMEOUT = datetime.timedelta(minutes=10)
# The flat collectives under their current names (torch >= 2.13 renamed
# them; the old ones warn there).
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
LAUNCH = ("torchrun --nproc-per-node {N} -m "
          "tensorflow_distributed_tpu_torch.cli --mesh.data {D} "
          "--mesh.pipe {P} --mesh.seq {S} --mesh.model {M} "
          "--mesh.expert {X} ...")


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


# --- the pipe's transports ----------------------------------------------
# A message is keyed (source stage, destination stage, tag). ``exchange``
# hands over what this process sends and returns what it expects, as one
# P2P batch; a stage that sends nothing in a tick appears in no key.

Key = Tuple[int, int, str]


class StackedPipe:
    """All P pipe stages in this process (the tests and the one-card
    smoke): a hop hands the tensor over."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"pipe axis must be >= 1, got {size}")
        self.size = size
        self.stages = list(range(size))

    def exchange(self, out: Dict[Key, torch.Tensor],
                 expect: Dict[Key, tuple]) -> Dict[Key, torch.Tensor]:
        return {k: out[k] for k in expect}


class ProcessGroupPipe:
    """One pipe stage per process of ``group`` (the default group when
    None): the stage is this process's place in the group. ``exchange``
    posts every send and receive of a tick in one ``batch_isend_irecv``
    (NCCL between cards, gloo on the CPU), as the ring's permutes do."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.stages = [self.index]

    def _peer(self, stage: int) -> int:
        return (stage if self.group is None
                else dist.get_global_rank(self.group, stage))

    def exchange(self, out: Dict[Key, torch.Tensor],
                 expect: Dict[Key, tuple]) -> Dict[Key, torch.Tensor]:
        """``out``: this stage's messages; ``expect``: the (shape,
        dtype, device) of each message addressed to it."""
        got = {k: out[k] for k in expect if k[0] == self.index}
        ops = []
        for (src, dst, tag), t in sorted(out.items()):
            if dst != self.index:
                ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                      self._peer(dst), self.group))
        for key, (shape, dtype, device) in sorted(expect.items()):
            if key[0] != self.index:
                got[key] = torch.empty(shape, dtype=dtype, device=device)
                ops.append(dist.P2POp(dist.irecv, got[key],
                                      self._peer(key[0]), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got


# --- the mesh ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, pipe, seq, model, expert) mesh.
    ``distributed``: a process group is up, so the collectives run (also
    for a world of one under torchrun); without one they are no-ops."""

    data: int = 1
    seq: int = 1
    rank: int = 0
    data_group: Any = None
    seq_group: Any = None
    ring: Optional[ProcessGroupRing] = None  # over seq_group when seq > 1
    distributed: bool = False
    model: int = 1
    model_group: Any = None
    replica_group: Any = None  # None: the whole world (model 1)
    tp: Optional[ProcessGroupTP] = None  # over model_group when model > 1
    stacked: bool = False  # every data rank in this process (stacked_data)
    expert: int = 1
    expert_group: Any = None
    ep: Optional[ProcessGroupTP] = None  # over expert_group when expert > 1
    pipe: int = 1
    pipe_group: Any = None
    # StackedPipe (every stage here) or ProcessGroupPipe over pipe_group;
    # None: one stage (``pipe_transport``).
    pp: Any = None

    @property
    def expert_index(self) -> int:
        return self.rank % self.expert

    @property
    def model_index(self) -> int:
        return (self.rank // self.expert) % self.model

    @property
    def seq_index(self) -> int:
        return (self.rank // (self.expert * self.model)) % self.seq

    @property
    def pipe_index(self) -> int:
        return (self.rank // (self.expert * self.model * self.seq)
                ) % self.pipe

    @property
    def data_index(self) -> int:
        return self.rank // (self.pipe * self.seq * self.model * self.expert)

    @property
    def replica_index(self) -> int:
        """This rank's (data, seq) coordinate, row-major. The model,
        expert and pipe ranks of one coordinate share it (and so their
        dropout seeds)."""
        return self.data_index * self.seq + self.seq_index

    @property
    def data_ranks(self) -> List[int]:
        """The data indices whose blocks this process holds: its own, or
        all of them on the stacked transport."""
        return list(range(self.data)) if self.stacked else [self.data_index]

    def reduce_scatter(self, flat: torch.Tensor, async_op: bool = False):
        """Sum the flat tensor ``flat`` (numel a multiple of ``data``)
        over the data group and return (this process's blocks ``[len(
        data_ranks), numel / data]``, the pending work or None). The
        blocks are valid once the work is waited on."""
        if not self.distributed or self.data == 1:
            return flat.view(self.data, -1)[self.data_ranks[0]:
                                            self.data_ranks[-1] + 1], None
        out = flat.new_empty(flat.numel() // self.data)
        work = _REDUCE_SCATTER(out, flat, group=self.data_group,
                               async_op=async_op)
        return out.view(1, -1), work

    def all_gather_(self, flat: torch.Tensor, blocks: torch.Tensor,
                    async_op: bool = False):
        """Write every data rank's block into ``flat`` (numel ``data`` x
        the block's), in rank order, from this process's ``blocks``
        (``reduce_scatter``'s layout; not a view of ``flat`` over a
        process group). Returns the pending work or None."""
        if not self.distributed or self.data == 1:
            rows = flat.view(self.data, -1)[self.data_ranks[0]:
                                            self.data_ranks[-1] + 1]
            if rows.data_ptr() != blocks.data_ptr():
                rows.copy_(blocks)
            return None
        return _ALL_GATHER(flat, blocks.reshape(-1), group=self.data_group,
                           async_op=async_op)

    def data_all_reduce_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the data group, in place."""
        if self.distributed and self.data > 1:
            all_reduce_sum_(tensors, self.data_group)

    def seq_all_reduce_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the seq group, in place."""
        if self.distributed and self.seq > 1:
            all_reduce_sum_(tensors, self.seq_group)

    def replica_all_reduce_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the replica group (the ranks that
        hold the same shards), in place: the gradients and the loss
        sums."""
        if self.distributed:
            all_reduce_sum_(tensors, self.replica_group)

    def model_all_reduce_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the model group, in place."""
        if self.distributed and self.model > 1:
            all_reduce_sum_(tensors, self.model_group)

    def expert_all_reduce_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the expert group, in place."""
        if self.distributed and self.expert > 1:
            all_reduce_sum_(tensors, self.expert_group)

    def pipe_all_reduce_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the pipe group, in place."""
        if self.distributed and self.pipe > 1:
            all_reduce_sum_(tensors, self.pipe_group)

    def data_broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite same-dtype tensors with the values of data index 0's
        rank of this rank's data group."""
        if self.distributed and self.data > 1:
            broadcast_(tensors, self.rank % (self.pipe * self.seq
                                             * self.model * self.expert),
                       self.data_group)

    def replica_broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite same-dtype tensors with the values of the first rank
        of the replica group (data and seq index 0: rank ``rank % (M *
        X)``); rank 0's over the world without a model or expert axis."""
        if self.distributed:
            broadcast_(tensors, self.rank % (self.model * self.expert),
                       self.replica_group)

    def barrier(self) -> None:
        """Wait for every rank of the world."""
        if self.distributed:
            dist.barrier()


ONE_PROCESS = Mesh()


def stacked_data(data: int) -> Mesh:
    """The mesh of ``data`` data ranks all in this process (no process
    group; see the module docstring)."""
    if data < 1:
        raise ValueError(f"data axis must be >= 1, got {data}")
    return Mesh(data=data, stacked=True)


def pipe_transport(mesh: Mesh):
    """The mesh's pipe transport: a one-stage ``StackedPipe`` where it
    has none."""
    return mesh.pp if mesh.pp is not None else StackedPipe(1)


def stacked_pipe(pipe: int, model: int = 1, seq: int = 1) -> Mesh:
    """The mesh of ``pipe`` pipe stages all in this process (no process
    group; see the module docstring), each stage's ``model`` model ranks
    (``StackedTP``) and ``seq`` ring positions (``StackedRing``) stacked
    in it too."""
    return Mesh(pipe=pipe, pp=StackedPipe(pipe), model=model,
                tp=StackedTP(model) if model > 1 else None,
                ring=StackedRing(seq) if seq > 1 else None)


def process_batch_role(mesh: Mesh):
    """(effective_count, effective_index) for batch-row distribution:
    the processes that share a data coordinate (the pipe and seq ranks
    of one data index) supply identical rows. One process holds one
    device, so this is (data width, data index)."""
    return mesh.data, mesh.data_index


DEVICE_MASK_ENV = "TFD_DEVICE_MASK"
CPU_DEVICES_ENV = "TFD_CPU_DEVICE_COUNT"


def device_count(device_type: str = "cuda") -> int:
    """The devices of ``device_type`` this machine shows: the CUDA cards,
    or the CPU processes ``TFD_CPU_DEVICE_COUNT`` declares (1 unset)."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get(CPU_DEVICES_ENV, "1") or 1)


def alive_devices(device_type: str = "cuda") -> List[int]:
    """The indices of ``device_type``'s devices less the drill mask (JAX's
    ``alive_devices``): ``TFD_DEVICE_MASK=N`` hides the LAST N, as dead
    cards on a host whose runtime still lists them. A real loss needs no
    mask: the cards are gone from the count. Unset, every device."""
    n = device_count(device_type)
    mask = int(os.environ.get(DEVICE_MASK_ENV, "0") or 0)
    if mask < 0:
        raise ValueError(f"TFD_DEVICE_MASK must be >= 0, got {mask}")
    if mask >= n:
        raise ValueError(
            f"TFD_DEVICE_MASK={mask} masks every device ({n} visible) — "
            f"nothing left to run on")
    return list(range(n - mask))


def check_alive(device: torch.device) -> None:
    """Refuse this rank when the drill mask hides its device: a CUDA
    device by its index, a CPU rank by its ``LOCAL_RANK`` (only where
    ``TFD_CPU_DEVICE_COUNT`` declares the CPU devices). Does nothing
    without a mask."""
    kind = "cuda" if device.type == "cuda" else "cpu"
    if not os.environ.get(DEVICE_MASK_ENV) or (
            kind == "cpu" and not os.environ.get(CPU_DEVICES_ENV)):
        return
    index = (device.index if kind == "cuda" and device.index is not None
             else int(os.environ.get("LOCAL_RANK", "0")))
    alive = alive_devices(kind)
    if index not in alive:
        raise RuntimeError(
            f"this rank's {kind} device {index} is masked by "
            f"TFD_DEVICE_MASK={os.environ[DEVICE_MASK_ENV]} (alive: "
            f"{len(alive)} of {device_count(kind)}); launch at most "
            f"{len(alive)} processes")


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


def mesh_shape(data: int, seq: int, model: int = 1,
               expert: int = 1, pipe: int = 1) -> Tuple[int, int, int]:
    """(data, seq, model) for ``--mesh.data data --mesh.pipe pipe
    --mesh.seq seq --mesh.model model --mesh.expert expert`` in this
    world: the process group's when one is up (a caller that set up its
    own, such as a test with a file:// store), else torchrun's
    WORLD_SIZE, else 1. ``data = -1`` takes every process that the
    other axes leave over. Raises, naming the torchrun line, when the
    sizes do not multiply to the world. Starts nothing."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else (_torchrun_world() or 1)
    if data == -1:
        data = pick_data_width({AXIS_SEQ: seq, AXIS_MODEL: model,
                                AXIS_EXPERT: expert, AXIS_PIPE: pipe},
                               world) or 1
    n = data * pipe * seq * model * expert
    if n != world:
        have = (f"the process group has {world}" if up else
                f"torchrun started WORLD_SIZE={world}" if _torchrun_world()
                else "this is one process")
        raise RuntimeError(
            f"--mesh.data {data} --mesh.pipe {pipe} --mesh.seq {seq} "
            f"--mesh.model {model} --mesh.expert {expert} runs one process "
            f"per mesh position ({n}) but {have}; launch it as "
            f"`{LAUNCH.format(N=n, D=data, P=pipe, S=seq, M=model,
                              X=expert)}`")
    return data, seq, model


def bootstrap(data: int, seq: int, device: torch.device,
              model: int = 1, expert: int = 1, pipe: int = 1) -> Mesh:
    """The mesh for ``--mesh.data data --mesh.pipe pipe --mesh.seq seq
    --mesh.model model --mesh.expert expert`` (``mesh_shape`` resolves
    and checks the sizes).

    Without torchrun and a world of one there is no process group.
    Otherwise the default group starts from torchrun's environment
    unless one is up (NCCL for a CUDA ``device``, gloo for the CPU; also
    for a world of one, so that run takes the collective path), every
    rank creates the model groups, the expert groups, the seq groups,
    the data groups and (with a model or expert axis) the replica groups
    in the same order (and the pipe groups), and one all-reduce runs on
    the world and on each of this rank's groups: NCCL wants every rank
    of a group in its first collective before point-to-point calls. A
    rank whose device the drill mask hides is refused (``check_alive``)."""
    data, seq, model = mesh_shape(data, seq, model, expert, pipe)
    check_alive(device)
    up = dist.is_initialized()
    if not up and _torchrun_world() is None:
        return ONE_PROCESS
    if not up:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://", timeout=PG_TIMEOUT)
    rank = dist.get_rank()
    X = expert
    # Rank r at grid[d, p, s, m, e]: JAX's row-major device order.
    grid = torch.arange(data * pipe * seq * model * X).view(
        data, pipe, seq, model, X)

    def groups_along(*axes):
        """This rank's group of the ranks that differ only along
        ``axes``; every group of that kind is created, in one order on
        every rank."""
        rows = grid.permute(*[a for a in range(5) if a not in axes],
                            *axes).reshape(-1, math.prod(
                                grid.shape[a] for a in axes))
        mine = None
        for ranks in rows.tolist():
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        return mine

    model_group = groups_along(3) if model > 1 else None
    expert_group = groups_along(4) if X > 1 else None
    seq_group, data_group = groups_along(2), groups_along(0)
    replica_group = groups_along(0, 1, 2) if model * X > 1 else None
    pipe_group = groups_along(1) if pipe > 1 else None
    mesh = Mesh(data=data, seq=seq, rank=rank, model=model, expert=X,
                distributed=True, model_group=model_group,
                expert_group=expert_group, seq_group=seq_group,
                data_group=data_group, replica_group=replica_group,
                pipe=pipe, pipe_group=pipe_group)
    groups = [None, seq_group, data_group]
    if model > 1:
        groups.append(model_group)
    if X > 1:
        groups.append(expert_group)
    if model * X > 1:
        groups.append(replica_group)
    if pipe > 1:
        groups.append(pipe_group)
    for group in groups:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    if seq > 1:
        mesh = dataclasses.replace(mesh, ring=ProcessGroupRing(mesh.seq_group))
    if model > 1:
        mesh = dataclasses.replace(mesh, tp=ProcessGroupTP(mesh.model_group))
    if X > 1:
        mesh = dataclasses.replace(mesh,
                                   ep=ProcessGroupTP(mesh.expert_group))
    if pipe > 1:
        mesh = dataclasses.replace(mesh,
                                   pp=ProcessGroupPipe(mesh.pipe_group))
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

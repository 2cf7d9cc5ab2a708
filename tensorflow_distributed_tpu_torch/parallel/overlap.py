"""The explicit gradient sync (``--grad-sync serial|overlap``): the port
of ``parallel/overlap.py``.

The implicit step (``train/step.py``) sums whole gradients over the
ranks after the backward. This step writes the weight update out as
"Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training" (arXiv 2004.13336) has it:

1. the gradient leaves are packed into deterministic, size-bounded,
   dtype-keyed buckets (``plan_buckets``, the JAX package's greedy rule,
   over the leaves in the order the backward finishes them: the reverse
   of registration);
2. ``overlap``: each bucket is reduce-scattered over the data group
   (``async_op``) from a ``register_post_accumulate_grad_hook`` as soon
   as its last leaf's gradient lands, while the backward goes on
   through earlier layers; the step waits on the handles after the
   backward;
3. each rank updates only its block of every scattered leaf, against
   zero1's slot blocks (the same layout: ``parallel/sharding.py``'s
   rule and flat ``[data, numel / data]`` rows; the slots are never
   gathered);
4. the updated params are all-gathered per bucket.

Leaves the rule leaves whole ride replicated buckets: summed by an
all-reduce, updated whole on every rank. ``serial`` is the baseline:
one all-reduce of the whole tree, then the whole update on every rank.

Both modes have the explicit step's per-rank semantics (the JAX
``make_explicit_train_step``'s): each rank's loss is the mean over its
own rows (the tasks' ``local`` losses), the synced gradient is the mean
of the ranks' gradients, the metrics are averaged over the ranks,
dropout draws per rank, and a BatchNorm model normalizes with its
rank's statistics and averages the new running averages. The clip (and
the grad-norm metric and the skip verdict) read one global norm rebuilt
from block sums of squares (one all-reduce of a scalar) in both modes,
so serial and overlap are bit-identical: a reduce-scatter and an
all-reduce of two ranks add the same two numbers, and the update is
elementwise. The optimizer's own clip is off (``train/optim.py``).

Block layout (``leaf_rows``, ``bucket_rows``, ``split_blocks``): a
leaf's rows are its tensor viewed ``[data, numel / data]``, row i data
rank i's block; a bucket's rows are its leaves' rows side by side
(``[data, sum of numel / data]``), so a reduce-scatter of the bucket
hands rank i the bucket's leaves' blocks i, each a column range of its
row.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.parallel.mesh import Mesh
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    FSDP_MIN_SIZE, fsdp_scatter_dim)

GRAD_SYNC_MODES = ("serial", "overlap")
# ~4 MiB keeps GPT-2-small's ~500 MB f32 gradient in ~120 collectives:
# large enough to amortize a launch, small enough that the first
# reduce-scatter starts long before the backward ends.
DEFAULT_BUCKET_BYTES = 4 << 20


# --- bucket planning (deterministic; shapes only) -----------------------

@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One gradient leaf's place in the sync plan."""

    index: int                 # position in the planned leaf order
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: str
    scatter_dim: int           # -1: a replicated (all-reduced) leaf
    size: int = 0
    nbytes: int = 0


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Scatter buckets (reduce-scatter, sharded update, all-gather) and
    replicated buckets (all-reduce, whole update)."""

    axis_size: int
    bucket_bytes: int
    scatter: Tuple[Tuple[LeafPlan, ...], ...]
    replicated: Tuple[Tuple[LeafPlan, ...], ...]
    n_leaves: int

    @property
    def scatter_bytes(self) -> int:
        return sum(lp.nbytes for b in self.scatter for lp in b)

    @property
    def replicated_bytes(self) -> int:
        return sum(lp.nbytes for b in self.replicated for lp in b)

    def describe(self) -> dict:
        """A serializable summary (the JAX plan's keys)."""
        return {
            "axis_size": self.axis_size,
            "bucket_bytes": self.bucket_bytes,
            "scatter_buckets": len(self.scatter),
            "replicated_buckets": len(self.replicated),
            "scatter_bytes": self.scatter_bytes,
            "replicated_bytes": self.replicated_bytes,
            "leaves": self.n_leaves,
        }


def plan_buckets(leaves: Sequence[Tuple[Tuple[str, ...], tuple, str]],
                 axis_size: int, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 fsdp_min_size: int = FSDP_MIN_SIZE) -> BucketPlan:
    """Pack ``leaves`` ((path, shape, dtype name) in the order to plan
    them) into size-bounded buckets: each leaf joins the open bucket of
    its (scatterable, dtype) key, which closes first when the leaf would
    take it past ``bucket_bytes`` (a leaf over the bound gets a bucket
    of its own). A leaf is scatterable under the rule that places
    zero1's slots: at least ``fsdp_min_size`` elements and a dim
    ``axis_size`` divides (``fsdp_scatter_dim``). The JAX package's
    ``plan_buckets`` over its leaves in tree-flatten order."""
    if axis_size < 1:
        raise ValueError(f"axis_size must be >= 1, got {axis_size}")
    if bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    plans: List[LeafPlan] = []
    for i, (path, shape, dtype) in enumerate(leaves):
        shape = tuple(int(s) for s in shape)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        dim = -1
        if axis_size > 1 and size >= fsdp_min_size:
            dim = fsdp_scatter_dim(shape, axis_size)
        plans.append(LeafPlan(index=i, path=tuple(path), shape=shape,
                              dtype=dtype, scatter_dim=dim, size=size,
                              nbytes=size * np.dtype(dtype).itemsize))
    open_buckets: dict = {}   # (scatterable, dtype) -> (leaves, bytes)
    scatter: List[Tuple[LeafPlan, ...]] = []
    replicated: List[Tuple[LeafPlan, ...]] = []

    def close(key):
        group, _ = open_buckets.pop(key)
        (scatter if key[0] else replicated).append(tuple(group))

    for lp in plans:
        key = (lp.scatter_dim >= 0, lp.dtype)
        group, nbytes = open_buckets.get(key, ([], 0))
        if group and nbytes + lp.nbytes > bucket_bytes:
            close(key)
            group, nbytes = [], 0
        group.append(lp)
        open_buckets[key] = (group, nbytes + lp.nbytes)
    for key in list(open_buckets):
        close(key)
    return BucketPlan(axis_size=axis_size, bucket_bytes=bucket_bytes,
                      scatter=tuple(scatter), replicated=tuple(replicated),
                      n_leaves=len(plans))


def comm_bytes_per_step(plan: BucketPlan) -> float:
    """A rank's collective bytes in one overlap step, by the ring cost:
    the reduce-scatter and the all-gather of the scattered leaves and
    the all-reduce of the replicated ones each move (N-1)/N of their
    bytes twice. The serial all-reduce moves the same total."""
    n = plan.axis_size
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    return 2.0 * ring * plan.scatter_bytes + 2.0 * ring * plan.replicated_bytes


def model_leaves(model) -> List[Tuple[Tuple[str, ...], tuple, str]]:
    """``model``'s params for ``plan_buckets``, in the order the backward
    finishes them (the reverse of registration): (name, the flax leaf's
    shape, dtype), so the scatterable set is the zero1 slots' blocked
    set (``parallel/sharding.data_blocked``)."""
    from tensorflow_distributed_tpu_torch.interop import flax_layout

    out = []
    for name, p in reversed(list(model.named_parameters())):
        to_flax = flax_layout(model, name)[1]
        shape = tuple(to_flax(torch.empty(p.shape, device="meta")).shape)
        out.append(((name,), shape, str(p.dtype).replace("torch.", "")))
    return out


# --- block layout --------------------------------------------------------

def leaf_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """A leaf as its ``n`` data ranks' blocks: ``[n, numel / n]`` (a
    view of a contiguous tensor), row i rank i's block."""
    return t.reshape(n, -1)


def bucket_rows(tensors: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """A bucket's leaves' rows side by side, ``[n, sum of numel / n]``
    (a copy): what a reduce-scatter consumes and an all-gather yields."""
    return torch.cat([leaf_rows(t, n) for t in tensors], dim=1)


def split_blocks(blocks: torch.Tensor, sizes: Sequence[int], n: int
                 ) -> List[torch.Tensor]:
    """A bucket's blocks (``[k, sum of numel / n]``, k ranks' rows) as
    each leaf's blocks ``[k, numel / n]`` (views of column ranges)."""
    return list(blocks.split([s // n for s in sizes], dim=1))


def rows_to_leaf(rows: torch.Tensor, shape) -> torch.Tensor:
    """A leaf's ``[n, numel / n]`` rows back in its shape."""
    return rows.reshape(shape)


# --- the step ------------------------------------------------------------

def _launch(mesh: Mesh, tensors, scatter: bool, async_op: bool):
    """Start one bucket's sync: (the reduce-scatter of its rows, or the
    all-reduce of its flat gradient; the pending work or None)."""
    n = mesh.data
    if scatter:
        return mesh.reduce_scatter(bucket_rows(tensors, n).view(-1),
                                   async_op=async_op)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if not mesh.distributed:
        return flat, None
    work = torch.distributed.all_reduce(flat, group=mesh.data_group,
                                        async_op=async_op)
    return flat, work


def mean_over_data(metrics: Dict[str, torch.Tensor], mesh: Mesh
                   ) -> Dict[str, torch.Tensor]:
    """Metrics averaged over the data group (one all-reduce)."""
    if not mesh.distributed or mesh.data == 1:
        return metrics
    names = list(metrics)
    packed = torch.stack([metrics[k].float().reshape(()) for k in names])
    mesh.data_all_reduce_([packed])
    return dict(zip(names, packed / mesh.data))


def average_batch_stats_(model, mesh: Mesh) -> None:
    """A BatchNorm model's pending running averages (each rank's, from
    its own statistics) replaced by their mean over the data group."""
    pending = getattr(model, "pending_batch_stats", None)
    if pending is None or not mesh.distributed or mesh.data == 1:
        return
    stats = pending()
    mesh.data_all_reduce_(stats)
    torch._foreach_div_(stats, float(mesh.data))


def make_explicit_train_step(loss, device: torch.device, mesh: Mesh,
                             state, grad_sync: str = "overlap",
                             bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                             seed: int = 0, grad_norm_metric: bool = False,
                             ema_decay: float = 0.0,
                             skip_nonfinite: bool = False,
                             grad_clip_norm: float = 0.0,
                             sync: Optional[Callable] = None):
    """The explicit-sync train step of ``state`` (its optimizer without
    the chain clip; under overlap laid out as zero1) over the pure data
    ``mesh``. ``loss`` is the task's per-rank (local-mean) loss;
    ``grad_clip_norm`` > 0 clips by the rebuilt global norm. The other
    arguments are ``train/step.make_train_step``'s. The built step
    carries its plan (``step.bucket_plan``)."""
    from tensorflow_distributed_tpu_torch.train import step as step_lib

    if grad_sync not in GRAD_SYNC_MODES:
        raise ValueError(f"unknown grad_sync {grad_sync!r}; have "
                         f"{GRAD_SYNC_MODES}")
    nondata = {a: s for a, s in (("seq", mesh.seq), ("model", mesh.model))
               if s > 1}
    if nondata:
        raise ValueError(f"explicit grad-sync needs a pure data mesh; axes "
                         f"{nondata} > 1")
    if grad_sync == "overlap" and mesh.data < 2:
        raise ValueError(
            "grad_sync=overlap reduce-scatters over the data axis; "
            f"data={mesh.data} leaves nothing to scatter — use the "
            "implicit step on a single data shard")
    if state.tx.clip_norm:
        raise ValueError("the explicit step clips by its rebuilt norm: "
                         "build the optimizer without the chain clip")
    model, n = state.model, mesh.data
    overlap = grad_sync == "overlap"
    plan = plan_buckets(model_leaves(model), n, bucket_bytes,
                        state.partition.min_size)
    if overlap and state.partition.kind != "zero1":
        raise ValueError("grad_sync=overlap updates against zero1's slot "
                         "blocks: lay the state out as zero1")
    if overlap and {lp.path[0] for b in plan.scatter for lp in b} != set(
            state.partition.blocked):
        raise ValueError("the overlap plan's scattered leaves are not the "
                         "zero1 slots' blocked leaves")
    params = dict(model.named_parameters())
    buckets = [(True, [lp.path[0] for lp in b]) for b in plan.scatter] + \
        [(False, [lp.path[0] for lp in b]) for b in plan.replicated]
    generator = torch.Generator(device=device)
    # Per step: each bucket's (blocks or flat sum, work), and how many of
    # its leaves have landed.
    pending: Dict[int, tuple] = {}
    landed: Dict[int, int] = {}
    armed = False
    hooked = overlap and mesh.distributed

    def launch(b: int, async_op: bool) -> None:
        scatter, names = buckets[b]
        pending[b] = _launch(mesh, [params[m].grad for m in names], scatter,
                             async_op)
        if async_op:  # the whole gradients are in the bucket's copy now
            for m in names:
                params[m].grad = None

    if hooked:
        where = {m: b for b, (_, names) in enumerate(buckets) for m in names}

        def landed_hook(p: torch.Tensor, name: str) -> None:
            if not armed:
                return
            b = where[name]
            landed[b] = landed.get(b, 0) + 1
            if landed[b] == len(buckets[b][1]):
                launch(b, async_op=True)

        for name, p in params.items():
            p.register_post_accumulate_grad_hook(
                lambda p, name=name: landed_hook(p, name))

    def synced() -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """(each leaf's mean gradient: blocks for a scattered leaf under
        overlap, else whole; each scatter bucket's blocks, for the
        norm)."""
        for b in range(len(buckets)):
            if b not in pending:
                for m in buckets[b][1]:
                    p = params[m]
                    if p.grad is None:  # a leaf the loss did not reach
                        p.grad = torch.zeros_like(p)
                if overlap:
                    launch(b, async_op=False)
        out: Dict[str, torch.Tensor] = {}
        scattered: List[torch.Tensor] = []
        if not overlap:
            grads = [params[m].grad for _, names in buckets for m in names]
            mesh.data_all_reduce_(grads)
            torch._foreach_div_(grads, float(n))
        for b, (scatter, names) in enumerate(buckets):
            if overlap:
                got, work = pending[b]
                if work is not None:
                    work.wait()
                got = got / n
            elif scatter:  # this rank's blocks, laid out as overlap's
                got = bucket_rows([params[m].grad for m in names], n)[
                    mesh.data_ranks[0]:mesh.data_ranks[-1] + 1].clone()
            if scatter:
                scattered.append(got)
            if overlap and scatter:
                out.update(zip(names, split_blocks(
                    got, [params[m].numel() for m in names], n)))
            elif overlap:
                out.update(zip(names, [
                    v.view_as(params[m]) for m, v in zip(names, got.split(
                        [params[m].numel() for m in names]))]))
            else:
                out.update((m, params[m].grad) for m in names)
        return out, scattered

    def global_norm(grads, scattered) -> torch.Tensor:
        """The whole gradient's norm from this rank's blocks: the block
        sums of squares summed over the data group, plus the replicated
        leaves' (the same reconstruction in both modes)."""
        sq = torch.stack([torch.sum(g.float() * g.float())
                          for g in scattered]).sum() if scattered else \
            torch.zeros((), device=device)
        sq = sq.reshape(1)
        mesh.data_all_reduce_([sq])
        rep = [grads[m] for s, names in buckets if not s for m in names]
        rest = torch.stack([torch.sum(g.float() * g.float())
                            for g in rep]).sum() if rep else 0.0
        return torch.sqrt(sq[0] + rest)

    def step(state, batch):
        nonlocal armed
        pending.clear()
        landed.clear()
        armed = True
        try:
            metrics = step_lib.forward_backward(
                state, batch, loss, generator, seed, mesh, 1,
                local_mean=True)
        finally:
            armed = False
        metrics = mean_over_data(metrics, mesh)
        average_batch_stats_(state.model, mesh)
        grads, scattered = synced()
        norm = None
        if grad_clip_norm or grad_norm_metric or skip_nonfinite:
            norm = global_norm(grads, scattered)
        if grad_norm_metric:
            metrics = dict(metrics, grad_norm=norm)
        apply = True
        if skip_nonfinite:
            apply, metrics = step_lib.verdict(metrics, norm, sync,
                                              state.step)
        if apply:
            with torch.no_grad():
                names = list(grads)
                g = [grads[m] for m in names]
                if grad_clip_norm:
                    keep = norm < grad_clip_norm
                    g = [torch.where(keep, t, t / norm * grad_clip_norm)
                         for t in g]
                views = (state.partition.slot_views(params) if overlap
                         else params)
                updates = state.tx.update(dict(zip(names, g)),
                                          state.opt_state, views)
                torch._foreach_add_([views[m] for m in names],
                                    [updates[m] for m in names])
                if overlap:
                    gather_params(views)
        step_lib.finish(state, apply, ema_decay)
        return state, {k: v.detach() for k, v in metrics.items()}

    def gather_params(views) -> None:
        """The updated blocks all-gathered per scatter bucket (in place
        on the stacked transport, where every block is here)."""
        if not mesh.distributed:
            return
        works = []
        for scatter, names in buckets:
            if not scatter:
                continue
            blocks = torch.cat([views[m] for m in names], dim=1)
            rows = blocks.new_empty((n, blocks.shape[1]))
            works.append((names, rows, mesh.all_gather_(
                rows.view(-1), blocks, async_op=True)))
        for names, rows, work in works:
            work.wait()
            for m, part in zip(names, split_blocks(
                    rows, [params[m].numel() for m in names], n)):
                params[m].detach().copy_(rows_to_leaf(part, params[m].shape))

    step.bucket_plan = plan
    return step

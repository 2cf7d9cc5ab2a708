"""Step-tagged checkpoints: the single-process core of the JAX package's
``train/checkpoint.py``, writing its on-disk format byte for byte, so a
checkpoint of either package restores in the other.

One directory per checkpoint, ``<dir>/step_00001234/``:

- ``state.msgpack``: the train state as the JAX ``TrainState``'s state
  dict (``interop.state_to_flax``) in flax's msgpack
  (``utils/serialization.py``, pure Python);
- ``manifest.json``: ``step``, ``param_bytes``, ``format``
  (``flax-msgpack-v1``) and the state file's ``sha256``;
- ``mesh.json``: the mesh the state was written on (the port's
  ``{"data", "seq", "model"}`` sizes, and ``expert`` where it is more
  than 1), the process and device counts, and the layout of every leaf
  (its flax ``PartitionSpec`` over the model axis, a MoE block's
  experts over the axis they were cut on, ``PartitionSpec()`` where
  every rank holds all of it).

Under tensor parallelism (``--mesh.model M``) a save gathers every
rank's shards back into the whole model's arrays (params, moments,
EMA; ``parallel/sharding.gather_state_dict``, an all-gather over the
model group that every rank joins), so the step directory is byte for
byte what one process writes of the same params, the ``--shard-vocab``
tables' padded rows included; a restore reads the whole arrays and
keeps this rank's shards (``interop.state_from_flax``), from a
one-process checkpoint or a TP one alike. A MoE model's experts are
gathered over the expert group the same way (``--mesh.expert X``), and
a restore keeps this rank's experts. Under ``--param-partition
zero1|fsdp`` the data blocks (slots; params and EMA under fsdp) are
all-gathered over the data group first (every data rank joins), so the
save is, byte for byte, the replicated run's save of the same state; a
restore cuts the whole arrays to this rank's blocks. Any checkpoint
(the JAX package's under fsdp included) restores under any partition.

A ``pipelined_lm``'s save is JAX's pipelined tree (``{"shell": ...,
"blocks": [S, lps, ...]}``, ``interop.layers_to_pipelined``): over a
pipe of processes each stage's blocks (params, moments, EMA) are first
broadcast over the pipe group (every pipe rank joins), so the step
directory is byte for byte what one process of all S stages writes; a
restore keeps this rank's stages, and a checkpoint of another stage
count is refused (JAX's restore cannot restack it either).

A save writes into ``step_XXXXXXXX.tmp`` and renames it, so a crash
mid-save never leaves a partial step behind; the newest ``keep`` steps
are kept. Only the chief writes; every rank waits for the rename. The
write retries an ``OSError`` with capped exponential backoff
(``set_io_policy``, from ``--resilience.save-retries`` and
``save-retry-backoff-s``), each retry a ``ckpt_retry`` recovery record;
``arm_io_fault`` injects failures there for the ``ckpt_io_fail`` drill.

``restore_resharded`` restores a checkpoint written on another mesh
(the elastic restart's resume): the values are the written ones to the
bit (a restore reads whole arrays and cuts this rank's part, in
place into the template's own tensors, each checked against the
template's shape first: ``interop._copy_checked``, the port's form of
JAX's sharding-contract check). The meshes are compared with every missing axis taken as 1: the port's
``mesh.json`` lists ``expert`` and ``pipe`` only above 1, JAX's every
axis. A failure of a restore across meshes that is not already a clear
error is re-raised as ``MeshMismatchError``, naming both meshes.

``restore`` takes the newest step whose sha256 verifies: a corrupt one
is renamed aside (``quarantined_step_XXXXXXXX``, with a ``quarantine``
recovery record) and the next newer one is tried; ``quarantine_from``
renames aside every step from one on (a rewind's poisoned saves). An explicit step is exact, and its error lists the steps
there are. ``restore_params`` reads only the params (the EMA where there
is one) for a live weight swap, walking back past corrupt and
non-finite steps.

A local-SGD run (``--param-sync-every`` > 1, ``train/local_sgd.py``)
saves JAX's replica-stacked state: a leading [R] dim on the step, the
params and the optimizer leaves, the replicas all-gathered over the
data group. ``restore`` loads each replica's slice back (a plain
checkpoint into a stacked template, or the reverse, raises naming
``--param-sync-every``); ``restore_averaged`` averages the replicas
on the host into a plain template (``--mode eval``, generate, serve),
and ``restore_params`` averages them for a live swap.

The orbax backend and background saves of the JAX package are not
ported (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib
from tensorflow_distributed_tpu_torch.parallel.fsdp import swapped_params
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    flax_spec, gather_state_dict, is_split)
from tensorflow_distributed_tpu_torch.train.local_sgd import StackedState
from tensorflow_distributed_tpu_torch.train.state import TrainState
from tensorflow_distributed_tpu_torch.utils import serialization
from tensorflow_distributed_tpu_torch.utils.atomicio import atomic_write_json
from tensorflow_distributed_tpu_torch.utils.logging import emit_event

STEP_PREFIX = "step_"
QUARANTINE_PREFIX = "quarantined_"
MESH_MANIFEST = "mesh.json"
FORMAT = "flax-msgpack-v1"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification (sha256 mismatch, unreadable or
    undecodable state file). ``restore`` quarantines it and falls back
    to the next newest step; this escapes only for an explicit step or
    when no verifiable step is left."""


class MeshMismatchError(RuntimeError):
    """A restore failed because the checkpoint was written on another
    mesh than the one the template is laid out for: raised with both
    meshes named, instead of the error underneath. A restore across
    meshes is :func:`restore_resharded`'s job."""


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{STEP_PREFIX}{step:08d}")


def available_steps(ckpt_dir: str) -> List[int]:
    """The complete checkpoints: step directories holding a
    ``state.msgpack``. Staging (``.tmp``) and quarantined directories,
    stray files named like a step and everything else are ignored."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith(STEP_PREFIX):
            continue
        try:
            step = int(name[len(STEP_PREFIX):])
        except ValueError:
            continue
        d = os.path.join(ckpt_dir, name)
        if os.path.isdir(d) and os.path.exists(
                os.path.join(d, "state.msgpack")):
            out.append(step)
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _leaf_paths(tree: Any, prefix: str = ""):
    """``/``-joined paths of the array leaves, in the order JAX flattens
    a state dict (keys sorted)."""
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaf_paths(value, path + "/")
        elif value is not None:
            yield path


MESH_AXES = ("data", "pipe", "seq", "model", "expert")


def mesh_shape_dict(mesh: Mesh) -> dict:
    """The mesh as ``mesh.json`` writes it: ``data``, ``seq`` and
    ``model`` always, ``expert`` and ``pipe`` where above 1. (JAX reads
    a live state's mesh off its leaves, ``_tree_mesh``; a port state
    does not carry its mesh, so the caller names it, as to ``save``.)"""
    shape = {"data": mesh.data, "seq": mesh.seq, "model": mesh.model}
    if mesh.expert > 1:
        shape["expert"] = mesh.expert
    if mesh.pipe > 1:
        shape["pipe"] = mesh.pipe
    return shape


def same_mesh(a: Optional[dict], b: Optional[dict]) -> bool:
    """Whether two written or live mesh dicts name one mesh, every axis
    one of them leaves out taken as 1 (a checkpoint of either package
    written on the same mesh never reads as resharded)."""
    return all(int((a or {}).get(x, 1)) == int((b or {}).get(x, 1))
               for x in MESH_AXES)


def _mesh_manifest(tree: dict, mesh: Mesh, shard_vocab: bool,
                   experts_cut: bool = False) -> dict:
    """JAX's mesh manifest keys: the mesh sizes, the process and device
    counts, and each leaf's layout over the model axis (and, where the
    experts were cut, over their axis)."""
    n = mesh.data * mesh.pipe * mesh.seq * mesh.model * mesh.expert
    shape = mesh_shape_dict(mesh)
    expert_axis = None
    if experts_cut:
        expert_axis = "expert" if mesh.expert > 1 else "model"

    def spec(path):
        parts = path.split("/")
        if mesh.pipe > 1 and "blocks" in parts:
            return "PartitionSpec('pipe',)"
        return flax_spec(parts, shard_vocab, mesh.model > 1, expert_axis)

    return {"mesh": shape, "process_count": n, "devices": n,
            "specs": {p: spec(p) for p in _leaf_paths(tree)}}


def _format_mesh(shape: Optional[dict]) -> str:
    if not shape:
        return "unknown mesh"
    parts = [f"{k}={v}" for k, v in shape.items() if int(v) != 1]
    return ",".join(parts) if parts else "single-device"


def read_mesh_manifest(ckpt_dir: str, step: int) -> Optional[dict]:
    """The mesh manifest a step was written with, or None (absent or
    unreadable: never a reason to refuse a restore)."""
    try:
        with open(os.path.join(_step_dir(ckpt_dir, step),
                               MESH_MANIFEST)) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def steps_with_mesh(ckpt_dir: str) -> List[tuple]:
    """``[(step, written mesh dict or None), ...]`` for every complete
    checkpoint."""
    return [(s, (read_mesh_manifest(ckpt_dir, s) or {}).get("mesh"))
            for s in available_steps(ckpt_dir)]


def _describe_available(ckpt_dir: str, steps: List[int]) -> str:
    """The available steps for an error message, with the mesh each was
    written on."""
    if not steps:
        return "none"
    meta = steps_with_mesh(ckpt_dir)
    meshes = {_format_mesh(m) for _, m in meta if m}
    if not meshes:
        return str(steps)
    if len(meshes) == 1:
        return f"{steps} (written on mesh {meshes.pop()})"
    return "[" + ", ".join(
        f"{s} (mesh {_format_mesh(m)})" if m else str(s)
        for s, m in meta) + "]"


def _write_json(path: str, obj: Any) -> None:
    """Atomically replace ``path`` with ``obj`` as JSON (JAX's
    ``atomic_write_json``: same bytes, fsync'd, then renamed)."""
    atomic_write_json(path, obj)


# The save-I/O retry policy (capped exponential backoff), module-wide as
# in the JAX package: the train loop sets it from cfg.resilience at the
# start of a run.
_io_retries = 2
_io_backoff_s = 0.05
_io_backoff_max_s = 2.0
# Injected write failures (the ckpt_io_fail drill): the next N write
# attempts raise OSError inside the retry loop.
_injected_io_failures = 0


def set_io_policy(retries: int = 2, backoff_s: float = 0.05,
                  backoff_max_s: float = 2.0) -> None:
    global _io_retries, _io_backoff_s, _io_backoff_max_s
    _io_retries, _io_backoff_s = retries, backoff_s
    _io_backoff_max_s = backoff_max_s


def arm_io_fault(count: int = 1) -> None:
    global _injected_io_failures
    _injected_io_failures = count


def _retry_io(fn, step: int):
    """Run a save-I/O callable, retrying an OSError up to the policy's
    budget with capped exponential backoff; each retry prints a
    ``ckpt_retry`` recovery record."""
    delay = _io_backoff_s
    for attempt in range(_io_retries + 1):
        try:
            return fn()
        except OSError as e:
            if attempt == _io_retries:
                raise
            emit_event("recovery", kind="ckpt_retry", step=step,
                       attempt=attempt + 1, budget=_io_retries,
                       error=str(e), backoff_s=round(delay, 4))
            time.sleep(delay)
            delay = min(delay * 2, _io_backoff_max_s)


def _write(ckpt_dir: str, step: int, tree: dict, keep: int,
           mesh_manifest: Optional[dict] = None) -> str:
    """Serialize and atomically publish one checkpoint, then prune to
    the newest ``keep``. The state is hashed and written piece by piece
    (no second copy of it in memory); the whole sequence retries under
    the I/O policy."""
    final = _step_dir(ckpt_dir, step)
    param_bytes = sum(leaf.nbytes for leaf in _leaves(tree["params"]))

    def attempt() -> None:
        global _injected_io_failures
        if _injected_io_failures > 0:
            _injected_io_failures -= 1
            raise OSError(
                f"injected checkpoint I/O failure at step {step} "
                f"(resilience fault drill)")
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        sha = hashlib.sha256()
        with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
            for piece in serialization.encode_chunks(tree):
                sha.update(piece)
                f.write(piece)
        _write_json(os.path.join(tmp, "manifest.json"), {
            "step": step, "param_bytes": int(param_bytes), "format": FORMAT,
            "sha256": sha.hexdigest()})
        if mesh_manifest is not None:
            _write_json(os.path.join(tmp, MESH_MANIFEST), mesh_manifest)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    _retry_io(attempt, step)
    for old in available_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)
    return final


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif tree is not None:
        yield tree


@contextlib.contextmanager
def whole_state(state: TrainState):
    """``state`` itself, or one holding the whole model's tensors: the
    data blocks of a ``--param-partition`` layout gathered over the data
    group, then a tensor- or expert-parallel model's shards over the
    model and expert groups, then a pipelined model's stages over the
    pipe group (every rank of them must enter it). Such a model's whole
    state is held by a template of the whole model built on the meta
    device; under fsdp the model holds the gathered params while the
    context is open."""
    model, part = state.model, state.partition
    split = is_split(model)
    piped = getattr(model, "is_pipelined", False) and len(
        model.pipe.stages) < model.num_stages
    if part.kind == "replicated" and not split and not piped:
        yield state
        return

    @torch.no_grad()
    def whole(tensors):
        out = {n: part.whole(n, t) for n, t in tensors.items()}
        return gather_state_dict(out, model) if split else out

    params = whole({n: p.detach() for n, p in state.params.items()})
    opt = {k: (whole(v) if isinstance(v, dict) else v)
           for k, v in state.opt_state.items()}
    ema = None if state.ema is None else whole(state.ema)
    if piped:
        yield _whole_pipe(state, params, opt, ema)
        return
    if split:
        template = model.whole("meta")
        template.load_state_dict(params, assign=True)
        yield TrainState(model=template, tx=state.tx, opt_state=opt,
                         step=state.step, ema=ema)
        return
    with swapped_params(model, params if part.params_blocked else {}):
        yield TrainState(model=model, tx=state.tx, opt_state=opt,
                         step=state.step, ema=ema)


@torch.no_grad()
def _whole_pipe(state: TrainState, params, opt, ema) -> TrainState:
    """A state of every stage of a pipelined model run over a pipe of
    processes, from this stage's whole ``params``, ``opt`` and ``ema``
    (gathered over the data and model groups): each block tensor (param,
    moment, Adafactor statistic, EMA) broadcast from the stage that
    holds it over the pipe group, on a template of all S stages built on
    the meta device. Every stage's layers are alike, so a tensor takes
    the shape of this rank's tensor of the same name past its
    ``layer_g``."""
    model = state.model
    pipe = model.pipe
    template = model.whole("meta")
    lps = model.cfg.n_layers // (model.num_stages * model.virtual_stages)
    owners = {n: (int(n.split(".")[0][len("layer_"):]) // lps)
              % model.num_stages
              for n, _ in template.named_parameters()
              if n.startswith("layer_")}
    device = next(model.parameters()).device

    def whole(tensors):
        like = {n.split(".", 1)[1]: t for n, t in tensors.items()
                if n in owners}
        out = {}
        for n, _ in template.named_parameters():
            if n not in owners:
                out[n] = tensors[n]
                continue
            mine = like[n.split(".", 1)[1]]
            t = (tensors[n].contiguous() if owners[n] == pipe.index else
                 torch.empty(mine.shape, dtype=mine.dtype, device=device))
            dist.broadcast(t, pipe._peer(owners[n]), group=pipe.group)
            out[n] = t
        return out

    params = whole(params)
    opt = {k: (whole(v) if isinstance(v, dict) else v)
           for k, v in opt.items()}
    ema = None if ema is None else whole(ema)
    template.load_state_dict(params, assign=True)
    return TrainState(model=template, tx=state.tx, opt_state=opt,
                      step=state.step, ema=ema)


def _replica_trees(stacked: StackedState) -> Optional[List[dict]]:
    """Every replica's plain state dict, in data order, on the chief
    (None on the other ranks): this process's replicas, or under
    torchrun each data rank's tensors gathered to the chief a leaf at a
    time, each leaf's D copies moved to the host before the next is
    gathered (every data rank joins)."""
    mesh = stacked.mesh
    if not mesh.distributed or mesh.data == 1:
        return [interop.state_to_flax(r) for r in stacked.replicas]
    rep = stacked.replicas[0]
    chief = mesh_lib.is_chief()

    @torch.no_grad()
    def gather(t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.data)] \
            if chief else None
        dist.gather(t, parts, dst=0, group=mesh.data_group)
        return [x.cpu() for x in parts] if chief else None

    params = {n: gather(p) for n, p in rep.params.items()}
    opt = {k: ({n: gather(t) for n, t in v.items()}
               if isinstance(v, dict) else v)
           for k, v in rep.opt_state.items()}
    if not chief:
        return None
    trees = []
    for r in range(mesh.data):
        mine = {k: ({n: t[r] for n, t in v.items()}
                    if isinstance(v, dict) else v) for k, v in opt.items()}
        with swapped_params(rep.model, {n: t[r] for n, t in params.items()}):
            trees.append(interop.state_to_flax(TrainState(
                model=rep.model, tx=rep.tx, opt_state=mine, step=rep.step)))
    return trees


def _save_stacked(ckpt_dir: str, stacked: StackedState, keep: int) -> str:
    """Local SGD's save: JAX's replica-stacked tree
    (``interop.stack_trees``), every leaf laid out over the data axis in
    the mesh manifest."""
    mesh = stacked.mesh
    trees = _replica_trees(stacked)
    if trees is not None:
        tree = interop.stack_trees(trees)
        del trees
        manifest = _mesh_manifest(tree, mesh, False)
        manifest["specs"] = {
            p: ("PartitionSpec('data',)"
                if p.split("/")[0] in interop.STACKED_KEYS
                else "PartitionSpec()") for p in manifest["specs"]}
        _write(ckpt_dir, stacked.step, tree, keep, manifest)
    mesh.barrier()
    return _step_dir(ckpt_dir, stacked.step)


def save(ckpt_dir: str, state: TrainState, keep: int = 3,
         mesh: Mesh = ONE_PROCESS) -> str:
    """Write ``state`` at its step and prune to the newest ``keep``.
    Every rank calls it: under tensor or expert parallelism and a data
    partition every rank joins the gathers; the chief writes, and every rank
    leaves only after the rename, so ``latest_step`` agrees everywhere
    on return. A local-SGD ``StackedState`` writes JAX's replica-stacked
    state (its replicas gathered over the data group)."""
    if isinstance(state, StackedState):
        return _save_stacked(ckpt_dir, state, keep)
    final = _step_dir(ckpt_dir, state.step)
    with whole_state(state) as whole:
        if mesh_lib.is_chief():
            tree = interop.state_to_flax(whole)
            cfg = getattr(state.model, "cfg", None)
            _write(ckpt_dir, state.step, tree, keep,
                   _mesh_manifest(tree, mesh,
                                  bool(getattr(cfg, "shard_vocab", False)),
                                  getattr(state.model, "ep", None)
                                  is not None))
    mesh.barrier()
    return final


def _quarantine(ckpt_dir: str, step: int, reason: str) -> str:
    """Rename a step aside (``quarantined_step_XXXXXXXX``): no listing
    sees it again and its bytes stay for inspection. The chief renames;
    every rank reached the same verdict from the same bytes. Prints a
    ``quarantine`` recovery record naming the mesh the step was written
    on."""
    name = f"{STEP_PREFIX}{step:08d}"
    dst = os.path.join(ckpt_dir, QUARANTINE_PREFIX + name)
    written = (read_mesh_manifest(ckpt_dir, step) or {}).get("mesh")
    if mesh_lib.is_chief():
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        try:
            os.rename(os.path.join(ckpt_dir, name), dst)
        except OSError:
            pass  # already moved or removed: skipping it is what counts
        print(f"[checkpoint] quarantined step {step}: {reason}",
              file=sys.stderr, flush=True)
    emit_event("recovery", kind="quarantine", step=step, reason=reason,
               mesh=_format_mesh(written) if written else None)
    return dst


def quarantine_from(ckpt_dir: str, step: int, reason: str,
                    mesh: Mesh = ONE_PROCESS) -> List[int]:
    """Quarantine every checkpoint at or after ``step``: a rewind's
    companion. A bad update at step K is seen a few steps later (the
    loop retires steps with a lag), so the cadence saves in between hold
    the poisoned state, with intact bytes; renamed aside, ``latest_step``
    lands on the newest save before the damage. Every rank calls it: the
    chief renames, and every rank leaves only after the renames. Returns
    the quarantined steps (the chief's view; empty on the other ranks)."""
    mesh.barrier()
    bad: List[int] = []
    if mesh_lib.is_chief():
        bad = [s for s in available_steps(ckpt_dir) if s >= step]
        for s in bad:
            _quarantine(ckpt_dir, s, reason)
    mesh.barrier()
    return bad


def _load_native_raw(step_path: str) -> Any:
    """Read and verify a step's state dict. Raises CheckpointCorruptError
    on unreadable bytes, a sha256 that differs from the manifest's, or a
    state file that does not decode. A manifest without a sha256 skips
    the hash; the decode check remains."""
    path = os.path.join(step_path, "state.msgpack")
    try:
        with open(path, "rb") as f:
            blob = bytearray(os.fstat(f.fileno()).st_size)
            f.readinto(blob)
    except OSError as e:
        raise CheckpointCorruptError(f"unreadable {path}: {e}") from e
    expected = None
    man_path = os.path.join(step_path, "manifest.json")
    if os.path.exists(man_path):
        try:
            with open(man_path) as f:
                expected = json.load(f).get("sha256")
        except (OSError, ValueError):
            expected = None
    if expected is not None:
        got = hashlib.sha256(blob).hexdigest()
        if got != expected:
            raise CheckpointCorruptError(
                f"checksum mismatch for {path}: manifest sha256 "
                f"{expected[:12]}…, file {got[:12]}… (truncated or "
                f"bit-flipped write)")
    try:
        raw = serialization.msgpack_restore(blob)
    except Exception as e:
        raise CheckpointCorruptError(f"undecodable {path}: {e}") from e
    if not isinstance(raw, dict) or "params" not in raw:
        raise CheckpointCorruptError(f"{path} holds no train state")
    return raw


def _restore_from_raw(raw: Any, state: TrainState) -> TrainState:
    """Load a state dict into ``state``, with JAX's EMA rules: EMA newly
    on seeds from the restored params, EMA newly off drops the average,
    and a checkpoint without an ``ema`` key has it off. A local-SGD
    ``StackedState`` takes its replicas' slices of a replica-stacked
    state dict."""
    if isinstance(state, StackedState):
        mesh = state.mesh
        interop.stacked_state_from_flax(raw, state.replicas,
                                        mesh.data_ranks, mesh.data)
        return state
    raw.setdefault("ema", None)
    want, have = state.ema is not None, raw["ema"] is not None
    if want and not have:
        raw["ema"] = raw["params"]
    elif have and not want:
        raw["ema"] = None
    return interop.state_from_flax(raw, state)


def _load_step(ckpt_dir: str, step: int, state: TrainState) -> TrainState:
    return _restore_from_raw(_load_native_raw(_step_dir(ckpt_dir, step)),
                             state)


def _load_step_checked(ckpt_dir: str, step: int, state: TrainState,
                       mesh: Optional[Mesh]) -> TrainState:
    """``_load_step``, with a failure across meshes named: when the
    written mesh differs from ``mesh`` (this run's; None: unknown), an
    error this layer does not already make clear (corruption, a missing
    file, a shape or ``--param-sync-every`` ValueError) is re-raised as
    :class:`MeshMismatchError` naming both meshes and pointing at
    :func:`restore_resharded`. On the same mesh it stays itself."""
    try:
        return _load_step(ckpt_dir, step, state)
    except (CheckpointCorruptError, FileNotFoundError, ValueError,
            MeshMismatchError):
        raise
    except Exception as e:
        written = read_mesh_manifest(ckpt_dir, step) or {}
        want = mesh_shape_dict(mesh) if mesh is not None else None
        if written.get("mesh") and want and not same_mesh(
                written["mesh"], want):
            raise MeshMismatchError(
                f"restore of step {step} under {ckpt_dir} failed: the "
                f"checkpoint was written on mesh "
                f"{_format_mesh(written['mesh'])} "
                f"({written.get('process_count', '?')} process(es)) but "
                f"the template requests mesh {_format_mesh(want)} "
                f"[{type(e).__name__}: {e}]. Use restore_resharded() to "
                f"re-lay a checkpoint out onto a different mesh with the "
                f"layout verified.") from e
        raise


def _newest_verified(ckpt_dir: str, step: Optional[int], load,
                     what: str = "--resume"):
    """``(step, load(step))`` of the checkpoint ``restore`` picks:
    ``step=None`` the newest whose ``load`` verifies, a corrupt candidate
    quarantined and the next newest tried; an explicit ``step`` exact
    (missing raises FileNotFoundError listing the steps there are,
    corrupt raises CheckpointCorruptError and leaves the directory as
    it is). ``what`` names the mode in the empty-directory error."""
    steps = available_steps(ckpt_dir)
    if step is not None:
        if step not in steps:
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {ckpt_dir}; "
                f"available steps: {_describe_available(ckpt_dir, steps)}")
        return step, load(step)
    if not steps:
        raise FileNotFoundError(
            f"no checkpoints under {ckpt_dir} — is this a {what} "
            f"on an empty or absent checkpoint dir, or the wrong "
            f"--checkpoint-dir?")
    last_err: Optional[CheckpointCorruptError] = None
    for s in reversed(steps):
        try:
            return s, load(s)
        except CheckpointCorruptError as e:
            _quarantine(ckpt_dir, s, str(e))
            last_err = e
    raise CheckpointCorruptError(
        f"every checkpoint under {ckpt_dir} failed verification "
        f"(all quarantined); last error: {last_err}")


def restore(ckpt_dir: str, state: TrainState,
            step: Optional[int] = None,
            mesh: Optional[Mesh] = None) -> TrainState:
    """Restore into ``state`` (a freshly built template) in place, and
    return it.

    ``step=None``: the newest step that verifies. A corrupt candidate is
    quarantined and the next newest is tried, so a damaged latest
    checkpoint costs ``checkpoint_every`` steps, never the run. An
    explicit ``step`` is exact: missing raises FileNotFoundError listing
    the steps there are; corrupt raises CheckpointCorruptError and
    leaves the directory as it is. ``mesh``: the mesh ``state`` is laid
    out for (a local-SGD state's own by default), which names a failure
    across meshes (``MeshMismatchError``)."""
    if mesh is None and isinstance(state, StackedState):
        mesh = state.mesh
    return _newest_verified(
        ckpt_dir, step,
        lambda s: _load_step_checked(ckpt_dir, s, state, mesh))[1]


def restore_resharded(ckpt_dir: str, state: TrainState,
                      step: Optional[int] = None, verify: bool = True,
                      mesh: Optional[Mesh] = None):
    """Restore a checkpoint written on mesh A into a template laid out on
    mesh B (``mesh``; a local-SGD state's own by default): the elastic
    restart's path. Returns ``(state, info)``.

    The values are the written ones to the bit (a restore reads the
    whole arrays and keeps this rank's shards and blocks), so any data,
    fsdp, tensor or expert layout restores any other, onto more devices
    than wrote it too. ``verify`` is kept for JAX's signature: the
    port's sharding contract is ``restore``'s own, which copies each
    leaf in place into the template's tensor after checking its shape
    (``interop._copy_checked``), so a restored leaf always has the
    template's shape, dtype and device.

    ``info``: ``step``, ``from_mesh`` (the written manifest's, None for
    a checkpoint without one), ``to_mesh``, ``resharded`` (False when
    the two name one mesh) and ``seconds``. An actual change of mesh
    prints one ``reshard_restore`` recovery record. The integrity
    contract is ``restore``'s."""
    t0 = time.perf_counter()
    if mesh is None:
        mesh = state.mesh if isinstance(state, StackedState) else ONE_PROCESS
    restored = restore(ckpt_dir, state, step=step, mesh=mesh)
    got_step = restored.step
    written = read_mesh_manifest(ckpt_dir, got_step) or {}
    to_mesh = mesh_shape_dict(mesh)
    from_mesh = written.get("mesh")
    resharded = bool(from_mesh and not same_mesh(from_mesh, to_mesh))
    info = {"step": got_step, "from_mesh": from_mesh, "to_mesh": to_mesh,
            "resharded": resharded,
            "seconds": round(time.perf_counter() - t0, 4)}
    if resharded:
        emit_event("recovery", kind="reshard_restore", **info)
    return restored, info


def _mean0(x: np.ndarray) -> np.ndarray:
    """A replica-stacked leaf's replica mean (float) or replica 0's
    (integer), as JAX's ``restore_averaged``."""
    if not x.ndim:
        return x
    if np.issubdtype(x.dtype, np.floating):
        return x.mean(axis=0)
    return x[0]


def restore_averaged(ckpt_dir: str, state: TrainState,
                     step: Optional[int] = None) -> TrainState:
    """Restore a replica-stacked (local SGD) checkpoint into the PLAIN
    template ``state`` by averaging the replica dim on the host: the
    ``--mode eval``, generate and serve path of a local-SGD run, on any
    data width (train on 4 replicas, validate on 1). Float leaves take
    the replicas' mean, integer leaves (the step, the counts) replica
    0's. The same integrity contract as ``restore``."""
    step, raw = _newest_verified(
        ckpt_dir, step, lambda s: _load_native_raw(_step_dir(ckpt_dir, s)),
        "--resume/mode=eval")
    if not interop.is_stacked(raw):
        raise ValueError(
            f"checkpoint at {_step_dir(ckpt_dir, step)} is not "
            f"replica-stacked (was it saved with --param-sync-every > 1?)")
    for key in interop.STACKED_KEYS:
        raw[key] = interop.map_tree(_mean0, raw[key])
    return _restore_from_raw(raw, state)


def _host_finite(tree: Any) -> bool:
    """True when every float leaf of a host tree is finite."""
    for leaf in _leaves(tree):
        arr = np.asarray(leaf)
        if (np.issubdtype(arr.dtype, np.floating)
                and not np.isfinite(arr).all()):
            return False
    return True


def restore_params(ckpt_dir: str, model: torch.nn.Module,
                   step: Optional[int] = None
                   ) -> Tuple[Dict[str, torch.Tensor], int]:
    """PARAMS-ONLY restore for a live weight swap: the newest verifiable
    checkpoint's params (its EMA where it has one) under the serving
    ``model``'s parameter names, each on the device and in the dtype of
    the live tensor it replaces. No optimizer state, no train state.
    Returns ``(params, step)``, what ``SlotDecodeEngine.swap_params``
    takes. A tensor-parallel ``model`` takes this process's ranks'
    slices of every whole leaf (``shard_vocab``'s padded rows included),
    the layout its TP training saves.

    Walks back from the newest step past one that fails the sha256 or
    decode check (quarantined, as ``restore`` does) or holds NON-FINITE
    params (skipped with a ``swap_skip`` recovery record, not
    quarantined: the bytes are intact). An explicit ``step`` (a
    tensor-parallel worker, told which step its chief picked) reads that
    step alone."""
    steps = available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(
            f"no checkpoints under {ckpt_dir} — live weight swap needs "
            f"at least one completed save")
    if step is not None:
        steps = [step]
    last_err: Optional[Exception] = None
    got = None
    for s in reversed(steps):
        try:
            raw = _load_native_raw(_step_dir(ckpt_dir, s))
        except CheckpointCorruptError as e:
            _quarantine(ckpt_dir, s, str(e))
            last_err = e
            continue
        tree = raw["ema"] if raw.get("ema") is not None else raw["params"]
        if interop.is_stacked(raw):
            # A local-SGD save: the replicas' mean (restore_averaged's).
            tree = interop.map_tree(_mean0, tree)
        if not _host_finite(tree):
            emit_event("recovery", kind="swap_skip", step=s,
                       reason="non-finite params")
            last_err = ValueError(f"params at step {s} are non-finite")
            continue
        got = (s, tree)
        break
    if got is None:
        raise CheckpointCorruptError(
            f"no verifiable swap target under {ckpt_dir}; last error: "
            f"{last_err}")
    s, tree = got
    host = interop.shards_from_flax(tree, model)
    live = dict(model.named_parameters())
    interop._check_names(host, live, "params")
    out = {}
    for name, t in live.items():
        if host[name].shape != t.shape:
            raise ValueError(
                f"checkpoint param shape {tuple(host[name].shape)} != "
                f"live {tuple(t.shape)} ({name}): live weight swap needs "
                f"an identical architecture (same config)")
        out[name] = host[name].to(device=t.device, dtype=t.dtype)
    return out, s

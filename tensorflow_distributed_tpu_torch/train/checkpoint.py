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
  ``{"data", "seq"}`` sizes), the process and device counts, and the
  layout of every leaf (replicated: every rank holds all of it).

A save writes into ``step_XXXXXXXX.tmp`` and renames it, so a crash
mid-save never leaves a partial step behind; the newest ``keep`` steps
are kept. Only the chief writes; every rank waits for the rename.

``restore`` takes the newest step whose sha256 verifies: a corrupt one
is renamed aside (``quarantined_step_XXXXXXXX``) and the next newer one
is tried. An explicit step is exact, and its error lists the steps
there are. The orbax backend and background saves of the JAX package
are not ported (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from typing import Any, List, Optional

from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.train.state import TrainState
from tensorflow_distributed_tpu_torch.utils import serialization

STEP_PREFIX = "step_"
QUARANTINE_PREFIX = "quarantined_"
MESH_MANIFEST = "mesh.json"
FORMAT = "flax-msgpack-v1"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification (sha256 mismatch, unreadable or
    undecodable state file). ``restore`` quarantines it and falls back
    to the next newest step; this escapes only for an explicit step or
    when no verifiable step is left."""


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


def _mesh_manifest(tree: dict, mesh: Mesh) -> dict:
    """JAX's mesh manifest keys: the mesh sizes, the process and device
    counts, and each leaf's layout (every leaf is replicated here)."""
    return {"mesh": {"data": mesh.data, "seq": mesh.seq},
            "process_count": mesh.data * mesh.seq,
            "devices": mesh.data * mesh.seq,
            "specs": {p: "PartitionSpec()" for p in _leaf_paths(tree)}}


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
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write(ckpt_dir: str, step: int, tree: dict, keep: int,
           mesh_manifest: Optional[dict] = None) -> str:
    """Serialize and atomically publish one checkpoint, then prune to
    the newest ``keep``. The state is hashed and written piece by piece
    (no second copy of it in memory)."""
    final = _step_dir(ckpt_dir, step)
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
    param_bytes = sum(leaf.nbytes for leaf in _leaves(tree["params"]))
    _write_json(os.path.join(tmp, "manifest.json"), {
        "step": step, "param_bytes": int(param_bytes), "format": FORMAT,
        "sha256": sha.hexdigest()})
    if mesh_manifest is not None:
        _write_json(os.path.join(tmp, MESH_MANIFEST), mesh_manifest)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for old in available_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)
    return final


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif tree is not None:
        yield tree


def save(ckpt_dir: str, state: TrainState, keep: int = 3,
         mesh: Mesh = ONE_PROCESS) -> str:
    """Write ``state`` at its step and prune to the newest ``keep``.
    Every rank calls it: the chief writes, and every rank leaves only
    after the rename, so ``latest_step`` agrees everywhere on return."""
    final = _step_dir(ckpt_dir, state.step)
    if mesh_lib.is_chief():
        tree = interop.state_to_flax(state)
        _write(ckpt_dir, state.step, tree, keep,
               _mesh_manifest(tree, mesh))
    mesh.barrier()
    return final


def _quarantine(ckpt_dir: str, step: int, reason: str) -> str:
    """Rename a corrupt step aside (``quarantined_step_XXXXXXXX``): no
    listing sees it again and its bytes stay for inspection. The chief
    renames; every rank reached the same verdict from the same bytes."""
    name = f"{STEP_PREFIX}{step:08d}"
    dst = os.path.join(ckpt_dir, QUARANTINE_PREFIX + name)
    if mesh_lib.is_chief():
        if os.path.exists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        try:
            os.rename(os.path.join(ckpt_dir, name), dst)
        except OSError:
            pass  # already moved or removed: skipping it is what counts
        print(f"[checkpoint] quarantined step {step}: {reason}",
              file=sys.stderr, flush=True)
    return dst


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
    and a checkpoint without an ``ema`` key has it off."""
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


def restore(ckpt_dir: str, state: TrainState,
            step: Optional[int] = None) -> TrainState:
    """Restore into ``state`` (a freshly built template) in place, and
    return it.

    ``step=None``: the newest step that verifies. A corrupt candidate is
    quarantined and the next newest is tried, so a damaged latest
    checkpoint costs ``checkpoint_every`` steps, never the run. An
    explicit ``step`` is exact: missing raises FileNotFoundError listing
    the steps there are; corrupt raises CheckpointCorruptError and
    leaves the directory as it is."""
    steps = available_steps(ckpt_dir)
    if step is not None:
        if step not in steps:
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {ckpt_dir}; "
                f"available steps: {_describe_available(ckpt_dir, steps)}")
        return _load_step(ckpt_dir, step, state)
    if not steps:
        raise FileNotFoundError(
            f"no checkpoints under {ckpt_dir} — is this a --resume "
            f"on an empty or absent checkpoint dir, or the wrong "
            f"--checkpoint-dir?")
    last_err: Optional[CheckpointCorruptError] = None
    for s in reversed(steps):
        try:
            return _load_step(ckpt_dir, s, state)
        except CheckpointCorruptError as e:
            _quarantine(ckpt_dir, s, str(e))
            last_err = e
    raise CheckpointCorruptError(
        f"every checkpoint under {ckpt_dir} failed verification "
        f"(all quarantined); last error: {last_err}")

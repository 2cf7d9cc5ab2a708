"""PyTorch port: ``checkpoint.restore_resharded`` (a checkpoint written on
one mesh restored onto another: the elastic restart's resume), against
the JAX package.

- JAX checkpoints of a tiny GPT (a 512-id vocabulary, so that fsdp cuts
  its tables; EMA on) written on the 8-device CPU mesh (data 8, data 8
  fsdp, data 2 x model 2) restore in the port onto ``stacked_data(2)``
  fsdp, one process and ``StackedTP(2)``: params, Adam state and EMA
  equal JAX's to the bit, compared through ``interop.state_to_flax``,
  and the port's re-save is JAX's file byte for byte.
- A port save at data 4 fsdp (``stacked_data(4)``) restores through
  JAX's ``restore_resharded`` onto meshes of 2 (fsdp) and 1 devices,
  equal to the bit.
- ``info`` has JAX's keys and values (the meshes compared with every
  missing axis 1); a restore on the same mesh, a JAX-spelled
  ``mesh.json`` included, is plain and prints no record.
- ``MeshMismatchError`` names both meshes and ``restore_resharded``; on
  the same mesh the failure stays itself. The quarantine record names the
  written mesh. A local-SGD checkpoint of 4 replicas onto 2 is refused
  with JAX's message.
"""

import hashlib
import json
import os
import shutil

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import checkpoint as jckpt
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import MeshConfig, TrainConfig
from tensorflow_distributed_tpu_torch.data.prefetch import to_device
from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    StackedTP)
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from torch_threads import _one_thread  # noqa: F401

CPU = torch.device("cpu")
GPT = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
           train_steps=2, eval_every=0, log_every=1, eval_batch_size=8,
           compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
           seed=0, synthetic_vocab=512, ema_decay=0.9, checkpoint_every=1)
# name: (config fields, JAX mesh, devices JAX masks off its 8)
SOURCES = {"data8": ({}, dict(data=8), 0),
           "data8_fsdp": ({"param_partition": "fsdp"}, dict(data=8), 0),
           "data2_model2": ({}, dict(data=2, model=2), 4)}


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """Each of SOURCES trained 2 steps by JAX's train() and saved at
    steps 1 and 2: {name: checkpoint dir}."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    out = {}
    for name, (extra, mesh, mask) in SOURCES.items():
        with pytest.MonkeyPatch.context() as mp:
            if mask:
                mp.setenv("TFD_DEVICE_MASK", str(mask))
            jloop.train(JaxConfig(**GPT, **extra, mesh=JaxMesh(**mesh),
                                  checkpoint_dir=str(root / name)),
                        logger=JaxLogger(enabled=False))
        out[name] = str(root / name)
    return out


def _raw(d, step=2):
    return ckpt._load_native_raw(ckpt._step_dir(d, step))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, np.asarray(tree)


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _port_tree(state):
    with ckpt.whole_state(state) as whole:
        return interop.state_to_flax(whole)


def _target(name, **extra):
    """A fresh port template and its mesh: ``stacked_data(2)`` fsdp, one
    process, or ``StackedTP(2)``."""
    if name == "stacked2_fsdp":
        cfg = TrainConfig(**GPT, **extra, device="cpu",
                          mesh=MeshConfig(data=2), param_partition="fsdp")
        _, state, _ = tloop.build_stacked(cfg, CPU)
        return state, state.partition.mesh
    mesh = (mesh_lib.Mesh(model=2, tp=StackedTP(2)) if name == "tp2"
            else mesh_lib.ONE_PROCESS)
    cfg = TrainConfig(**GPT, **extra, device="cpu")
    _, state = tloop._build_model_and_state(
        cfg, CPU, mesh=mesh, task=tloop._make_task(cfg, mesh_lib.ONE_PROCESS))
    return state, mesh


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.mark.parametrize("source", list(SOURCES))
@pytest.mark.parametrize("target", ["stacked2_fsdp", "one", "tp2"])
def test_jax_checkpoint_restores_at_another_width(jax_ckpts, source, target,
                                                  tmp_path, capsys):
    d = jax_ckpts[source]
    state, mesh = _target(target)
    state, info = ckpt.restore_resharded(d, state, mesh=mesh)
    written = json.load(open(os.path.join(ckpt._step_dir(d, 2),
                                          "mesh.json")))["mesh"]
    assert info["step"] == 2 and info["from_mesh"] == written
    assert info["to_mesh"] == ckpt.mesh_shape_dict(mesh)
    assert info["resharded"] and info["seconds"] >= 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if '"reshard_restore"' in line]
    assert len(recs) == 1 and recs[0]["from_mesh"] == written
    _assert_bit_equal(_port_tree(state), _raw(d))
    ckpt.save(str(tmp_path), state, mesh=mesh)
    assert (_sha(os.path.join(ckpt._step_dir(str(tmp_path), 2),
                              "state.msgpack"))
            == _sha(os.path.join(ckpt._step_dir(d, 2), "state.msgpack")))


def test_info_equals_jax_s(jax_ckpts):
    """The data 8 checkpoint onto 2 devices in both packages: the same
    keys, step and verdict, the same meshes once every missing axis is
    1."""
    d = jax_ckpts["data8"]
    jm = make_mesh(JaxMesh(data=2), jax.devices()[:2])
    jcfg = JaxConfig(**GPT, mesh=JaxMesh(data=2))
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    _, want = jckpt.restore_resharded(d, jstate)
    state, mesh = _target("stacked2_fsdp")
    _, got = ckpt.restore_resharded(d, state, mesh=mesh)
    assert sorted(got) == sorted(want)
    assert (got["step"], got["resharded"]) == (want["step"], want["resharded"])
    assert got["from_mesh"] == want["from_mesh"]
    assert ckpt.same_mesh(got["to_mesh"], want["to_mesh"])


@pytest.fixture(scope="module")
def port_fsdp4(tmp_path_factory):
    """A port save at data 4 fsdp (stacked_data(4), one step from the
    seeded init): (its dir, its tree)."""
    d = str(tmp_path_factory.mktemp("port_fsdp4"))
    cfg = TrainConfig(**GPT, device="cpu", mesh=MeshConfig(data=4),
                      param_partition="fsdp")
    task, state, step = tloop.build_stacked(cfg, CPU)
    state, _ = step(state, to_device(next(task.train_stream(0)), CPU))
    ckpt.save(d, state, mesh=state.partition.mesh)
    return d, _port_tree(state)


@pytest.mark.parametrize("devices,partition", [(2, "fsdp"), (1, "replicated")])
def test_port_checkpoint_restores_in_jax(port_fsdp4, devices, partition):
    d, tree = port_fsdp4
    jm = make_mesh(JaxMesh(data=devices), jax.devices()[:devices])
    jcfg = JaxConfig(**GPT, mesh=JaxMesh(data=devices),
                     param_partition=partition)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    restored, info = jckpt.restore_resharded(d, jstate)
    assert info["resharded"] and info["from_mesh"] == {
        "data": 4, "seq": 1, "model": 1}
    _assert_bit_equal(
        flax.serialization.to_state_dict(jax.device_get(restored)), tree)


def test_same_mesh_is_plain(tmp_path, capsys):
    """A port save restored on its own mesh, and with its mesh.json
    spelled as JAX spells it (every axis), is not resharded and prints
    no record."""
    state, mesh = _target("one")
    ckpt.save(str(tmp_path), state, mesh=mesh)
    for spelling in ("port", "jax"):
        if spelling == "jax":
            path = os.path.join(ckpt._step_dir(str(tmp_path), 0), "mesh.json")
            man = json.load(open(path))
            man["mesh"] = {"data": 1, "pipe": 1, "seq": 1, "model": 1,
                           "expert": 1}
            json.dump(man, open(path, "w"))
        fresh, _ = _target("one")
        _, info = ckpt.restore_resharded(str(tmp_path), fresh, mesh=mesh)
        assert not info["resharded"], spelling
    assert "reshard_restore" not in capsys.readouterr().out


def test_mesh_mismatch_error_names_both_meshes(jax_ckpts, monkeypatch):
    """A failure under a restore across meshes is re-raised naming the
    written and the requested mesh and restore_resharded; on the same
    mesh it stays itself (JAX's test_mesh_mismatch_error_names_both_meshes)."""
    d = jax_ckpts["data8"]
    one, one_mesh = _target("one")
    cfg = TrainConfig(**GPT, device="cpu", mesh=MeshConfig(data=8))
    _, eight, _ = tloop.build_stacked(cfg, CPU)

    def boom(*a, **k):
        raise RuntimeError("placement exploded")

    monkeypatch.setattr(ckpt.interop, "state_from_flax", boom)
    with pytest.raises(ckpt.MeshMismatchError) as ei:
        ckpt.restore(d, one, mesh=one_mesh)
    msg = str(ei.value)
    assert "data=8" in msg and "single-device" in msg
    assert "restore_resharded" in msg
    with pytest.raises(RuntimeError, match="placement exploded") as ei:
        ckpt.restore(d, eight, mesh=mesh_lib.stacked_data(8))
    assert not isinstance(ei.value, ckpt.MeshMismatchError)


def test_quarantine_record_names_the_written_mesh(jax_ckpts, tmp_path,
                                                  monkeypatch):
    d = str(tmp_path / "copy")
    shutil.copytree(jax_ckpts["data8"], d)
    with open(os.path.join(ckpt._step_dir(d, 2), "state.msgpack"),
              "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff")
    events = []
    monkeypatch.setattr(ckpt, "emit_event",
                        lambda event, **f: events.append({"event": event,
                                                          **f}))
    state, mesh = _target("one")
    state, info = ckpt.restore_resharded(d, state, mesh=mesh)
    assert state.step == info["step"] == 1
    quar = [e for e in events if e.get("kind") == "quarantine"]
    assert [q["mesh"] for q in quar] == ["data=8"]


def test_local_sgd_onto_another_replica_count_is_refused(tmp_path):
    """JAX's _restore_from_raw message: a replica-stacked state of 4 is
    not averaged onto 2 replicas."""
    fields = dict(GPT, optimizer="sgd", param_sync_every=2, ema_decay=0.0)
    cfg = TrainConfig(**fields, device="cpu", mesh=MeshConfig(data=4))
    _, state, _ = tloop.build_stacked(cfg, CPU)
    ckpt.save(str(tmp_path), state)
    cfg2 = TrainConfig(**fields, device="cpu", mesh=MeshConfig(data=2))
    _, two, _ = tloop.build_stacked(cfg2, CPU)
    with pytest.raises(ValueError, match=(
            r"checkpoint leaf shape \(4,\) != template \(2,\).*was this run "
            r"saved with a different --param-sync-every \(replica-stacked "
            r"vs plain state\)\?")):
        ckpt.restore_resharded(str(tmp_path), two)

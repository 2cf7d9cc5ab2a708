"""PyTorch port: the elastic supervisor's planning and the ``device_loss``
drill, against the JAX package.

- ``parse_mesh_args``, ``pick_elastic_mesh``, ``rewrite_mesh_args``,
  ``plan_elastic``, ``_read_mask`` and ``build_leg_args`` equal JAX's
  exactly over a grid: each non-data axis in {1, 2, 4}, 0-9 alive
  devices, the global batch None, 6, 8 or 64, and both flag spellings.
- The ``device_loss`` grammar and its phase rules (train only, a
  checkpoint dir required) are JAX's, messages included.
- The drill fires on the first leg only, writes JAX's mask file and
  SIGKILLs the process; the supervisor's mask path is the drill's.
- ``alive_devices`` hides the last N devices with JAX's two errors, and
  a rank on a masked device is refused.
- The leg command: torchrun for a mesh of more than one process.
"""

import itertools
import json
import os
import signal

import pytest
import torch

from tensorflow_distributed_tpu import config as jconfig
from tensorflow_distributed_tpu.resilience import faults as jfaults
from tensorflow_distributed_tpu.resilience import supervisor as jsup
from tensorflow_distributed_tpu_torch import config as tconfig
from tensorflow_distributed_tpu_torch.parallel import mesh as tmesh
from tensorflow_distributed_tpu_torch.resilience import faults as tfaults
from tensorflow_distributed_tpu_torch.resilience import supervisor as tsup
from torch_threads import _one_thread  # noqa: F401

NON_DATA = ("model", "seq", "pipe", "expert")
SIZES = (1, 2, 4)
BATCHES = (None, 6, 8, 64)


def _argv(axes, spelling, batch=None, extra=()):
    """A child argv setting ``axes`` ({axis: size}) and the batch, in
    ``--flag v`` or ``--flag=v`` spelling."""
    out = list(extra)
    items = list(axes.items()) + ([("batch-size", batch)]
                                  if batch is not None else [])
    for name, v in items:
        flag = f"--mesh.{name}" if name != "batch-size" else "--batch-size"
        out += [f"{flag}={v}"] if spelling == "eq" else [flag, str(v)]
    return out


def _grid():
    """Every non-data product of {1, 2, 4} per axis."""
    for sizes in itertools.product(SIZES, repeat=len(NON_DATA)):
        yield dict(zip(NON_DATA, sizes))


@pytest.mark.parametrize("spelling", ["space", "eq"])
def test_parse_and_rewrite_mesh_args_equal_jax(spelling):
    for axes in _grid():
        for data in (None, 1, 2, 4, 8):
            ax = dict(axes, **({"data": data} if data else {}))
            argv = _argv(ax, spelling, extra=["--train-steps", "5"])
            assert tsup.parse_mesh_args(argv) == jsup.parse_mesh_args(argv)
            for alive in range(10):
                mesh = jsup.pick_elastic_mesh(jsup.parse_mesh_args(argv),
                                              alive, 64)
                if mesh is None:
                    continue
                assert (tsup.rewrite_mesh_args(argv, mesh)
                        == jsup.rewrite_mesh_args(argv, mesh)), (argv, mesh)


def test_pick_elastic_mesh_equals_jax():
    for axes in _grid():
        for data in (-1, 1, 4):
            ax = dict(axes, data=data)
            for alive, batch in itertools.product(range(10), BATCHES):
                assert (tsup.pick_elastic_mesh(ax, alive, batch)
                        == jsup.pick_elastic_mesh(ax, alive, batch)), (
                    ax, alive, batch)


@pytest.mark.parametrize("spelling", ["space", "eq"])
def test_plan_elastic_equals_jax(spelling):
    for axes in _grid():
        for batch in BATCHES:
            argv = _argv(dict(axes, data=4), spelling, batch)
            for total in range(10):
                for masked in range(total + 1):
                    assert (tsup.plan_elastic(argv, total, masked)
                            == jsup.plan_elastic(argv, total, masked)), (
                        argv, total, masked)


def test_read_mask_equals_jax(tmp_path):
    path = tmp_path / "DEVICE_MASK"
    assert tsup._read_mask(None) == jsup._read_mask(None) == 0
    assert tsup._read_mask(str(path)) == jsup._read_mask(str(path)) == 0
    for text in ("not json", "[1, 2]", json.dumps({"lost": 3}),
                 json.dumps({"lost": -2}), json.dumps({"lost": "x"}),
                 json.dumps({"step": 5}), json.dumps({"lost": 2.0}), ""):
        path.write_text(text)
        assert tsup._read_mask(str(path)) == jsup._read_mask(str(path)), text


@pytest.mark.parametrize("args", [
    ["--mesh.data", "8", "--checkpoint-dir", "/tmp/c"],
    ["--mesh.data=4", "--checkpoint-dir=/c", "--resume=false"],
    ["--checkpoint-dir", "/c", "--resume", "true", "--mesh.model", "2"],
    ["--train-steps", "5"],
    ["--mode", "serve", "--model", "gpt_lm", "--checkpoint-dir", "/c"],
])
def test_build_leg_args_equals_jax(args):
    for restarts in range(3):
        assert (tsup.build_leg_args(args, restarts)
                == jsup.build_leg_args(args, restarts))


def test_default_batch_is_jax_s():
    assert tsup._default_batch_size() == jsup._default_batch_size()


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    "device_loss@13:2", "device_loss@13", "device_loss@13:0",
    "device_loss@13:1.5", "device_loss@0", "device_loss@4:2s",
    "sigkill@3,device_loss@5:3", "device_loss@5:2,device_loss@5:3"])
def test_device_loss_grammar_equals_jax(spec):
    got = _outcome(tfaults.parse_fault_plan, spec)
    want = _outcome(jfaults.parse_fault_plan, spec)
    assert got[0] == want[0] and (got[0] == "ok" or got[1] == want[1])
    if got[0] == "ok":
        assert ({k: (e.kind, e.step, e.arg) for k, e in got[1]._by_step.items()}
                == {k: (e.kind, e.step, e.arg)
                    for k, e in want[1]._by_step.items()})


@pytest.mark.parametrize("mode,ckpt", [("train", "/c"), ("train", ""),
                                       ("serve", "/c"), ("eval", "/c")])
def test_device_loss_phase_rules_equal_jax(mode, ckpt):
    kw = dict(mode=mode, checkpoint_dir=ckpt)
    if mode != "train":
        kw["model"] = "gpt_lm"

    def run(mod):
        cfg = mod.TrainConfig(**kw, resilience=mod.ResilienceConfig(
            fault_plan="device_loss@5:2"))
        return _outcome(cfg.validate)

    got, want = run(tconfig), run(jconfig)
    assert got[0] == want[0]
    if want[0] == "ok":
        assert got == ("ok", None)
    else:
        assert got[1] == want[1]


def test_device_loss_fires_on_the_first_leg_only(tmp_path, monkeypatch):
    """A resumed leg never fires the drill; the first writes JAX's mask
    file (``{"lost": N, "step": K}``) and SIGKILLs the process."""
    results = {}
    for name, mod in (("port", tfaults), ("jax", jfaults)):
        killed = []
        monkeypatch.setattr(mod.os, "kill", lambda *a: killed.append(a))
        d = tmp_path / name
        d.mkdir()
        plan = mod.parse_fault_plan("device_loss@5:2")
        plan.bind(4)
        plan.maybe_device_loss(5, str(d))
        assert not killed and not (d / "DEVICE_MASK").exists()
        plan = mod.parse_fault_plan("device_loss@5:2")
        plan.bind(0)
        plan.maybe_device_loss(4, str(d))
        assert not killed
        plan.maybe_device_loss(5, str(d))
        assert killed == [(os.getpid(), signal.SIGKILL)]
        plan.maybe_device_loss(5, str(d))  # one-shot
        assert len(killed) == 1
        results[name] = json.loads((d / "DEVICE_MASK").read_text())
    assert results["port"] == results["jax"] == {"lost": 2, "step": 5}


def test_mask_path_is_the_supervisor_s(tmp_path, monkeypatch):
    monkeypatch.delenv("TFD_DEVICE_MASK_FILE", raising=False)
    assert (tfaults.device_mask_path("/c") == jfaults.device_mask_path("/c")
            == os.path.join("/c", "DEVICE_MASK"))
    monkeypatch.setenv("TFD_DEVICE_MASK_FILE", str(tmp_path / "m"))
    assert tfaults.device_mask_path("/c") == str(tmp_path / "m")


def test_supervisor_stops_when_no_mesh_fits(tmp_path, monkeypatch, capsys):
    """JAX's: survivors below the non-data product and no leg yet: no
    leg is launched, a mesh_exhausted record, exit 1."""
    mask = tmp_path / "DEVICE_MASK"
    mask.write_text(json.dumps({"lost": 7}))
    monkeypatch.setenv("TFD_DEVICE_MASK_FILE", str(mask))
    monkeypatch.setattr(tsup, "_probe_devices", lambda *a, **k: 8)
    rc = tsup.main(["--elastic", "--", "--mesh.model", "2",
                    "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert rc == 1
    out = capsys.readouterr().out
    assert '"kind": "mesh_exhausted"' in out and "leg 0" not in out


@pytest.mark.parametrize("mask,count,want", [
    ("", 4, [0, 1, 2, 3]), ("1", 4, [0, 1, 2]), ("3", 4, [0]),
    ("4", 4, "masks every device"), ("-1", 4, "must be >= 0")])
def test_alive_devices_hides_the_last(mask, count, want, monkeypatch):
    monkeypatch.setenv("TFD_CPU_DEVICE_COUNT", str(count))
    monkeypatch.setenv("TFD_DEVICE_MASK", mask)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tmesh.alive_devices("cpu")
    else:
        assert tmesh.alive_devices("cpu") == want


def test_a_rank_on_a_masked_device_is_refused(monkeypatch):
    monkeypatch.setenv("TFD_CPU_DEVICE_COUNT", "4")
    monkeypatch.setenv("TFD_DEVICE_MASK", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    tmesh.check_alive(torch.device("cpu"))
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="masked by TFD_DEVICE_MASK=2"):
        tmesh.check_alive(torch.device("cpu"))
    # Without a declared CPU count the mask is JAX's alone.
    monkeypatch.delenv("TFD_CPU_DEVICE_COUNT")
    tmesh.check_alive(torch.device("cpu"))


@pytest.mark.parametrize("args,nproc", [
    (["--mesh.data", "4"], 4), (["--mesh.data=2", "--mesh.model", "2"], 4),
    (["--mesh.data", "1", "--mesh.model", "2"], 2), (["--mesh.data", "1"], 1),
    ([], 1)])
def test_leg_command(args, nproc):
    cmd = tsup.leg_command(args)
    if nproc > 1:
        assert cmd[1:6] == ["-m", "torch.distributed.run", "--standalone",
                            "--nproc-per-node", str(nproc)]
    else:
        assert cmd[1:3] == ["-m", tsup.CLI]
    assert cmd[len(cmd) - len(args):] == args

"""PyTorch port: ``supervisor --elastic`` end to end over torchrun with
gloo on the CPU (JAX's ``test_supervisor_elastic_device_loss_shrinks_and_
continues``, with the CPU devices declared by ``TFD_CPU_DEVICE_COUNT``).

- A tiny ``gpt_lm`` in f32 at ``--mesh.data 4`` (batch 8, 8 steps,
  saves every 2) with ``device_loss@5:2``: every rank writes nothing but
  the chief's mask and dies at step 5; the supervisor probes 4 devices,
  reads 2 lost, relaunches at ``--mesh.data 2`` (a ``mesh_change``
  record), the loop's resume reshards 4 -> 2 (``reshard_restore``) and
  goes on from step 4 with 4 rows a rank, and the run ends at exit 0.
  Steps 5-8 are within 1e-5 of the uninterrupted data-4 run (the
  stacked transport of 4 data ranks in one process).
- ``--mesh.data 2 --mesh.model 2`` with the same fault resumes at data 1
  x model 2: the model axis is kept.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu_torch.config import MeshConfig, TrainConfig
from tensorflow_distributed_tpu_torch.data.prefetch import to_device
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISOR = "tensorflow_distributed_tpu_torch.resilience.supervisor"
GPT = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
           train_steps=8, eval_every=0, eval_batch_size=8,
           compute_dtype="float32", dropout_rate=0.0, log_every=1)
CHILD = ["--device", "cpu", "--model", "gpt_lm", "--model-size", "tiny",
         "--seq-len", "32", "--batch-size", "8", "--train-steps", "8",
         "--eval-every", "0", "--eval-batch-size", "8", "--compute-dtype",
         "float32", "--dropout-rate", "0", "--log-every", "1",
         "--checkpoint-every", "2", "--resilience.fault-plan",
         "device_loss@5:2"]
STEP = re.compile(r"^\[step +(\d+)\] .* loss=([0-9.e+-]+)")


def _supervise(tmp_path, mesh_args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TFD_DEVICE_MASK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
               TFD_CPU_DEVICE_COUNT="4")
    ck = str(tmp_path / "ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", SUPERVISOR, "--elastic", "--max-restarts",
         "3", "--backoff-base-s", "0.2", "--", *CHILD, *mesh_args,
         "--checkpoint-dir", ck],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-3000:]
    recs = []
    for line in proc.stdout.splitlines():
        line = line.removeprefix("[supervisor] ")
        if line.startswith("{"):
            recs.append(json.loads(line))
    legs = proc.stdout.split("[supervisor] leg 1:")
    assert len(legs) == 2 and "[supervisor] leg 2:" not in proc.stdout
    losses = {int(m[1]): float(m[2]) for m in
              (STEP.match(line) for line in legs[1].splitlines()) if m}
    return proc.stdout, recs, losses, ck


def _kinds(recs, kind):
    return [r for r in recs if r.get("kind") == kind]


def _straight_data4():
    """The uninterrupted data-4 run: 8 steps of the stacked transport of
    4 data ranks (one process), its losses by step."""
    cfg = TrainConfig(**GPT, device="cpu", mesh=MeshConfig(data=4))
    cpu = torch.device("cpu")
    task, state, step = tloop.build_stacked(cfg, cpu)
    stream = task.train_stream(0)
    out = {}
    for i in range(1, 9):
        state, metrics = step(state, to_device(next(stream), cpu))
        out[i] = float(metrics["loss"])
    return out


def _check_resize(out, recs, from_mesh, to_mesh, data_flag):
    lost = [r for r in recs if r.get("fault") == "device_loss"]
    assert lost and all(r["lost"] == 2 and r["step"] == 5 for r in lost)
    change = _kinds(recs, "mesh_change")
    assert len(change) == 1
    assert ({k: v for k, v in change[0]["from_mesh"].items() if v != 1}
            == from_mesh)
    assert ({k: v for k, v in change[0]["to_mesh"].items() if v != 1}
            == to_mesh)
    assert data_flag in out.split("[supervisor] leg 1:")[1].splitlines()[0]
    reshard = _kinds(recs, "reshard_restore")
    assert reshard and all(r["step"] == 4 and r["resharded"]
                           for r in reshard)
    resumed = [r for r in recs if r.get("event") == "resumed"]
    assert [r["step"] for r in resumed] == [4]
    return resumed[0]


def test_device_loss_shrinks_data_4_to_2_and_continues(tmp_path):
    out, recs, losses, _ = _supervise(tmp_path, ["--mesh.data", "4"])
    resumed = _check_resize(out, recs, {"data": 4}, {"data": 2},
                            "--mesh.data 2")
    assert resumed["per_device_batch"] == 4
    assert resumed["from_mesh"]["data"] == 4 and resumed["to_mesh"]["data"] == 2
    assert sorted(losses) == [5, 6, 7, 8]
    want = _straight_data4()
    np.testing.assert_allclose([losses[i] for i in range(5, 9)],
                               [want[i] for i in range(5, 9)], rtol=1e-5)
    assert [r["steps"] for r in recs if r.get("event") == "done"] == [8]


def test_device_loss_keeps_the_model_axis(tmp_path):
    out, recs, losses, _ = _supervise(
        tmp_path, ["--mesh.data", "2", "--mesh.model", "2"])
    resumed = _check_resize(out, recs, {"data": 2, "model": 2}, {"model": 2},
                            "--mesh.data 1")
    assert resumed["per_device_batch"] == 8
    assert resumed["to_mesh"] == {"data": 1, "seq": 1, "model": 2}
    assert sorted(losses) == [5, 6, 7, 8]
    # One process's run of the whole model: the same global batches.
    res = tloop.train(TrainConfig(**GPT, device="cpu"),
                      logger=MetricLogger(enabled=False))
    want = [r.metrics["loss"] for r in res.logger.records]
    np.testing.assert_allclose([losses[i] for i in range(5, 9)], want[4:8],
                               rtol=1e-5)

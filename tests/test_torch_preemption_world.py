"""PyTorch port: the coordinated preemption stop under more than one
process (``train/preemption.py``), over two gloo ranks on the CPU.

- A SIGTERM to rank 1 alone (its ``sigterm@4``) stops both ranks at the
  same step (the step at which rank 1 took the notice, plus one, as
  JAX's sync point: the step at which every rank reads the host
  agreement that carried it), with one save, a ``preempted`` record
  from each rank, and both processes exit 0. A ``--resume`` run on the
  same two ranks ends within 1e-5 of the straight run (its losses and
  its final eval).
- A rank whose peer died leaves without saving (exit 143, a
  ``preempt_abandoned`` record naming the step whose agreement failed)
  instead of waiting on the peer.
"""

import contextlib
import io
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from torch_ring_workers import spawn_ranks
from torch_threads import _one_thread  # noqa: F401

GPT = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
           train_steps=10, eval_every=0, log_every=1, eval_batch_size=8,
           compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
           seed=0, checkpoint_every=100)
NOTICE_STEP = 4  # rank 1's sigterm@4: the notice taken at step 4


def preempt_runs(rank, world, runs, out_dir):
    """Each (name, fields, rank 1's fault plan) of ``runs`` in turn on
    this rank: its losses, final eval, last step, standard output and the
    steps saved after it."""
    from tensorflow_distributed_tpu_torch.config import (
        MeshConfig, ResilienceConfig, TrainConfig)
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    out = {}
    for name, fields, plan in runs:
        cfg = TrainConfig(**fields, device="cpu", mesh=MeshConfig(data=world),
                          resilience=ResilienceConfig(
                              fault_plan=plan if rank == 1 else ""))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = train(cfg, logger=MetricLogger(stream=buf))
        out[name] = {"losses": [r.metrics["loss"] for r in res.logger.records
                                if "loss" in r.metrics],
                     "final": res.final_metrics, "step": res.state.step,
                     "out": buf.getvalue(),
                     "saved": ckpt.available_steps(fields["checkpoint_dir"])}
    torch.save(out, os.path.join(str(out_dir), f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("preempt")
    a, b = str(tmp / "a"), str(tmp / "b")
    runs = [("preempted", dict(GPT, checkpoint_dir=a), f"sigterm@{NOTICE_STEP}"),
            ("resumed", dict(GPT, checkpoint_dir=a, resume=True), ""),
            ("straight", dict(GPT, checkpoint_dir=b), "")]
    spawn_ranks(preempt_runs, 2, tmp, runs, tmp)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


def _events(out, name):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith(f'{{"event": "{name}"')]


def test_both_ranks_stop_at_one_step_with_one_save(two_ranks):
    stop = NOTICE_STEP + 1
    for rank, got in enumerate(two_ranks):
        run = got["preempted"]
        assert run["step"] == stop
        assert _events(run["out"], "preempted") == [
            {"event": "preempted", "step": stop, "rank": rank}]
        assert run["saved"] == [stop]
        assert run["final"] == {}  # no final eval after a notice
    assert [e["fault"] for e in _events(two_ranks[1]["preempted"]["out"],
                                        "recovery")] == ["sigterm"]
    assert not _events(two_ranks[0]["preempted"]["out"], "recovery")


def test_resume_ends_at_the_straight_run(two_ranks):
    stop = NOTICE_STEP + 1
    # The chief prints the lifecycle records.
    assert [e["step"] for e in _events(two_ranks[0]["resumed"]["out"],
                                       "resumed")] == [stop]
    for got in two_ranks:
        assert got["resumed"]["step"] == got["straight"]["step"] == 10
        np.testing.assert_allclose(got["preempted"]["losses"],
                                   got["straight"]["losses"][:stop],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["resumed"]["losses"],
                                   got["straight"]["losses"][stop:],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["resumed"]["final"]["loss"],
                                   got["straight"]["final"]["loss"],
                                   rtol=1e-5)


def abandon_case(rank, world, out_dir):
    """Rank 1 leaves right after the guard is armed; rank 0 then takes a
    notice and asks the guard whether to stop."""
    from tensorflow_distributed_tpu_torch.train import preemption

    preemption.PEER_TIMEOUT_S = 5.0
    guard = preemption.PreemptionGuard()
    if rank == 1:
        return
    time.sleep(1.0)
    os.kill(os.getpid(), signal.SIGTERM)
    with open(os.path.join(str(out_dir), "t0"), "w") as f:
        f.write(str(time.time()))
    guard.should_stop(0)  # posts step 0's agreement
    guard.should_stop(1)  # reads it: leaves the process here
    with open(os.path.join(str(out_dir), "returned"), "w") as f:
        f.write("1")


def test_a_rank_whose_peer_died_leaves_without_saving(tmp_path, capfd):
    with pytest.raises(AssertionError, match=r"rank exit codes \[143, 0\]"):
        spawn_ranks(abandon_case, 2, tmp_path, tmp_path, timeout=60)
    waited = time.time() - float((tmp_path / "t0").read_text())
    assert not (tmp_path / "returned").exists()
    assert waited < 30.0
    out = capfd.readouterr().out
    recs = _events(out, "recovery")
    assert [r["kind"] for r in recs] == ["preempt_abandoned"]
    assert recs[0]["notice"] is True and recs[0]["step"] == 0

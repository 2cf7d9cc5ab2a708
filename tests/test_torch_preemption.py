"""PyTorch port: preemption (SIGTERM -> a save at the next step -> exit 0
-> ``--resume``) and the train CLI's exit codes, against the JAX package.

- ``PreemptionGuard`` installs its SIGTERM handler and restores the one
  before it, stops at the step after a notice, drops an unread notice on
  close, and installs nothing when disabled (in one process or more).
- A planned ``sigterm@4`` in ``train()`` stops both packages at step 4
  with a ``preempted`` record, the one save at step 4 and no final eval;
  ``--resume`` goes on from it, and both legs' losses agree with JAX's
  to 1e-4.
- A CLI process sent SIGTERM while it trains exits 0 with the record and
  the save, and a ``--resume`` process continues from that step.
- The CLI exits 2 on a diverged run and 3 on a stalled fetch, as the JAX
  CLI does, with its ``[resilience]`` lines.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from tensorflow_distributed_tpu import cli as jcli
from tensorflow_distributed_tpu import config as jconfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import config as tconfig
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.train import checkpoint as tckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.train import preemption
from tensorflow_distributed_tpu_torch.train.preemption import PreemptionGuard
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN = dict(dataset="synthetic", batch_size=64, eval_every=0, log_every=1,
           eval_batch_size=64, compute_dtype="float32", dropout_rate=0.0,
           checkpoint_every=100000)
CLI_CNN = ["--dataset", "synthetic", "--batch-size", "64", "--eval-every",
           "0", "--eval-batch-size", "64", "--compute-dtype", "float32",
           "--log-every", "1"]


def test_guard_flag_and_handler_restore():
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    assert signal.getsignal(signal.SIGTERM) != prev
    assert not guard.should_stop(0)
    os.kill(os.getpid(), signal.SIGTERM)
    # Delivery is synchronous for self-signals on the main thread.
    assert guard.should_stop(1)
    assert guard.fired == 1
    guard.close()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_guard_close_drops_an_unread_notice():
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    try:
        os.kill(os.getpid(), signal.SIGTERM)  # a notice, never read
        guard.close()
        assert signal.getsignal(signal.SIGTERM) == prev
        assert not guard.should_stop(0) and guard.fired is None
        guard.close()  # idempotent
    finally:
        signal.signal(signal.SIGTERM, prev)


@pytest.mark.parametrize("why", ["disabled", "world_of_two"])
def test_guard_installs_nothing_when_it_must_not_stop(why, monkeypatch):
    """Without a checkpoint directory the guard installs nothing and never
    stops, in one process or under more than one (where it makes no
    group either). The coordinated stop of an enabled guard over two
    ranks: tests/test_torch_preemption_world.py."""
    monkeypatch.setattr(preemption, "_world", lambda: 2 if why != "disabled"
                        else 1)
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(enabled=False)
    assert guard._group is None
    assert signal.getsignal(signal.SIGTERM) == prev
    guard._flag.set()
    assert not guard.should_stop(0)
    guard.close()


def _jax_init(fields):
    jcfg = jconfig.TrainConfig(**fields)
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    return interop.params_from_flax(jax.device_get(jstate.params))


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_leg(fields, _capsys):
    """JAX's leg; its lifecycle records, read from its metrics file, as
    the lines the port prints."""
    jsonl = os.path.join(fields["checkpoint_dir"] + ".jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    logger = JaxLogger(enabled=False)
    cfg = jconfig.TrainConfig(
        **fields, mesh=jconfig.MeshConfig(data=8),
        observe=jconfig.ObserveConfig(metrics_jsonl=jsonl),
        resilience=jconfig.ResilienceConfig(fault_plan="sigterm@4"))
    r = jloop.train(cfg, logger=logger)
    with open(jsonl) as f:
        out = "".join(json.dumps({"event": rec.pop("event"), **rec}) + "\n"
                      for rec in map(json.loads, f))
    return _losses(logger), r.final_metrics, out


def _port_leg(fields, init, capsys):
    logger = MetricLogger()
    cfg = tconfig.TrainConfig(
        **fields, device="cpu",
        resilience=tconfig.ResilienceConfig(fault_plan="sigterm@4"))
    r = tloop.train(cfg, logger=logger, init_params=init)
    return _losses(logger), r.final_metrics, capsys.readouterr().out


def _events(out, name):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith(f'{{"event": "{name}"')]


def test_planned_sigterm_saves_and_resumes_as_jax(tmp_path, capsys):
    fields = dict(CNN, train_steps=8)
    init = _jax_init(fields)
    prev = signal.getsignal(signal.SIGTERM)
    legs = {}
    for who, leg in (("jax", _jax_leg), ("port", _port_leg)):
        d = str(tmp_path / who)
        args = ((dict(fields, checkpoint_dir=d), capsys) if who == "jax"
                else (dict(fields, checkpoint_dir=d), init, capsys))
        first = leg(*args)
        steps_after_first = tckpt.available_steps(d)
        args[0]["resume"] = True
        second = leg(*args)
        legs[who] = (first, steps_after_first, second,
                     tckpt.available_steps(d))
    port, ref = legs["port"], legs["jax"]
    for leg in (port, ref):
        first, saved, second, final = leg
        assert [e["step"] for e in _events(first[2], "preempted")] == [4]
        assert first[1] == {} and saved == [4] and final == [4, 8]
        assert [e["step"] for e in _events(second[2], "resumed")] == [4]
        assert len(first[0]) == len(second[0]) == 4
    np.testing.assert_allclose(port[0][0] + port[2][0],
                               ref[0][0] + ref[2][0], atol=1e-4)
    # SIGTERM's disposition is restored after each leg.
    assert signal.getsignal(signal.SIGTERM) == prev


def _env():
    return dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1",
                CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """tests/test_preemption.py's story at the process level: SIGTERM in
    the middle of a run -> a ``preempted`` record, the save, exit 0; a
    ``--resume`` process continues from that save."""
    ckpt_dir = str(tmp_path / "ckpt")
    args = [sys.executable, "-m", "tensorflow_distributed_tpu_torch.cli",
            "--device", "cpu", *CLI_CNN, "--train-steps", "2000",
            "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "100000"]
    proc = subprocess.Popen(args, cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # The guard is armed after the first step (its record comes before):
    # wait for the second step's record, then send the notice.
    lines, deadline = [], time.time() + 120
    try:
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("[step      2]"):
                break
        assert lines and lines[-1].startswith("[step "), "".join(lines)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = "".join(lines) + out
    assert proc.returncode == 0, log[-2000:]
    assert '"event": "preempted"' in log
    saved = tckpt.latest_step(ckpt_dir)
    assert saved is not None and 0 < saved < 2000
    assert [e["step"] for e in _events(log, "preempted")] == [saved]
    args2 = list(args)
    args2[args2.index("--train-steps") + 1] = str(saved + 3)
    out2 = subprocess.run(args2 + ["--resume", "true"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert f'"resumed", "step": {saved}' in out2.stdout
    assert tckpt.latest_step(ckpt_dir) == saved + 3


EXITS = {
    "diverged": (["--train-steps", "6", "--resilience.fault-plan",
                  "nan_grad@3", "--resilience.nonfinite", "halt"], 2,
                 "[resilience] diverged: non-finite loss nan at step 3"),
    "halt_on_nonfinite": (["--train-steps", "6", "--resilience.fault-plan",
                           "nan_grad@3", "--halt-on-nonfinite", "true"], 2,
                          "[resilience] diverged: non-finite loss nan at "
                          "step 3 (halt_on_nonfinite=true)"),
    "stalled": (["--train-steps", "6", "--resilience.fault-plan",
                 "data_stall@3:20s", "--resilience.data-timeout-s", "0.5"],
                3, "[resilience] stalled: next-batch fetch for step 3 "
                   "exceeded the 0.5s watchdog deadline"),
}


@pytest.mark.parametrize("case", sorted(EXITS))
def test_cli_exit_codes_equal_jax(case, capsys):
    """The port's CLI in a process of its own (a stalled one exits while
    its fetch still sleeps) and the JAX CLI in this one: the same exit
    code and the same ``[resilience]`` line."""
    flags, code, line = EXITS[case]
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "tensorflow_distributed_tpu_torch.cli",
         "--device", "cpu", *CLI_CNN, *flags], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == code, out.stderr[-2000:]
    assert line in out.stderr
    if case == "stalled":
        assert time.time() - t0 < 20  # the 20 s stall was not waited out
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = jcli.main([*CLI_CNN, "--mesh.data", "8", *flags])
    assert rc == code
    assert line in err.getvalue()

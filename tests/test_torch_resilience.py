"""PyTorch port: training under faults, against the JAX package.

- The fault plan's train points (``wrap_stream``/``poison_batch``,
  ``maybe_stall``, ``arm_checkpoint_faults``, ``maybe_signal``) fire as
  JAX's, once each, with the same records; an integer batch cannot be
  poisoned, with JAX's message.
- ``NonFinitePolicy``, ``LossSpikeDetector`` and ``Watchdog.fetch`` /
  ``sync`` decide, record and raise as JAX's.
- Checkpoint writes retry armed failures (attempts [1, 2]) and raise the
  injected ``OSError`` past the budget.
- Whole runs of the JAX suite's CNN config (synthetic digits, batch 64,
  f32, 10 steps; dropout 0, the port started from the JAX init) under a
  fault plan and a policy: the recovery records, the checkpoint steps and
  the quarantined names equal JAX's exactly, the losses agree to 1e-4
  (the skipped and rewound steps' successors included), and the
  exceptions match in type and message.
- The tiny GPT under ``ckpt_io_fail`` with the fused CE's plain path,
  under ``data_stall``, and under ``nan_grad`` (its float loss mask takes
  the poison), likewise.
- Without a policy, a detector or a watchdog, the loop reads nothing of a
  step beyond its log fetch.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from tensorflow_distributed_tpu import config as jconfig
from tensorflow_distributed_tpu.observe import registry as jreg
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.resilience import faults as jfaults
from tensorflow_distributed_tpu.resilience import policies as jpolicies
from tensorflow_distributed_tpu.resilience import watchdog as jwatchdog
from tensorflow_distributed_tpu.train import checkpoint as jckpt
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import config as tconfig
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.resilience import faults as tfaults
from tensorflow_distributed_tpu_torch.resilience import policies as tpolicies
from tensorflow_distributed_tpu_torch.resilience import watchdog as twatchdog
from tensorflow_distributed_tpu_torch.train import checkpoint as tckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401

# tests/test_resilience.py's _cfg, logging every step, dropout off (the two
# frameworks draw different masks).
CNN = dict(dataset="synthetic", batch_size=64, train_steps=10, eval_every=0,
           log_every=1, eval_batch_size=64, compute_dtype="float32",
           dropout_rate=0.0)
TINY_LM = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
               train_steps=4, eval_every=0, log_every=1, eval_batch_size=8,
               compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3)
# The fields of a recovery record both packages must agree on.
KEYS = ("kind", "step", "action", "used", "budget", "attempt", "from_step",
        "to_step", "fault", "reason", "what")


def _records(out: str):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith('{"event": "recovery"')]


def _view(records):
    return [tuple(r.get(k) for k in KEYS) for r in records]


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)


def _ckpt_view(path):
    if not path or not os.path.isdir(path):
        return None
    return (tckpt.available_steps(path),
            sorted(n for n in os.listdir(path)
                   if n.startswith("quarantined_")))


def _jax_init(fields):
    jcfg = jconfig.TrainConfig(**fields)
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    return interop.params_from_flax(jax.device_get(jstate.params))


def _run_jax(fields, res, tmp_path, tag):
    """JAX's train() on its 8-device mesh: (outcome, records, losses,
    checkpoint view)."""
    jsonl = str(tmp_path / f"jax_{tag}.jsonl")
    logger = JaxLogger(enabled=False)
    cfg = jconfig.TrainConfig(
        **fields, mesh=jconfig.MeshConfig(data=8),
        observe=jconfig.ObserveConfig(metrics_jsonl=jsonl),
        resilience=jconfig.ResilienceConfig(**res))
    got = _outcome(lambda: jloop.train(cfg, logger=logger))
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    recs = [r for r in recs if r["event"] == "recovery"]
    return (got[0], None if got[0] == "ok" else got[1], _view(recs),
            _losses(logger), _ckpt_view(fields.get("checkpoint_dir")))


def _run_port(fields, res, init, capsys):
    capsys.readouterr()
    logger = MetricLogger(enabled=False)
    cfg = tconfig.TrainConfig(**fields, device="cpu",
                              resilience=tconfig.ResilienceConfig(**res))
    got = _outcome(lambda: tloop.train(cfg, logger=logger,
                                       init_params=init))
    recs = _records(capsys.readouterr().out)
    return (got[0], None if got[0] == "ok" else got[1], _view(recs),
            _losses(logger), _ckpt_view(fields.get("checkpoint_dir")))


def _assert_same(port, ref):
    assert port[0] == ref[0], (port[:2], ref[:2])
    if ref[1] is not None:
        # The message up to the run-specific tail (a checkpoint path).
        assert port[1][:60] == ref[1][:60], (port[1], ref[1])
    assert port[2] == ref[2]
    assert port[4] == ref[4]
    assert len(port[3]) == len(ref[3])
    np.testing.assert_allclose(port[3], ref[3], atol=1e-4)


# --- the fault plan's train points -----------------------------------------

def _drive_train_points(mod, ckpt_mod, spec, start, monkeypatch):
    slept, killed = [], []
    monkeypatch.setattr(time, "sleep", slept.append)
    monkeypatch.setattr(os, "kill", lambda pid, sig: killed.append(sig))
    plan = mod.parse_fault_plan(spec)
    if start is not None:
        plan.bind(start)
    rng = np.random.default_rng(0)
    stream = [(rng.random((2, 3)).astype(np.float32),
               np.arange(2, dtype=np.int32)) for _ in range(6)]
    got = [(int(np.isnan(x).all()), y.tolist())
           for x, y in plan.wrap_stream(iter(stream), 1)]
    armed = []
    for _ in range(2):
        for step in range(1, 9):
            plan.maybe_stall(step)
            plan.maybe_signal(step)
            plan.arm_checkpoint_faults(step)
            armed.append(ckpt_mod._injected_io_failures)
            ckpt_mod.arm_io_fault(0)
    return got, slept, killed, armed


@pytest.mark.parametrize("start", [None, 3])
def test_train_points_fire_once_as_jax(start, monkeypatch, capsys):
    spec = "nan_grad@4,nan_grad@6,data_stall@3:0.25s,data_stall@5,"
    spec += "ckpt_io_fail@2:2,ckpt_io_fail@6,sigterm@7,sigkill@8"
    got = _drive_train_points(tfaults, tckpt, spec, start, monkeypatch)
    port = _records(capsys.readouterr().out)
    r = jreg.MetricsRegistry()
    jreg.set_active(r)
    try:
        want = _drive_train_points(jfaults, jckpt, spec, start, monkeypatch)
    finally:
        jreg.set_active(None)
    assert got == want
    ref = [x for x in r.records if x["event"] == "recovery"]
    assert _view(port) == _view(ref)
    assert [x.get("seconds") for x in port] == [x.get("seconds")
                                                for x in ref]
    if start is None:
        assert [s for s, *_ in got[0]] == [0, 0, 1, 0, 1, 0]
        assert got[1] == [0.25, 5.0] and len(got[2]) == 2
        assert got[3][1] == 2 and got[3][5] == 1 and sum(got[3]) == 3


def test_poisoning_an_integer_batch_raises_as_jax():
    batch = {"tokens": np.zeros((2, 4), np.int32),
             "targets": np.zeros((2, 4), np.int32)}
    msgs = []
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError) as e:
            mod.parse_fault_plan("nan_grad@3").poison_batch(3, batch)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no float leaves" in msgs[0]
    assert tfaults.parse_fault_plan("").wrap_stream(iter([batch]), 0) is not (
        None)


# --- the policies ------------------------------------------------------------

def _drive_policy(mod, mode):
    p = mod.NonFinitePolicy(mode, max_skips=2, max_rewinds=2)
    out = [p.on_nonfinite(3, float("nan")), p.on_spike(4, 50.0, 1.0),
           p.on_nonfinite(5, float("inf")), p.on_spike(6, 60.0, 1.5),
           p.on_nonfinite(7, float("nan")), p.on_nonfinite(8, float("nan"))]
    return out, p.halt_message(8, float("nan"), 4)


@pytest.mark.parametrize("mode", ["halt", "skip_batch", "rewind"])
def test_nonfinite_policy_equals_jax(mode, capsys):
    got = _drive_policy(tpolicies, mode)
    port = _records(capsys.readouterr().out)
    r = jreg.MetricsRegistry()
    jreg.set_active(r)
    try:
        want = _drive_policy(jpolicies, mode)
    finally:
        jreg.set_active(None)
    assert got == want
    ref = [x for x in r.records if x["event"] == "recovery"]
    assert _view(port) == _view(ref)
    for a, b in zip(port, ref):
        assert (a.get("loss"), a.get("window_median"), a.get("trigger")) == (
            b.get("loss"), b.get("window_median"), b.get("trigger"))
    assert issubclass(tpolicies.RecoveryBudgetExceeded, FloatingPointError)
    with pytest.raises(ValueError):
        tpolicies.NonFinitePolicy("skip")


def test_loss_spike_detector_equals_jax():
    rng = np.random.default_rng(1)
    series = list(1.0 + 0.1 * rng.standard_normal(40))
    series[12] = series[30] = 50.0
    series[20] = 9.0
    port = tpolicies.LossSpikeDetector(window=4, factor=8.0)
    ref = jpolicies.LossSpikeDetector(window=4, factor=8.0)
    got, want = [], []
    for i, v in enumerate(series):
        if i == 25:
            port.reset()
            ref.reset()
        got.append(port.observe(v))
        want.append(ref.observe(v))
    assert got == want
    assert [i for i, g in enumerate(got) if g is not None] == [12, 20, 30]


# --- the watchdog -------------------------------------------------------------

def test_watchdog_fetch_and_sync_pass_through_and_time_out(capsys):
    def drive(mod, value):
        wd = mod.Watchdog(data_timeout_s=0.2, sync_timeout_s=0.0)
        try:
            out = [wd.fetch(lambda: 42, step=1), wd.sync(value, step=1)]
            with pytest.raises(mod.StallError) as e:
                wd.fetch(lambda: time.sleep(1.0), step=2)
            with pytest.raises(KeyError):
                wd.fetch(lambda: {}["x"], step=3)  # errors pass through
        finally:
            wd.close()
        return out, str(e.value)

    got = drive(twatchdog, torch.ones(()))
    port = _records(capsys.readouterr().out)
    r = jreg.MetricsRegistry()
    jreg.set_active(r)
    try:
        want = drive(jwatchdog, jax.numpy.ones(()))
    finally:
        jreg.set_active(None)
    assert got[0][0] == want[0][0] == 42
    assert float(got[0][1]) == float(want[0][1]) == 1.0
    assert got[1] == want[1]
    ref = [x for x in r.records if x["event"] == "recovery"]
    assert _view(port) == _view(ref) == [
        ("stall", 2, None, None, None, None, None, None, None, None,
         "next-batch fetch")]
    # A watched sync blocks on the device work and times out like fetch.
    wd = twatchdog.Watchdog(sync_timeout_s=0.2)
    try:
        assert wd.sync("ready", step=4) == "ready"
        wd._watched(lambda: time.sleep(0.01), "device sync", 5, 0.2)
        with pytest.raises(twatchdog.StallError, match="device sync for "
                                                       "step 6"):
            wd._watched(lambda: time.sleep(1.0), "device sync", 6, 0.2)
    finally:
        wd.close()


# --- save retries -------------------------------------------------------------

def _state():
    cfg = tconfig.TrainConfig(**CNN, device="cpu")
    return tloop._build_model_and_state(cfg, torch.device("cpu"))[1]


def test_save_io_failure_retries_and_succeeds(tmp_path, capsys):
    state = _state()
    tckpt.set_io_policy(retries=2, backoff_s=0.01)
    try:
        tckpt.arm_io_fault(2)
        tckpt.save(str(tmp_path), state)
    finally:
        tckpt.set_io_policy()
    assert tckpt.available_steps(str(tmp_path)) == [0]
    retries = [r for r in _records(capsys.readouterr().out)
               if r["kind"] == "ckpt_retry"]
    assert [(r["attempt"], r["budget"]) for r in retries] == [(1, 2), (2, 2)]
    assert [r["backoff_s"] for r in retries] == [0.01, 0.02]
    # The sha256 manifest of the write that landed verifies.
    assert tckpt.restore(str(tmp_path), _state()).step == 0


def test_save_io_failure_exhausts_retries(tmp_path):
    state = _state()
    tckpt.set_io_policy(retries=1, backoff_s=0.01)
    try:
        tckpt.arm_io_fault(5)
        with pytest.raises(OSError, match="injected"):
            tckpt.save(str(tmp_path), state)
    finally:
        tckpt.arm_io_fault(0)
        tckpt.set_io_policy()
    assert tckpt.available_steps(str(tmp_path)) == []


def test_quarantine_from_renames_every_later_step(tmp_path, capsys):
    state = _state()
    for step in (2, 4, 6):
        state.step = step
        tckpt.save(str(tmp_path), state, keep=5)
    capsys.readouterr()
    assert tckpt.quarantine_from(str(tmp_path), 4, "why") == [4, 6]
    assert tckpt.available_steps(str(tmp_path)) == [2]
    recs = _records(capsys.readouterr().out)
    assert [(r["kind"], r["step"], r["reason"], r["mesh"]) for r in recs] == [
        ("quarantine", 4, "why", "single-device"),
        ("quarantine", 6, "why", "single-device")]
    assert sorted(os.listdir(tmp_path)) == [
        "quarantined_step_00000004", "quarantined_step_00000006",
        "step_00000002"]


# --- whole runs against JAX ---------------------------------------------------

RUNS = {
    "skip": (dict(), dict(fault_plan="nan_grad@5", nonfinite="skip_batch",
                          max_skips=2)),
    "skip_budget": (dict(), dict(fault_plan="nan_grad@4,nan_grad@6",
                                 nonfinite="skip_batch", max_skips=1)),
    "halt": (dict(), dict(fault_plan="nan_grad@4", nonfinite="halt")),
    "rewind": (dict(checkpoint_every=2),
               dict(fault_plan="nan_grad@5", nonfinite="rewind",
                    max_rewinds=1)),
    "ckpt_io_fail": (dict(train_steps=6, checkpoint_every=2),
                     dict(fault_plan="ckpt_io_fail@4:2", save_retries=3,
                          save_retry_backoff_s=0.01)),
    "data_stall": (dict(), dict(fault_plan="data_stall@4:1.5s",
                                data_timeout_s=0.3)),
    "halt_on_nonfinite": (dict(halt_on_nonfinite=True),
                          dict(fault_plan="nan_grad@4")),
    # Step 2's loss is 2.5x step 1's: a spike over a window of one.
    "spike_rewind": (dict(checkpoint_every=1),
                     dict(nonfinite="rewind", spike_window=1,
                          spike_factor=1.5, max_rewinds=1)),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_under_faults_equals_jax(name, tmp_path, capsys):
    extra, res = RUNS[name]
    fields = dict(CNN, **extra)
    init = _jax_init(fields)
    if "checkpoint_every" in extra:
        fields["checkpoint_dir"] = str(tmp_path / "jax_ckpt")
    ref = _run_jax(fields, res, tmp_path, name)
    if "checkpoint_every" in extra:
        fields["checkpoint_dir"] = str(tmp_path / "port_ckpt")
    port = _run_port(fields, res, init, capsys)
    _assert_same(port, ref)
    expect = {"skip": "ok", "skip_budget": "RecoveryBudgetExceeded",
              "halt": "RecoveryBudgetExceeded", "rewind": "ok",
              "ckpt_io_fail": "ok", "data_stall": "StallError",
              "halt_on_nonfinite": "FloatingPointError",
              "spike_rewind": "ok"}[name]
    assert port[0] == expect
    if name == "skip":
        # The skipped step's NaN, then the steps after it on the params,
        # moments and count from before it.
        assert np.isnan(port[3][4]) and np.isfinite(port[3][5:]).all()
    if name == "rewind":
        assert ("rewind", None, None, None, None, None, 5, 4) in [
            v[:8] for v in port[2]]
        assert port[4] == ([6, 8, 10], ["quarantined_step_00000006"])
        assert len(port[3]) == 12  # steps 1-6, then 5-10 again
    if name == "spike_rewind":
        assert any(v[0] == "loss_spike" for v in port[2])


def _poison_params(path, step):
    """NaN-fill a step's params with valid bytes (the manifest's sha256
    rewritten), so that only the finiteness check can catch it."""
    import hashlib

    sd = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(sd, "state.msgpack"), "rb") as f:
        raw = flax_serialization.msgpack_restore(f.read())
    raw["params"] = jax.tree_util.tree_map(
        lambda x: np.full_like(x, np.nan), raw["params"])
    blob = flax_serialization.msgpack_serialize(raw)
    with open(os.path.join(sd, "state.msgpack"), "wb") as f:
        f.write(blob)
    with open(os.path.join(sd, "manifest.json")) as f:
        man = json.load(f)
    man["sha256"] = hashlib.sha256(blob).hexdigest()
    with open(os.path.join(sd, "manifest.json"), "w") as f:
        json.dump(man, f)


def test_rewind_walks_back_past_poisoned_params_as_jax(tmp_path, capsys):
    """tests/test_resilience.py's walk-back: six steps saved every two,
    step 6's params NaN with valid bytes, then a resumed run under rewind:
    its first loss is NaN, step 6 fails the finiteness check and is
    quarantined, step 4 is the target, and the run ends at step 10."""
    fields = dict(CNN, train_steps=6, checkpoint_every=2)
    init = _jax_init(fields)
    res = dict(nonfinite="rewind", max_rewinds=1)
    views = {}
    for who in ("jax", "port"):
        d = str(tmp_path / who)
        first = dict(fields, checkpoint_dir=d)
        if who == "jax":
            _run_jax(first, {}, tmp_path, "first")
        else:
            _run_port(first, {}, init, capsys)
        assert tckpt.available_steps(d) == [2, 4, 6]
        _poison_params(d, 6)
        second = dict(first, train_steps=10, resume=True)
        views[who] = (_run_jax(second, res, tmp_path, "second")
                      if who == "jax" else
                      _run_port(second, res, init, capsys))
    _assert_same(views["port"], views["jax"])
    recs = views["port"][2]
    assert ("rewind", None, None, None, None, None, 7, 4) in [
        r[:8] for r in recs]
    reasons = [r[9] for r in recs if r[0] == "quarantine"]
    assert reasons == ["restored params non-finite (damage predates step 6)"]
    assert np.isnan(views["port"][3][0])


# --- the tiny GPT ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["ckpt_io_fail", "data_stall"])
def test_tiny_gpt_under_faults_equals_jax(case, tmp_path, capsys):
    """The LM's wiring: a checkpoint write failing twice inside the cadence
    save, with the fused CE's plain path (``ce_impl=kernel`` on the CPU),
    or a stalled fetch past the data watchdog."""
    fields = dict(TINY_LM)
    if case == "ckpt_io_fail":
        fields.update(ce_chunk=32, ce_impl="kernel", checkpoint_every=2)
        res = dict(fault_plan="ckpt_io_fail@2:2", save_retry_backoff_s=0.01,
                   nonfinite="skip_batch", spike_window=2)
    else:
        res = dict(fault_plan="data_stall@3:1.5s", data_timeout_s=0.3,
                   sync_timeout_s=5.0)
    init = _jax_init(fields)
    if "checkpoint_every" in fields:
        fields["checkpoint_dir"] = str(tmp_path / "jax")
    ref = _run_jax(fields, res, tmp_path, case)
    if "checkpoint_every" in fields:
        fields["checkpoint_dir"] = str(tmp_path / "port")
    port = _run_port(fields, res, init, capsys)
    _assert_same(port, ref)
    assert port[0] == ("ok" if case == "ckpt_io_fail" else "StallError")


def test_tiny_gpt_nan_grad_poisons_the_loss_mask_as_jax(tmp_path, capsys):
    """An LM batch's float array is its loss mask: poisoned, the step's
    loss is NaN in both packages and skip_batch discards its update."""
    fields = dict(TINY_LM)
    res = dict(fault_plan="nan_grad@2", nonfinite="skip_batch")
    init = _jax_init(fields)
    ref = _run_jax(fields, res, tmp_path, "lm_nan")
    port = _run_port(fields, res, init, capsys)
    _assert_same(port, ref)
    assert np.isnan(port[3][1]) and np.isfinite(port[3][2:]).all()


# --- the default path -------------------------------------------------------------

@pytest.mark.parametrize("res,reads", [
    ({}, 0), (dict(fault_plan="ckpt_io_fail@2"), 0),
    (dict(nonfinite="halt"), 4), (dict(sync_timeout_s=5.0), 4)])
def test_only_a_policy_or_watchdog_reads_each_step(res, reads, monkeypatch):
    """The loop copies a step's loss for inspection (``to_host_async``,
    then a wait) only where a policy, a detector or a watchdog reads it:
    a plan alone, or nothing, dispatches as before. The losses are the
    same either way."""
    calls = []
    real = tloop.to_host_async

    def counted(values):
        calls.append(values.shape)
        return real(values)

    monkeypatch.setattr(tloop, "to_host_async", counted)
    fields = dict(CNN, train_steps=5)
    logger = MetricLogger(enabled=False)
    tloop.train(tconfig.TrainConfig(
        **fields, device="cpu", resilience=tconfig.ResilienceConfig(**res)),
        logger=logger)
    assert len(calls) == reads
    base = MetricLogger(enabled=False)
    tloop.train(tconfig.TrainConfig(**fields, device="cpu"), logger=base)
    assert _losses(logger) == _losses(base)

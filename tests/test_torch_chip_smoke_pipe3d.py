"""PyTorch port: ``chip_smoke.py``'s local-SGD, pipe x model and pipe x
seq phases (52-56: model_local_sgd, model_pipe_tp, model_pipe_seq,
train_local_sgd, train_pipe3d), rehearsed on the CPU.

The argvs parse to GPT-2-small (seq 1024, batch 8) over the meshes the
phases name; the phases run after the earlier ones and ``--only`` takes
them; model_local_sgd, model_pipe_tp and model_pipe_seq at a tiny size
on the CPU hold H 1 to the synchronous step, the replicas' parting and
meeting, GPipe to the unstaged model and 1F1B to GPipe, and fail only
on the launch counts (the plain path launches no kernel);
train_local_sgd and train_pipe3d skip by the device count alone, and on
four cards hold their losses, kernel shares and the eval of the save
within the bounds written in the file (each pipe leg's first five losses
to one card's with a rank's tokens a microbatch).
"""

import importlib.util
import inspect
import json
import os

import pytest
from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()
TINY_LSGD = ["--model-size", "tiny", "--seq-len", "16"]


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _cards(n):
    return type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: n)})})


def _failures(monkeypatch):
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    return failed


def test_argvs_are_gpt2_small_over_the_named_meshes():
    from tensorflow_distributed_tpu_torch.config import parse_args

    lsgd = parse_args(cs.MODEL_LSGD_ARGV + ["--param-sync-every", "4"])
    assert (lsgd.model, lsgd.model_size, lsgd.seq_len, lsgd.batch_size,
            lsgd.optimizer, lsgd.dropout_rate, lsgd.ema_decay,
            lsgd.mesh.data, lsgd.compute_dtype) == (
        "gpt_lm", "small", 1024, 8, "sgd", 0.0, 0.0, cs.LSGD_D,
        "bfloat16")
    lsgd.validate()
    run = parse_args(cs.TRAIN_LSGD_ARGV + ["--mesh.data", "4"])
    assert (run.param_sync_every, run.train_steps, run.model_size) == (
        4, 10, "small")
    run.validate()
    for name, flags, ref in cs.TRAIN_PIPE3D_RUNS:
        cfg = parse_args(cs.TRAIN_PIPE_ARGV + flags)
        one = parse_args(cs.TRAIN_PIPE_ARGV + ref)
        cfg.validate()
        assert (max(cfg.mesh.data, 1) * cfg.mesh.pipe * cfg.mesh.model
                * cfg.mesh.seq) == 4
        assert (cfg.model, cfg.model_size, cfg.seq_len, cfg.batch_size,
                cfg.train_steps) == ("pipelined_lm", "small", 1024, 8, 10)
        # The one-card run has a rank's tokens a microbatch.
        assert (cfg.batch_size // max(cfg.mesh.data, 1)
                // cfg.pipeline_microbatches * cfg.seq_len
                // cfg.mesh.seq) == (
            one.batch_size // one.pipeline_microbatches * one.seq_len)
    assert [r[0] for r in cs.TRAIN_PIPE3D_RUNS] == [
        "pipe2_model2", "pipe2_seq2", "data2_pipe2_zero1"]


def test_phases_run_last_in_order_and_alone():
    src = inspect.getsource(cs.main)
    order = ["phase_train_pipe(", "phase_model_local_sgd(",
             "phase_model_pipe_tp(", "phase_model_pipe_seq(",
             "phase_train_local_sgd(", "phase_train_pipe3d(",
             'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)
    assert {"model_local_sgd", "model_pipe_tp", "model_pipe_seq",
            "train_local_sgd", "train_pipe3d"} <= set(cs.ONLY_PHASES)


def test_model_local_sgd_agrees_on_the_cpu_and_counts_launches(
        monkeypatch, capsys):
    import torch

    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "MODEL_LSGD_ARGV",
                        cs.MODEL_LSGD_ARGV + TINY_LSGD)
    failed = _failures(monkeypatch)
    cs.phase_model_local_sgd(fa.KERNELS, torch)
    rows = _rows(capsys)
    assert [r["leg"] for r in rows] == ["h1_vs_sync", "h4"]
    h1, h4 = rows
    assert h1["loss_rel_err"] <= cs.TOL_ZERO_LOSS
    assert h1["params_excess_over_tol"][0] <= cs.TOL_ZERO_PARAMS["atol"]
    spreads = h4["replica_spread_after_step"]
    assert all(s > 0 for s in spreads[:3]) and spreads[3] == 0.0
    assert len(failed) == 2
    assert all("B1-B3 not launched" in msg for msg in failed)


@pytest.mark.parametrize("axis", ["model", "seq"])
def test_model_pipe3d_agrees_on_the_cpu_and_counts_launches(
        axis, monkeypatch, capsys):
    import numpy as np
    import torch

    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "PIPE3D_MODEL", dict(cs.PIPE3D_MODEL,
                                                 size="tiny", L=16))
    failed = _failures(monkeypatch)
    launches = cs.phase_model_pipe3d(fa, torch, np, axis)
    rows = _rows(capsys)
    phase = "model_pipe_tp" if axis == "model" else "model_pipe_seq"
    assert [(r["phase"], r["leg"]) for r in rows] == [
        (phase, leg) for leg in cs.PIPE3D_LEGS]
    gpipe, *scheds = rows
    assert gpipe["loss_rel_err"] <= cs.TOL_PIPE_LOSS
    assert gpipe["logits_rel_err"] <= cs.TOL_PIPE
    assert gpipe["grads_rel_err"] <= cs.TOL_PIPE
    # The gate is the plain gpt_lm over the same microbatches; the same
    # model unstaged is an extra check, the whole batch at once printed.
    unstaged = gpipe["unstaged"]
    assert unstaged["loss_rel_err"] <= cs.TOL_PIPE_LOSS
    assert unstaged["grads_rel_err"] <= cs.TOL_PIPE
    assert "plain_whole_batch" in gpipe
    for r in scheds:
        assert r["loss_rel_err"] <= cs.TOL_PIPE_SCHED_LOSS
        assert r["grads_rel_err"] <= cs.TOL_PIPE_SCHED_GRAD
    assert len(failed) == len(rows)
    assert all("launched" in msg for msg in failed)
    assert set(launches) == {f"{phase}_{leg}" for leg in cs.PIPE3D_LEGS}


@pytest.mark.parametrize("phase,cards", [("train_local_sgd", 1),
                                         ("train_pipe3d", 1),
                                         ("train_pipe3d", 2)])
def test_multi_card_phases_skip_by_the_device_count(phase, cards, capsys):
    getattr(cs, f"phase_{phase}")(_cards(cards))
    rec = json.loads(capsys.readouterr().out)
    assert rec["phase"] == phase and "skipped" in rec


ONE_CARD = [10.9, 10.2, 9.6, 9.1, 8.7, 8.4, 8.1, 7.9, 7.7, 7.5]


def _fake_run(fault, run=None):
    """A torchrun stand-in: every run one card's losses, a fault on the
    named leg's run of 4 processes ("drift" moves its losses from the
    third on off one card's)."""
    def fake(phase, nproc, argv, timeout):
        seq = "--mesh.seq" in argv
        names = (("flash_fwd_partial", "flash_dq_partial",
                  "flash_dkv_partial") if seq
                 else ("flash_fwd", "flash_dq", "flash_dkv"))
        if phase.endswith("eval"):
            loss = 7.0 + (1e-4 if fault == "eval" else 0.0)
            return 1.0, [{"eval": {"loss": loss}}] * nproc, [""] * nproc
        losses = list(ONE_CARD)
        launches = {k: 0 for k in ("flash_fwd", "flash_dq", "flash_dkv",
                                   "flash_fwd_partial", "flash_dq_partial",
                                   "flash_dkv_partial")}
        launches.update((k, 240) for k in names)
        mine = (run is None or run in phase) and nproc == 4
        if mine and fault == "loss":
            losses[0 if run is None else 3] += 2e-2
        if mine and fault == "drift":
            losses[2:] = [x + 1.5e-2 for x in losses[2:]]
        if mine and fault == "launch":
            launches[names[1]] = 0
        return 1.0, [{"losses": losses, "step_ms_median": 90.0,
                      "max_memory_allocated": 1, "final": {"loss": 7.0},
                      "launches": launches}] * nproc, [""] * nproc
    return fake


@pytest.mark.parametrize("fault", [None, "loss", "launch", "eval"])
def test_train_local_sgd_holds_its_bounds_on_four_cards(fault, monkeypatch,
                                                        capsys):
    monkeypatch.setattr(cs, "one_card_losses", lambda argv: (ONE_CARD, 8.0))
    monkeypatch.setattr(cs, "run_torchrun", _fake_run(fault))
    if fault is None:
        cs.phase_train_local_sgd(_cards(4))
    else:
        with pytest.raises(SystemExit):
            cs.phase_train_local_sgd(_cards(4))
    out, err = capsys.readouterr()
    rec = json.loads(out.splitlines()[0])
    assert rec["processes"] == 4 and "--param-sync-every" in rec["argv"]
    assert (fault is None) == ("train_local_sgd" not in err)


@pytest.mark.parametrize("run,fault", [
    (None, None), ("pipe2_seq2", "drift"), ("pipe2_seq2", "loss"),
    ("data2_pipe2_zero1", "launch"), ("pipe2_model2", "loss")])
def test_train_pipe3d_holds_its_bounds_on_four_cards(run, fault,
                                                     monkeypatch, capsys):
    monkeypatch.setattr(cs, "one_card_losses", lambda argv: (ONE_CARD, 8.0))
    monkeypatch.setattr(cs, "run_torchrun", _fake_run(fault, run))
    if fault is None:
        cs.phase_train_pipe3d(_cards(4))
    else:
        with pytest.raises(SystemExit):
            cs.phase_train_pipe3d(_cards(4))
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert (fault is None) == ("train_pipe3d" not in err)
    # Every leg runs before the checks.
    assert [r["run"] for r in rows] == [
        "pipe2_model2", "pipe2_seq2", "data2_pipe2_zero1"]
    assert [r["one_card_flags"] for r in rows] == [
        [], ["--pipeline-microbatches", "8"],
        ["--pipeline-microbatches", "8"]]

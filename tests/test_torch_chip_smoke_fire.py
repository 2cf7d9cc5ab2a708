"""PyTorch port: ``chip_smoke.py``'s train_fire phase (training under
faults), rehearsed on the CPU (split from ``test_torch_chip_smoke.py``):
its argvs are the full-width fused runs, and its legs pass on the CPU
and fail on a changed trajectory, a missing watchdog or a missing
kernel launch.
"""

import json

import pytest

from test_torch_chip_smoke import cs, cs_kernels


def test_train_fire_argvs_are_the_full_width_fused_runs():
    """(a)-(c) run GPT-2-small at seq 1024, batch 8, bf16, on the fused-CE
    kernels, 8 steps logging every loss; (c) stalls step 5's fetch past a
    shorter data watchdog; (d) is the CNN on the MNIST fixture under
    nan_grad@5."""
    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.resilience.faults import (
        parse_fault_plan)

    cfg = parse_args(cs.TRAIN_FIRE_ARGV + cs.TRAIN_FIRE_WATCH)
    assert (cfg.model_size, cfg.seq_len, cfg.batch_size, cfg.compute_dtype,
            cfg.ce_chunk, cfg.ce_impl, cfg.train_steps, cfg.log_every) == (
        "small", 1024, 8, "bfloat16", 8192, "kernel", 8, 1)
    assert cs.TRAIN_FIRE_STEPS == 8 and cs.TRAIN_FIRE_SIGTERM == 5
    res = cfg.resilience
    assert (res.nonfinite, res.spike_window, res.data_timeout_s,
            res.sync_timeout_s) == ("skip_batch", 4, 30.0, 30.0)
    stall = parse_args(cs.TRAIN_FIRE_STALL_ARGV)
    ev = parse_fault_plan(stall.resilience.fault_plan)._by_step
    assert list(ev) == [("data_stall", 5)]
    assert ev["data_stall", 5].arg == cs.TRAIN_FIRE_STALL_S > (
        stall.resilience.data_timeout_s)
    cnn = parse_args(cs.TRAIN_FIRE_CNN_ARGV)
    assert (cnn.model, cnn.dataset, cnn.data_dir, cnn.resilience.fault_plan
            ) == ("mnist_cnn", "mnist", cs.FIXTURE_DIR, "nan_grad@5")
    assert parse_fault_plan(cs.TRAIN_FIRE_SAVE_PLAN)._by_step[
        "ckpt_io_fail", 4].arg == 2


TINY_TRAIN = ["--mode", "train", "--model", "gpt_lm", "--model-size", "tiny",
              "--seq-len", "64", "--batch-size", "8", "--train-steps",
              str(cs.TRAIN_FIRE_STEPS),
              "--eval-every", "0", "--eval-batch-size", "8",
              "--compute-dtype", "float32", "--log-every", "1",
              "--ce-chunk", "32", "--ce-impl", "kernel", "--device", "cpu"]


@pytest.fixture
def train_fire_smoke(monkeypatch):
    """train_fire's legs on the CPU: the tiny GPT through the fused CE's
    plain path, CLI processes of it, and the CNN on the fixture; the
    launch check (a card's) is left out."""
    import torch

    monkeypatch.setattr(cs, "TRAIN_FIRE_ARGV", TINY_TRAIN)
    monkeypatch.setattr(cs, "TRAIN_FIRE_STALL_ARGV", TINY_TRAIN + [
        "--resilience.data-timeout-s", "1", "--resilience.fault-plan",
        "data_stall@5:3.0s"])
    monkeypatch.setattr(cs, "TRAIN_FIRE_CNN_ARGV",
                        cs.TRAIN_FIRE_CNN_ARGV + ["--device", "cpu"])
    monkeypatch.setattr(cs, "fire_launch_check", lambda rec, what: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield torch
    torch.set_num_threads(threads)


def _legs(out):
    return {l["leg"]: l for l in map(json.loads, (
        x for x in out.splitlines() if x.startswith('{"phase"')))}


def test_train_fire_legs_a_b_pass_on_the_cpu(train_fire_smoke, capsys):
    plain = cs.train_fire_leg_a([], train_fire_smoke)
    cs.train_fire_leg_b(plain)
    legs = _legs(capsys.readouterr().out)
    a = legs["a: resilience on the fused path"]
    assert a["watched_max_rel_diff"] == a["fire_max_rel_diff"] == 0.0
    assert set(a["step_ms_cost"]) == {"watched"}
    assert a["retries"] == [[4, 1], [4, 2]] and a["landed"] == [4, 6, 8]
    b = legs["b: sigterm + resume"]
    assert b["exits"] == [0, 0] and b["stopped_at"] == 5
    assert b["saved"] == [5] and b["final"] == [5, 8]
    assert b["resumed_steps"] == list(range(6, 9))
    assert b["max_rel_diff"] <= 1e-5


def test_train_fire_leg_a_fails_on_a_changed_trajectory(
        train_fire_smoke, monkeypatch, capsys):
    """A run whose losses leave the plain run's (here: another learning
    rate under the watch flags) fails the leg."""
    monkeypatch.setattr(cs, "TRAIN_FIRE_WATCH", cs.TRAIN_FIRE_WATCH + [
        "--learning-rate", "2e-3"])
    with pytest.raises(SystemExit):
        cs.train_fire_leg_a([], train_fire_smoke)
    assert "train_fire (a: watched): losses" in capsys.readouterr().err


def test_train_fire_checks_the_kernels_launched(capsys):
    """On the CPU the fused CE and flash attention take their plain
    versions: the launch check fails, as on a card where B1-B6 did not
    run."""
    rec = {"steps": 12, "launches": {k.name: 0 for k in cs_kernels()}}
    with pytest.raises(SystemExit):
        cs.fire_launch_check(rec, "plain")
    assert "not B1-B6 at every step" in capsys.readouterr().err
    rec["launches"].update(flash_fwd=150, flash_dq=144, flash_dkv=144,
                           fused_ce_fwd=12, fused_ce_dx=12, fused_ce_dw=12)
    cs.fire_launch_check(rec, "plain")


def test_train_fire_leg_c_exits_3_and_fails_without_the_watchdog(
        train_fire_smoke, monkeypatch, capsys):
    cs.train_fire_leg_c()
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["exit"] == 3 and line["stall_to_exit_s"] < 3.0
    assert line["stall"]["what"] == "next-batch fetch"
    monkeypatch.setattr(cs, "TRAIN_FIRE_STALL_ARGV", TINY_TRAIN + [
        "--resilience.fault-plan", "data_stall@5:0.2s"])
    with pytest.raises(SystemExit):
        cs.train_fire_leg_c()
    assert "train_fire (c): exit 0" in capsys.readouterr().err


def test_train_fire_leg_d_skips_halts_and_rewinds(train_fire_smoke, capsys):
    cs.train_fire_leg_d(train_fire_smoke)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["halt_exit"] == 2
    assert ["rewind", None, None, 5, 4] in line["rewind"]["records"]
    assert "quarantined_step_00000006" in line["rewind"]["dir"]

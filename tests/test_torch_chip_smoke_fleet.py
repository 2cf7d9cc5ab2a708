"""PyTorch port: ``chip_smoke.py``'s ``serve_fleet`` phase (62),
rehearsed on the CPU.

The argvs parse (a replica's, with the controller's wiring appended);
``--only`` takes the phase and the full run calls it after serve_fire,
inside the checkpoint phase's block; the workload's shape (16 requests,
16-64 prompt tokens, 32 new, 0.1 s apart, high:standard 1:3); a newer
step published with the same bytes restores as that step; the gates'
arithmetic on a record; and the phase's own code at a tiny size on the
CPU: two real replica processes, the kill, the restart, the roll and the
stream check, where every gate holds (nothing of it needs the card: the
replicas' peak memory is a card's reading and stays null here). Then the
cuts that pay for the phase: ``beside`` returns a thread's result or its
failure, and serve_fire's (d) and train_fire's (b) CLI processes run
beside their phases' untimed in-process legs, joined before their
checks.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()


def test_fleet_argvs_parse():
    from tensorflow_distributed_tpu_torch.config import parse_args

    cfg = parse_args(cs.FLEET_ARGV + ["--checkpoint-dir", "ck"])
    assert (cfg.model_size, cfg.seq_len, cfg.compute_dtype) == (
        "small", 1024, "float32")
    assert cfg.serve.num_slots == 4 and cfg.device == "cuda"
    # The controller's wiring on top: a fleet replica.
    cfg = parse_args(cs.FLEET_ARGV + [
        "--checkpoint-dir", "ck", "--serve.inbox", "i.jsonl",
        "--serve.journal", "j.jsonl", "--observe.export-path", "s.json",
        "--observe.export-every", "0.2", "--observe.metrics-jsonl",
        "m.jsonl"])
    assert cfg.serve.inbox == "i.jsonl" and cfg.observe.export_every == 0.2
    # Continuations re-prefill up to prompt + new tokens: the ladder
    # covers them.
    assert max(cs.FLEET_PROMPTS) + cs.FLEET_NEW <= 128


def test_fleet_phase_is_taken_alone_and_runs_after_serve_fire():
    import inspect

    assert "serve_fleet" in cs.ONLY_PHASES
    src = inspect.getsource(cs.main)
    order = ["phase_serve_fire(", "phase_serve_fleet(torch, np, ckpt_dir)",
             "phase_train_fire("]
    at = [src.index(call) for call in order]
    assert at == sorted(at)
    assert "serve_fleet" in inspect.getsource(cs.run_alone)


def test_fleet_workload_shape(tmp_path):
    rows = cs.fleet_workload(np, str(tmp_path / "wl.jsonl"))
    assert len(rows) == 16
    assert all(16 <= len(r["prompt"]) <= 64 for r in rows)
    assert all(r["max_new_tokens"] == 32 for r in rows)
    assert [r["arrival_s"] for r in rows] == [round(0.1 * i, 3)
                                              for i in range(16)]
    assert [r["slo"] for r in rows].count("high") == 4
    from tensorflow_distributed_tpu_torch.fleet.run import load_workload

    wl = load_workload(str(tmp_path / "wl.jsonl"))
    assert [w["prompt"] for w in wl] == [r["prompt"] for r in rows]


def test_published_step_restores_as_that_step(tmp_path):
    from tensorflow_distributed_tpu_torch.config import TrainConfig
    from tensorflow_distributed_tpu_torch.fleet.controller import (
        latest_ckpt_step)
    from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state)

    cfg = TrainConfig(model="gpt_lm", model_size="tiny", seq_len=32,
                      compute_dtype="float32", device="cpu")
    model, state = _build_model_and_state(cfg, torch.device("cpu"))
    state.step = 6
    d = str(tmp_path / "ck")
    ckpt.save(d, state)
    cs.publish_step(os.path.join(d, "step_00000006"), d, 9)
    assert latest_ckpt_step(d) == 9 and ckpt.available_steps(d) == [6, 9]
    params, step = ckpt.restore_params(d, model)
    assert step == 9
    assert all(torch.equal(params[n], t) for n, t in
               model.named_parameters())
    with open(os.path.join(d, "step_00000009", "manifest.json")) as f:
        assert json.load(f)["step"] == 9


def _record(**kw):
    rec = {"timed_out": False, "requests_done": 16, "requests_lost": 0,
           "requests_shed": 0, "deaths": 1, "restarts": 1,
           "redispatches": 2, "rolling_swaps": 1, "partial_rolls": 0,
           "rolled_step": 9, "dead_epoch_done": 3,
           "replica_done": {"r0": 9, "r1": 7},
           "replicas": {"r0": {"ckpt_step": 9, "seq_first": 1,
                               "seq_last": 40, "requests_done": 9},
                        "r1": {"ckpt_step": 9, "seq_first": 1,
                               "seq_last": 9, "requests_done": 4}}}
    rec.update(kw)
    return rec


@pytest.mark.parametrize("change,fails", [
    ({}, False),
    ({"requests_lost": 1}, True),
    ({"requests_shed": 1}, True),
    ({"requests_done": 15}, True),
    ({"deaths": 2}, True),
    ({"restarts": 0}, True),
    ({"redispatches": 0}, True),
    ({"rolling_swaps": 0, "partial_rolls": 1}, True),
    ({"rolled_step": 12}, True),
    ({"dead_epoch_done": 2}, True),
    ({"timed_out": True}, True)])
def test_fleet_gates_arithmetic(change, fails, monkeypatch):
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    cs.fleet_gates(_record(**change))
    assert bool(failed) is fails
    rec = _record()
    rec["replicas"]["r1"]["seq_last"] = 1        # a frozen snapshot
    failed.clear()
    cs.fleet_gates(rec)
    assert len(failed) == 1 and "seq did not rise" in failed[0]


def test_serve_fleet_phase_on_the_cpu(monkeypatch, capsys):
    """The phase's own code at a tiny size: two CPU replicas, the kill
    mid-decode, the restart on epoch 1, the roll of the republished
    step, every stream against generate(); every gate holds."""
    tiny = ["--model", "gpt_lm", "--model-size", "tiny", "--seq-len", "128",
            "--synthetic-vocab", "50257"]
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "FLEET_ARGV", [
        "--mode", "serve", *tiny, "--compute-dtype", "float32",
        "--serve.num-slots", "4", "--serve.buckets", "64,128",
        "--device", "cpu"])
    monkeypatch.setattr(cs, "CHECKPOINT_ARGV", [
        "--mode", "train", *tiny, "--batch-size", "8",
        "--compute-dtype", "float32"])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    cs.phase_serve_fleet(torch, np)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"phase"')]
    assert not failed, failed
    rec = rows[-1]
    assert rec["phase"] == "serve_fleet"
    assert rec["identical"] + len(rec["excused"]) == 16
    assert rec["served_step"] == 6 and rec["rolled_step"] == 9
    assert set(rec["swap_s"]) == {"r0", "r1"}
    for key in ("replica_start_s", "death_to_next_token_s", "restart_s",
                "tokens_per_sec", "ttft_ms_p50_high", "ttft_ms_p95_standard"):
        assert rec[key] is not None and rec[key] > 0, key
    assert all(r["peak_bytes"] is None for r in rec["replicas"].values())
    assert rec["replica_log_lines"] > 0


# --- the cuts that pay for the phase: the fire phases' CLI legs beside
# their untimed in-process legs --------------------------------------------

def test_beside_returns_the_result_or_raises_the_failure(monkeypatch):
    import threading
    import time as time_mod

    main = threading.get_ident()
    got = cs.beside(lambda: (threading.get_ident() != main, 7))
    assert got() == (True, 7)

    def failing():
        time_mod.sleep(0.05)
        cs.fail("a check in the thread")
    with pytest.raises(SystemExit):
        cs.beside(failing)()


def _orchestration(monkeypatch, names, phase, *args):
    """Call ``phase`` with its legs replaced by recorders: the order in
    which each starts and ends, and which ran on another thread."""
    import threading
    import time as time_mod

    events = []
    main = threading.get_ident()

    def leg(name, ret=None, slow=0.0):
        def run(*a, **k):
            events.append(("start", name, threading.get_ident() != main))
            time_mod.sleep(slow)
            clis = k.get("clis") if "clis" in k else (
                a[-1] if a and callable(a[-1]) else None)
            if clis is not None:
                clis()
            events.append(("end", name))
            return ret
        return run
    for name, ret, slow in names:
        monkeypatch.setattr(cs, name, leg(name, ret, slow))
    phase(*args)
    return events


def test_serve_fire_runs_d_processes_beside_b(monkeypatch, capsys):
    events = _orchestration(monkeypatch, [
        ("fire_leg_a", None, 0), ("fire_leg_c", None, 0),
        ("fire_leg_d_clis", {}, 0.2), ("fire_leg_b", None, 0),
        ("fire_leg_d", None, 0)], cs.phase_serve_fire, torch, np, "ck", {})
    starts = [e[1] for e in events if e[0] == "start"]
    assert starts == ["fire_leg_a", "fire_leg_c", "fire_leg_d_clis",
                      "fire_leg_b", "fire_leg_d"]
    assert ("start", "fire_leg_d_clis", True) in events
    assert ("start", "fire_leg_b", False) in events
    # b ran while the processes were up; d waited for them.
    assert events.index(("end", "fire_leg_b")) < events.index(
        ("end", "fire_leg_d_clis")) < events.index(("end", "fire_leg_d"))
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(line["leg_seconds"]) == {"a", "b", "c", "b_and_d"}


def test_train_fire_runs_b_processes_beside_d(monkeypatch, capsys):
    events = _orchestration(monkeypatch, [
        ("train_fire_leg_a", [1.0], 0), ("train_fire_leg_c", None, 0),
        ("train_fire_leg_b_clis", {}, 0.2), ("train_fire_leg_d", None, 0),
        ("train_fire_leg_b", None, 0)], cs.phase_train_fire, [], torch)
    starts = [e[1] for e in events if e[0] == "start"]
    assert starts == ["train_fire_leg_a", "train_fire_leg_c",
                      "train_fire_leg_b_clis", "train_fire_leg_d",
                      "train_fire_leg_b"]
    assert ("start", "train_fire_leg_b_clis", True) in events
    assert events.index(("end", "train_fire_leg_d")) < events.index(
        ("end", "train_fire_leg_b_clis")) < events.index(
        ("end", "train_fire_leg_b"))
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(line["leg_seconds"]) == {"a", "c", "d", "b_and_d"}

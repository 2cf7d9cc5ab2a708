"""PyTorch port: ``chip_smoke.py``'s pipeline phases (50-51: model_pipe,
train_pipe), rehearsed on the CPU.

The legs' argvs parse to GPT-2-small as ``pipelined_lm`` (seq 1024,
batch 8, 10 steps, dropout 0) over the meshes the phase names; the
phases run after the earlier ones; model_pipe at a tiny size on the CPU
holds GPipe to the whole model over the same microbatches and 1F1B
(recompute, stash, V 2) to GPipe, and fails only on the launch counts
(the plain path launches no kernel); train_pipe skips on one card, runs
the pipe 2 legs on two, and on four holds each rank's first five losses
to one card's, its B1-B3 share, and the eval of the first leg's save to
that run's final eval, within the bounds written in the file.
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


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _cards(n):
    return type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: n)})})


@pytest.mark.parametrize("cards", [2, 4])
def test_pipe_argvs_are_gpt2_small_over_the_named_meshes(cards):
    from tensorflow_distributed_tpu_torch.config import parse_args

    runs = cs.train_pipe_runs(cards)
    for name, nproc, flags, mesh, ref in runs:
        cfg = parse_args(cs.TRAIN_PIPE_ARGV + flags + mesh)
        one = parse_args(cs.TRAIN_PIPE_ARGV + ref)
        # The one-card run does the same bf16 products: its microbatches
        # have a data rank's microbatches' rows.
        assert (cfg.batch_size // max(cfg.mesh.data, 1)
                // cfg.pipeline_microbatches) == (
            one.batch_size // one.pipeline_microbatches)
        assert (one.mesh.pipe, one.pipeline_schedule,
                one.pipeline_backward) == (1, cfg.pipeline_schedule,
                                           cfg.pipeline_backward)
        assert (cfg.model, cfg.model_size, cfg.seq_len, cfg.batch_size,
                cfg.train_steps, cfg.dropout_rate) == (
            "pipelined_lm", "small", 1024, 8, 10, 0.0)
        assert max(cfg.mesh.data, 1) * cfg.mesh.pipe == nproc <= cards
        assert name.startswith(f"pipe{cfg.mesh.pipe}") or name == (
            "data2_pipe2")
        assert 12 % (cfg.mesh.pipe * cfg.pipeline_virtual_stages) == 0
    names = [r[0] for r in runs]
    assert names == (["pipe4_recompute", "pipe4_stash", "pipe4_gpipe",
                      "pipe2_v2", "data2_pipe2"] if cards == 4
                     else ["pipe2_recompute", "pipe2_v2"])


def test_pipe_phases_run_last_in_order():
    src = inspect.getsource(cs.main)
    order = ["phase_train_ep(", "phase_model_pipe(", "phase_train_pipe(",
             'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)
    assert {"model_pipe", "train_pipe"} <= set(cs.ONLY_PHASES)


def test_model_pipe_agrees_on_the_cpu_and_counts_launches(monkeypatch,
                                                          capsys):
    import numpy as np
    import torch

    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "PIPE_MODEL", dict(size="tiny", B=8, L=16))
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    launches = cs.phase_model_pipe(fa, torch, np)
    rows = _rows(capsys)
    legs = [(r["S"], r["M"], r["leg"]) for r in rows]
    assert legs == [(2, 4, "gpipe"), (2, 4, "recompute"), (2, 4, "stash"),
                    (2, 4, "v2"), (4, 4, "gpipe"), (4, 4, "recompute"),
                    (4, 4, "stash"), (4, 8, "gpipe"), (4, 8, "recompute"),
                    (4, 8, "stash")]
    for r in rows:
        if r["leg"] == "gpipe":
            assert r["loss_rel_err"] <= cs.TOL_PIPE_LOSS
            assert r["logits_rel_err"] <= cs.TOL_PIPE
            assert r["grads_rel_err"] <= cs.TOL_PIPE
            assert "whole_batch" in r and "bf16_floor_whole_vs_halves" in r
        else:
            assert r["loss_rel_err"] <= cs.TOL_PIPE_SCHED_LOSS
            assert r["grads_rel_err"] <= cs.TOL_PIPE_SCHED_GRAD
    assert len(failed) == len(rows)
    assert all("B1-B3 launched" in msg for msg in failed)
    assert set(launches) == {f"S{S}_M{M}_{leg}" for S, M, leg in legs}


def test_train_pipe_skips_on_one_card(capsys):
    cs.phase_train_pipe(_cards(1))
    rec = json.loads(capsys.readouterr().out)
    assert rec["phase"] == "train_pipe" and "skipped" in rec


ONE_CARD = [10.9, 10.2, 9.6, 9.1, 8.7, 8.4, 8.1, 7.9, 7.7, 7.5]
# (run, fault, passes): a loss 2e-2 off at step 3, a rank short of its
# B2 share, an eval of the save 1e-4 off the run's final eval.
PIPE_FAULTS = [(None, None, True), ("pipe4_stash", "loss", False),
               ("data2_pipe2", "launch", False),
               ("pipe4_recompute", "eval", False)]


@pytest.mark.parametrize("run,fault,passes", PIPE_FAULTS)
def test_train_pipe_holds_its_bounds_on_four_cards(run, fault, passes,
                                                   monkeypatch, capsys):
    monkeypatch.setattr(cs, "one_card_losses", lambda argv: (ONE_CARD, 8.0))

    def fake_run(phase, nproc, argv, timeout):
        name = phase.split()[1]
        S = int(argv[argv.index("--mesh.pipe") + 1])
        M = (int(argv[argv.index("--pipeline-microbatches") + 1])
             if "--pipeline-microbatches" in argv else 4)
        share = 12 // S * M * cs.TRAIN_PIPE_STEPS
        if phase.endswith("eval"):
            loss = 7.0 + (1e-4 if fault == "eval" else 0.0)
            return 1.0, [{"eval": {"loss": loss}}] * nproc, [""] * nproc
        losses = list(ONE_CARD)
        launches = {"flash_fwd": 2 * share, "flash_dq": share,
                    "flash_dkv": share}
        if name == run and fault == "loss":
            losses[3] += 2e-2
        if name == run and fault == "launch":
            launches["flash_dq"] -= 1
        return 1.0, [{"losses": losses, "step_ms_median": 90.0,
                      "max_memory_allocated": 1, "final": {"loss": 7.0},
                      "launches": dict(launches)}] * nproc, [""] * nproc

    monkeypatch.setattr(cs, "run_torchrun", fake_run)
    if passes:
        cs.phase_train_pipe(_cards(4))
    else:
        with pytest.raises(SystemExit):
            cs.phase_train_pipe(_cards(4))
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert rows[0]["run"] == "pipe4_recompute"
    assert rows[1]["run"] == "pipe4_recompute_eval"
    assert passes == ("train_pipe" not in err)
    if passes:
        assert [r["run"] for r in rows] == [
            "pipe4_recompute", "pipe4_recompute_eval", "pipe4_stash",
            "pipe4_gpipe", "pipe2_v2", "data2_pipe2"]

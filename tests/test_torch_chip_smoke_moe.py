"""PyTorch port: ``chip_smoke.py``'s mixture-of-experts phases (46-49:
model_moe, train_moe, serve_moe, train_ep), rehearsed on the CPU.

The legs' argvs parse to the MoE cell (moe_lm at GPT-2-small widths, 8
experts, top-2, capacity 1.25, batch 8 x 1024); the phases run after
the earlier ones; model_moe at a tiny size on the CPU holds scatter to
dense and the stacked expert transport to the whole model, prints the
routing agreement shares, and fails only on the launch counts (the
plain path launches no kernel); serve_moe at a tiny size delivers every
token and holds the bucket-filling prompts to ``generate()``; train_ep
skips on fewer than four cards, and on four holds each run's first
step's gradient norm and its first five losses (the model axis's first
two) to one card's within a bound written in the file.
"""

import importlib.util
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
TINY = dict(size="tiny", experts=4, B=2, L=32)


def _rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_moe_argvs_are_the_cell():
    from tensorflow_distributed_tpu_torch.config import parse_args

    for extra in cs.MOE_LEGS.values():
        cfg = parse_args(cs.TRAIN_MOE_ARGV + extra)
        assert (cfg.model, cfg.model_size, cfg.moe_experts, cfg.moe_top_k,
                cfg.moe_capacity_factor) == ("moe_lm", "small", 8, 2, 1.25)
        assert (cfg.batch_size, cfg.seq_len, cfg.train_steps) == (8, 1024, 20)
    assert parse_args(cs.TRAIN_MOE_ARGV
                      + cs.MOE_LEGS["scatter"]).moe_dispatch == "scatter"
    assert parse_args(cs.TRAIN_MOE_ARGV
                      + cs.MOE_LEGS["dense_fused"]).ce_impl == "kernel"
    for name, nproc, argv in cs.train_ep_runs():
        cfg = parse_args(argv)
        mesh = cfg.mesh
        assert max(mesh.data, 1) * mesh.model * mesh.expert == nproc == 4
        assert cfg.dropout_rate == 0.0 and cfg.model == "moe_lm"
    assert [r[0] for r in cs.train_ep_runs()] == [
        "expert4", "model4", "data2_expert2"]


def test_moe_phases_run_last_in_order():
    import inspect

    src = inspect.getsource(cs.main)
    order = ["phase_train_zero(", "phase_model_moe(", "phase_train_moe(",
             "phase_serve_moe(", "phase_train_ep(", 'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)
    assert {"model_moe", "train_moe", "serve_moe", "train_ep"} <= set(
        cs.ONLY_PHASES)


def test_model_moe_agrees_on_the_cpu_and_counts_launches(monkeypatch,
                                                         capsys):
    import numpy as np
    import torch

    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "MOE_MODEL", TINY)
    monkeypatch.setattr(cs, "MOE_CPU_ROWS", 1)
    # A tiny bf16 loss over 64 tokens (one head a rank at X 4) moves by
    # more than the full-width gate under another reduction order.
    monkeypatch.setattr(cs, "TOL_MOE_LOSS", 1e-4)
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    cs.phase_model_moe(fa, torch, np)
    rows = _rows(capsys)
    assert [r["leg"] for r in rows] == (
        ["dispatch"] + ["stacked_ep"] * len(cs.MOE_EP_SIZES)
        + ["f32_plain_cpu"])
    assert rows[0]["first_layer_routing_identical"]
    assert rows[0]["logits_rel_err"] <= cs.TOL_MOE_LOGITS
    for r in rows[1:-1]:
        assert r["routing_pinned_to_whole"]
        assert r["loss_rel_err"] <= cs.TOL_MOE_LOSS
        assert r["grads_rel_err"] <= cs.TOL_TP
        assert r["experts_a_rank"] == 4 // r["X"]
    assert 0.0 <= rows[-1]["routing_agreement"] <= 1.0
    assert len(failed) == len(cs.MOE_EP_SIZES)
    assert all("not launched" in msg for msg in failed)


def test_serve_moe_delivers_and_holds_filled_buckets(monkeypatch, capsys):
    import numpy as np
    import torch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "MOE_MODEL", TINY)
    monkeypatch.setattr(cs, "MOE_SERVE_PROMPTS", (16, 32, 20))
    monkeypatch.setattr(cs, "MOE_SERVE_NEW", 6)
    cs.phase_serve_moe(torch, np)
    rows = _rows(capsys)
    assert [r["dtype"] for r in rows] == ["float32", "bfloat16"]
    assert all(r["tokens"] == 3 * 6 for r in rows)
    assert rows[0]["bucket_filled"] == 2 and rows[0]["padded"] == 1
    assert rows[0]["bucket_filled_identical"] + len(rows[0]["excused"]) == 2


def test_train_ep_skips_below_four_cards(capsys):
    torch_two = type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: 2)})})
    cs.phase_train_ep(torch_two)
    rec = json.loads(capsys.readouterr().out)
    assert rec["phase"] == "train_ep" and "skipped" in rec


ONE_CARD = [10.9, 10.2, 9.6, 9.1, 8.7, 8.4, 8.1, 7.9, 7.7, 7.5]
# (run, step, loss offset, grad-norm scale, passes): the model axis
# parts from one card from its third loss; nothing else may.
EP_FAULTS = [("model4", 2, 2.5e-2, 1.0, True),
             ("model4", 1, 2e-2, 1.0, False),
             ("data2_expert2", 0, 0.0, 1.02, False),
             ("expert4", 4, 2e-2, 1.0, False)]


@pytest.mark.parametrize("run,step,offset,scale,passes", EP_FAULTS)
def test_train_ep_holds_fixed_bounds_on_four_cards(run, step, offset, scale,
                                                   passes, monkeypatch,
                                                   capsys):
    torch_four = type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: 4)})})
    flash = {"flash_fwd": 120, "flash_dq": 120, "flash_dkv": 120}
    monkeypatch.setattr(cs, "one_card_metrics", lambda argv: (
        [{"loss": v, "grad_norm": 2.0} for v in ONE_CARD], 8.0))

    def fake_run(phase, nproc, argv, timeout):
        losses, norms = list(ONE_CARD), [2.0] * len(ONE_CARD)
        if phase.endswith(run):
            losses[step:] = [v + offset for v in losses[step:]]
            norms[0] *= scale
        return 1.0, [{"losses": losses, "grad_norms": norms,
                      "steps_per_sec": 9.0, "max_memory_allocated": 1,
                      "launches": dict(flash)}] * nproc, [""] * nproc

    monkeypatch.setattr(cs, "run_torchrun", fake_run)
    if passes:
        cs.phase_train_ep(torch_four)
    else:
        with pytest.raises(SystemExit):
            cs.phase_train_ep(torch_four)
    out, err = capsys.readouterr()
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["run"] for r in rows] == ["expert4", "model4", "data2_expert2"]
    assert passes == (f"train_ep {run}" not in err)
    assert [r["losses_held"] for r in rows] == [5, 2, 5]
    assert all(r["tolerance"] == cs.TOL_RING_LOSS == 1e-2 for r in rows)

"""PyTorch port: ``chip_smoke.py``'s tensor-parallel phases (41-43:
tp_kernels, model_tp, train_tp), rehearsed on the CPU.

The kernel cases are a model rank's shapes (H/M heads); the train_tp
legs' argvs parse, each against a one-card run of the same global
batch; the phases run after the earlier ones; model_tp at a tiny size on
the CPU agrees with the whole model in every variant and fails only on
the launch count (the plain path launches no kernel); and train_tp
skips on one card.
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


def test_tp_kernel_cases_are_a_model_rank_s_shapes():
    """GPT-2-small's 12 heads at batch 8 over M 2 and 4 (B.H 48 and 24,
    causal, L 1024), BERT-base's batch 16 over M 2 (B.H 96, L 512)."""
    got = [(c["M"], c["B"] * c["H"], c["L"], c["causal"])
           for c in cs.TP_KERNEL_CASES]
    assert got == [(2, 48, 1024, True), (4, 24, 1024, True),
                   (2, 96, 512, False)]
    assert all(c["H"] * c["M"] == 12 and c["D"] == 64
               for c in cs.TP_KERNEL_CASES)


@pytest.mark.parametrize("count", [2, 3, 4, 8])
def test_train_tp_argvs_parse(count):
    """M 4 on four cards or more, else 2; the shard-vocab leg on the
    vocab-parallel scan; a (data 2, model 2) leg on four cards; the
    one-card twin has no mesh and the same global batch."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    runs = cs.train_tp_runs(count)
    M = 4 if count >= 4 else 2
    names = [r[0] for r in runs]
    assert names == [f"model{M}", f"model{M}_shard_vocab"] + (
        ["data2_model2_shard_vocab"] if count >= 4 else [])
    for name, nproc, argv, one_argv in runs:
        cfg, one = parse_args(argv), parse_args(one_argv)
        assert max(cfg.mesh.data, 1) * cfg.mesh.model == nproc <= count
        assert cfg.mesh.model == (2 if name.startswith("data2") else M)
        assert (one.mesh.data, one.mesh.model) == (-1, 1)
        assert cfg.batch_size == one.batch_size == 8
        assert cfg.model_size == "small" and cfg.seq_len == 1024
        assert cfg.dropout_rate == 0.0 and cfg.ce_impl == "scan"
        assert cfg.shard_vocab == one.shard_vocab == ("shard_vocab" in name)
        assert cfg.ce_chunk == (8192 if "shard_vocab" in name else 0)


def test_tp_phases_run_last_in_order():
    import inspect

    src = inspect.getsource(cs.main)
    order = ["phase_train_resnet(", "phase_tp_kernels(", "phase_model_tp(",
             "phase_train_tp(", 'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)
    assert {"tp_kernels", "model_tp", "train_tp"} <= set(cs.ONLY_PHASES)


def test_model_tp_agrees_on_the_cpu_and_counts_launches(monkeypatch,
                                                        capsys):
    """Every variant at M 2 and 4 on a tiny GPT (bf16, the CPU): the TP
    model's loss, logits and gradients agree with the whole model's
    within the gate (the whole gradient's relative error; each
    parameter's worst, and the whole model against itself on two
    half-batches, printed); the one check that fails is the launch count
    (the CPU's plain attention launches no kernel)."""
    import torch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "TP_MODEL", dict(size="tiny", B=2, L=64))
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    import numpy as np

    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa

    cs.phase_model_tp(fa, torch, np)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [(r["M"], r["variant"]) for r in rows] == [
        (M, v) for M in cs.TP_SIZES for v in cs.TP_VARIANTS]
    for r in rows:
        assert r["loss_rel_err"] <= cs.TOL_TP
        assert r["grads_rel_err"] <= cs.TOL_TP
        assert r["worst_param_rel_err"] >= r["grads_rel_err"] > 0
        assert r["bf16_floor_whole_vs_halves"]["grads_rel_err"] > 0
        assert (r["logits_rel_err"] is None) == (r["variant"] == "fused_scan")
        assert r["heads_a_rank"] == 4 // r["M"]
    assert len(failed) == len(rows)
    assert all("not launched" in msg for msg in failed)


def test_train_tp_skips_on_one_card(capsys):
    torch_one = type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: 1)})})
    cs.phase_train_tp(torch_one)
    rec = json.loads(capsys.readouterr().out)
    assert rec["phase"] == "train_tp" and "skipped" in rec

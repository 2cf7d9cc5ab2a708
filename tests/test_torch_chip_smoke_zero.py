"""PyTorch port: ``chip_smoke.py``'s ZeRO-1 / FSDP / explicit-sync phases
(44-45: model_zero, train_zero), rehearsed on the CPU.

The legs' argvs parse (each partition and sync mode at D data ranks,
the fused leg, and the torchrun legs for 2-8 cards); the phases run
after the earlier ones; model_zero at a tiny size on the CPU (its
threshold lowered so that the tiny GPT is cut) holds serial and overlap
bit-identical and zero1 and fsdp to replicated, prints each rank's
resident bytes beside the prediction, and fails only on the launch
counts (the plain path launches no kernel); train_zero skips on one
card.
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


@pytest.mark.parametrize("D", cs.ZERO_SIZES)
def test_model_zero_argvs_parse(D):
    """GPT-2-small as published (tied), bf16, clip 1.0, EMA, Adam; each
    leg's partition and sync; the NaN skip on the explicit legs only."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    for name, extra in list(cs.ZERO_LEGS.items()) + [("fused",
                                                      cs.ZERO_FUSED)]:
        cfg = parse_args(cs.MODEL_ZERO_ARGV + ["--mesh.data", str(D)]
                         + extra)
        assert cfg.model_size == "small" and cfg.seq_len == 1024
        assert cfg.tie_embeddings and cfg.batch_size == 8
        assert cfg.grad_clip_norm == 1.0 and cfg.ema_decay == 0.999
        assert cfg.param_partition == {"zero1": "zero1", "fsdp": "fsdp",
                                       "overlap": "zero1",
                                       "fused": "zero1"}.get(name,
                                                             "replicated")
        assert cfg.grad_sync == (name if name in ("serial", "overlap")
                                 else "implicit")
        assert (cfg.resilience.nonfinite == "skip_batch") == (
            name in ("serial", "overlap"))
        assert (cfg.ce_impl, cfg.ce_chunk) == (
            ("kernel", 8192) if name == "fused" else ("scan", 0))


@pytest.mark.parametrize("count", [2, 3, 4, 8])
def test_train_zero_argvs_parse(count):
    """zero1, fsdp, serial and overlap over D = min(cards, 4) ranks, and
    fsdp over data 2 x model 2 with four cards; every leg GPT-2-small at
    global batch 8 against the one-card run of the same argv."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    runs = cs.train_zero_runs(count)
    assert [r[0] for r in runs] == ["zero1", "fsdp", "serial", "overlap"] + (
        ["data2_model2_fsdp"] if count >= 4 else [])
    one = parse_args(cs.TRAIN_ZERO_ARGV)
    for name, nproc, argv in runs:
        cfg = parse_args(argv)
        assert cfg.mesh.data * cfg.mesh.model == nproc <= count
        assert cfg.batch_size == one.batch_size == 8
        assert cfg.model_size == "small" and cfg.seq_len == 1024
        assert cfg.dropout_rate == 0.0 and cfg.ce_chunk == 0
        assert cfg.param_partition == ("replicated" if name == "serial"
                                       else "fsdp" if "fsdp" in name
                                       else "zero1")


def test_zero_phases_run_last_in_order():
    import inspect

    src = inspect.getsource(cs.main)
    order = ["phase_train_tp(", "phase_model_zero(", "phase_train_zero(",
             'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)
    assert {"model_zero", "train_zero"} <= set(cs.ONLY_PHASES)


def test_predicted_bytes_are_gpt2_small_s():
    """GPT-2-small (tied): 497.76 MB of params and 995.52 MB of slots
    replicated; zero1's slots 2 (497.27 / D + 0.49) MB; fsdp's params
    124.8 MB at D 4."""
    rep = cs.zero_predicted("replicated", 4)
    assert (rep["params"], rep["slots"]) == (497_759_232, 995_518_464)
    assert cs.zero_predicted("zero1", 4)["slots"] == 2 * (
        497_273_856 // 4 + 485_376)
    assert cs.zero_predicted("fsdp", 4)["params"] == 124_803_840


def test_model_zero_agrees_on_the_cpu_and_counts_launches(monkeypatch,
                                                          capsys):
    """Every leg at D 2 and 4 on a tiny GPT (f32, the CPU, the threshold
    256): overlap bit-identical to serial with the poisoned step skipped,
    zero1 and fsdp within the gates of replicated, the cut leaves'
    resident bytes a rank's share; the checks that fail are the launch
    counts (the CPU's plain attention and CE launch no kernel)."""
    import torch

    from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
    from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "ZERO_MIN_SIZE", 256)
    argv = list(cs.MODEL_ZERO_ARGV)
    argv[argv.index("small")] = "tiny"
    argv[argv.index("1024")] = "64"
    argv[argv.index("bfloat16")] = "float32"
    monkeypatch.setattr(cs, "MODEL_ZERO_ARGV",
                        argv + ["--synthetic-vocab", "512", "--device", "cpu"])
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    cs.phase_model_zero(fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS,
                        torch)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    legs = list(cs.ZERO_LEGS)
    assert [(r["D"], r["leg"]) for r in rows] == [
        (D, leg) for D in cs.ZERO_SIZES for leg in legs] + [
        (cs.ZERO_SIZES[0], "zero1_fused")]
    for r in rows:
        if r["leg"] in ("zero1", "fsdp"):
            assert r["loss_rel_err"] <= cs.TOL_ZERO_LOSS
            assert r["params_excess_over_tol"][0] <= cs.TOL_ZERO_PARAMS[
                "atol"]
        if r["leg"] == "overlap":
            assert all(r["bit_identical_to_serial"].values())
            assert r["skipped"] == [0.0, 1.0, 0.0]
        held = r["resident_bytes_a_rank"]
        if r["leg"] == "fsdp":
            assert held["params"] < rows[0]["resident_bytes_a_rank"][
                "params"]
        assert r["blocked_leaves"] == (0 if r["leg"] in ("replicated",
                                                         "serial") else 10)
    assert len(failed) == len(rows)
    assert all("not launched" in msg for msg in failed)


def test_train_zero_skips_on_one_card(capsys):
    torch_one = type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: 1)})})
    cs.phase_train_zero(torch_one)
    rec = json.loads(capsys.readouterr().out)
    assert rec["phase"] == "train_zero" and "skipped" in rec

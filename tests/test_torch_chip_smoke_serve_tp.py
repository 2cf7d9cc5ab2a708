"""PyTorch port: ``chip_smoke.py``'s tensor-parallel serving phases
(model_serve_tp, serve_tp, generate_tp), rehearsed on the CPU.

model_serve_tp at a tiny size on the CPU passes its gates (streams,
per-device bytes, bf16 logits) and fails them on a TP twin whose weights
drifted; serve_tp's readings, taken once over two gloo ranks at a tiny
size, pass its gates, and a drifted stream or a surviving worker fails
them; the four-card phases skip on one card by the device count alone;
their argvs parse.
"""

import copy
import importlib.util
import json
import os

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

TINY = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
        "--synthetic-vocab", "61", "--shard-vocab", "true", "--seq-len",
        "48", "--device", "cpu",
        "--serve.num-slots", "2", "--serve.num-requests", "6",
        "--serve.prompt-len-min", "4", "--serve.prompt-len-max", "10",
        "--serve.max-new-tokens", "12"]
TINY_PAGED = ["--serve.paged", "true", "--serve.page-size", "8",
              "--serve.prompt-len-max", "8", "--serve.session-turns", "2"]


def _tiny_gpt(torch, dtype, **overrides):
    """The phases' GPT-2-small swapped for a tiny GPT of 8 heads (so
    that the GQA leg's 4 K/V heads split over M 4) on the CPU."""
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    model = gpt_lm("tiny", compute_dtype=dtype, dropout_rate=0.0,
                   d_model=64, n_heads=8, **overrides)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


@pytest.fixture
def tiny_phase(monkeypatch):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "gpt2_small", _tiny_gpt)
    monkeypatch.setattr(cs, "SERVE_TP_PROMPTS", (4, 40))
    monkeypatch.setattr(cs, "SERVE_TP_NEW", 8)
    monkeypatch.setattr(cs, "SERVE_TP_BUCKETS", 64)
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    return failed


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_model_serve_tp_passes_on_the_cpu(tiny_phase, capsys):
    """Every leg at M 2, int8, k-gram and GQA at M 4 too: the streams equal the whole engine's, the
    per-device cache (and page) bytes are 1/M of its, a k-gram verify
    ran, and the bf16 logits are within the gate."""
    import numpy as np

    cs.phase_model_serve_tp(torch, np)
    (row,) = _lines(capsys)
    assert tiny_phase == []
    legs = [(r["leg"], r["M"]) for r in row["legs"]]
    assert legs == [(leg, M) for leg in ("dense", "paged", "int8", "kgram",
                                         "gqa")
                    for M in cs.SERVE_TP_SIZES + cs.SERVE_TP_MORE.get(leg, ())]
    for r in row["legs"]:
        assert r["identical"] == r["requests"] and not r["excused"]
        assert r["cache_bytes_per_slot"] * r["M"] == (
            r["whole_cache_bytes_per_slot"])
    paged = [r for r in row["legs"] if r["leg"] == "paged"]
    assert all(r["page_bytes"] * r["M"] == r["whole_page_bytes"]
               and r["prefix_hits"] >= cs.SERVE_TP_REQUESTS for r in paged)
    assert all(max(v) <= cs.TOL_SERVE_TP
               for v in row["bf16_rel_err_by_step"].values())


def test_model_serve_tp_fails_on_drifted_weights(tiny_phase, monkeypatch,
                                                 capsys):
    """A TP twin whose out projections drifted serves other streams:
    the identity gate fails (the whole model's gaps are not ties), and
    the bf16 logits leave their tolerance."""
    import numpy as np

    twin = cs.tp_twin

    def drifted(torch, whole, M):
        model = twin(torch, whole, M)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("attn.out.weight"):
                    p.mul_(3.0)
        return model

    monkeypatch.setattr(cs, "tp_twin", drifted)
    cs.phase_model_serve_tp(torch, np)
    _lines(capsys)
    assert any("differs from the whole engine" in m for m in tiny_phase)
    assert any("bf16" in m for m in tiny_phase)


@pytest.fixture(scope="module")
def serve_tp_readings(tmp_path_factory):
    """serve_tp's readings over two gloo ranks at a tiny size (f32 dense
    and paged against one card, bf16, the supervised SIGKILL leg), taken
    once for the gate tests."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "DEVICE", "cpu")
    mp.setattr(cs, "SERVE_TP_WIDTH", 2)
    mp.setattr(cs, "SERVE_TP_ARGV", TINY)
    mp.setattr(cs, "SERVE_TP_PAGED", TINY_PAGED)
    mp.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = cs.serve_tp_readings(str(tmp_path_factory.mktemp("serve_tp")))
    finally:
        torch.set_num_threads(n)
        mp.undo()
    return got


@pytest.fixture
def tiny_gates(monkeypatch):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "SERVE_TP_WIDTH", 2)
    monkeypatch.setattr(cs, "SERVE_TP_ARGV", TINY)
    monkeypatch.setattr(cs, "SERVE_TP_PAGED", TINY_PAGED)
    failed = []
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: cond or failed.append(msg))
    return failed


def test_serve_tp_readings_pass_the_gates(serve_tp_readings, tiny_gates):
    """Over two gloo ranks every f32 stream equals one card's, the
    per-device cache is half of one card's, and the supervised leg was
    killed, restarted and finished with the clean TP streams, leaving no
    worker of the killed leg alive."""
    runs = cs.serve_tp_gates(torch, serve_tp_readings)
    assert tiny_gates == []
    assert runs["f32_dense_tp"]["identical"] == 6
    assert runs["f32_paged_tp"]["identical"] == 6
    assert runs["f32_paged_tp"]["prefix_hits"] > 0
    assert runs["bf16_tp"]["tp_width"] == 2
    # Where each replica's start and stop went, by part.
    assert set(runs["f32_dense_tp"]["tp_start_s"]) == {
        "spawn_join", "build", "warmup"}
    assert set(runs["f32_dense_tp"]["tp_stop_s"]) == {
        "shutdown", "group_end", "workers"}
    assert runs["f32_dense_one_card"]["tp_stop_s"] is None
    sup = runs["supervised"]
    assert sup["legs"] == 2 and sup["equal_clean"]
    assert len(sup["killed_leg_workers"]) == 1 and not sup["workers_left"]


@pytest.mark.parametrize("bad", ["drifted_stream", "surviving_worker",
                                 "lost_request", "no_restart"])
def test_serve_tp_gates_fail_on_bad_readings(serve_tp_readings, tiny_gates,
                                             bad):
    got = copy.deepcopy(serve_tp_readings)
    sup = got["supervised"]
    if bad == "drifted_stream":
        stream = got["streams"]["f32_paged_tp"][0]
        stream[0] = (stream[0] + 1) % 61
    elif bad == "surviving_worker":
        sup["workers_left"] = list(sup["killed_leg_workers"])
    elif bad == "lost_request":
        sup["streams"].pop(3)
    else:
        sup.update(restarted=False, legs=1)
    cs.serve_tp_gates(torch, got)
    assert len(tiny_gates) == 1, tiny_gates


def test_four_card_phases_skip_on_one_card(capsys):
    torch_one = type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: 1)})})
    cs.phase_serve_tp(torch_one)
    cs.phase_generate_tp(torch_one)
    recs = _lines(capsys)
    assert [r["phase"] for r in recs] == ["serve_tp", "generate_tp"]
    assert all("skipped" in r for r in recs)


def test_phase_argvs_parse():
    """serve_tp's legs at GPT-2-small's widths over 4 cards (f32 dense
    and paged sessions, bf16), the supervised leg's plan, and
    generate_tp's train and generate lines under --mesh.model 4 with
    --shard-vocab."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    tp = ["--serve.mesh-model", str(cs.SERVE_TP_WIDTH)]
    from tensorflow_distributed_tpu_torch.serve.run import check_tp_serving
    from tensorflow_distributed_tpu_torch.train.loop import build_model_for

    cfg = parse_args(cs.SERVE_TP_ARGV + cs.SERVE_TP_PAGED + tp)
    assert (cfg.serve.mesh_model, cfg.model_size, cfg.seq_len) == (
        4, "small", 1024)
    # serve/run.py's checks pass (the vocabulary padded by --shard-vocab).
    check_tp_serving(cfg, build_model_for(cfg, "meta", vocab_size=50257).cfg,
                     torch.device("cpu"))
    assert cfg.serve.paged and cfg.serve.session_turns == 2
    assert (cfg.serve.num_requests, cfg.serve.max_new_tokens,
            cfg.serve.num_slots) == (32, 64, 8)
    mesh = ["--mesh.model", "4"]
    train = parse_args(cs.GENERATE_TP_TRAIN + mesh + ["--checkpoint-dir",
                                                      "d"])
    gen = parse_args(cs.GENERATE_TP_RUN + mesh + ["--checkpoint-dir", "d",
                                                  "--num-beams", "4"])
    assert train.shard_vocab and gen.shard_vocab and gen.num_beams == 4
    assert cfg.shard_vocab
    assert train.checkpoint_every == train.train_steps == 2
    assert gen.compute_dtype == "float32" and gen.mesh.model == 4
    assert {"model_serve_tp", "serve_tp", "generate_tp"} <= set(
        cs.ONLY_PHASES)


def test_serve_tp_phases_run_last_in_order():
    import inspect

    src = inspect.getsource(cs.main)
    order = ["phase_train_pipe3d(", "phase_model_serve_tp(",
             "phase_serve_tp(", "phase_generate_tp(", 'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)

"""PyTorch port: ``chip_smoke.py``'s BASELINE phases (BERT, text, the
u8 CNN, ResNet-20/50), rehearsed on the CPU (split from
``test_torch_chip_smoke.py``): their argvs, order and launch checks,
and the legs that run on the CPU pass and fail where the file says.
"""

import json

import pytest

from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
from test_torch_chip_smoke import cs


def test_baseline_argvs_parse_as_their_phases_say():
    """train_bert is BERT-base at L 512, vocab 30522, 16 rows, dense then
    fused on the CE kernels; train_text GPT-2-small at seq 1024 on the
    byte corpus; train_cnn_u8 the fixture run under u8_native; the
    ResNets at their published shapes."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    bert = parse_args(cs.TRAIN_BERT_ARGV)
    assert (bert.model, bert.model_size, bert.seq_len, bert.synthetic_vocab,
            bert.batch_size, bert.ce_chunk, bert.compute_dtype) == (
        "bert_mlm", "", 512, 30522, 16, 0, "bfloat16")
    fused = parse_args(cs.TRAIN_BERT_FUSED_ARGV)
    assert (fused.ce_chunk, fused.ce_impl) == (8192, "kernel")
    text = parse_args(cs.TRAIN_TEXT_ARGV)
    assert (text.model, text.model_size, text.dataset, text.text_tokenizer,
            text.seq_len, text.batch_size) == (
        "gpt_lm", "small", "text", "byte", 1024, 8)
    u8 = parse_args(cs.TRAIN_CNN_U8_ARGV)
    assert (u8.model, u8.data_dir, u8.data_backend) == (
        "mnist_cnn", cs.FIXTURE_DIR, "u8_native")
    r50 = parse_args(cs.TRAIN_RESNET50_ARGV)
    r20 = parse_args(cs.TRAIN_RESNET20_ARGV)
    assert (r50.model, r50.dataset, r50.batch_size) == (
        "resnet50", "imagenet_synthetic", 64)
    assert (r20.model, r20.dataset, r20.batch_size) == (
        "resnet20", "cifar10_synthetic", 128)


def test_baseline_phases_run_last_in_order():
    import inspect

    src = inspect.getsource(cs.main)
    order = ["phase_train_fire(", "phase_model_bert(", "phase_train_bert(",
             "phase_train_text(", "phase_train_cnn_u8(",
             "phase_model_resnet(", "phase_train_resnet(",
             'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)


def _bert_rec(steps, per_step, ce):
    flash = {k: per_step * steps for k in ("flash_fwd", "flash_dq",
                                           "flash_dkv")}
    return {"steps": steps, "train_launches": {
        **flash, **{k: ce for k in cs.CE_KERNELS},
        **{k: 0 for k in cs.RING_KERNELS}}}


@pytest.mark.parametrize("fault", ["none", "b1_count", "ce_count",
                                   "ce_in_dense"])
def test_train_bert_checks_the_launches(fault, capsys):
    """B1-B3 twelve times a step each, non-causal (a count off by a layer
    fails), and B4-B6 once a step in the fused leg only."""
    per_step = 11 if fault == "b1_count" else 12
    fused = fault != "ce_in_dense"
    ce = {"ce_count": 19, "ce_in_dense": 20}.get(fault, 20)
    rec = _bert_rec(20, per_step, ce)
    if fault == "none":
        cs.flash_launch_check(rec, True, "train_bert")
        cs.flash_launch_check(_bert_rec(20, 12, 0), False, "train_bert")
        return
    with pytest.raises(SystemExit):
        cs.flash_launch_check(rec, fused and fault != "ce_in_dense",
                             "train_bert")
    assert "not B1-B3 12 times a step" in capsys.readouterr().err


@pytest.fixture
def baseline_smoke(monkeypatch):
    """The new phases on the CPU at tiny sizes: the card's launch checks,
    memory reads and synchronizations left out."""
    import torch

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    for name in ("reset_peak_memory_stats", "max_memory_allocated",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    monkeypatch.setattr(cs, "flash_launch_check", lambda *a: None)
    cpu = ["--device", "cpu"]
    monkeypatch.setattr(cs, "TRAIN_TEXT_ARGV", [
        "--mode", "train", "--model", "gpt_lm", "--model-size", "tiny",
        "--dataset", "text", "--seq-len", "64", "--batch-size", "8",
        "--train-steps", "6", "--eval-every", "0", "--eval-batch-size", "8",
        "--compute-dtype", "float32", "--log-every", "1",
        "--learning-rate", "3e-3", *cpu])
    monkeypatch.setattr(cs, "TEXT_GEN_ARGV", [
        "--model", "gpt_lm", "--model-size", "tiny", "--dataset", "text",
        "--seq-len", "64", "--compute-dtype", "float32", *cpu])
    monkeypatch.setattr(cs, "TEXT_NEW", 6)
    monkeypatch.setattr(cs, "TRAIN_CNN_U8_ARGV", cs.TRAIN_CNN_U8_ARGV + cpu)
    monkeypatch.setattr(cs, "TRAIN_RESNET20_ARGV", [
        "--mode", "train", "--model", "resnet20", "--dataset",
        "cifar10_synthetic", "--batch-size", "128", "--train-steps", "24",
        "--eval-every", "0", "--eval-batch-size", "500", "--log-every", "1",
        "--compute-dtype", "float32", *cpu])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield torch
    torch.set_num_threads(threads)


def test_train_text_passes_on_the_cpu(baseline_smoke, capsys):
    """The byte corpus of the repository's files, a tiny GPT on it, then
    the generate and serve CLI processes with text prompts: every stream
    equal to generate() on the restored model."""
    cs.phase_train_text([], baseline_smoke)
    line = json.loads([l for l in capsys.readouterr().out.splitlines()
                       if l.startswith('{"phase": "train_text"')][-1])
    assert line["corpus_bytes"] > 10 ** 6 and line["vocab"] == 256
    assert line["serve_requests"] == len(cs.TEXT_PROMPTS)
    assert line["serve_params"] == "checkpoint"
    assert isinstance(line["generate_text"], str)


def test_text_streams_check_fails_on_a_stream_that_differs(capsys):
    """A served stream that leaves generate() where the top-2 gap is
    wide fails the phase."""
    import torch

    from tensorflow_distributed_tpu_torch.models.generate import generate
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    model = gpt_lm("tiny", compute_dtype=torch.float32, vocab_size=256)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.lm_head.weight.mul_(50.0)  # wide top-2 gaps
    cs_device, cs.DEVICE = cs.DEVICE, "cpu"
    try:
        prompt = [100, 101, 102]
        ref = generate(model, torch.tensor([prompt]), cs.TEXT_NEW)[0].tolist()
        assert cs.text_streams_check(torch, model, [prompt], {0: ref},
                                     "x") == []
        bad = list(ref)
        bad[3] = (bad[3] + 1) % 256
        with pytest.raises(SystemExit):
            cs.text_streams_check(torch, model, [prompt], {0: bad},
                                  "train_text (serve)")
    finally:
        cs.DEVICE = cs_device
    assert "differs from generate() at step 3" in capsys.readouterr().err


def test_train_cnn_u8_passes_and_fails_without_the_library(
        baseline_smoke, monkeypatch, capsys):
    cs.phase_train_cnn_u8([], baseline_smoke)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["library"].startswith("build/torch_native/libtfd_native.")
    assert line["native_gathers"] >= 50
    assert line["max_rel_loss_diff"] <= cs.TOL_U8
    from tensorflow_distributed_tpu_torch.native import runtime as native

    monkeypatch.setattr(native, "loaded_path", lambda: None)
    with pytest.raises(SystemExit):
        cs.native_check(native, "train_cnn_u8")
    assert "was not built into build/torch_native/" in (
        capsys.readouterr().err)


def test_train_resnet_leg_b_passes_and_fails_on_changed_stats(
        baseline_smoke, monkeypatch, capsys):
    """ResNet-20's leg on the CPU (the ResNet-50 leg replaced by a stub
    run): the restored batch_stats equal the trained ones, the eval reads
    them; a restore that changed them fails."""
    monkeypatch.setattr(cs, "TRAIN_RESNET50_ARGV", cs.TRAIN_RESNET20_ARGV)
    monkeypatch.setattr(cs, "profiled", lambda torch, argv, steps=0: {})
    cs.phase_train_resnet([], baseline_smoke)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["eval_rel_diff"] <= cs.TOL_EVAL_STATS
    assert line["batch_stats_tensors"] == 2 * 21  # 21 BN layers
    import torch

    a = {"bn.mean": torch.zeros(3), "bn.var": torch.ones(3)}
    cs.stats_check(torch, a, {k: v.clone() for k, v in a.items()}, "x")
    b = dict(a, **{"bn.var": torch.ones(3) + 1e-7})
    with pytest.raises(SystemExit):
        cs.stats_check(torch, a, b, "train_resnet")
    assert "batch_stats differ after the restore" in capsys.readouterr().err


def test_ce_cases_hold_bert_s_masked_head():
    """ce_kernels holds B4-B6 at the shape the fused BERT leg gives them:
    T = batch x seq, D 768, the table sliced to V 30522, no bias, a 0/1
    weight on 15% of the rows."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    fused = parse_args(cs.TRAIN_BERT_FUSED_ARGV)
    case = dict(T=fused.batch_size * fused.seq_len, D=768,
                V=fused.synthetic_vocab, bias=False, eps=0.0, mask=0.15)
    assert case in cs.CE_CASES and case["T"] == fused.ce_chunk
    assert cs.CE_CASES[0] == cs.CE_MAIN  # the timed case stays the GPT's


@pytest.mark.parametrize("gap,ok", [(0.005, True), (0.02, False)])
def test_train_bert_holds_the_fused_first_loss_to_the_dense(
        gap, ok, monkeypatch, capsys):
    import types

    import numpy as np

    from tensorflow_distributed_tpu_torch.train import tasks

    task = types.SimpleNamespace(train_stream=lambda seed: iter(
        [{"mask": np.array([1.0, 0.0, 0.0, 0.0])}]))
    monkeypatch.setattr(tasks, "make_task", lambda cfg: task)
    monkeypatch.setattr(cs, "flash_launch_check", lambda *a: None)
    monkeypatch.setattr(cs, "bert_kernel_times", lambda *a: {})
    runs = iter([10.3, 10.3 + gap])

    def run_train(kernels, torch, phase, argv, beside=None):
        return {"first_loss": next(runs), "tokens_per_s": 1.0,
                "step_ms_median": 1.0, "peak_mem_bytes": 0,
                "last5_mean_loss": 9.0, "train_launches": {}}

    monkeypatch.setattr(cs, "run_train", run_train)
    if ok:
        cs.phase_train_bert(fa, [], None)
        line = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert line["masked_share_first_batch"] == 0.25
        return
    with pytest.raises(SystemExit):
        cs.phase_train_bert(fa, [], None)
    assert "the fused leg's first loss" in capsys.readouterr().err


def test_train_cnn_u8_fails_on_a_gather_off_by_an_ulp(baseline_smoke,
                                                      monkeypatch, capsys):
    """Every native gather is held bit for bit to numpy's u8 * f32(scale)
    of the same rows: one value an ulp off fails the phase."""
    import numpy as np

    from tensorflow_distributed_tpu_torch.native import runtime as native

    real = native.gather_u8_f32

    def off(src, idx, scale, *a, **kw):
        out = real(src, idx, scale, *a, **kw)
        out.flat[7] = np.nextafter(out.flat[7], np.float32(2.0))
        return out

    monkeypatch.setattr(native, "gather_u8_f32", off)
    with pytest.raises(SystemExit):
        cs.phase_train_cnn_u8([], baseline_smoke)
    assert "native gather 0 differs from numpy's" in capsys.readouterr().err


@pytest.mark.parametrize("fault", ["none", "branch_bn_reads_averages"])
def test_model_resnet_gates_train_mode_through_live_branches(
        fault, baseline_smoke, monkeypatch, capsys):
    """The phase at ResNet-20's size on the CPU (32 x 32): it passes, and
    a fault in the card's train-mode BN of the residual branches' last
    layers (the running averages read in place of the batch statistics)
    fails the f32 live-branch gate, though at the init weights (zero
    scales) and in eval mode the outputs are unchanged."""
    from tensorflow_distributed_tpu_torch.models import resnet as tresnet

    made = []

    def factory(compute_dtype):
        model = tresnet.resnet20(num_classes=10, compute_dtype=compute_dtype)
        if made and fault != "none":  # the "card's" models
            for bn in model.modules():
                if isinstance(bn, tresnet.BatchNorm) and bn.zero_scale:
                    bn.forward = (lambda x, train, bn=bn:
                                  tresnet.BatchNorm.forward(bn, x, False))
        made.append(model)
        return model

    monkeypatch.setattr(tresnet, "resnet50", factory)
    monkeypatch.setattr(cs, "MODEL_RESNET_IMAGE", 32)
    if fault == "none":
        cs.phase_model_resnet(baseline_smoke, __import__("numpy"))
        line = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert line["train_random_bn_f32_rel_err"] <= cs.TOL_RESNET_F32
        assert len(made) == 3
        return
    with pytest.raises(SystemExit):
        cs.phase_model_resnet(baseline_smoke, __import__("numpy"))
    err = capsys.readouterr().err
    assert "train mode through the live branches in f32" in err

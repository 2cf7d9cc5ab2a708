"""PyTorch port: ``chip_smoke.py``'s tables and build checks, on the CPU.

The smoke runs only on a card, so what it holds the build to is checked
here: every Hopper kernel it lists is a ``__global__`` function of the
source it names; ``REPLACES`` names exactly the port's kernels, each at
the line of a Pallas kernel function of the JAX package (read as text:
this file imports no JAX); and the ptxas checks catch a spill and a
serialized wgmma.
"""

import importlib.util
import json
import os
import re

import pytest

from tensorflow_distributed_tpu_torch.ops import flash_attention as fa
from tensorflow_distributed_tpu_torch.ops import fused_ce_kernel as fce

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()
GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def _globals(path):
    with open(os.path.join(REPO, path)) as f:
        return set(GLOBAL.findall(f.read()))


@pytest.mark.parametrize("kernel", sorted(cs.HOPPER_KERNELS))
def test_hopper_kernel_is_a_global_function_of_its_source(kernel):
    """Each key names a ``__global__`` of its library's source; a
    "<partial>" key, a kernel templated on the PARTIAL flag."""
    library = cs.HOPPER_KERNELS[kernel]
    assert library in cs.SOURCES
    base, _, form = kernel.partition("<")
    assert base in _globals(cs.SOURCES[library])
    if form:
        text = _source(library)
        head = text[:text.index(f"\n{base}(")]
        assert head.rstrip().splitlines()[-2].startswith(
            "template <int D, bool PARTIAL>")


@pytest.mark.parametrize("name,key", [
    ("_ZN12_GLOBAL__N_13hdq15flash_dq_hopperILi64ELb1EEEv14CUtensorMap_st",
     "flash_dq_hopper<partial>"),
    ("_ZN12_GLOBAL__N_13hdq15flash_dq_hopperILi128ELb0EEEv14CUtensorMap_st",
     "flash_dq_hopper"),
    ("_ZN12_GLOBAL__N_14hdkv16flash_dkv_hopperILi128ELb1EEEv14CUtensorMap_st",
     "flash_dkv_hopper<partial>"),
    ("_ZN12_GLOBAL__N_14hfwd16flash_fwd_hopperILi64ELb0EEEv14CUtensorMap_st",
     "flash_fwd_hopper"),
    ("_ZN12_GLOBAL__N_14hfwd16flash_fwd_hopperILi128ELb1EEEv14CUtensorMap_st",
     "flash_fwd_hopper<partial>"),
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb1EEEvPK13__nv_bfloat16",
     None)])
def test_mangled_names_map_to_their_hopper_instance(name, key):
    assert cs.hopper_instance(name) == key


def _source(library):
    with open(os.path.join(REPO, cs.SOURCES[library])) as f:
        return f.read()


def test_fused_ce_has_no_wmma_or_cp_async_left():
    """All three fused-CE kernels run on the Hopper header: the WMMA and
    cp.async helpers of the first forward are gone."""
    text = _source("fused_ce")
    for gone in ("<mma.h>", "wmma::", "nvcuda", "cp.async", "cp_async",
                 "logits_tile", "load_block", "Tile<"):
        assert gone not in text, gone


def test_normalized_dq_is_the_hopper_kernel():
    """tfd_flash_dq launches flash_dq_hopper (no WMMA in its namespace),
    the normalized instantiation; the WMMA dQ kernel is gone."""
    text = _source("flash_attention")
    hdq = text[text.index("namespace hdq {"):
               text.index("}  // namespace hdq")]
    assert "wmma::" not in hdq and "mm_abt" not in hdq
    assert "__global__" in hdq and "flash_dq_hopper" in hdq
    entry = text[text.index('extern "C" int tfd_flash_dq('):]
    entry = entry[:entry.index("\n}\n")]
    assert "hdq::launch, false" in entry and "launch_dq" not in entry
    assert "flash_dq_kernel" not in text


@pytest.mark.parametrize("name,namespace", [("fwd", "hfwd"), ("dq", "hdq"),
                                            ("dkv", "hdkv")])
def test_partial_backward_launches_the_hopper_kernel(name, namespace):
    """tfd_flash_{fwd,dq,dkv}_partial launch the PARTIAL instantiation
    of the Hopper kernel (B7, B8, B9), whose namespace holds no WMMA."""
    text = _source("flash_attention")
    ns = text[text.index(f"namespace {namespace} {{"):
              text.index(f"}}  // namespace {namespace}")]
    assert "wmma::" not in ns and "tma_load_3d" in ns
    entry = text[text.index(f'extern "C" int tfd_flash_{name}_partial('):]
    entry = entry[:entry.index("\n}\n")]
    assert f"{namespace}::launch, true" in entry


def test_no_wmma_is_left_in_flash_attention():
    """All six attention kernels run on the Hopper header: the WMMA
    forward and backward, and the helpers only they used, are gone."""
    text = _source("flash_attention")
    for gone in ("wmma::", "<mma.h>", "nvcuda", "flash_fwd_kernel",
                 "launch_fwd", "fwd_smem", "load_tile", "mm_abt",
                 "warp_max", "warp_sum", "kv_range", "FragA", "FragB",
                 "FragC", "flash_dq_kernel", "flash_dkv_kernel",
                 "launch_dq", "launch_dkv", "dq_smem", "dkv_smem",
                 "load_dout", "q_range", "mm_ab_acc", "store_rows"):
        assert gone not in text, gone
    for name in ("BQ", "BK", "WARPS", "THREADS"):
        assert not re.search(rf"^constexpr int {name} =", text, re.M), name


def test_sass_counts_group_the_library_by_hopper_instance(monkeypatch):
    """One cuobjdump of a library gives each Hopper instance's counts
    and, under None, its other functions' (the library-wide HMMA
    check)."""
    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN12_GLOBAL__N_14hfwd16flash_fwd_hopperILi64ELb1EEEv",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;",
        "        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24 ;",
        "        /*0020*/              @P0  SYNCS.ARRIVE.TRANS64 RZ ;",
        "        /*0030*/                   UTMALDG.3D [UR8], [UR4] ;",
        "\t\tFunction : _ZN12_GLOBAL__N_14hfwd16flash_fwd_hopperILi128ELb1EEEv",
        "        /*0000*/                   HGMMA.64x128x16.F32.BF16 R24 ;",
        "\t\tFunction : _Z3fooPf",
        "        /*0000*/                   HMMA.16816.F32.BF16 R4, R8 ;"])
    from tensorflow_distributed_tpu_torch.ops import cuda_ext

    monkeypatch.setattr(cuda_ext, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(cs.os.path, "exists", lambda path: True)
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": sass})())
    got = cs.sass_counts("libflash_attention.so")
    assert got == {
        "flash_fwd_hopper<partial>": {"HGMMA": 2, "UTMALDG": 1, "SYNCS": 1,
                                      "HMMA": 0},
        None: {"HGMMA": 0, "UTMALDG": 0, "SYNCS": 0, "HMMA": 1}}


def test_every_library_of_the_kernels_has_a_source():
    kernels = fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS
    assert {k.library for k in kernels} == set(cs.SOURCES)
    for path in cs.SOURCES.values():
        assert os.path.exists(os.path.join(REPO, path))


def test_replaces_names_exactly_the_ports_kernels():
    kernels = fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS
    assert set(cs.REPLACES) == {k.name for k in kernels}
    assert len(kernels) == 9


@pytest.mark.parametrize("name", sorted(cs.REPLACES))
def test_replaces_points_at_a_pallas_kernel_function(name):
    path, line = cs.REPLACES[name].rsplit(":", 1)
    assert path.startswith("tensorflow_distributed_tpu/ops/")
    with open(os.path.join(REPO, path)) as f:
        text = f.read().splitlines()[int(line) - 1]
    assert re.match(r"def _\w*kernel\(", text), text


@pytest.mark.parametrize("code", [f"C751{i}" for i in range(6)])
def test_build_check_catches_serialized_wgmma(code):
    log = (f"ptxas warning : ({code}) Potential Performance Loss: "
           f"wgmma.mma_async instructions are serialized")
    assert cs.WGMMA_SERIALIZED.search(log)


@pytest.mark.parametrize("code", ["C7509", "C7516", "C75150"])
def test_build_check_ignores_other_warnings(code):
    assert not cs.WGMMA_SERIALIZED.search(f"ptxas warning : ({code}) other")


def test_build_check_catches_a_spill():
    clean = ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
             "ptxas info    : Used 168 registers, used 16 barriers"]
    assert not cs.spills(clean)
    assert cs.spills(["24 bytes stack frame, 20 bytes spill stores, "
                      "0 bytes spill loads"])
    assert cs.spills(["0 bytes stack frame, 0 bytes spill stores, "
                      "100 bytes spill loads"])


def test_ptxas_lines_are_grouped_by_kernel():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 1 barriers",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"])
    got = cs.ptxas_by_kernel(log)
    assert sorted(got) == ["_Z3barPf", "_Z3fooPf"]
    assert not cs.spills(got["_Z3fooPf"]) and cs.spills(got["_Z3barPf"])


def test_new_phases_run_after_the_ring_in_order():
    """model_cnn, train_cnn and train_data run after every earlier phase
    (train_ring last of those), then the serving phases (decode,
    serve_identity, serve), then the checkpoint phases (checkpoint,
    eval, generate, serve_checkpoint), then the Llama-style phases
    (model_llama, train_llama, train_window, decode_llama, serve_llama),
    before the kernels line."""
    import inspect

    src = inspect.getsource(cs.main)
    order = ["phase_device(", "phase_build(", "phase_kernels(",
             "phase_ce_kernels(", "phase_model(", "phase_model_fused(",
             "phase_train(", "phase_train_fused(", "phase_step_profile(",
             "phase_ring_kernels(", "phase_ring(", "phase_train_ring(",
             "phase_model_cnn(", "phase_train_cnn(", "phase_train_data(",
             "phase_decode(", "phase_serve_identity(", "phase_serve(",
             "phase_checkpoint(", "phase_eval(", "phase_generate(",
             "phase_serve_checkpoint(", "phase_model_llama(",
             "phase_train_llama(", "phase_train_window(",
             "phase_decode_llama(", "phase_serve_llama(", 'emit({"kernels"']
    at = [src.index(call) for call in order]
    assert at == sorted(at)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 8])
def test_train_data_argv_parses(count):
    """Every run's argv and its one-card twin parse: the same global
    batch, 8 GPT rows a data rank, the mesh only in the torchrun argv."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    runs = cs.data_runs(count)
    n = min(count, 4)
    assert [r[0] for r in runs] == (["mnist_cnn", "gpt_lm"]
                                    + (["gpt_lm_seq"] if n == 4 else []))
    for name, nproc, argv, one_argv, must_launch in runs:
        cfg, one = parse_args(argv), parse_args(one_argv)
        assert cfg.mesh.data * cfg.mesh.seq == nproc
        assert (one.mesh.data, one.mesh.seq) == (-1, 1)
        assert cfg.batch_size == one.batch_size
        assert cfg.dropout_rate == 0.0 and cfg.train_steps == 5
        if name.startswith("gpt"):
            assert cfg.batch_size // cfg.mesh.data == 8
            assert set(must_launch) >= {"fused_ce_fwd", "fused_ce_dx",
                                        "fused_ce_dw"}
        assert set(must_launch) <= set(cs.REPLACES)


def test_one_card_still_runs_torchrun(monkeypatch):
    """With one card train_data is a torchrun of one process, not a
    skip: the first run goes to torchrun with one process."""
    calls = []

    class Stop(Exception):
        pass

    def fake_run(phase, nproc, argv, timeout):
        calls.append((nproc, argv))
        raise Stop

    torch_one = type("T", (), {"cuda": type("C", (), {
        "device_count": staticmethod(lambda: 1)})})
    monkeypatch.setattr(cs, "run_torchrun", fake_run)
    with pytest.raises(Stop):
        cs.phase_train_data(torch_one)
    assert calls[0][0] == 1 and "--mesh.data" in calls[0][1]
    line = cs.torchrun_command(1, "/out", ["--model", "mnist_cnn"])
    assert line[1:3] == ["-m", "torch.distributed.run"]
    assert "--nproc-per-node=1" in line
    assert line[-4:] == ["--rank", "/out", "--model", "mnist_cnn"]


def test_accuracy_bar_asserts_the_fixture_is_real(tmp_path, monkeypatch):
    from tensorflow_distributed_tpu_torch.config import parse_args

    cs.check_fixture(cs.FIXTURE_DIR)
    with pytest.raises(SystemExit):
        cs.check_fixture(str(tmp_path))  # the synthetic fall-back fails
    cfg = parse_args(cs.TRAIN_CNN_ARGV)
    assert (cfg.model, cfg.dataset, cfg.data_dir) == (
        "mnist_cnn", "mnist", cs.FIXTURE_DIR)
    assert (cfg.validation_size, cfg.batch_size, cfg.train_steps,
            cfg.learning_rate) == (64, 64, 50, 2e-3)
    seen = []
    monkeypatch.setattr(cs, "check_fixture", seen.append)
    monkeypatch.setattr(cs, "run_train", lambda *a: (_ for _ in ()).throw(
        SystemExit(0)))
    with pytest.raises(SystemExit):
        cs.phase_train_cnn([], None)
    assert seen == [cs.FIXTURE_DIR]  # checked before the run


@pytest.mark.parametrize("script", ["torch_multicard.py", "torch_cnn_bar.py"])
def test_card_scripts_fail_without_a_gpu(script):
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "FAILED" in out.stderr
    assert out.stdout == ""


# --- the serving phases (decode, serve_identity, serve) ---------------

def test_serve_argv_is_the_full_width_cli_run():
    """The serve phase runs exactly GPT-2-small's full-width CLI call:
    bf16 on the card, 8 slots, 32 requests of 64-512 prompt tokens, 64
    new tokens each, the 50257-token vocabulary and a 1024 cache."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    assert cs.SERVE_ARGV == [
        "--mode", "serve", "--model", "gpt_lm", "--model-size", "small",
        "--synthetic-vocab", "50257", "--seq-len", "1024",
        "--serve.num-slots", "8", "--serve.num-requests", "32",
        "--serve.prompt-len-min", "64", "--serve.prompt-len-max", "512",
        "--serve.max-new-tokens", "64"]
    cfg = parse_args(cs.SERVE_ARGV)
    assert (cfg.mode, cfg.device, cfg.compute_dtype) == (
        "serve", "cuda", "bfloat16")
    assert (cfg.serve.num_requests * cfg.serve.max_new_tokens
            == cs.SERVE_REQUESTS * cs.SERVE_NEW == 32 * 64)
    assert cs.DECODE_PROMPTS == (17, 100, 300, 511)
    assert cs.DECODE_STEPS == 16 and cs.TOL_DECODE == 2e-2
    assert (cs.IDENTITY_SLOTS, cs.IDENTITY_REQUESTS, cs.IDENTITY_NEW,
            cs.IDENTITY_PROMPTS, cs.IDENTITY_GAP) == (4, 12, 32, (8, 480),
                                                      1e-4)


@pytest.mark.parametrize("got,ref,want", [
    ([1, 2, 3], [1, 2, 3], None), ([1, 2, 3], [1, 5, 3], 1),
    ([9, 2], [1, 2], 0), ([1, 2], [1, 2, 3], 2)])
def test_first_mismatch(got, ref, want):
    assert cs.first_mismatch(got, ref) == want


@pytest.fixture
def tiny_smoke(monkeypatch):
    """The serving phases on the CPU at a tiny size (a 2-layer GPT with
    head dim 64), as a rehearsal of their code paths and failures."""
    import torch

    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    def tiny(torch_mod, dtype, **overrides):
        model = gpt_lm("tiny", compute_dtype=dtype, d_model=128, n_heads=2,
                       d_ff=256, max_len=256, vocab_size=500, **overrides)
        model.init_weights(torch.Generator().manual_seed(0))
        return model

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    # Two heads: the Llama-style options with one K/V head (MQA).
    monkeypatch.setattr(cs, "LLAMA_OPTS", dict(cs.LLAMA_OPTS, n_kv_heads=1))
    monkeypatch.setattr(cs, "gpt2_small", tiny)
    monkeypatch.setattr(cs, "DECODE_PROMPTS", (17, 40, 70, 101))
    monkeypatch.setattr(cs, "DECODE_STEPS", 3)
    monkeypatch.setattr(cs, "IDENTITY_PROMPTS", (8, 60))
    monkeypatch.setattr(cs, "IDENTITY_REQUESTS", 4)
    monkeypatch.setattr(cs, "IDENTITY_NEW", 6)
    return torch


def test_decode_fails_when_the_oracle_does_not_run_b1(tiny_smoke, capsys):
    """On the CPU the oracle's attention is B1's plain version, which
    launches nothing: the phase reports agreeing logits and fails on the
    launch count, as it must on a card where B1 did not run."""
    import numpy as np

    with pytest.raises(SystemExit):
        cs.phase_decode(fa, tiny_smoke, np)
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert line["phase"] == "decode" and len(line["rel_err_by_step"]) == 4
    assert line["max_rel_err"] <= cs.TOL_DECODE
    assert "did not run B1" in err


def test_serve_identity_passes_and_fails_on_a_real_mismatch(
        tiny_smoke, monkeypatch, capsys):
    import numpy as np

    from tensorflow_distributed_tpu_torch.models import generate as gen

    cs.phase_serve_identity(tiny_smoke, np)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["identical"] == 4 and line["excused"] == []
    assert line["buckets_used"] <= len(line["ladder"])
    real = gen.generate

    def off_by_one(model, prompt, n, **kw):
        out = real(model, prompt, n, **kw)
        out[0, 2] = (out[0, 2] + 1) % model.cfg.vocab_size
        return out

    monkeypatch.setattr(gen, "generate", off_by_one)
    with pytest.raises(SystemExit):
        cs.phase_serve_identity(tiny_smoke, np)
    assert "differs from generate() at step 2" in capsys.readouterr().err


@pytest.mark.parametrize("fault", ["tokens", "exit", "no_summary"])
def test_serve_phase_failure_paths(fault, tiny_smoke, monkeypatch, capsys):
    """The serve phase fails when a token is missing, when the CLI exits
    non-zero, or when it prints no summary."""
    from tensorflow_distributed_tpu_torch import cli

    summary = {"tokens_per_sec": 1.0, "ttft_ms_p50": 1.0, "ttft_ms_p95": 1.0,
               "tok_ms_mean": 1.0, "mean_slot_occupancy": 1.0,
               "buckets": "64", "prefill_compiles": 1, "decode_steps": 1,
               "total_new_tokens": 32 * 64 - (fault == "tokens"),
               "wall_s": 1.0}

    def fake_main(argv):
        print("[serve] 32 requests")
        if fault != "no_summary":
            print(json.dumps({"event": "serve_summary", **summary}))
        return 1 if fault == "exit" else 0

    monkeypatch.setattr(cli, "main", fake_main)
    monkeypatch.setattr(cs, "serve_profile", lambda torch, argv: {})
    for name in ("reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(tiny_smoke.cuda, name, lambda *a: 0)
    with pytest.raises(SystemExit):
        cs.phase_serve(tiny_smoke)
    err = capsys.readouterr().err
    assert ("tokens delivered" if fault == "tokens"
            else "without its summary") in err


# --- the checkpoint phases (checkpoint, eval, generate, serve_checkpoint) --

def test_checkpoint_argvs_are_the_full_width_runs():
    """GPT-2-small at seq 1024 throughout: the fused run with dropout
    0.25 saving at step 3 of 6, the dense bf16 eval at batch 8, generate
    and serve in f32 (8 requests, 4 slots, 16 new tokens)."""
    from tensorflow_distributed_tpu_torch.config import parse_args

    d = ["--checkpoint-dir", "/ckpt"]
    train = parse_args(cs.CHECKPOINT_ARGV + ["--train-steps", "6"] + d)
    assert (train.model_size, train.seq_len, train.batch_size) == (
        "small", 1024, 8)
    assert (train.ce_chunk, train.ce_impl, train.dropout_rate) == (
        8192, "kernel", 0.25)
    assert (cs.CHECKPOINT_STEPS, cs.CHECKPOINT_EVERY, cs.TOL_RESUME) == (
        6, 3, 1e-5)
    ev = parse_args(cs.EVAL_ARGV + d)
    assert (ev.mode, ev.ce_chunk, ev.compute_dtype, ev.eval_batch_size) == (
        "eval", 0, "bfloat16", 8)
    gen = parse_args(cs.GENERATE_ARGV + d + ["--prompt", "1"])
    assert (gen.mode, gen.compute_dtype, gen.max_new_tokens) == (
        "generate", "float32", cs.GENERATE_NEW)
    serve = parse_args(cs.SERVE_CKPT_ARGV + d)
    assert (serve.serve.num_requests, serve.serve.num_slots,
            serve.serve.max_new_tokens, serve.compute_dtype) == (
        8, 4, 16, "float32")
    for cfg in (train, ev, gen, serve):
        assert (cfg.model_size, cfg.seq_len, cfg.device) == (
            "small", 1024, "cuda")


TINY_CKPT = ["--model", "gpt_lm", "--model-size", "tiny", "--seq-len", "64",
             "--device", "cpu"]


@pytest.fixture
def ckpt_smoke(monkeypatch, tmp_path):
    """The checkpoint phases on the CPU at a tiny size, with a tiny
    checkpoint of 2 steps under ``tmp_path / "ckpt"``; the resumed leg
    runs in this process (returning the launch counts it is given)."""
    import torch

    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.train.loop import train
    from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger

    # One intra-op thread: these tiny models run hundreds of small ops
    # a step, which threads only slow down when workers share the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "CHECKPOINT_ARGV", [
        "--mode", "train", *TINY_CKPT, "--batch-size", "8", "--eval-every",
        "0", "--eval-batch-size", "8", "--compute-dtype", "float32",
        "--log-every", "1", "--ce-chunk", "32", "--ce-impl", "kernel",
        "--dropout-rate", "0.25"])
    monkeypatch.setattr(cs, "EVAL_ARGV", [
        "--mode", "eval", *TINY_CKPT, "--eval-batch-size", "8",
        "--compute-dtype", "float32"])
    monkeypatch.setattr(cs, "GENERATE_NEW", 6)
    monkeypatch.setattr(cs, "GENERATE_PROMPT_LEN", 8)
    monkeypatch.setattr(cs, "GENERATE_ARGV", [
        "--mode", "generate", *TINY_CKPT, "--compute-dtype", "float32",
        "--max-new-tokens", "6"])
    monkeypatch.setattr(cs, "SERVE_CKPT_ARGV", [
        "--mode", "serve", *TINY_CKPT, "--synthetic-vocab", "64",
        "--compute-dtype", "float32", "--serve.num-slots", "2",
        "--serve.num-requests", "3", "--serve.prompt-len-min", "4",
        "--serve.prompt-len-max", "12", "--serve.max-new-tokens", "5",
        "--serve.stream", "true"])
    launches = {kern.name: 0 for kern in cs_kernels()}

    def in_process(phase, nproc, argv, timeout):
        result = train(parse_args(argv), logger=MetricLogger(enabled=False))
        return 0.0, [{"losses": cs.train_losses(result),
                      "launches": dict(launches)}], [""]

    monkeypatch.setattr(cs, "run_torchrun", in_process)
    ckpt = tmp_path / "ckpt"
    train(parse_args(cs.CHECKPOINT_ARGV + [
        "--train-steps", "2", "--checkpoint-dir", str(ckpt)]),
        logger=MetricLogger(enabled=False))
    yield torch, str(ckpt), launches
    torch.set_num_threads(threads)


CARD_LAUNCHES = {"fused_ce_fwd": 3, "fused_ce_dx": 3, "fused_ce_dw": 3,
                 "flash_dq": 36, "flash_dkv": 36, "flash_fwd": 48}


@pytest.mark.parametrize("fault", ["none", "cpu", "diverged"])
def test_checkpoint_phase_passes_and_fails(fault, ckpt_smoke, tmp_path,
                                           monkeypatch, capsys):
    """Straight vs split-and-resumed, bit for bit on the CPU, and the
    save/restore round trip; the phase fails where the kernels did not
    launch (as on the CPU) and where a resumed loss moves."""
    torch, _, launches = ckpt_smoke
    if fault != "cpu":
        launches.update(CARD_LAUNCHES)
    if fault == "diverged":
        real = cs.train_losses
        monkeypatch.setattr(cs, "train_losses", lambda r: [
            x * (1 + 1e-4) for x in real(r)] if r.state.step == 6
            and r.logger.records[0].step == 4 else real(r))
    d = tmp_path / "phase"
    if fault == "none":
        cs.phase_checkpoint([], torch, str(d))
    else:
        with pytest.raises(SystemExit):
            cs.phase_checkpoint([], torch, str(d))
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert line["phase"] == "checkpoint" and line["roundtrip_equal"]
    assert line["steps_saved"] == [3, 6]
    assert line["step_dir_bytes"] > line["param_bytes"] > 0
    if fault == "diverged":
        assert "left the straight one" in err
    else:
        assert line["bit_identical"] and line["max_rel_diff"] == 0.0
    if fault == "cpu":
        assert "did not run B1-B6" in err


def test_eval_phase_fails_when_b1_does_not_run(ckpt_smoke, capsys):
    """On the CPU B1 launches nothing: the CLI's val_loss agrees with the
    in-process evaluate(), and the phase fails on the launch gate."""
    torch, ckpt, _ = ckpt_smoke
    with pytest.raises(SystemExit):
        cs.phase_eval(cs_kernels(), torch, ckpt)
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert line["phase"] == "eval" and line["rel_diff"] <= cs.TOL_EVAL
    assert line["eval_batches"] == 64 and line["record"]["step"] == 2
    assert "did not run B1" in err


def cs_kernels():
    return fa.KERNELS + fce.KERNELS + fa.PARTIAL_KERNELS


def test_generate_phase_passes_and_fails_on_a_real_mismatch(
        ckpt_smoke, monkeypatch, capsys):
    import numpy as np

    from tensorflow_distributed_tpu_torch.models import generate as gen

    torch, ckpt, _ = ckpt_smoke
    cs.phase_generate(torch, np, ckpt)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["greedy_identical"] and line["one_beam_identical"]
    assert line["beams"] == 4 and np.isfinite(line["beam_score"])
    real = gen.generate

    def off_by_one(model, prompt, n, **kw):
        out = real(model, prompt, n, **kw)
        out[0, 1] = (out[0, 1] + 1) % model.cfg.vocab_size
        return out

    monkeypatch.setattr(gen, "generate", off_by_one)
    with pytest.raises(SystemExit):
        cs.phase_generate(torch, np, ckpt)
    assert "differs from generate() at step 1" in capsys.readouterr().err


@pytest.mark.parametrize("fault", ["none", "fresh"])
def test_serve_checkpoint_phase_passes_and_fails_on_fresh_params(
        fault, ckpt_smoke, monkeypatch, capsys):
    torch, ckpt, _ = ckpt_smoke
    if fault == "fresh":
        real = cs.serve_cli

        def fresh(argv):
            rc, line, summary, out = real(argv)
            return rc, line, dict(summary, params="fresh-init"), out

        monkeypatch.setattr(cs, "serve_cli", fresh)
        with pytest.raises(SystemExit):
            cs.phase_serve_checkpoint(torch, ckpt)
        assert "served fresh-init params" in capsys.readouterr().err
        return
    cs.phase_serve_checkpoint(torch, ckpt)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["params"] == "checkpoint" and line["excused"] == []
    assert line["identical"] == line["requests"] == 3
    assert line["summary_line"].startswith("[serve] 3 requests")
    assert line["total_new_tokens"] == 15


# --- the Llama-style phases (model_llama, train_llama, train_window,
# decode_llama, serve_llama) ----------------------------------------------

def test_llama_argvs_are_the_full_width_runs():
    """train_llama is train_fused's run with the Llama-style flags at
    GPT-2-small's widths (~142M params tied); train_window is 8192 tokens
    a step at seq 4096 under a 512 window with remat and Adafactor, and
    its control only drops remat and shortens the run."""
    import torch

    from tensorflow_distributed_tpu_torch.config import parse_args
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    cfg = parse_args(cs.TRAIN_LLAMA_ARGV)
    assert (cfg.pos_emb, cfg.n_kv_heads, cfg.mlp_variant, cfg.norm,
            cfg.tie_embeddings, cfg.ce_chunk, cfg.ce_impl) == (
        "rope", 4, "swiglu", "rmsnorm", True, 8192, "kernel")
    assert (cfg.model_size, cfg.seq_len, cfg.batch_size, cfg.train_steps) == (
        "small", 1024, 8, 30)
    with torch.device("meta"):
        model = gpt_lm("small", **cs.LLAMA_OPTS)
    assert 142e6 < sum(p.numel() for p in model.parameters()) < 143e6
    win = parse_args(cs.TRAIN_WINDOW_ARGV)
    assert (win.seq_len * win.batch_size, win.attn_window, win.pos_emb,
            win.remat, win.optimizer, win.train_steps) == (
        8192, 512, "rope", "full", "adafactor", 20)
    ctl = parse_args(cs.with_flags(cs.TRAIN_WINDOW_ARGV, remat="none",
                                   train_steps=cs.WINDOW_CONTROL_STEPS))
    assert (ctl.remat, ctl.train_steps) == ("none", 3)
    assert ({k: v for k, v in vars(ctl).items()
             if k not in ("remat", "train_steps")}
            == {k: v for k, v in vars(win).items()
                if k not in ("remat", "train_steps")})


def _window_rec(steps, b1_per_step, peak):
    launches = {k.name: 0 for k in cs_kernels()}
    launches.update(flash_fwd=b1_per_step * steps, flash_dq=12 * steps,
                    flash_dkv=12 * steps)
    return {"steps": steps, "train_launches": launches,
            "train_peak_mem_bytes": peak, "step_ms_median": 1.0}


@pytest.mark.parametrize("fault", ["none", "no_recompute", "no_saving",
                                   "control_recomputes", "dots_saves_b1"])
def test_train_window_passes_and_fails(fault, monkeypatch, capsys):
    """The checks of train_window on run records: it fails where B1 did
    not run twice a step under remat (full or dots), where remat saved no
    memory, and where the control still recomputed."""
    runs = []

    def fake_run(kernels, torch, phase, argv, beside=None):
        runs.append((phase, argv))
        if phase == "train_window":
            return _window_rec(20, 12 if fault == "no_recompute" else 24,
                               5 * 2 ** 30)
        if phase == "train_window_dots":
            return _window_rec(3, 12 if fault == "dots_saves_b1" else 24,
                               7 * 2 ** 30)
        return _window_rec(3, 24 if fault == "control_recomputes" else 12,
                           4 * 2 ** 30 if fault == "no_saving"
                           else 9 * 2 ** 30)

    monkeypatch.setattr(cs, "run_train", fake_run)
    if fault == "none":
        cs.phase_train_window([], None)
        line = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert line["phase"] == "train_window_memory"
        assert line["saved_bytes"] == 4 * 2 ** 30
        assert [r[0] for r in runs] == ["train_window", "train_window_dots",
                                        "train_window_control"]
        assert "dots" in runs[1][1] and "none" in runs[2][1]
        return
    with pytest.raises(SystemExit):
        cs.phase_train_window([], None)
    err = capsys.readouterr().err
    assert {"no_recompute": "not recomputed",
            "no_saving": "remat saved no memory",
            "control_recomputes": "without remat, not 12 a step",
            "dots_saves_b1": "not 24 and 12 a step"}[fault] in err


@pytest.mark.parametrize("fault", ["none", "ce", "ring", "b2"])
def test_train_llama_checks_the_launches(fault, monkeypatch, capsys):
    def fake_run(kernels, torch, phase, argv, beside=None):
        train = {k.name: 0 for k in cs_kernels()}
        train.update(flash_fwd=360, flash_dq=360 - (fault == "b2"),
                     flash_dkv=360, fused_ce_fwd=30, fused_ce_dx=30,
                     fused_ce_dw=30 - (fault == "ce"))
        total = dict(train, flash_fwd_partial=int(fault == "ring"))
        return {"steps": 30, "train_launches": train, "launches": total}

    monkeypatch.setattr(cs, "run_train", fake_run)
    if fault == "none":
        cs.phase_train_llama([], None, {})
        return
    with pytest.raises(SystemExit):
        cs.phase_train_llama([], None, {})
    err = capsys.readouterr().err
    assert {"ce": "CE kernel", "ring": "ring kernel",
            "b2": "B1-B3"}[fault] in err


def test_decode_llama_holds_the_narrow_cache_and_fails_without_b1(
        tiny_smoke, capsys):
    """On the CPU the narrow cache passes its byte check (1/2 of the MHA
    cache with one of two K/V heads), the logits agree, and the phase
    fails on B1's launch count, as it must on a card where B1 did not
    run."""
    import numpy as np

    with pytest.raises(SystemExit):
        cs.phase_decode_llama(fa, tiny_smoke, np)
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert line["phase"] == "decode_llama"
    assert line["cache_bytes"] * 2 == line["mha_cache_bytes"]
    assert line["cache_shape"] == [4, 256, 1, 64]
    assert line["max_rel_err"] <= cs.TOL_DECODE
    assert "did not run B1" in err


def test_decode_llama_fails_on_a_full_width_cache(tiny_smoke, monkeypatch,
                                                  capsys):
    """A model that dropped n_kv_heads (MHA) allocates a full-width cache:
    the phase fails on the cache's bytes."""
    import numpy as np

    real = cs.gpt2_small
    monkeypatch.setattr(cs, "gpt2_small", lambda torch, dtype, **kw: real(
        torch, dtype, **{k: v for k, v in kw.items() if k != "n_kv_heads"}))
    with pytest.raises(SystemExit):
        cs.phase_decode_llama(fa, tiny_smoke, np)
    assert "a GQA cache of full width" in capsys.readouterr().err


def test_serve_llama_passes_and_fails_on_a_real_mismatch(
        tiny_smoke, monkeypatch, capsys):
    import numpy as np

    from tensorflow_distributed_tpu_torch.models import generate as gen

    cs.phase_serve_llama(tiny_smoke, np)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "serve_llama"
    assert line["identical"] == 4 and line["excused"] == []
    # 2 layers x (K, V) x max_len 256 x 1 K/V head x Dh 64 x 4 B (f32)
    assert line["cache_bytes_per_slot"] == 2 * 2 * 256 * 1 * 64 * 4
    real = gen.generate

    def off_by_one(model, prompt, n, **kw):
        out = real(model, prompt, n, **kw)
        out[0, 3] = (out[0, 3] + 1) % model.cfg.vocab_size
        return out

    monkeypatch.setattr(gen, "generate", off_by_one)
    with pytest.raises(SystemExit):
        cs.phase_serve_llama(tiny_smoke, np)
    assert "differs from generate() at step 3" in capsys.readouterr().err

"""PyTorch port: data, losses, config and the train loop against the JAX
package.

The headline check runs the JAX ``train()`` and the port's ``train()``
for 5 steps of the tiny GPT (f32, dropout 0, same seed, the port started
from the JAX init via ``interop.params_from_flax``): the per-step losses
agree to 1e-4. The sequence-parallel run (``--mesh.seq 4``, 4 spawned
gloo ranks) is held to JAX's (data 2, seq 4) mesh and to the port's one
process. The CLI then runs end to end on the CPU.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.data import lm as jlm
from tensorflow_distributed_tpu.ops import losses as jlosses
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import (MeshConfig, TrainConfig,
                                                parse_args)
from tensorflow_distributed_tpu_torch.data import lm as tlm
from tensorflow_distributed_tpu_torch.ops import losses as tlosses
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_threads import _one_thread  # noqa: F401


TINY = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
            train_steps=5, eval_every=0, log_every=1, eval_batch_size=8,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0)


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def test_five_step_loss_trajectory_matches_jax_train():
    jcfg = JaxConfig(**TINY)
    jres = jloop.train(jcfg, logger=MetricLogger(enabled=False))
    # The JAX run's init, rebuilt the way its train() built it.
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    init = interop.params_from_flax(jax.device_get(jstate.params))

    tres = tloop.train(TrainConfig(**TINY, device="cpu"),
                       logger=MetricLogger(enabled=False), init_params=init)
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               atol=1e-4)
    assert len(_losses(tres.logger)) == 5
    np.testing.assert_allclose(tres.final_metrics["loss"],
                               jres.final_metrics["loss"], atol=1e-4)
    assert tres.state.step == 5


def test_mesh_seq_flag_spelling_and_default_match_jax():
    assert parse_args(["--mesh.seq", "4", "--device", "cpu", "--model",
                       "gpt_lm"]).mesh.seq == 4
    assert jax_parse_args(["--mesh.seq", "4"]).mesh.seq == 4
    assert TrainConfig().mesh.seq == JaxConfig().mesh.seq == 1
    for argv in (["--mesh.seq", "0"], ["--mesh.seq", "-2"]):
        with pytest.raises(ValueError, match="mesh.seq"):
            parse_args(argv + ["--device", "cpu", "--model", "gpt_lm"])
        with pytest.raises(ValueError, match="mesh.seq"):
            JaxMesh(seq=int(argv[1])).validate()


def test_mesh_seq_without_a_world_of_that_size_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    cfg = parse_args(["--mesh.seq", "4", "--device", "cpu", "--model",
                      "gpt_lm", "--model-size", "tiny", "--seq-len", "32",
                      "--batch-size", "8"])
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        tloop.train(cfg, logger=MetricLogger(enabled=False))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
        tloop.train(cfg, logger=MetricLogger(enabled=False))


def test_attn_window_with_a_ring_raises_as_in_jax():
    from tensorflow_distributed_tpu_torch.models.transformer import gpt_lm

    with pytest.raises(ValueError, match="attn_window"):
        JaxConfig(model="gpt_lm", attn_window=8,
                  mesh=JaxMesh(data=2, seq=4)).validate()
    ring = types.SimpleNamespace(size=4, index=0)
    with pytest.raises(ValueError, match="attn_window"):
        gpt_lm("tiny", ring=ring, attn_window=8)
    gpt_lm("tiny", ring=types.SimpleNamespace(size=1, index=0),
           attn_window=8)  # a ring of one is the single-device path


def test_fused_flags_parse_with_jax_spellings_and_defaults():
    cfg = parse_args(["--ce-chunk", "8192", "--ce-impl", "kernel",
                      "--tie-embeddings", "true", "--device", "cpu",
                      "--model", "gpt_lm"])
    assert (cfg.ce_chunk, cfg.ce_impl, cfg.tie_embeddings) == (
        8192, "kernel", True)
    for name in ("ce_chunk", "ce_impl", "tie_embeddings"):
        assert getattr(TrainConfig(), name) == getattr(JaxConfig(), name)


@pytest.mark.parametrize("jax_fields,argv", [
    (dict(ce_chunk=-1), ["--ce-chunk", "-1"]),
    (dict(ce_chunk=8, ce_impl="pallas"), ["--ce-chunk", "8", "--ce-impl",
                                          "pallas"]),
    (dict(ce_impl="kernel"), ["--ce-impl", "kernel"]),
    # The one-device rows of the JAX fused-CE config check: the port
    # refuses them too (flag or model not ported, or not applicable).
    (dict(ce_chunk=8192, ce_impl="kernel", shard_vocab=True),
     ["--ce-chunk", "8192", "--ce-impl", "kernel", "--shard-vocab", "true"]),
    (dict(model="pipelined_lm", ce_chunk=8192, ce_impl="kernel"),
     ["--model", "pipelined_lm", "--ce-chunk", "8192", "--ce-impl",
      "kernel"]),
    (dict(model="mnist_cnn", ce_chunk=8192),
     ["--model", "mnist_cnn", "--ce-chunk", "8192"]),
], ids=["negative_chunk", "unknown_impl", "impl_without_chunk",
        "kernel_shard_vocab", "kernel_pipelined", "chunk_non_lm"])
def test_config_rejects_what_jax_rejects(jax_fields, argv):
    with pytest.raises(ValueError):
        JaxConfig(**dict(dict(model="gpt_lm"), **jax_fields)).validate()
    with pytest.raises((ValueError, NotImplementedError, SystemExit)):
        parse_args(["--model", "gpt_lm"] + argv + ["--device", "cpu"])


def test_parse_args_spellings_and_defaults():
    cfg = parse_args(["--model", "gpt_lm", "--model-size", "small",
                      "--seq-len", "1024", "--grad-clip-norm", "1",
                      "--log-grad-norm", "true", "--device", "cpu"])
    assert (cfg.model, cfg.model_size, cfg.seq_len) == ("gpt_lm", "small",
                                                        1024)
    assert cfg.grad_clip_norm == 1.0 and cfg.log_grad_norm
    jcfg = JaxConfig()
    for name in ("dropout_rate", "batch_size", "learning_rate",
                 "eval_batch_size", "eval_every", "log_every",
                 "train_steps", "compute_dtype", "optimizer"):
        assert getattr(TrainConfig(), name) == getattr(jcfg, name), name


@pytest.mark.parametrize("argv", [["--plan", "auto"],
                                  ["--profile-dir", "/tmp/prof"],
                                  ["--check", "true"],
                                  ["--observe.metrics-jsonl", "/tmp/m"]])
def test_unported_jax_flags_are_rejected(argv, capsys):
    with pytest.raises(SystemExit):
        parse_args(argv)
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("fields", [dict(checkpoint_backend="orbax"),
                                    dict(checkpoint_async=True),
                                    dict(mode="serve",
                                         mesh=MeshConfig(seq=2)),
                                    dict(model="moe_lm",
                                         mesh=MeshConfig(seq=2)),
                                    dict(moe_experts=4,
                                         param_partition="zero1"),
                                    dict(model="moe_lm", grad_sync="serial",
                                         mesh=MeshConfig(data=2)),
                                    dict(optimizer="adafactor",
                                         mesh=MeshConfig(model=2)),
                                    dict(compute_dtype="float32"),
                                    dict(model="pipelined_lm",
                                         optimizer="adafactor",
                                         param_partition="zero1",
                                         mesh=MeshConfig(data=2, pipe=2)),
                                    dict(mode="serve",
                                         mesh=MeshConfig(data=2))])
def test_unported_values_raise(fields):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(**dict(dict(model="gpt_lm"), **fields)).validate()


def test_shared_fields_have_the_jax_defaults():
    """Every field the port's TrainConfig, MeshConfig, ServeConfig,
    ResilienceConfig and ObserveConfig share with the JAX dataclasses has
    the JAX default,
    so one bare CLI call means one job in both (the model included: the
    reference's mnist_cnn)."""
    port, ref = TrainConfig(), JaxConfig()
    shared = ({f.name for f in dataclasses.fields(TrainConfig)}
              & {f.name for f in dataclasses.fields(JaxConfig)}) - {
                  "mesh", "serve", "resilience", "observe"}
    assert {"model", "batch_size", "learning_rate", "seed", "dataset",
            "data_dir", "validation_size", "init_scheme", "grad_accum_steps",
            "ema_decay"} <= shared
    for name in sorted(shared):
        assert getattr(port, name) == getattr(ref, name), name
    mesh = ({f.name for f in dataclasses.fields(type(port.mesh))}
            & {f.name for f in dataclasses.fields(type(ref.mesh))})
    assert mesh == {"data", "seq", "model", "pipe", "expert"}
    for name in mesh:
        assert getattr(port.mesh, name) == getattr(ref.mesh, name), name
    for part in ("serve", "resilience", "observe"):
        for f in dataclasses.fields(type(getattr(port, part))):
            assert (getattr(getattr(port, part), f.name)
                    == getattr(getattr(ref, part), f.name)), f.name
    assert port.model == "mnist_cnn"


def test_cuda_device_without_cuda_fails_loudly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tloop.resolve_device("cuda")


def test_synthetic_clm_and_batches_match_jax():
    jds = jlm.synthetic_clm(n=64, seq_len=20, vocab_size=50, seed=3)
    tds = tlm.synthetic_clm(n=64, seq_len=20, vocab_size=50, seed=3)
    for f in ("tokens", "targets", "mask"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    jb = jlm.LmBatcher(jds, 16, seed=5).forever(2)
    tb = tlm.LmBatcher(tds, 16, seed=5).forever(2)
    for _ in range(6):  # crosses an epoch boundary
        a, b = next(jb), next(tb)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_masked_losses_match_jax(smoothing):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    logits[0, 0, [2, 5]] = 9.0  # a tie: both take the first max
    targets = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    targets[0, 0] = 2
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    mask[0, 0] = 1.0
    t = [torch.tensor(x) for x in (logits, targets, mask)]
    for got, want in zip(tlosses.masked_ce_sums(*t, smoothing),
                         jlosses.masked_ce_sums(logits, targets, mask,
                                                smoothing)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.masked_softmax_cross_entropy(*t, smoothing)),
        float(jlosses.masked_softmax_cross_entropy(logits, targets, mask,
                                                   smoothing)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.masked_accuracy(*t)),
        float(jlosses.masked_accuracy(logits, targets, mask)), rtol=1e-6)

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
from tensorflow_distributed_tpu_torch import cli, interop
from tensorflow_distributed_tpu_torch.config import (MeshConfig, TrainConfig,
                                                parse_args)
from tensorflow_distributed_tpu_torch.data import lm as tlm
from tensorflow_distributed_tpu_torch.ops import losses as tlosses
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from tests.conftest import FIXTURE_DIR
from torch_ring_workers import spawn_ranks, train_run

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


FUSED = {"scan": dict(ce_chunk=32, ce_impl="scan"),
         "kernel": dict(ce_chunk=32, ce_impl="kernel", label_smoothing=0.1),
         "kernel_tied": dict(ce_chunk=32, ce_impl="kernel",
                             tie_embeddings=True)}


@pytest.mark.parametrize("fused", FUSED)
def test_five_step_fused_loss_trajectory_matches_jax_train(fused):
    """The fused head+loss through train(): the JAX run (its Pallas
    kernels in interpret mode for ce_impl=kernel) and the port (the
    plain versions on the CPU), same init, 5 steps, then the final eval
    through the scan formulation."""
    fields = dict(TINY, **FUSED[fused])
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=MetricLogger(enabled=False))
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    init = interop.params_from_flax(jax.device_get(jstate.params))
    assert ("lm_head.weight" in init) != fields.get("tie_embeddings", False)

    tres = tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False), init_params=init)
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               atol=1e-4)
    assert len(_losses(tres.logger)) == 5
    np.testing.assert_allclose(tres.final_metrics["loss"],
                               jres.final_metrics["loss"], atol=1e-4)


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("tie", [False, True])
def test_fused_task_loss_and_grads_match_jax(impl, tie):
    """make_mlm_loss with ce_chunk on one batch: loss, accuracy and every
    grad against the JAX task loss on the same weights (f32)."""
    import flax.linen as fnn

    from tensorflow_distributed_tpu.models import transformer as jtr
    from tensorflow_distributed_tpu.train.tasks import (
        make_mlm_loss as jax_mlm_loss)
    from tensorflow_distributed_tpu_torch.models import transformer as ttr
    from tensorflow_distributed_tpu_torch.train.tasks import make_mlm_loss

    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 64, (2, 32)).astype(np.int32),
             "targets": rng.integers(0, 64, (2, 32)).astype(np.int32),
             "mask": (rng.random((2, 32)) < 0.8).astype(np.float32)}
    jmodel = jtr.gpt_lm(size="tiny", tie_embeddings=tie, dropout_rate=0.0)
    params = fnn.meta.unbox(jmodel.init(jax.random.key(1), batch["tokens"],
                                        train=False)["params"])
    jloss = jax_mlm_loss(0.1, ce_chunk=24, ce_impl=impl)

    def f(p):
        loss, (metrics, _) = jloss(jmodel.apply, p, {}, batch, None, False)
        return loss, metrics

    (j_loss, j_metrics), j_grads = jax.value_and_grad(f, has_aux=True)(params)
    model = ttr.gpt_lm(size="tiny", tie_embeddings=tie, dropout_rate=0.0)
    model.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    loss, metrics = make_mlm_loss(0.1, ce_chunk=24, ce_impl=impl)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               atol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(j_metrics["accuracy"]), atol=1e-6)
    want = interop.params_from_flax(jax.device_get(j_grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


def _jax_init(jcfg):
    """The JAX run's init, rebuilt the way its train() built it."""
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    return interop.params_from_flax(jax.device_get(jstate.params))


SEQ_HEADS = {"dense": {}, "fused_scan": dict(ce_chunk=32, ce_impl="scan")}


@pytest.mark.parametrize("head", SEQ_HEADS)
def test_seq4_trajectory_matches_jax_seq_mesh_and_one_process(head,
                                                              tmp_path):
    """3 steps of --mesh.seq 4 --device cpu in 4 spawned gloo ranks
    (ring attention, the global masked mean, summed gradients) from the
    JAX init: the losses equal JAX's on a (data 2, seq 4) mesh to 1e-4
    and the port's one-process run to 1e-5, and every rank ends with
    the same parameters."""
    fields = dict(TINY, train_steps=3, **SEQ_HEADS[head])
    jcfg = JaxConfig(**fields, mesh=JaxMesh(data=2, seq=4))
    jres = jloop.train(jcfg, logger=MetricLogger(enabled=False))
    init = _jax_init(jcfg)
    torch.save(init, tmp_path / "init.pt")
    spawn_ranks(train_run, 4, tmp_path, fields, tmp_path / "init.pt",
                tmp_path)
    one = tloop.train(TrainConfig(**fields, device="cpu"),
                      logger=MetricLogger(enabled=False), init_params=init)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for rank in ranks:
        assert len(rank["losses"]) == 3
        np.testing.assert_allclose(rank["losses"], _losses(jres.logger),
                                   atol=1e-4)
        np.testing.assert_allclose(rank["losses"], _losses(one.logger),
                                   atol=1e-5)
        np.testing.assert_allclose(rank["final"]["loss"],
                                   jres.final_metrics["loss"], atol=1e-4)
        for name, value in rank["params"].items():
            assert torch.equal(value, ranks[0]["params"][name]), name


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


def test_cli_trains_fused_on_cpu(capsys):
    """The tentpole command at tiny size on the CPU, with the kernels'
    plain versions."""
    argv = ["--device", "cpu", "--mode", "train", "--model", "gpt_lm",
            "--model-size", "tiny", "--ce-chunk", "32", "--ce-impl",
            "kernel", "--seq-len", "64", "--batch-size", "8",
            "--train-steps", "3", "--eval-every", "0", "--eval-batch-size",
            "8", "--log-every", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"event": "done"' in out and "val_loss" in out
    assert out.count("[step") == 3  # the final eval is in the done record


def test_cli_trains_end_to_end_on_cpu(capsys):
    argv = ["--mode", "train", "--model", "gpt_lm", "--model-size", "tiny",
            "--seq-len", "64", "--batch-size", "8", "--train-steps", "4",
            "--eval-every", "2", "--eval-batch-size", "8", "--log-every",
            "1", "--compute-dtype", "float32", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"event": "done"' in out and "val_loss" in out
    assert out.count("[step") == 4 + 2  # 4 train records, 2 eval records


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
                                         param_partition="zero1",
                                         mesh=MeshConfig(data=2, pipe=2)),
                                    dict(mode="serve",
                                         mesh=MeshConfig(data=2))])
def test_unported_values_raise(fields):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainConfig(**dict(dict(model="gpt_lm"), **fields)).validate()


def test_shared_fields_have_the_jax_defaults():
    """Every field the port's TrainConfig, MeshConfig, ServeConfig and
    ResilienceConfig share with the JAX dataclasses has the JAX default,
    so one bare CLI call means one job in both (the model included: the
    reference's mnist_cnn)."""
    port, ref = TrainConfig(), JaxConfig()
    shared = ({f.name for f in dataclasses.fields(TrainConfig)}
              & {f.name for f in dataclasses.fields(JaxConfig)}) - {
                  "mesh", "serve", "resilience"}
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
    for part in ("serve", "resilience"):
        for f in dataclasses.fields(type(getattr(port, part))):
            assert (getattr(getattr(port, part), f.name)
                    == getattr(getattr(ref, part), f.name)), f.name
    assert port.model == "mnist_cnn"


def test_bare_cli_call_refuses_the_unported_default_model(capsys):
    """The bare call now selects the ported mnist_cnn; on a machine
    without CUDA it is refused by the device, with the fix named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        cli.main([])


def test_cli_trains_mnist_cnn_on_cpu_and_prints_the_table(capsys):
    """A few steps of the reference's job on the committed fixture, then
    the chief's performance table (one row per eval)."""
    argv = ["--device", "cpu", "--data-dir", FIXTURE_DIR,
            "--validation-size", "64", "--batch-size", "32",
            "--train-steps", "4", "--eval-every", "2", "--log-every", "2",
            "--eval-batch-size", "64"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert '"images_per_sec"' in out
    assert '"mesh": {"data": 1, "seq": 1, "model": 1}' in out
    table = out[out.index("Steps,        Time,"):].strip().splitlines()
    assert len(table) == 3 and table[1].startswith("2,")
    assert table[2].startswith("4,") and table[2].endswith("0.001")


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

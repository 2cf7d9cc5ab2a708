"""PyTorch port: sync data parallelism (``--mesh.data D``), the
reference's job (mnist_cnn on the idx pipeline), gradient accumulation,
the EMA and the performance table, against the JAX package.

The headline checks: 5 steps of mnist_cnn through the port's ``train()``
on the committed MNIST fixture equal the JAX ``train()`` on its 8-device
data mesh (f32, dropout 0, the port started from the JAX init) at rtol
1e-4; ``--mesh.data 2`` and ``4`` in spawned gloo processes equal one
process on the same global batch at the bounds of the JAX package's
``test_n_device_equals_1_device``; and gpt_lm over (data 2, seq 2) in
four gloo processes equals the JAX trajectory at 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.parallel import mesh as jmesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.state import (
    ema_update as jax_ema_update)
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import (
    MeshConfig, TrainConfig, parse_args)
from tensorflow_distributed_tpu_torch.parallel import mesh as tmesh
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.train.state import ema_update
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from tests.conftest import FIXTURE_DIR
from torch_ring_workers import mesh_groups, spawn_ranks, train_run

CNN = dict(model="mnist_cnn", dataset="mnist", data_dir=FIXTURE_DIR,
           validation_size=64, batch_size=64, train_steps=5, eval_every=0,
           log_every=1, eval_batch_size=64, compute_dtype="float32",
           dropout_rate=0.0, learning_rate=2e-3, seed=0)
TINY_LM = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
               train_steps=3, eval_every=0, log_every=1, eval_batch_size=8,
               compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
               seed=0)


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_run_and_init(fields, mesh=None):
    """The JAX train() of ``fields`` and its init as a port state dict."""
    jcfg = JaxConfig(**fields, **({"mesh": mesh} if mesh else {}))
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    return jres, interop.params_from_flax(jax.device_get(jstate.params))


def _port_run(fields, init=None):
    return tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False), init_params=init)


@pytest.mark.parametrize("extra", [{}, dict(ema_decay=0.9),
                                   dict(grad_accum_steps=2)],
                         ids=["plain", "ema", "accum2"])
def test_mnist_cnn_trajectory_matches_jax_train(extra):
    """The reference's job, 5 steps on the fixture: the per-step losses
    and the final eval (on the EMA when there is one) equal the JAX
    run's on its 8-device data mesh."""
    fields = dict(CNN, **extra)
    jres, init = _jax_run_and_init(fields)
    tres = _port_run(fields, init)
    assert len(_losses(tres.logger)) == 5 and tres.state.step == 5
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               rtol=1e-4)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(tres.final_metrics[k],
                                   jres.final_metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert (tres.state.ema is None) == ("ema_decay" not in extra)


def test_grad_accum_two_equals_one_on_the_same_batch():
    one = _port_run(CNN)
    two = _port_run(dict(CNN, grad_accum_steps=2))
    np.testing.assert_allclose(_losses(two.logger), _losses(one.logger),
                               rtol=1e-4)
    for (name, a), b in zip(one.state.model.named_parameters(),
                            two.state.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=2e-3, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("data", [2, 4])
def test_data_parallel_equals_one_process(data, tmp_path):
    """--mesh.data D in D spawned gloo ranks, each drawing its D-th of
    every global batch, against one process on the same global batch
    (JAX's test_n_device_equals_1_device bounds); every rank ends with
    the same parameters. JAX's test settings: 3 steps of Adam at 1e-3."""
    fields = dict(CNN, train_steps=3, learning_rate=1e-3)
    spawn_ranks(train_run, data, tmp_path, fields, None, tmp_path,
                {"data": data})
    one = _port_run(fields)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(data)]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], _losses(one.logger),
                                   rtol=1e-5)
        np.testing.assert_allclose(rank["final"]["loss"],
                                   one.final_metrics["loss"], rtol=1e-5)
        for name, value in one.state.model.state_dict().items():
            np.testing.assert_allclose(rank["params"][name].numpy(),
                                       value.numpy(), rtol=2e-3, atol=5e-5,
                                       err_msg=name)
            assert torch.equal(rank["params"][name], ranks[0]["params"][name])


def test_gpt_data2_seq2_trajectory_matches_jax(tmp_path):
    """gpt_lm over (data 2, seq 2): 4 gloo ranks, two data rows of
    two-position rings (ring attention inside each row, gradients summed
    over all four), from the JAX init: the losses equal JAX's on its
    (data 4, seq 2) mesh to 1e-4 (the same global batch and math) and
    the port's one process to 1e-5."""
    jres, init = _jax_run_and_init(TINY_LM, JaxMesh(data=4, seq=2))
    torch.save(init, tmp_path / "init.pt")
    spawn_ranks(train_run, 4, tmp_path, TINY_LM, tmp_path / "init.pt",
                tmp_path, {"data": 2, "seq": 2})
    one = _port_run(TINY_LM, init)
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


def test_mesh_groups_follow_the_jax_layout(tmp_path):
    """(data 2, seq 2) over 4 ranks: rank r sits at (r // 2, r % 2); the
    seq group is the contiguous pair, the data group the ranks of one
    seq index, and each row's ring swaps inside its own row."""
    spawn_ranks(mesh_groups, 4, tmp_path, 2, 2, tmp_path)
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        d, s = r // 2, r % 2
        assert (got["data_index"], got["seq_index"]) == (d, s)
        assert got["sums"] == {"seq": float(4 * d + 1), "data": float(2 + 2 * s)}
        assert got["swapped"] == float(r ^ 1)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(0)
    ema = {"a": rng.normal(size=(5, 3)).astype(np.float32),
           "b": rng.normal(size=(7,)).astype(np.float32)}
    port = {k: torch.tensor(v) for k, v in ema.items()}
    for step in (0, 3, 50, 5000):
        new = {k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in ema.items()}
        ema = jax.device_get(jax_ema_update(ema, new, 0.999,
                                            jax.numpy.int32(step)))
        ema_update(port, {k: torch.tensor(v) for k, v in new.items()},
                   0.999, step)
        for k in ema:
            np.testing.assert_allclose(port[k].numpy(), ema[k], rtol=1e-6)


def test_eval_reads_the_ema():
    cfg = TrainConfig(**dict(CNN, ema_decay=0.5), device="cpu")
    task = tloop.make_task(cfg)
    _, state = tloop._build_model_and_state(cfg, torch.device("cpu"))
    _, other = tloop._build_model_and_state(
        TrainConfig(**dict(CNN, seed=1), device="cpu"), torch.device("cpu"))
    state.ema = {n: p.detach().clone() for n, p in other.params.items()}
    eval_fn = tloop.make_eval_step(task.eval_loss)
    with_ema = tloop.evaluate(state, eval_fn, task, 64, torch.device("cpu"))
    want = tloop.evaluate(other, eval_fn, task, 64, torch.device("cpu"))
    state.ema = None
    raw = tloop.evaluate(state, eval_fn, task, 64, torch.device("cpu"))
    assert with_ema == want and raw != want


def test_performance_table_matches_jax():
    port, ref = MetricLogger(enabled=False), JaxLogger(enabled=False)
    for logger in (port, ref):
        logger.log(10, loss=0.5, accuracy=0.75)
        logger.log(10, val_loss=0.3, val_accuracy=0.91234)
        logger.log(20, val_loss=0.1, val_accuracy=1.0)
        for rec, t in zip(logger.records, (3.2, 4.6, 61.4)):
            rec.wall_time = t
    assert port.performance_table(2e-3) == ref.performance_table(2e-3)
    assert port.performance_table(1e-3).count("\n") == 2


@pytest.mark.parametrize("axes,devices,batch", [
    ({"data": 2, "seq": 2}, 4, 8), ({"data": 3}, 4, 9),
    ({"data": 4}, 4, 6), ({"data": 0, "seq": 2}, 2, 8)])
def test_mesh_helpers_equal_jax(axes, devices, batch):
    assert (tmesh.mesh_infeasible(axes, devices, batch)
            == jmesh.mesh_infeasible(axes, devices, batch))
    assert (tmesh.pick_data_width(axes, devices, batch)
            == jmesh.pick_data_width(axes, devices, batch))
    assert tmesh.nondata_product(axes) == jmesh.nondata_product(axes)


def _torchrun_env(monkeypatch, world):
    for var, value in (("RANK", "0"), ("LOCAL_RANK", "0"),
                       ("WORLD_SIZE", str(world))):
        monkeypatch.setenv(var, value)


def test_mesh_product_must_equal_the_world(monkeypatch):
    for var in tmesh.TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    cfg = TrainConfig(**CNN, device="cpu", mesh=MeshConfig(data=2))
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        tloop.train(cfg, logger=MetricLogger(enabled=False))
    _torchrun_env(monkeypatch, 4)
    cfg = TrainConfig(**CNN, device="cpu", mesh=MeshConfig(data=3))
    with pytest.raises(RuntimeError, match="WORLD_SIZE=4.*nproc-per-node 3"):
        tloop.train(cfg, logger=MetricLogger(enabled=False))
    assert tmesh.mesh_shape(-1, 2) == (2, 2)  # data -1: what seq leaves


@pytest.mark.parametrize("fields,match", [
    (dict(batch_size=6), "global batch 6 not divisible by data width 4"),
    (dict(batch_size=8, grad_accum_steps=4), "grad_accum_steps 4 must "
     "divide the per-rank batch 2")])
def test_batch_must_split_over_the_data_axis(monkeypatch, fields, match):
    """Refused before any process group starts (a world of 4 that is not
    there would otherwise wait for its peers)."""
    _torchrun_env(monkeypatch, 4)
    cfg = TrainConfig(**dict(CNN, **fields), device="cpu")
    with pytest.raises(ValueError, match=match):
        tloop.train(cfg, logger=MetricLogger(enabled=False))
    assert not torch.distributed.is_initialized()


def test_ce_chunk_on_mnist_cnn_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="ce_chunk has no effect"):
        JaxConfig(model="mnist_cnn", ce_chunk=8192).validate()
    with pytest.raises(ValueError, match="ce_chunk has no effect"):
        parse_args(["--model", "mnist_cnn", "--ce-chunk", "8192",
                    "--device", "cpu"])


def test_native_data_backend_is_refused(capsys):
    with pytest.raises(SystemExit):
        parse_args(["--data-backend", "u8_native", "--device", "cpu"])
    assert "ROADMAP" in capsys.readouterr().err


def test_mesh_data_flag_spelling_and_default_match_jax():
    assert parse_args(["--mesh.data", "4", "--device", "cpu"]).mesh.data == 4
    assert TrainConfig().mesh.data == JaxConfig().mesh.data == -1
    for bad in (0, -2):
        with pytest.raises(ValueError, match="mesh.data"):
            MeshConfig(data=bad).validate()
        with pytest.raises(ValueError, match="mesh.data"):
            JaxMesh(data=bad).validate()

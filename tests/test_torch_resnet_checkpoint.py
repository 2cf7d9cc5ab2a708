"""PyTorch port: ResNet checkpoints carry ``batch_stats`` both ways,
byte for byte, against the JAX package on the CPU (split from
``test_torch_resnet.py``, whose helpers it uses).
"""

import jax
import numpy as np
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import checkpoint as jckpt
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import MetricLogger as JaxLogger
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from test_torch_resnet import RESNET, _assert_stats_equal, _port_run
from torch_threads import _one_thread  # noqa: F401


def _jax_state(fields):
    jcfg = JaxConfig(**fields)
    jm = make_mesh(jcfg.mesh)
    return jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))[1]


def test_checkpoints_carry_batch_stats_both_ways_byte_for_byte(tmp_path):
    """A port save restores in JAX with the port's params and batch_stats
    bit-equal, and JAX saving that state writes the port's bytes; a JAX
    save restores in the port with its batch_stats exactly, and ``--mode
    eval`` of it gives JAX's metrics (1e-5)."""
    fields = dict(RESNET, train_steps=2, checkpoint_every=2)
    res = _port_run(dict(fields, checkpoint_dir=str(tmp_path / "port")))
    jstate = jckpt.restore(str(tmp_path / "port"), _jax_state(fields))
    assert int(jstate.step) == 2
    _assert_stats_equal(res.state.model, jstate.extra, 0.0)
    jckpt.save(str(tmp_path / "jax"), jstate)
    for name in ("state.msgpack", "manifest.json"):
        port_bytes = (tmp_path / "port" / "step_00000002" / name).read_bytes()
        assert (tmp_path / "jax" / "step_00000002" / name
                ).read_bytes() == port_bytes, name

    jdir = str(tmp_path / "jax_run")
    jres = jloop.train(JaxConfig(**fields, checkpoint_dir=jdir),
                       logger=JaxLogger(enabled=False))
    fresh = tloop._build_model_and_state(
        TrainConfig(**fields, device="cpu"), torch.device("cpu"))[1]
    got = ckpt.restore(jdir, fresh)
    assert got.step == 2
    _assert_stats_equal(got.model, jres.state.extra, 0.0)
    want = interop.params_from_flax(jax.device_get(jres.state.params))
    for name, p in got.params.items():
        assert torch.equal(p.detach(), want[name]), name
    # --mode eval of that checkpoint reads its running averages in both.
    evals = [mod.evaluate_only(cfg(**dict(fields, mode="eval",
                                          checkpoint_dir=jdir), **kw),
                               logger=log(enabled=False))
             for mod, cfg, kw, log in (
                 (jloop, JaxConfig, {}, JaxLogger),
                 (tloop, TrainConfig, {"device": "cpu"}, MetricLogger))]
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(evals[1][k], evals[0][k], rtol=1e-5,
                                   err_msg=k)


def test_port_save_and_restore_bring_back_batch_stats_exactly(tmp_path):
    res = _port_run(dict(RESNET, train_steps=3, checkpoint_dir=str(tmp_path)))
    fresh = tloop._build_model_and_state(
        TrainConfig(**RESNET, device="cpu"), torch.device("cpu"))[1]
    got = ckpt.restore(str(tmp_path), fresh)
    assert got.step == 3
    for name, t in res.state.extra.items():
        assert torch.equal(got.extra[name], t), name

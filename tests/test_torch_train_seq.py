"""PyTorch port: sequence parallelism (``--mesh.seq 4``, four gloo
ranks) through ``train()`` against the JAX package's seq mesh and one
process, dense and fused heads (split from ``test_torch_train.py``,
whose helpers it uses).
"""

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import MeshConfig as JaxMesh
from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_ring_workers import spawn_ranks, train_run
from test_torch_train import TINY, _losses
from torch_threads import _one_thread  # noqa: F401


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

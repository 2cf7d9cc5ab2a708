"""PyTorch port: gradient accumulation under ``--mesh.data D`` against
the JAX package on the CPU.

JAX's microbatch ``i`` of an accumulated step is rows ``[iB/A,
(i+1)B/A)`` of the global batch, split over the data axis. The port's
data rank ``d`` therefore draws, for each microbatch in order, its
``D``-th of that slice, so that sync BatchNorm sees JAX's rows and a
masked loss is normalised by JAX's per-microbatch token count. Two gloo
ranks with ``--grad-accum-steps 2`` hold JAX's ``train()`` (its default
8-device data mesh: the microbatches are global-batch slices whatever
the data width) at 1e-4: ResNet-20's losses and ``batch_stats`` at
32 x 32, and a tiny BERT whose rows hold different masked-token counts.
"""

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.data.batcher import local_rows
from tensorflow_distributed_tpu_torch.parallel.mesh import Mesh
from tensorflow_distributed_tpu_torch.train.loop import data_rows
from torch_ring_workers import spawn_ranks, train_run
from torch_threads import _one_thread  # noqa: F401


RESNET = dict(model="resnet20", dataset="cifar10_synthetic", batch_size=16,
              train_steps=5, eval_every=0, log_every=1, eval_batch_size=200,
              compute_dtype="float32", learning_rate=1e-3, seed=0,
              grad_accum_steps=2)
BERT = dict(model="bert_mlm", model_size="tiny", seq_len=32, batch_size=8,
            train_steps=5, eval_every=0, log_every=1, eval_batch_size=64,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0, grad_accum_steps=2)


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_run(fields):
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    return jres, interop.params_from_flax(jax.device_get(jstate.params))


def test_local_rows_interleave_the_microbatches():
    """B 16, A 2, D 2: rank 0 takes rows 0-3 and 8-11, rank 1 rows 4-7
    and 12-15; one microbatch (A 1) is the contiguous half."""
    assert local_rows(16, 2, 0, 2).tolist() == [0, 1, 2, 3, 8, 9, 10, 11]
    assert local_rows(16, 2, 1, 2).tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    assert local_rows(16, 2, 1, 1).tolist() == list(range(8, 16))
    batch = {"x": np.arange(16)}
    got = data_rows(batch, Mesh(data=2, rank=1), accum_steps=2)
    assert got["x"].tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    with pytest.raises(ValueError, match="grad_accum_steps"):
        local_rows(12, 2, 0, 4)


@pytest.mark.parametrize("fields", [RESNET, BERT], ids=["resnet20", "bert"])
def test_accumulation_over_two_data_ranks_matches_jax(fields, tmp_path):
    """5 steps over two gloo ranks, each accumulating two microbatches:
    the losses equal JAX's to 1e-4, and ResNet-20's running averages
    (the last microbatch's, as JAX's scan keeps) too."""
    jres, init = _jax_run(fields)
    torch.save(init, tmp_path / "init.pt")
    spawn_ranks(train_run, 2, tmp_path, fields, tmp_path / "init.pt",
                tmp_path, {"data": 2})
    want = _losses(jres.logger)
    stats = {}
    if "batch_stats" in (jres.state.extra or {}):
        stats = {".".join(path): leaf for path, leaf in interop._walk(
            jax.device_get(jres.state.extra["batch_stats"]))}
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        for name, leaf in stats.items():
            np.testing.assert_allclose(got["params"][name].numpy(), leaf,
                                       rtol=1e-4, atol=1e-4, err_msg=name)
    assert not fields["model"].startswith("resnet") or stats

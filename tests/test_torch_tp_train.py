"""PyTorch port: Megatron tensor parallelism (``--mesh.model M``) in
``train()``, ``--mode eval`` and checkpoints, against the JAX package on
the CPU.

Gloo worlds of 2 and 4 ranks (``spawn_ranks``, under its deadline) run
5 steps of a tiny GPT, dense and with ``--shard-vocab --ce-chunk`` (a
vocabulary of 61 ids, whose tables' rows pad to an even count, as JAX's),
and of a tiny BERT, from the JAX init, over ``model 2``, ``data 2 x
model 2`` and ``seq 2 x model 2``: the losses and the final eval equal
JAX ``train()``'s on the same model and seq axes (its data axis the rest
of 8 CPU devices: the same global batch) at 1e-4.
Dropout draws one mask for the model ranks of a place (the losses equal
one process's). A checkpoint written under ``model 2`` is byte for byte
the one-process save of the same params; it resumes under ``model 2``
and under one process alike, and ``--mode eval`` of it agrees with one
process's at 1e-5.
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
from tensorflow_distributed_tpu.utils.logging import (
    MetricLogger as JaxLogger)
from tensorflow_distributed_tpu_torch import interop
from torch_ring_workers import spawn_ranks, train_run
from torch_threads import _one_thread  # noqa: F401


GPT = dict(model="gpt_lm", model_size="tiny", seq_len=32, batch_size=8,
           train_steps=5, eval_every=0, log_every=1, eval_batch_size=8,
           compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
           seed=0)
BERT = dict(model="bert_mlm", model_size="tiny", seq_len=32, batch_size=8,
            train_steps=5, eval_every=0, log_every=1, eval_batch_size=64,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0)
# 61 ids: the tables' rows pad to an even count (JAX's init refuses an
# untied head of 61 columns over model 2 without shard_vocab).
VOCAB_PARALLEL = dict(shard_vocab=True, ce_chunk=16, synthetic_vocab=61)


def _losses(logger):
    return [r.metrics["loss"] for r in logger.records if "loss" in r.metrics]


def _jax_run_and_init(fields, mesh):
    """JAX's train() on the mesh's model and seq axes, its data axis the
    rest of the 8 devices (the same global batch and math), and its init
    as a port state dict."""
    jcfg = JaxConfig(**fields, mesh=JaxMesh(
        **{k: v for k, v in mesh.items() if k != "data"}))
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    return jres, interop.params_from_flax(jax.device_get(jstate.params))


def _ranks(tmp_path, n):
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


CASES = [(GPT, {}, {"model": 2}),
         (GPT, {}, {"data": 2, "model": 2}),
         (GPT, {}, {"seq": 2, "model": 2}),
         (GPT, VOCAB_PARALLEL, {"model": 2}),
         (GPT, VOCAB_PARALLEL, {"data": 2, "model": 2}),
         (GPT, VOCAB_PARALLEL, {"seq": 2, "model": 2}),
         (BERT, {}, {"model": 2}),
         (BERT, VOCAB_PARALLEL, {"data": 2, "model": 2})]


@pytest.mark.parametrize(
    "base,extra,mesh", CASES,
    ids=[f"{b['model']}-{'vp' if e else 'dense'}-"
         + "x".join(f"{k}{v}" for k, v in m.items()) for b, e, m in CASES])
def test_tp_trajectory_matches_jax(base, extra, mesh, tmp_path):
    """5 steps from the JAX init over a gloo world of the mesh: every
    rank's losses and final eval equal JAX's on the same MeshConfig at
    1e-4, and the ranks of one model index end with the same params."""
    fields = dict(base, **extra)
    jres, init = _jax_run_and_init(fields, mesh)
    torch.save(init, tmp_path / "init.pt")
    world = int(np.prod(list(mesh.values())))
    spawn_ranks(train_run, world, tmp_path, fields, tmp_path / "init.pt",
                tmp_path, mesh)
    ranks = _ranks(tmp_path, world)
    model = mesh["model"]
    for r, got in enumerate(ranks):
        assert len(got["losses"]) == 5
        np.testing.assert_allclose(got["losses"], _losses(jres.logger),
                                   rtol=1e-4)
        for k in ("loss", "accuracy"):
            np.testing.assert_allclose(got["final"][k],
                                       jres.final_metrics[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        for name, value in got["params"].items():
            assert torch.equal(value, ranks[r % model]["params"][name]), name

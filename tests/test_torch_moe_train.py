"""PyTorch port: training mixture-of-experts models (``moe_lm``, and
``bert_mlm`` with ``--moe-experts``) against the JAX package on the CPU,
on one process and over gloo ranks.

- 5-step ``train()`` trajectories from the JAX init follow JAX's
  ``train()`` to 1e-4 in the loss and the three router metrics and in
  the final eval: ``moe_lm`` on the dense head with two accumulated
  microbatches, routing groups and clipping; ``bert_mlm`` with experts
  on the fused scan CE, scatter dispatch, capacity drops, the z-loss in
  the objective and ``--weight-decay``.
- 20 steps of ``moe_lm`` with 8 experts under the MoE cell's optimiser
  (Adam at 1e-3, JAX's load-balance weight 0.01) follow JAX to 1e-4 in
  the loss and the three router metrics at every step.
- Two ranks of ``--mesh.data 2``: the load balance, a product of two
  means over the global rows (per microbatch), equals JAX's to 1e-6 and
  the losses follow JAX's to 1e-4.
- Two ranks of ``--mesh.expert 2`` and of ``--mesh.model 2`` (experts
  on the model axis beside TP attention), with dropout and clipping,
  follow one process to 1e-5 (losses, the clip's norm) and 1e-4 (the
  params after 3 Adam steps, whose first updates are lr x sign(g) and
  so move a weight of near-zero gradient by an ulp's noise); the
  expert-parallel save is, byte for byte, one process's save of the
  same state, and it resumes under ``--mesh.expert 2`` as one process
  resumes. Four ranks of data 2 x expert 2 and data 2 x model 2 follow
  JAX to 1e-4.
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
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from torch_ring_workers import spawn_ranks, train_runs
from torch_threads import _one_thread  # noqa: F401

BASE = dict(model_size="tiny", seq_len=32, batch_size=8, train_steps=5,
            eval_every=0, log_every=1, eval_batch_size=64,
            compute_dtype="float32", dropout_rate=0.0, learning_rate=3e-3,
            seed=0)
MOE = dict(BASE, model="moe_lm", grad_accum_steps=2, moe_group_len=16,
           grad_clip_norm=0.5)
BERT_MOE = dict(BASE, model="bert_mlm", moe_experts=4, ce_chunk=16,
                moe_dispatch="scatter", moe_capacity_factor=1.0,
                moe_zloss_weight=0.01, weight_decay=0.1)
METRICS = ("loss", "aux_loss", "z_loss", "dropped_frac")


def _jax_run(fields):
    """JAX's train() (its 8-device data mesh: the same global batch) and
    its init as a port state dict."""
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=JaxLogger(enabled=False))
    jm = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, jm, jax_make_task(jcfg, jm))
    return jres, interop.params_from_flax(jax.device_get(jstate.params))


def _metrics(logger):
    return {k: [r.metrics[k] for r in logger.records if k in r.metrics]
            for k in METRICS}


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    """JAX's moe_lm run and its init (saved for the spawned ranks)."""
    jres, init = _jax_run(MOE)
    path = tmp_path_factory.mktemp("init") / "init.pt"
    torch.save(init, path)
    return jres, init, path


def _assert_follows(got_metrics, got_final, jres, rtol, steps=5):
    want = _metrics(jres.logger)
    for k in METRICS:
        assert len(got_metrics[k]) == steps, k
        np.testing.assert_allclose(got_metrics[k], want[k], rtol=rtol,
                                   atol=1e-7, err_msg=k)
    for k, v in jres.final_metrics.items():
        np.testing.assert_allclose(got_final[k], v, rtol=rtol, atol=1e-6,
                                   err_msg=k)


def test_moe_lm_trajectory_matches_jax(jax_moe):
    jres, init, _ = jax_moe
    res = tloop.train(TrainConfig(**MOE, device="cpu"),
                      logger=MetricLogger(enabled=False), init_params=init)
    assert res.state.model.layer_0.moe_mlp.wi.shape == (4, 32, 64)
    _assert_follows(_metrics(res.logger), res.final_metrics, jres, 1e-4)


def test_bert_moe_fused_trajectory_matches_jax():
    jres, init = _jax_run(BERT_MOE)
    res = tloop.train(TrainConfig(**BERT_MOE, device="cpu"),
                      logger=MetricLogger(enabled=False), init_params=init)
    assert res.final_metrics["dropped_frac"] > 0
    assert res.state.tx.mask["layer_1.moe_mlp.wo"]
    _assert_follows(_metrics(res.logger), res.final_metrics, jres, 1e-4)


def test_router_metrics_follow_jax_over_twenty_steps():
    fields = dict(BASE, model="moe_lm", moe_experts=8, train_steps=20,
                  learning_rate=1e-3)
    jres, init = _jax_run(fields)
    res = tloop.train(TrainConfig(**fields, device="cpu"),
                      logger=MetricLogger(enabled=False), init_params=init)
    assert res.final_metrics["dropped_frac"] > 0
    _assert_follows(_metrics(res.logger), res.final_metrics, jres, 1e-4,
                    steps=20)


def test_data_parallel_load_balance_is_global(jax_moe, tmp_path):
    """Each rank routes its own rows; the load balance of the global
    rows (a product of two means) equals JAX's to 1e-6."""
    jres, _, init_path = jax_moe
    spawn_ranks(train_runs, 2, tmp_path,
                [("data2", MOE, {"data": 2}, init_path)], tmp_path)
    want = _metrics(jres.logger)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")["data2"]
        np.testing.assert_allclose(got["metrics"]["aux_loss"],
                                   want["aux_loss"], rtol=1e-6, atol=1e-6)
        _assert_follows(got["metrics"], got["final"], jres, 1e-4)


def test_expert_parallel_follows_one_process_and_saves_its_bytes(tmp_path):
    """--mesh.expert 2 and --mesh.model 2 (dropout 0.1, clipping, scatter
    dispatch), 3 steps with a save, then 2 more from the expert-parallel
    save under --mesh.expert 2."""
    fields = dict(MOE, grad_accum_steps=1, dropout_rate=0.1, train_steps=3,
                  moe_dispatch="scatter", log_grad_norm=True,
                  checkpoint_every=3)
    ck = {m: str(tmp_path / m) for m in ("expert", "model", "one")}
    resume = dict(fields, train_steps=5, resume=True, checkpoint_every=0,
                  checkpoint_dir=ck["expert"])
    runs = [("expert2", dict(fields, checkpoint_dir=ck["expert"]),
             {"expert": 2}, None),
            ("model2", dict(fields, checkpoint_dir=ck["model"]),
             {"model": 2}, None),
            ("resumed", resume, {"expert": 2}, None)]
    spawn_ranks(train_runs, 2, tmp_path, runs, tmp_path)
    one = tloop.train(TrainConfig(**dict(fields, checkpoint_dir=ck["one"]),
                                  device="cpu"),
                      logger=MetricLogger(enabled=False))
    straight = tloop.train(TrainConfig(**dict(fields, train_steps=5),
                                       device="cpu"),
                           logger=MetricLogger(enabled=False))
    ones = {k: [r.metrics[k] for r in one.logger.records if k in r.metrics]
            for k in ("loss", "aux_loss", "grad_norm")}
    whole = one.state.model.state_dict()
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got["expert2"]["local"]["layer_0.moe_mlp.wi"] == (2, 32, 64)
        for name in ("expert2", "model2"):
            for k, v in ones.items():
                np.testing.assert_allclose(got[name]["metrics"][k], v,
                                           rtol=1e-5, err_msg=f"{name} {k}")
            for n, p in whole.items():
                np.testing.assert_allclose(got[name]["params"][n].numpy(),
                                           p.numpy(), atol=1e-4,
                                           err_msg=f"{name} {n}")
        np.testing.assert_allclose(
            got["resumed"]["metrics"]["loss"],
            [r.metrics["loss"] for r in straight.logger.records
             if "loss" in r.metrics][3:], rtol=1e-5)
    manifest = ckpt.read_mesh_manifest(ck["expert"], 3)
    assert manifest["mesh"] == {"data": 1, "seq": 1, "model": 1,
                                "expert": 2}
    assert manifest["specs"]["params/layer_0/moe_mlp/wi"] == (
        "PartitionSpec('expert', None, None)")
    assert manifest["specs"]["params/layer_0/moe_mlp/gate"] == (
        "PartitionSpec()")
    assert ckpt.read_mesh_manifest(ck["model"], 3)["specs"][
        "params/layer_0/moe_mlp/wo"] == "PartitionSpec('model', None, None)"
    _, state = tloop._build_model_and_state(TrainConfig(**fields, device="cpu"),
                                            torch.device("cpu"))
    state = ckpt.restore(ck["expert"], state, step=3)
    ckpt.save(str(tmp_path / "again"), state)
    for name in ("state.msgpack", "manifest.json"):
        assert ((tmp_path / "again" / "step_00000003" / name).read_bytes()
                == (tmp_path / "expert" / "step_00000003" / name
                    ).read_bytes()), name


def test_data_by_expert_and_model_grids_follow_jax(jax_moe, tmp_path):
    jres, _, init_path = jax_moe
    runs = [(name, MOE, mesh, init_path) for name, mesh in (
        ("data2_expert2", {"data": 2, "expert": 2}),
        ("data2_model2", {"data": 2, "model": 2}))]
    spawn_ranks(train_runs, 4, tmp_path, runs, tmp_path)
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for name, _, _, _ in runs:
            _assert_follows(got[name]["metrics"], got[name]["final"], jres,
                            1e-4)

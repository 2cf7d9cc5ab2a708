"""PyTorch port: the Llama-style options (RoPE, GQA, SwiGLU, RMSNorm,
window, tying, remat) through ``train()`` against the JAX package on
the CPU: 5-step trajectories, and the seq 2 composition against JAX's
seq mesh (split from ``test_torch_llama.py``, whose helpers it uses).
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
from test_torch_llama import LLAMA, TINY, _losses
from torch_threads import _one_thread  # noqa: F401


def _jax_init(jcfg):
    mesh = make_mesh(jcfg.mesh)
    _, jstate = jloop._build_model_and_state(jcfg, mesh,
                                             jax_make_task(jcfg, mesh))
    return interop.params_from_flax(jax.device_get(jstate.params))


TRAIN = {"rope": dict(pos_emb="rope"),
         "gqa": dict(n_kv_heads=2),
         "swiglu": dict(mlp_variant="swiglu"),
         "rmsnorm": dict(norm="rmsnorm"),
         "window": dict(attn_window=8),
         "llama_dense": dict(LLAMA),
         "llama_fused_scan": dict(LLAMA, ce_chunk=32, ce_impl="scan"),
         "llama_tied_fused_kernel": dict(LLAMA, tie_embeddings=True,
                                         ce_chunk=32, ce_impl="kernel")}


@pytest.mark.parametrize("case", TRAIN)
def test_five_step_trajectory_matches_jax_train(case):
    fields = dict(TINY, **TRAIN[case])
    jcfg = JaxConfig(**fields)
    jres = jloop.train(jcfg, logger=MetricLogger(enabled=False))
    tres = tloop.train(TrainConfig(**fields, device="cpu"),
                       logger=MetricLogger(enabled=False),
                       init_params=_jax_init(jcfg))
    assert len(_losses(tres.logger)) == 5
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               atol=1e-4)
    np.testing.assert_allclose(tres.final_metrics["loss"],
                               jres.final_metrics["loss"], atol=1e-4)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_seq2_composition_matches_jax_seq_mesh(remat, tmp_path):
    """3 steps of the Llama composition (tied) under --mesh.seq 2 in two
    spawned gloo ranks (the zigzag ring with RoPE at each block's global
    offset and GQA widened before the ring; under --remat full each
    rank recomputes its blocks, the ring's permutes included) against
    JAX on a (data 4, seq 2) mesh of the 8 CPU devices."""
    fields = dict(TINY, train_steps=3, tie_embeddings=True, remat=remat,
                  **LLAMA)
    jcfg = JaxConfig(**fields, mesh=JaxMesh(data=4, seq=2))
    jres = jloop.train(jcfg, logger=MetricLogger(enabled=False))
    torch.save(_jax_init(jcfg), tmp_path / "init.pt")
    spawn_ranks(train_run, 2, tmp_path, fields, tmp_path / "init.pt",
                tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], _losses(jres.logger),
                                   atol=1e-4)
        np.testing.assert_allclose(rank["final"]["loss"],
                                   jres.final_metrics["loss"], atol=1e-4)
        for name, value in rank["params"].items():
            assert torch.equal(value, ranks[0]["params"][name]), name

"""PyTorch port: the fused head+loss (``--ce-chunk``, scan and kernel
forms) through ``train()`` and the task loss, against the JAX package
on the CPU (split from ``test_torch_train.py``, whose helpers it uses):
5-step trajectories to 1e-4, the loss and its gradients.
"""

import jax
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.parallel import make_mesh
from tensorflow_distributed_tpu.train import loop as jloop
from tensorflow_distributed_tpu.train.tasks import make_task as jax_make_task
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.train import loop as tloop
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger
from test_torch_train import TINY, _losses
from torch_threads import _one_thread  # noqa: F401


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

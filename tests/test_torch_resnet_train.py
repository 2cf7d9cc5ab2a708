"""PyTorch port: ResNet-20's ``train()`` against the JAX package on the
CPU (split from ``test_torch_resnet.py``, whose helpers it uses).

Five steps of resnet20 on the synthetic CIFAR-10 set follow JAX's
``train()`` to 1e-4 (losses, ``batch_stats``, the final eval), with
gradient accumulation too.
"""

import numpy as np
import pytest

from test_torch_resnet import (
    RESNET, _assert_stats_equal, _jax_run, _losses, _port_run)
from torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("extra", [{}, dict(grad_accum_steps=2)],
                         ids=["plain", "accum2"])
def test_resnet20_trajectory_and_batch_stats_match_jax(extra):
    """5 steps of resnet20 on the synthetic CIFAR-10 set: the losses to
    1e-4, the batch_stats to 1e-4 (under accumulation, the last
    microbatch's, as JAX's scan keeps; Adam's steps carry the grads'
    ~1e-5 differences into the weights, 3e-5 at most in the stats), and
    the final eval, which reads the running averages, to 1e-4."""
    fields = dict(RESNET, **extra)
    jres, init = _jax_run(fields)
    tres = _port_run(fields, init)
    assert tres.state.step == 5
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               rtol=1e-4)
    _assert_stats_equal(tres.state.model, jres.state.extra, 1e-4)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(tres.final_metrics[k],
                                   jres.final_metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)

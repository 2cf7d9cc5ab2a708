"""PyTorch port: ResNet-50's ``train()`` against the JAX package on the
CPU (split from ``test_torch_resnet.py``, whose helpers it uses): its
trajectory on the synthetic ImageNet set at 32 x 32 follows JAX's.
"""

import functools

import numpy as np

from tensorflow_distributed_tpu.data import cifar as jcifar
from tensorflow_distributed_tpu_torch.data import cifar as tcifar
from test_torch_resnet import RESNET, _jax_run, _losses, _port_run
from torch_threads import _one_thread  # noqa: F401


def test_resnet50_trajectory_matches_jax_on_small_images(monkeypatch):
    """5 steps of resnet50 on imagenet_synthetic (1000 classes, the
    default optimizer and learning rate, as the card's ResNet-50 leg),
    its images cut to 32 x 32 and batch 8 so that the CPU can run it in
    both packages: the losses to 1e-4 (the stem, the max pool, the
    stride-2 bottlenecks and the batch statistics of every stage)."""
    for mod in (jcifar, tcifar):
        monkeypatch.setattr(mod, "synthetic_imagenet", functools.partial(
            mod.synthetic_imagenet, n_train=256, n_test=64,
            validation_size=64, image_size=32))
    fields = dict(RESNET, model="resnet50", dataset="imagenet_synthetic",
                  batch_size=8, eval_batch_size=64)
    del fields["learning_rate"]
    jres, init = _jax_run(fields)
    tres = _port_run(fields, init)
    np.testing.assert_allclose(_losses(tres.logger), _losses(jres.logger),
                               rtol=1e-4)
    np.testing.assert_allclose(tres.final_metrics["loss"],
                               jres.final_metrics["loss"], rtol=1e-4)

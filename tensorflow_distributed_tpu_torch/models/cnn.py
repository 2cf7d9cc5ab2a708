"""The reference MNIST CNN: the port of ``models/cnn.py``.

    5x5 conv  1->32, bias, ReLU, 2x2 max-pool stride 2   (28 -> 14)
    5x5 conv 32->64, bias, ReLU, 2x2 max-pool stride 2   (14 -> 7)
    flatten 7*7*64 = 3136
    dense 3136->1024, bias, ReLU, dropout
    dense 1024->10 logits (f32)

Convolutions and products run in ``compute_dtype`` (cuDNN and cuBLAS on
a GPU: XLA generated them in the JAX package, there is no Pallas kernel
on this path); the params stay f32. The JAX model is NHWC, so its fc1
rows are indexed ``h*448 + w*64 + c``: the features are flattened in
that order here (NCHW convs, then a permute to NHWC), so fc1 carries
across as a plain transpose and a weight means the same thing in both
packages.

Init schemes (``init_scheme``), drawn from an explicit generator:
- "improved": flax ``he_normal`` (a normal truncated at 2 sigma and
  rescaled to std sqrt(2 / fan_in)) for every kernel, zero biases;
- "reference": normal(std 1) for every weight and bias, as the
  reference's ``tf.random_normal``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_distributed_tpu_torch.models.transformer import dropout

# std of a unit normal truncated at +-2 (flax's variance_scaling rescale)
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def he_normal_(weight: torch.Tensor, fan_in: int,
               generator: torch.Generator) -> torch.Tensor:
    """flax ``he_normal``: variance_scaling(2, "fan_in",
    "truncated_normal"), by the inverse-CDF draw of
    ``torch.nn.init.trunc_normal_``."""
    std = math.sqrt(2.0 / fan_in) / TRUNCATED_STD
    edge = math.erf(2.0 / math.sqrt(2.0))  # 2 * Phi(2) - 1
    weight.uniform_(-edge, edge, generator=generator).erfinv_()
    return weight.mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.25,
                 init_scheme: str = "improved",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if init_scheme not in ("improved", "reference"):
            raise ValueError(f"unknown init_scheme {init_scheme!r}")
        self.dropout_rate = dropout_rate
        self.init_scheme = init_scheme
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear(7 * 7 * 64, 1024)
        self.out = nn.Linear(1024, num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.conv1, self.conv2, self.fc1, self.out):
            if self.init_scheme == "reference":
                layer.weight.normal_(0.0, 1.0, generator=generator)
                layer.bias.normal_(0.0, 1.0, generator=generator)
            else:
                fan_in = layer.weight[0].numel()  # 5*5*C_in, or in
                he_normal_(layer.weight, fan_in, generator)
                layer.bias.zero_()

    def _run(self, x: torch.Tensor, layer) -> torch.Tensor:
        dt = self.compute_dtype
        w, b = layer.weight.to(dt), layer.bias.to(dt)
        if isinstance(layer, nn.Conv2d):
            return F.conv2d(x, w, b, padding=layer.padding)
        return F.linear(x, w, b)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, 28, 28, 1] (NHWC, as the JAX model) or flat [B, 784]
        -> logits [B, 10] float32."""
        x = x.reshape(x.shape[0], 28, 28, 1).permute(0, 3, 1, 2)
        x = x.to(self.compute_dtype)
        x = F.max_pool2d(F.relu(self._run(x, self.conv1)), 2, 2)
        x = F.max_pool2d(F.relu(self._run(x, self.conv2)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order
        x = F.relu(self._run(x, self.fc1))
        x = dropout(x, self.dropout_rate, train, generator)
        return self._run(x, self.out).float()

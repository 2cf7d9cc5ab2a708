"""ResNet-20 (CIFAR-10) and ResNet-50 (ImageNet): the port of
``models/resnet.py``, the flax model's numerics:

- inputs arrive NHWC, as the JAX batches, and are permuted once at the
  stem to NCHW; the convolutions run in ``compute_dtype`` (cuDNN on a
  GPU: XLA generated them in the JAX package, no Pallas kernel computes
  them), the params stay f32;
- padding is XLA's "SAME": ``out = ceil(n / stride)`` and the
  ``(out - 1) * stride + k - n`` padding split low ``total // 2``, high
  the rest. Under stride 2 on an even input that is asymmetric (a 3x3
  conv pads (0, 1), the 7x7 stem on 224 (2, 3), the 3x3 max pool
  (0, 1) with -inf), so it is an explicit ``F.pad`` before a conv of
  padding 0, never ``Conv2d(padding=...)``'s symmetric pad;
- BatchNorm is flax's, not ``nn.BatchNorm2d``'s (:class:`BatchNorm`):
  f32 statistics, the biased batch variance ``E[x^2] - E[x]^2``
  clipped at 0 used both to normalize and in the moving average,
  ``running = 0.9 * running + 0.1 * batch``, eps 1e-5, the running
  averages in eval; the BN outputs, the residual adds and the global
  average pool are f32;
- under ``--mesh.data D`` the statistics are the global batch's, as
  GSPMD gives JAX: each BN layer all-reduces its per-channel sum, sum of
  squares and count over the data group, one packed f32 tensor a layer,
  differentiably (gloo on the CPU, NCCL on cards); under the explicit
  gradient sync (``--grad-sync serial|overlap``) each rank normalizes
  with its own statistics and the step averages the ranks' new running
  averages (``pending_batch_stats``), as JAX's explicit step does;
- init: flax ``he_normal`` for every kernel (the head's too), zero
  biases, BN scales one except the last BN of each residual branch,
  zero ("zero-gamma": blocks start as identity).

A training forward does not write the running averages: each BN layer
keeps its new ones pending (:meth:`ResNet.commit_batch_stats`), so the train
step keeps them only with the update (a skipped step keeps the old
ones, as JAX's skip keeps the whole state) and, under gradient
accumulation, keeps the last microbatch's, each microbatch computing
from the step's starting averages, as JAX's scan does.

Names mirror the flax tree (``stage0_block0.conv1`` for
``stage0_block0/conv1``; the BN's ``weight`` is flax's ``scale``, its
buffers ``mean`` and ``var`` the ``batch_stats`` leaves), so
``interop.params_from_flax`` carries the weights across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tensorflow_distributed_tpu_torch.models.cnn import he_normal_

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial dim of size ``n``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """``x`` [B, C, H, W] padded for a k x k window at ``stride``."""
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over ``group`` whose backward all-reduces the
    gradient: d(sum over ranks)/d(this rank's term) is the sum of the
    ranks' upstream gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``
    over the channels of [B, C, H, W]; ``group``: the process group whose
    ranks' rows the statistics cover (None: this rank's batch)."""

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.group = None
        self.pending: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.float()
        if train:
            c = x.shape[1]
            count = torch.full((1,), x.numel() / c, dtype=torch.float32,
                               device=x.device)
            sums = torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)),
                              count])
            if self.group is not None:
                sums = _SumOverGroup.apply(sums, self.group)
            mean = sums[:c] / sums[2 * c]
            var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean,
                              min=0.0)
            with torch.no_grad():
                self.pending = (
                    BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean,
                    BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _conv(c_in: int, c_out: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, bias=False)


class _Net(nn.Module):
    """What the blocks and the ResNet share: a conv at SAME padding in
    the compute dtype."""

    compute_dtype: torch.dtype

    def conv(self, layer: nn.Conv2d, x: torch.Tensor,
             stride: int = 1) -> torch.Tensor:
        dt = self.compute_dtype
        x = pad_same(x.to(dt), layer.kernel_size[0], stride)
        return F.conv2d(x, layer.weight.to(dt), stride=stride)


class BasicBlock(_Net):
    """3x3 -> 3x3 residual block (ResNet-20)."""

    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stride = stride
        self.conv1 = _conv(c_in, filters, 3)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters, zero_scale=True)
        if stride != 1 or c_in != filters:
            self.proj = _conv(c_in, filters, 1)
            self.bn_proj = BatchNorm(filters)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv(self.conv1, x, self.stride), train))
        y = self.bn2(self.conv(self.conv2, y), train)
        residual = x.float()
        if hasattr(self, "proj"):
            residual = self.bn_proj(self.conv(self.proj, x, self.stride),
                                    train)
        return F.relu(residual + y)


class BottleneckBlock(_Net):
    """1x1 -> 3x3 -> 1x1 (x4) residual block (ResNet-50)."""

    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.stride = stride
        self.conv1 = _conv(c_in, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.conv3 = _conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm(filters * 4, zero_scale=True)
        if stride != 1 or c_in != filters * 4:
            self.proj = _conv(c_in, filters * 4, 1)
            self.bn_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv(self.conv1, x), train))
        y = F.relu(self.bn2(self.conv(self.conv2, y, self.stride), train))
        y = self.bn3(self.conv(self.conv3, y), train)
        residual = x.float()
        if hasattr(self, "proj"):
            residual = self.bn_proj(self.conv(self.proj, x, self.stride),
                                    train)
        return F.relu(residual + y)


class ResNet(_Net):
    """A CIFAR stem (3x3) or an ImageNet stem (7x7/2 + 3x3/2 max pool),
    then ``stage_sizes`` blocks a stage, the filters doubling each stage
    (stride 2 at each later stage's first block), global average pool
    and a dense head: images [B, H, W, C] -> logits [B, classes] f32."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 10, num_filters: int = 16,
                 cifar_stem: bool = True, in_channels: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bn_group=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cifar_stem = cifar_stem
        self.stage_sizes = tuple(stage_sizes)
        self.conv_stem = _conv(in_channels, num_filters, 3 if cifar_stem
                               else 7)
        self.bn_stem = BatchNorm(num_filters)
        c = num_filters
        for stage, n_blocks in enumerate(stage_sizes):
            filters = num_filters * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"stage{stage}_block{block}", block_cls(
                    c, filters, stride, compute_dtype))
                c = filters * block_cls.expansion
        self.head = nn.Linear(c, num_classes)
        # A plain list, so the layers are not registered twice.
        self._batch_norms = [(name, module) for name, module
                             in self.named_modules()
                             if isinstance(module, BatchNorm)]
        for _, module in self._batch_norms:
            module.group = bn_group

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """Every BN layer's running averages by buffer name (the JAX
        state's ``extra["batch_stats"]`` leaves)."""
        return {f"{name}.{leaf}": getattr(module, leaf)
                for name, module in self._batch_norms
                for leaf in ("mean", "var")}

    @torch.no_grad()
    def pending_batch_stats(self):
        """Every BN layer's pending running averages (mean, var), in
        module order: the tensors a step may change in place before it
        commits them."""
        return [t for m in self.modules() if isinstance(m, BatchNorm)
                and m.pending is not None for t in m.pending]

    def commit_batch_stats(self, keep: bool = True) -> None:
        """Write every BN layer's pending running averages into its
        buffers (``keep``) or drop them."""
        for _, module in self._batch_norms:
            if module.pending is not None and keep:
                module.mean.copy_(module.pending[0])
                module.var.copy_(module.pending[1])
            module.pending = None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn in module order from ``generator``:
        he_normal kernels, zero biases, BN scales one (zero on the last
        BN of each residual branch), running mean 0 and variance 1."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                he_normal_(module.weight, module.weight[0].numel(), generator)
            elif isinstance(module, nn.Linear):
                he_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(0.0 if module.zero_scale else 1.0)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)
                module.pending = None

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, once
        x = self.conv(self.conv_stem, x, 1 if self.cifar_stem else 2)
        x = F.relu(self.bn_stem(x, train))
        if not self.cifar_stem:
            x = F.max_pool2d(pad_same(x, 3, 2, -math.inf), 3, 2)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"stage{stage}_block{block}")(x, train)
        x = x.float().mean((2, 3))
        return F.linear(x, self.head.weight, self.head.bias).float()


def resnet20(num_classes: int = 10, compute_dtype: torch.dtype = torch.bfloat16,
             in_channels: int = 3, bn_group=None) -> ResNet:
    """CIFAR-10 ResNet-20: 3 stages x 3 basic blocks, 16/32/64 filters
    (~0.27M params)."""
    return ResNet((3, 3, 3), BasicBlock, num_classes=num_classes,
                  num_filters=16, cifar_stem=True, in_channels=in_channels,
                  compute_dtype=compute_dtype, bn_group=bn_group)


def resnet50(num_classes: int = 1000, compute_dtype: torch.dtype = torch.bfloat16,
             in_channels: int = 3, bn_group=None) -> ResNet:
    """ImageNet ResNet-50: stages (3, 4, 6, 3) of bottleneck blocks,
    64-base filters, the 7x7/2 stem and max pool (~25.6M params)."""
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes=num_classes,
                  num_filters=64, cifar_stem=False, in_channels=in_channels,
                  compute_dtype=compute_dtype, bn_group=bn_group)

"""Weights carried across from the JAX package.

``params_from_flax`` maps the param tree that the JAX ``gpt_lm`` or
``mnist_cnn`` builds (a nested dict of numpy arrays, e.g.
``jax.device_get(state.params)``) to a state dict of the port's
``CausalLM`` or ``MnistCNN``. Names mirror each other
(``layer_0/attn/qkv/kernel`` -> ``layer_0.attn.qkv.weight``); the
kernels change layout:

- flax Dense kernels are ``[in, out]``, torch Linear weights ``[out, in]``;
- flax Conv kernels (``conv*``) are HWIO ``[5, 5, I, O]``, torch Conv2d
  weights OIHW;
- the attention ``qkv`` DenseGeneral kernel ``[D, 3, H, dh]`` (bias
  ``[3, H, dh]``) flattens its output axes, and ``out`` ``[H, dh, D]``
  flattens its two contracted input axes.

``cache_from_flax`` maps the ``cache`` collection that the JAX model's
``decode=True`` path fills (``layer_i/attn/{key,value}`` of shape
``[B, max_len, H, Dh]``, plus a scalar ``index``) to the port's
``KVCache``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.models.transformer import KVCache


def _walk(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, np.asarray(value)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's state dict (f32 CPU
    tensors)."""
    out = {}
    for path, leaf in _walk(tree):
        *module, name = path
        if name == "kernel" and module[-1].startswith("conv"):
            value = leaf.transpose(3, 2, 0, 1)
        elif name == "kernel":
            # The attention's DenseGeneral "out" contracts two input
            # axes ([H, dh, D]); every other kernel contracts one.
            n_in = 2 if module[-1] == "out" and leaf.ndim == 3 else 1
            rows = int(np.prod(leaf.shape[:n_in]))
            value = leaf.reshape(rows, -1).T
        elif name in ("embedding", "scale"):
            value = leaf
        elif name == "bias":
            value = leaf.reshape(-1)
        else:
            raise ValueError(f"unknown flax leaf {'/'.join(path)}")
        key = ".".join(module + ["weight" if name != "bias" else "bias"])
        out[key] = torch.tensor(np.asarray(value, dtype=np.float32))
    return out


def cache_from_flax(tree: Mapping[str, Any]) -> KVCache:
    """flax ``cache`` collection (numpy leaves) -> the port's KVCache
    (CPU tensors in the leaves' dtype). The scalar ``index`` is dropped:
    positions are the authority on depth in both packages."""
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    attn = [tree[k]["attn"] for k in layers]
    return KVCache(
        k=[torch.from_numpy(np.array(a["key"])) for a in attn],
        v=[torch.from_numpy(np.array(a["value"])) for a in attn])

"""Model registry of the PyTorch port (the families of ROADMAP.md queue A
not listed here are not ported yet)."""

from typing import Optional

import torch

MODEL_NAMES = ("mnist_cnn", "resnet20", "resnet50", "bert_mlm", "gpt_lm",
               "moe_lm", "pipelined_lm")
TRANSFORMER_MODELS = ("bert_mlm", "gpt_lm", "moe_lm")

# Families whose train state carries running statistics beside the params
# (BatchNorm's batch_stats), as the JAX registry lists them.
MUTABLE_EXTRA_MODELS = ("resnet20", "resnet50")


def build_model(name: str, dropout_rate: Optional[float] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                init_scheme: str = "improved", **overrides):
    """Explicit per-family dispatch. ``overrides`` are TransformerConfig
    fields (plus ``size``, ``ring`` for sequence parallelism, ``tp`` and
    ``ep`` for the model and expert groups) for the transformer
    families; for pipelined_lm ``size``, ``pipe`` (the pipe transport),
    ``num_microbatches``, ``virtual_stages``, ``aux_mesh`` and
    TransformerConfig fields; ``num_classes``, ``in_channels`` and ``bn_group`` (the
    process group of sync BN) for the ResNets; ``init_scheme`` selects
    mnist_cnn's init."""
    if name not in TRANSFORMER_MODELS + ("pipelined_lm",):
        overrides.pop("size", None)  # presets are transformer-only
    if name == "mnist_cnn":
        from tensorflow_distributed_tpu_torch.models.cnn import MnistCNN

        kw = {} if dropout_rate is None else {"dropout_rate": dropout_rate}
        return MnistCNN(init_scheme=init_scheme, compute_dtype=compute_dtype,
                        **kw, **overrides)
    if name in ("resnet20", "resnet50"):
        from tensorflow_distributed_tpu_torch.models import resnet

        return getattr(resnet, name)(compute_dtype=compute_dtype, **overrides)
    if name == "pipelined_lm":
        from tensorflow_distributed_tpu_torch.models.pipelined import (
            pipelined_lm)

        if dropout_rate is not None:
            overrides.setdefault("dropout_rate", dropout_rate)
        overrides.setdefault("compute_dtype", compute_dtype)
        return pipelined_lm(**overrides)
    if name in TRANSFORMER_MODELS:
        from tensorflow_distributed_tpu_torch.models import transformer

        if dropout_rate is not None:
            overrides.setdefault("dropout_rate", dropout_rate)
        overrides.setdefault("compute_dtype", compute_dtype)
        factory = {"bert_mlm": transformer.bert_base_mlm,
                   "gpt_lm": transformer.gpt_lm,
                   "moe_lm": transformer.moe_lm}[name]
        return factory(**overrides)
    raise NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet (have "
        f"{list(MODEL_NAMES)}; see ROADMAP.md queue A)")

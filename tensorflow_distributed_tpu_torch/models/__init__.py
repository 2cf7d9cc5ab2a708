"""Model registry of the PyTorch port (``mnist_cnn`` and ``gpt_lm``;
the other JAX families are listed in ROADMAP.md queue A)."""

from typing import Optional

import torch

MODEL_NAMES = ("mnist_cnn", "gpt_lm")


def build_model(name: str, dropout_rate: Optional[float] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                init_scheme: str = "improved", **overrides):
    """Explicit per-family dispatch; ``overrides`` are TransformerConfig
    fields (plus ``size``, and ``ring`` for sequence parallelism) for
    gpt_lm; ``init_scheme`` selects mnist_cnn's init."""
    if name == "mnist_cnn":
        from tensorflow_distributed_tpu_torch.models.cnn import MnistCNN

        kw = {} if dropout_rate is None else {"dropout_rate": dropout_rate}
        return MnistCNN(init_scheme=init_scheme, compute_dtype=compute_dtype,
                        **kw, **overrides)
    if name == "gpt_lm":
        from tensorflow_distributed_tpu_torch.models import transformer

        if dropout_rate is not None:
            overrides.setdefault("dropout_rate", dropout_rate)
        overrides.setdefault("compute_dtype", compute_dtype)
        return transformer.gpt_lm(**overrides)
    raise NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet (have "
        f"{list(MODEL_NAMES)}; see ROADMAP.md queue A)")

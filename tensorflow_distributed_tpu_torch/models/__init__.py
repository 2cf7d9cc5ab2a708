"""Model registry of the PyTorch port (``gpt_lm`` only so far; the
other JAX families are listed in ROADMAP.md queue A)."""

from typing import Optional

import torch

MODEL_NAMES = ("gpt_lm",)


def build_model(name: str, dropout_rate: Optional[float] = None,
                compute_dtype: torch.dtype = torch.bfloat16, **overrides):
    """Explicit per-family dispatch; ``overrides`` are TransformerConfig
    fields (plus ``size``, and ``ring`` for sequence parallelism)."""
    from tensorflow_distributed_tpu_torch.models import transformer

    if name == "gpt_lm":
        if dropout_rate is not None:
            overrides.setdefault("dropout_rate", dropout_rate)
        overrides.setdefault("compute_dtype", compute_dtype)
        return transformer.gpt_lm(**overrides)
    raise NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet (have "
        f"{list(MODEL_NAMES)}; see ROADMAP.md queue A)")

"""Synthetic causal-LM data (numpy): the port of ``data/lm.py``'s
``LmDataset``, ``synthetic_clm`` and ``LmBatcher``.

The generator draws from ``np.random.default_rng(seed)`` in the same
order as the JAX package, so both packages train on identical token
streams for the same seed. Batch layout: ``tokens``, ``targets`` and
``mask``, each [B, L].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from tensorflow_distributed_tpu_torch.data.batcher import Batcher


@dataclasses.dataclass
class LmDataset:
    tokens: np.ndarray    # [N, L] inputs
    targets: np.ndarray   # [N, L] next-token ids
    # [N, L] float {0,1}; None = all-ones, synthesized per batch.
    mask: Optional[np.ndarray]
    vocab_size: int

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        tokens = self.tokens[idx].astype(np.int32, copy=False)
        targets = self.targets[idx].astype(np.int32, copy=False)
        mask = (np.ones(targets.shape, np.float32) if self.mask is None
                else self.mask[idx])
        return {"tokens": tokens, "targets": targets, "mask": mask}


def synthetic_clm(n: int = 2048, seq_len: int = 128, vocab_size: int = 64,
                  seed: int = 0) -> LmDataset:
    """Synthetic causal-LM data: each sequence is an arithmetic token
    progression x_t = (start + stride*t) mod V with sparse substitution
    noise — learnable only through causal attention. seq_len+1 tokens
    are generated so targets (inputs shifted left one) are genuine
    continuations; the mask is all-ones."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab_size, size=(n, 1))
    stride = rng.integers(1, 6, size=(n, 1))
    t = np.arange(seq_len + 1)[None, :]
    seq = ((start + stride * t) % vocab_size).astype(np.int32)
    noise = rng.random((n, seq_len + 1)) < 0.02
    seq = np.where(noise, rng.integers(0, vocab_size,
                                       size=(n, seq_len + 1)), seq)
    seq = seq.astype(np.int32)
    return LmDataset(tokens=seq[:, :-1], targets=seq[:, 1:],
                     mask=np.ones((n, seq_len), np.float32),
                     vocab_size=vocab_size)


class LmBatcher(Batcher):
    """{tokens, targets, mask} batches over an LmDataset."""

    def __init__(self, ds: LmDataset, global_batch: int, seed: int = 0,
                 num_processes: int = 1, process_index: int = 0):
        self.ds = ds
        super().__init__(
            n_items=len(ds), global_batch=global_batch, gather=ds.batch,
            seed=seed, num_processes=num_processes,
            process_index=process_index)

"""Task definitions: the port of ``train/tasks.py``'s causal-LM task.

A Task bundles the loss, the data streams and the dataset facts the
loop needs. Slice 1 has the ``clm`` task (gpt_lm on the synthetic
next-token stream) with the dense head and masked cross-entropy; the
fused-CE head (``ce_chunk``) comes with the next slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.ops.losses import masked_ce_sums
from tensorflow_distributed_tpu_torch.train.step import LossFn


@dataclasses.dataclass
class Task:
    """Everything the loop needs beyond the step machinery."""

    name: str
    loss: LossFn
    train_stream: Callable[[int], Iterator[Any]]  # start_step -> batches
    eval_batches: Callable[[int], Iterator[Any]]  # batch_size -> batches
    eval_size: int                    # rows in the eval split
    steps_per_epoch: int
    seq_len: int
    # Loss for the EVAL pass; None = same as ``loss`` (train-only label
    # smoothing stays out of reported validation numbers).
    eval_loss: Optional[LossFn] = None
    vocab_size: int = 0               # the dataset's vocabulary


def make_mlm_loss(label_smoothing: float = 0.0) -> LossFn:
    def mlm_loss(model, batch, train, generator=None):
        """Masked-CE objective over a {tokens, targets, mask} batch."""
        logits = model(batch["tokens"], train=train, generator=generator)
        ce_sum, correct, n = masked_ce_sums(logits, batch["targets"],
                                            batch["mask"], label_smoothing)
        n = n.clamp(min=1.0)
        loss = ce_sum / n
        return loss, {"loss": loss, "accuracy": correct / n}

    return mlm_loss


def _make_lm_task(cfg: TrainConfig, objective: str = "clm",
                  seq_len: int = 128, vocab_size: int = 64) -> Task:
    """Causal-LM task over the synthetic next-token stream;
    ``cfg.seq_len`` / ``cfg.synthetic_vocab`` override the defaults."""
    from tensorflow_distributed_tpu_torch.data.lm import (
        LmBatcher, synthetic_clm)

    if objective != "clm":
        raise NotImplementedError(
            f"LM objective {objective!r} is not ported to PyTorch yet "
            f"(see ROADMAP.md queue A)")
    seq_len = cfg.seq_len or seq_len
    vocab_size = cfg.synthetic_vocab or vocab_size
    n = max(16 * cfg.batch_size, 4096)
    train_ds = synthetic_clm(n=n, seq_len=seq_len, vocab_size=vocab_size,
                             seed=cfg.seed)
    val_ds = synthetic_clm(n=max(4 * cfg.eval_batch_size, 512),
                           seq_len=seq_len, vocab_size=vocab_size,
                           seed=cfg.seed + 1)
    batcher = LmBatcher(train_ds, cfg.batch_size, cfg.shuffle_seed)

    def eval_batches(batch: int) -> Iterator[Any]:
        nrows = (len(val_ds) // batch) * batch
        for lo in range(0, nrows, batch):
            yield val_ds.batch(np.arange(lo, lo + batch))

    return Task(
        name=objective, loss=make_mlm_loss(cfg.label_smoothing),
        eval_loss=make_mlm_loss(), train_stream=batcher.forever,
        eval_batches=eval_batches, eval_size=len(val_ds),
        steps_per_epoch=batcher.steps_per_epoch, seq_len=seq_len,
        vocab_size=train_ds.vocab_size)


def make_task(cfg: TrainConfig) -> Task:
    """Model family -> task: gpt_lm trains next-token prediction."""
    if cfg.model == "gpt_lm":
        return _make_lm_task(cfg, "clm")
    raise NotImplementedError(
        f"no task for model {cfg.model!r} in the PyTorch port yet (see "
        f"ROADMAP.md queue A)")

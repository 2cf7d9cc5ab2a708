"""Task definitions: the port of ``train/tasks.py``'s causal-LM task.

A Task bundles the loss, the data streams and the dataset facts the
loop needs. The ``clm`` task (gpt_lm on the synthetic next-token stream)
trains either the dense head with masked cross-entropy or, with
``ce_chunk > 0``, the fused head+loss (ops/fused_ce.py: the model hands
over its features and head matrix, and the [B, L, V] logits are never
materialized), by the chunk loop (``ce_impl="scan"``) or the fused-CE
kernels (``ce_impl="kernel"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.ops.fused_ce import (
    fused_masked_cross_entropy)
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


def _fused_lm_metrics(model, batch, train, generator, label_smoothing,
                      ce_chunk, ce_impl="scan"):
    """The fused-CE body: run the model in features_only mode and the
    head product inside the chunked loss. Returns (loss, accuracy)."""
    feats, w, bias = model(batch["tokens"], train=train, generator=generator,
                           features_only=True)
    return fused_masked_cross_entropy(
        feats, w, bias, batch["targets"], batch["mask"],
        vocab_size=w.shape[0], chunk=ce_chunk,
        label_smoothing=label_smoothing, impl=ce_impl)


def make_mlm_loss(label_smoothing: float = 0.0, ce_chunk: int = 0,
                  ce_impl: str = "scan") -> LossFn:
    def mlm_loss(model, batch, train, generator=None):
        """Masked-CE objective over a {tokens, targets, mask} batch."""
        if ce_chunk:
            loss, acc = _fused_lm_metrics(model, batch, train, generator,
                                          label_smoothing, ce_chunk, ce_impl)
            return loss, {"loss": loss, "accuracy": acc}
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
        name=objective,
        loss=make_mlm_loss(cfg.label_smoothing, ce_chunk=cfg.ce_chunk,
                           ce_impl=cfg.ce_impl),
        # Eval drops the train-only smoothing but keeps the fused head
        # (the dense eval logits would not fit where ce_chunk is what
        # makes the train shapes fit), always by the scan formulation:
        # the JAX package's eval rule, kept so both report the same.
        eval_loss=make_mlm_loss(ce_chunk=cfg.ce_chunk),
        train_stream=batcher.forever,
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

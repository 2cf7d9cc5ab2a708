"""Task definitions: the port of ``train/tasks.py``'s vision task (the
reference's MNIST classifier) and causal-LM task.

A Task bundles the loss, the data streams and the dataset facts the
loop needs. The ``vision`` task (mnist_cnn) classifies MNIST digits; the
``clm`` task (gpt_lm on the synthetic next-token stream) trains either
the dense head with masked cross-entropy or, with ``ce_chunk > 0``, the
fused head+loss (ops/fused_ce.py: the model hands over its features and
head matrix, and the [B, L, V] logits are never materialized), by the
chunk loop (``ce_impl="scan"``) or the fused-CE kernels
(``ce_impl="kernel"``).

One rule normalizes every loss over the mesh (``parallel/mesh.py``):
each rank computes its cross-entropy sum, correct count and row (or
token) count; the three are summed over the whole world (data x seq),
and the rank's loss to differentiate is its own CE sum over the global
count. The gradients summed over the world (train/step.py) are then
exactly the gradient of the JAX package's global mean, also for masked
LM batches where ranks hold different token counts. Ranks of one data
coordinate that hold the same rows (a vision batch under ``mesh.seq >
1``) count them once each in the sums and in the count alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.ops.fused_ce import fused_ce_sums_by
from tensorflow_distributed_tpu_torch.ops.losses import (
    ce_sums, masked_ce_sums)
from tensorflow_distributed_tpu_torch.parallel.mesh import (
    ONE_PROCESS, Mesh, process_batch_role)
from tensorflow_distributed_tpu_torch.train.step import LossFn


@dataclasses.dataclass
class Task:
    """Everything the loop needs beyond the step machinery."""

    name: str
    loss: LossFn
    # start_step -> this data rank's rows of each global batch
    train_stream: Callable[[int], Iterator[Any]]
    eval_batches: Callable[[int], Iterator[Any]]  # batch_size -> batches
    eval_size: int                    # rows in the eval split
    steps_per_epoch: int
    seq_axis: Optional[int]           # batch dim the seq axis shards, if any
    seq_len: int = 0                  # LM tasks: tokens a row
    # Loss for the EVAL pass; None = same as ``loss`` (train-only label
    # smoothing stays out of reported validation numbers).
    eval_loss: Optional[LossFn] = None
    vocab_size: int = 0               # the dataset's vocabulary (LM)


def _mean(ce_sum, correct, n, mesh: Mesh):
    """(loss to differentiate, metrics) from this rank's sums: the mean
    over the whole world (one all-reduce of the three sums; a no-op
    without a process group)."""
    total = torch.stack([ce_sum, correct, n]).detach().float()
    mesh.all_reduce_sum_([total])
    n_all = total[2].clamp(min=1.0)
    return ce_sum / n_all, {"loss": total[0] / n_all,
                            "accuracy": total[1] / n_all}


# --- vision (the reference's task) --------------------------------------

def make_vision_loss(label_smoothing: float = 0.0,
                     mesh: Mesh = ONE_PROCESS) -> LossFn:
    def vision_loss(model, batch, train, generator=None):
        """The reference's classification objective over an (images,
        labels) batch."""
        images, labels = batch
        logits = model(images, train=train, generator=generator)
        return _mean(*ce_sums(logits, labels, label_smoothing), mesh)

    return vision_loss


def _make_vision_task(cfg: TrainConfig, mesh: Mesh) -> Task:
    from tensorflow_distributed_tpu_torch.data.mnist import (
        ShardedBatcher, load_dataset)

    train_ds, val_ds, _ = load_dataset(cfg.dataset, cfg.data_dir, cfg.seed,
                                       validation_size=cfg.validation_size)
    n_proc, i_proc = process_batch_role(mesh)
    batcher = ShardedBatcher(train_ds, cfg.batch_size, cfg.shuffle_seed,
                             num_processes=n_proc, process_index=i_proc)

    def eval_batches(batch: int) -> Iterator[Any]:
        n = (len(val_ds) // batch) * batch
        for lo in range(0, n, batch):
            yield (val_ds.images[lo:lo + batch], val_ds.labels[lo:lo + batch])

    return Task(
        name="vision", loss=make_vision_loss(cfg.label_smoothing, mesh),
        eval_loss=make_vision_loss(mesh=mesh),
        train_stream=batcher.forever, eval_batches=eval_batches,
        eval_size=len(val_ds), steps_per_epoch=batcher.steps_per_epoch,
        seq_axis=None)


# --- causal LM ------------------------------------------------------------

def _fused_lm_sums(model, batch, train, generator, label_smoothing,
                   ce_chunk, ce_impl="scan"):
    """The fused-CE body: run the model in features_only mode and the
    head product inside the chunked loss. Returns (ce_sum, correct,
    mask_sum)."""
    feats, w, bias = model(batch["tokens"], train=train, generator=generator,
                           features_only=True)
    return fused_ce_sums_by(ce_impl, feats, w, bias, batch["targets"],
                            batch["mask"], vocab_size=w.shape[0],
                            chunk=ce_chunk, label_smoothing=label_smoothing)


def make_mlm_loss(label_smoothing: float = 0.0, ce_chunk: int = 0,
                  ce_impl: str = "scan", mesh: Mesh = ONE_PROCESS) -> LossFn:
    def mlm_loss(model, batch, train, generator=None):
        """Masked-CE objective over a {tokens, targets, mask} batch."""
        if ce_chunk:
            sums = _fused_lm_sums(model, batch, train, generator,
                                  label_smoothing, ce_chunk, ce_impl)
        else:
            logits = model(batch["tokens"], train=train, generator=generator)
            sums = masked_ce_sums(logits, batch["targets"], batch["mask"],
                                  label_smoothing)
        return _mean(*sums, mesh)

    return mlm_loss


def _make_lm_task(cfg: TrainConfig, mesh: Mesh, objective: str = "clm",
                  seq_len: int = 128, vocab_size: int = 64) -> Task:
    """Causal-LM task over the synthetic next-token stream;
    ``cfg.seq_len`` / ``cfg.synthetic_vocab`` override the defaults.
    The train stream yields this data rank's rows of each global batch,
    and the loop hands each seq rank its block of the sequence axis."""
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
    n_proc, i_proc = process_batch_role(mesh)
    batcher = LmBatcher(train_ds, cfg.batch_size, cfg.shuffle_seed,
                        num_processes=n_proc, process_index=i_proc)

    def eval_batches(batch: int) -> Iterator[Any]:
        nrows = (len(val_ds) // batch) * batch
        for lo in range(0, nrows, batch):
            yield val_ds.batch(np.arange(lo, lo + batch))

    return Task(
        name=objective,
        loss=make_mlm_loss(cfg.label_smoothing, ce_chunk=cfg.ce_chunk,
                           ce_impl=cfg.ce_impl, mesh=mesh),
        # Eval drops the train-only smoothing but keeps the fused head
        # (the dense eval logits would not fit where ce_chunk is what
        # makes the train shapes fit), always by the scan formulation:
        # the JAX package's eval rule, kept so both report the same.
        eval_loss=make_mlm_loss(ce_chunk=cfg.ce_chunk, mesh=mesh),
        train_stream=batcher.forever,
        eval_batches=eval_batches, eval_size=len(val_ds),
        steps_per_epoch=batcher.steps_per_epoch, seq_axis=1,
        seq_len=seq_len, vocab_size=train_ds.vocab_size)


def make_task(cfg: TrainConfig, mesh: Mesh = ONE_PROCESS) -> Task:
    """Model family -> task: mnist_cnn classifies digits, gpt_lm trains
    next-token prediction."""
    if cfg.model == "mnist_cnn":
        return _make_vision_task(cfg, mesh)
    if cfg.model == "gpt_lm":
        return _make_lm_task(cfg, mesh)
    raise NotImplementedError(
        f"no task for model {cfg.model!r} in the PyTorch port yet (see "
        f"ROADMAP.md queue A)")

"""Task definitions: the port of ``train/tasks.py``'s vision task and
LM tasks.

A Task bundles the loss, the data streams and the dataset facts the
loop needs. The ``vision`` task (mnist_cnn, resnet20, resnet50)
classifies images of any vision dataset (``data/mnist.py``'s
``load_dataset``), batched by numpy or, under ``--data-backend
u8_native``, from uint8 storage by the native gather (``data/u8.py``).
The ``mlm`` task (bert_mlm on the synthetic masked-token stream) and the
``clm`` task (gpt_lm on the synthetic next-token stream, or on a local
text corpus under ``--dataset text``) train either the dense head with
masked cross-entropy or, with ``ce_chunk > 0``, the fused head+loss (ops/fused_ce.py: the model hands over its features and
head matrix, and the [B, L, V] logits are never materialized), by the
chunk loop (``ce_impl="scan"``) or the fused-CE kernels
(``ce_impl="kernel"``). A transformer with experts (``moe_lm``, or
``--moe-experts`` on gpt_lm or bert_mlm) trains the ``moe_clm`` or
``moe_mlm`` objective: the same CE plus the routers' load-balance and
z-loss terms (``make_moe_loss``).

One rule normalizes every loss over the mesh (``parallel/mesh.py``):
each rank computes its cross-entropy sum, correct count and row (or
token) count; the three are summed over the replica group (the data x
seq ranks of one model and expert index: the whole world without a
model or expert axis),
and the rank's loss to differentiate is its own CE sum over the global
count. Under tensor parallelism the sums come out of the vocab-parallel
losses already whole on every model rank (their combine over the model
group), so the model ranks are not summed again. The gradients summed
over the replica group (train/step.py) are then exactly the gradient of
the JAX package's global mean, also for masked LM batches where ranks
hold different token counts. Ranks of one data coordinate that hold the
same rows (a vision batch under ``mesh.seq > 1``) count them once each
in the sums and in the count alike. The router terms follow the same
rule (``models/moe.moe_objective``): the routed counts are summed over
the replica group, and each rank differentiates its own probability and
z sums over the global token count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models.moe import moe_objective
from tensorflow_distributed_tpu_torch.ops.fused_ce import fused_ce_sums_by
from tensorflow_distributed_tpu_torch.ops.losses import (
    ce_sums, masked_ce_sums)
from tensorflow_distributed_tpu_torch.parallel.mesh import (
    ONE_PROCESS, Mesh, process_batch_role)
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    VocabShards)
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
    image_shape: tuple = ()           # vision: one image's [H, W, C]
    # The pipeline's microbatches a batch splits into (a data rank holds
    # its rows of each); 1 without a pipeline.
    microbatches: int = 1


def _mean(ce_sum, correct, n, mesh: Mesh):
    """(loss to differentiate, metrics) from this rank's sums: the mean
    over the replica group (one all-reduce of the three sums; a no-op
    without a process group)."""
    total = torch.stack([ce_sum, correct, n]).detach().float()
    mesh.replica_all_reduce_([total])
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
    if cfg.data_backend == "u8_native":
        from tensorflow_distributed_tpu_torch.data.u8 import (
            U8Dataset, U8ShardedBatcher)
        batcher = U8ShardedBatcher(
            U8Dataset.from_float(train_ds), cfg.batch_size, cfg.shuffle_seed,
            num_processes=n_proc, process_index=i_proc,
            accum_steps=cfg.grad_accum_steps)
    else:
        batcher = ShardedBatcher(train_ds, cfg.batch_size, cfg.shuffle_seed,
                                 num_processes=n_proc, process_index=i_proc,
                                 accum_steps=cfg.grad_accum_steps)

    def eval_batches(batch: int) -> Iterator[Any]:
        n = (len(val_ds) // batch) * batch
        for lo in range(0, n, batch):
            yield (val_ds.images[lo:lo + batch], val_ds.labels[lo:lo + batch])

    return Task(
        name="vision",
        loss=make_vision_loss(cfg.label_smoothing, _train_mesh(cfg, mesh)),
        eval_loss=make_vision_loss(mesh=mesh),
        train_stream=batcher.forever, eval_batches=eval_batches,
        eval_size=len(val_ds), steps_per_epoch=batcher.steps_per_epoch,
        seq_axis=None, image_shape=tuple(train_ds.images.shape[1:]))


# --- causal LM ------------------------------------------------------------

def _fused_lm_sums(model, batch, train, generator, label_smoothing,
                   ce_chunk, ce_impl="scan", **model_kw):
    """The fused-CE body: run the model in features_only mode and the
    head product inside the chunked loss. Returns (ce_sum, correct,
    mask_sum)."""
    feats, w, bias = model(batch["tokens"], train=train, generator=generator,
                           features_only=True, **model_kw)
    vocab = w.vocab_size if isinstance(w, VocabShards) else w.shape[0]
    return fused_ce_sums_by(ce_impl, feats, w, bias, batch["targets"],
                            batch["mask"], vocab_size=vocab,
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


MOE_AUX_WEIGHT = 0.01  # Switch-Transformer-style coefficient (JAX's)


def make_moe_loss(aux_weight: float = MOE_AUX_WEIGHT,
                  zloss_weight: float = 0.0, label_smoothing: float = 0.0,
                  ce_chunk: int = 0, ce_impl: str = "scan",
                  mesh: Mesh = ONE_PROCESS) -> LossFn:
    """JAX's ``make_moe_loss``: the masked CE (dense head, or the fused
    body with ``ce_chunk``) plus ``aux_weight`` x the load-balance term
    and ``zloss_weight`` x the router z-loss, each the mean over the MoE
    layers and over the global batch. The metrics are JAX's: ``loss``
    (the CE alone), ``aux_loss``, ``z_loss``, ``dropped_frac``
    (never in the objective) and ``accuracy``."""

    def moe_loss(model, batch, train, generator=None):
        auxes: list = []
        if ce_chunk:
            sums = _fused_lm_sums(model, batch, train, generator,
                                  label_smoothing, ce_chunk, ce_impl,
                                  moe_aux=auxes)
        else:
            logits = model(batch["tokens"], train=train, generator=generator,
                           moe_aux=auxes)
            sums = masked_ce_sums(logits, batch["targets"], batch["mask"],
                                  label_smoothing)
        loss, metrics = _mean(*sums, mesh)
        lb, z, aux = moe_objective(auxes, mesh)
        total = loss + aux_weight * lb + zloss_weight * z
        return total, {"loss": metrics["loss"],
                       "aux_loss": aux["load_balance"],
                       "z_loss": aux["z_loss"],
                       "dropped_frac": aux["dropped_fraction"],
                       "accuracy": metrics["accuracy"]}

    return moe_loss


def make_pipelined_loss(label_smoothing: float = 0.0, ce_chunk: int = 0,
                        mesh: Mesh = ONE_PROCESS, moe: bool = False,
                        aux_weight: float = MOE_AUX_WEIGHT,
                        zloss_weight: float = 0.0) -> LossFn:
    """The pipelined family's objective through its GPipe forward
    (``models/pipelined.py``; the standard step differentiates it): the
    masked CE on the process that holds the last stage (the dense head,
    or with ``ce_chunk`` the fused loss's scan form), whose three sums
    are the only ones over the world (the other stages add zeros), and
    with ``moe`` JAX's router terms: each rank's (stage, microbatch)
    sums over ``n_layers * M``, weighted as ``make_moe_loss`` weights
    them. A rank that holds no last stage differentiates its router
    terms and the hop token (``link``), so its backward runs the
    schedule's."""

    def pipelined_loss(model, batch, train, generator=None):
        link: list = []
        auxes: Optional[list] = [] if moe else None
        out = model(batch["tokens"], train=train, generator=generator,
                    features_only=bool(ce_chunk), moe_aux=auxes, link=link)
        if out is None:
            zero = torch.zeros((), device=batch["tokens"].device)
            ce_sum, correct, n = zero, zero, zero
        elif ce_chunk:
            feats, w, bias = out
            ce_sum, correct, n = fused_ce_sums_by(
                "scan", feats, w, bias, batch["targets"], batch["mask"],
                vocab_size=w.shape[0], chunk=ce_chunk,
                label_smoothing=label_smoothing)
        else:
            ce_sum, correct, n = masked_ce_sums(
                out, batch["targets"], batch["mask"], label_smoothing)
        value, metrics = _mean(ce_sum, correct, n, mesh)
        for token in link:
            value = value + 0.0 * token
        if not moe:
            return value, metrics
        cfg = model.cfg
        denom = cfg.n_layers * model.num_microbatches
        aux = auxes[0]
        value = value + (aux_weight * aux["load_balance"]
                         + zloss_weight * aux["z_loss"]) / denom
        # The metrics: lb and z parts over the world, each slot's global
        # dropped fraction over the pipe group.
        parts = torch.stack([aux["load_balance"], aux["z_loss"]]).detach()
        mesh.replica_all_reduce_([parts])
        dropped = aux["dropped_fraction"].detach().reshape(1).clone()
        mesh.pipe_all_reduce_([dropped])
        return value, {"loss": metrics["loss"],
                       "aux_loss": parts[0] / denom,
                       "z_loss": parts[1] / denom,
                       "dropped_frac": dropped[0] / denom,
                       "accuracy": metrics["accuracy"]}

    return pipelined_loss


def _make_lm_task(cfg: TrainConfig, mesh: Mesh, objective: str,
                  seq_len: int = 128, vocab_size: int = 64) -> Task:
    """LM task: ``objective`` "mlm" (masked positions, the synthetic
    masked-token stream) or "clm" (next token: the synthetic stream, or
    under ``--dataset text`` the local corpus at ``--data-dir``, whose
    tokenizer sets the vocabulary), with a "moe_" prefix the MoE loss
    over the same stream. ``cfg.seq_len`` /
    ``cfg.synthetic_vocab`` override the defaults. The train stream
    yields this data rank's rows of each global batch, and the loop
    hands each seq rank its block of the sequence axis."""
    from tensorflow_distributed_tpu_torch.data.lm import (
        LmBatcher, synthetic_clm, synthetic_mlm, text_clm)

    seq_len = cfg.seq_len or seq_len
    vocab_size = cfg.synthetic_vocab or vocab_size
    if cfg.dataset == "text":
        if not objective.endswith("clm"):
            raise ValueError(
                "dataset='text' is causal-LM only (gpt_lm / moe_lm / "
                "pipelined_lm); bert_mlm has no byte-masking stream")
        train_ds, val_ds = text_clm(cfg.data_dir, seq_len=seq_len,
                                    seed=cfg.seed,
                                    tokenizer=cfg.text_tokenizer,
                                    bpe_vocab_size=cfg.bpe_vocab_size)
        # Fail at task creation, not after training: the final eval needs
        # one data-axis-wide batch of val rows, the batcher a full train
        # batch.
        if len(train_ds) < cfg.batch_size or len(val_ds) < mesh.data:
            raise ValueError(
                f"corpus {cfg.data_dir!r} too small: {len(train_ds)} "
                f"train / {len(val_ds)} val windows of seq_len "
                f"{seq_len}; need >= batch_size {cfg.batch_size} train "
                f"and >= mesh data axis {mesh.data} val")
    else:
        gen = synthetic_mlm if objective.endswith("mlm") else synthetic_clm
        n = max(16 * cfg.batch_size, 4096)
        train_ds = gen(n=n, seq_len=seq_len, vocab_size=vocab_size,
                       seed=cfg.seed)
        val_ds = gen(n=max(4 * cfg.eval_batch_size, 512), seq_len=seq_len,
                     vocab_size=vocab_size, seed=cfg.seed + 1)
    n_proc, i_proc = process_batch_role(mesh)
    # A pipelined step splits each (accumulation) microbatch into the
    # pipeline's: a data rank draws its rows of each of JAX's.
    pipelined = cfg.model == "pipelined_lm"
    splits = cfg.grad_accum_steps * (cfg.pipeline_microbatches
                                     if pipelined else 1)
    batcher = LmBatcher(train_ds, cfg.batch_size, cfg.shuffle_seed,
                        num_processes=n_proc, process_index=i_proc,
                        accum_steps=splits)

    def eval_batches(batch: int) -> Iterator[Any]:
        nrows = (len(val_ds) // batch) * batch
        for lo in range(0, nrows, batch):
            yield val_ds.batch(np.arange(lo, lo + batch))

    if pipelined:
        moe = objective.startswith("moe_")
        loss = make_pipelined_loss(
            cfg.label_smoothing, cfg.ce_chunk, _train_mesh(cfg, mesh), moe,
            cfg.moe_aux_weight, cfg.moe_zloss_weight)
        eval_loss = make_pipelined_loss(
            ce_chunk=cfg.ce_chunk, mesh=mesh, moe=moe,
            aux_weight=cfg.moe_aux_weight, zloss_weight=cfg.moe_zloss_weight)
    elif objective.startswith("moe_"):
        loss = make_moe_loss(cfg.moe_aux_weight, cfg.moe_zloss_weight,
                             cfg.label_smoothing, ce_chunk=cfg.ce_chunk,
                             ce_impl=cfg.ce_impl, mesh=mesh)
        # Eval keeps the router terms (part of the objective reported).
        eval_loss = make_moe_loss(cfg.moe_aux_weight, cfg.moe_zloss_weight,
                                  ce_chunk=cfg.ce_chunk, mesh=mesh)
    else:
        loss = make_mlm_loss(cfg.label_smoothing, ce_chunk=cfg.ce_chunk,
                             ce_impl=cfg.ce_impl, mesh=_train_mesh(cfg, mesh))
        eval_loss = make_mlm_loss(ce_chunk=cfg.ce_chunk, mesh=mesh)
    return Task(
        name=objective, loss=loss,
        # Eval drops the train-only smoothing but keeps the fused head
        # (the dense eval logits would not fit where ce_chunk is what
        # makes the train shapes fit), always by the scan formulation:
        # the JAX package's eval rule, kept so both report the same.
        eval_loss=eval_loss,
        train_stream=batcher.forever,
        eval_batches=eval_batches, eval_size=len(val_ds),
        steps_per_epoch=batcher.steps_per_epoch, seq_axis=1,
        seq_len=seq_len, vocab_size=train_ds.vocab_size,
        microbatches=cfg.pipeline_microbatches if pipelined else 1)


def _train_mesh(cfg: TrainConfig, mesh: Mesh) -> Mesh:
    """The mesh the train loss normalizes over: none under the explicit
    sync or local SGD (each rank's own mean)."""
    if cfg.grad_sync == "implicit" and cfg.param_sync_every == 1:
        return mesh
    return ONE_PROCESS


def make_task(cfg: TrainConfig, mesh: Mesh = ONE_PROCESS) -> Task:
    """Model family -> task: bert_mlm trains masked-LM, gpt_lm, moe_lm
    and pipelined_lm next-token prediction (with experts, the MoE
    objective; pipelined_lm through its GPipe forward);
    every other family classifies images."""
    moe = cfg.moe_experts > 0 or cfg.model == "moe_lm"
    if cfg.model == "bert_mlm":
        return _make_lm_task(cfg, mesh, "moe_mlm" if moe else "mlm")
    if cfg.model in ("gpt_lm", "moe_lm", "pipelined_lm"):
        return _make_lm_task(cfg, mesh, "moe_clm" if moe else "clm")
    return _make_vision_task(cfg, mesh)

"""The 1F1B pipelined train step: the port of ``train/pipeline_step.py``.

The standard step (``train/step.py``) runs ``pipelined_lm``'s GPipe
schedule: every forward, then autograd's backwards, each stage keeping M
microbatches of activations. This step runs 1F1B instead
(``parallel/pipeline.pipeline_value_and_grad``, or the interleaved form
with virtual stages): the loss is computed at the last stage inside the
schedule, and a microbatch's backward starts as soon as it clears the
last stage, so a stage keeps at most min(2 S, M) microbatches in flight.

What remains outside the schedule is the embedding: every rank embeds
the batch (its shape sizes the hops), and the holder of stage 0 runs the
embedding's backward from the cotangent the schedule returns. The head's
gradient accumulates at the last stage; the shell's gradient is the sum
of the two, summed over the pipe group (and the data and seq groups:
``parallel/pipeline.sync_pipe_grads_``), which is what ``--tie-embeddings``
needs. Per-microbatch CE sums are seeded with 1 / the global mask count
(summed over the data and seq groups), so the gradients and the loss
are the global batch's mean, as JAX's. MoE router losses are seeded per
slot with weight / (n_layers M). Under ``--mesh.model`` a stage's
blocks are Megatron blocks and under ``--mesh.seq`` its attention is
the ring (``models/pipelined.py``); recompute, stash and virtual stages
run under both.

The update is the standard step's: the optimizer (its clip by the norm
``pipe_grad_norm`` sums over the stages), under ``--param-partition
zero1`` on this data rank's blocks of the cut leaves with the params
all-gathered after it, the EMA and the counter. The loss and accuracy
sums leave the last stage by one all-reduce over the replica group
(the world without a model axis), so the chief (rank 0, stage 0)
reports them.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tensorflow_distributed_tpu_torch.models.pipelined import PipelinedLM
from tensorflow_distributed_tpu_torch.ops.fused_ce import fused_ce_sums
from tensorflow_distributed_tpu_torch.ops.losses import masked_ce_sums
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.parallel.pipeline import (
    interleaved_pipeline_value_and_grad, pipe_grad_norm,
    pipeline_value_and_grad, sync_pipe_grads_)
from tensorflow_distributed_tpu_torch.train.optim import global_norm
from tensorflow_distributed_tpu_torch.train.state import TrainState
from tensorflow_distributed_tpu_torch.parallel.sharding import is_sharded
from tensorflow_distributed_tpu_torch.train.step import (
    finish, gather_blocked_, step_seed)
from tensorflow_distributed_tpu_torch.train.tasks import MOE_AUX_WEIGHT

Batch = Dict[str, torch.Tensor]


def make_1f1b_train_step(model: PipelinedLM, device: torch.device,
                         mesh: Mesh = ONE_PROCESS, seed: int = 0,
                         moe_aux_weight: float = MOE_AUX_WEIGHT,
                         moe_zloss_weight: float = 0.0,
                         grad_norm_metric: bool = False,
                         label_smoothing: float = 0.0,
                         ema_decay: float = 0.0,
                         backward: str = "recompute",
                         ce_chunk: int = 0
                         ) -> Callable[[TrainState, Batch],
                                       Tuple[TrainState, Dict]]:
    """The 1F1B step of ``model`` (a ``PipelinedLM`` whose transport is
    the mesh's pipe) on ``device``. Same batches, state and optimizer as
    the standard step; ``backward``: "recompute" or "stash" (virtual
    stages: recompute only); ``ce_chunk`` > 0 runs the last stage's head
    inside the fused loss's scan form. Dropout reseeds a generator from
    (``seed``, this rank's data place, the step), as the standard step
    does, and each slot draws from (that seed, microbatch, virtual
    stage)."""
    V = model.virtual_stages
    if V > 1 and backward != "recompute":
        raise ValueError("pipeline_backward='stash' is not supported "
                         "with virtual stages; use 'recompute'")
    cfg = model.cfg
    moe = cfg.moe_experts > 0
    generator = torch.Generator(device=device)
    piped = mesh.pipe > 1 and mesh.distributed
    sharded = frozenset(n for n, _ in model.named_parameters()
                        if is_sharded(n, model))
    denom = cfg.n_layers * model.num_microbatches

    if ce_chunk:
        def last_fn(y, aux_mb):
            feats, w, bias = model.head_pieces(y)
            tgt, msk = aux_mb
            ce, correct, n = fused_ce_sums(feats, w, bias, tgt, msk,
                                           w.shape[0], ce_chunk,
                                           label_smoothing)
            return ce, {"correct": correct, "mask": n}
    else:
        def last_fn(y, aux_mb):
            tgt, msk = aux_mb
            ce, correct, n = masked_ce_sums(model.head(y), tgt, msk,
                                            label_smoothing)
            return ce, {"correct": correct, "mask": n}

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict]:
        tokens, targets, mask = batch["tokens"], batch["targets"], \
            batch["mask"]
        count = mask.float().sum().reshape(1)
        mesh.data_all_reduce_([count])
        mesh.seq_all_reduce_([count])
        total = torch.clamp(count[0], min=1.0)
        generator.manual_seed(step_seed(seed, mesh.replica_index,
                                        state.step))
        x = model.embed(tokens)
        stage_fn = model.make_stage_fn(
            train=True, seed=(generator.initial_seed()
                              if cfg.dropout_rate else None),
            with_aux=moe)
        aux_cot = ({"load_balance": moe_aux_weight / denom,
                    "z_loss": moe_zloss_weight / denom,
                    "dropped_fraction": 0.0} if moe else None)
        kw = dict(cotangent_scale=1.0 / total, stage_aux_cotangent=aux_cot)
        if V > 1:
            val, sums, aux, d_x = interleaved_pipeline_value_and_grad(
                stage_fn, last_fn, x, (targets, mask), model.pipe,
                model.num_microbatches, V, **kw)
        else:
            val, sums, aux, d_x = pipeline_value_and_grad(
                stage_fn, last_fn, x, (targets, mask), model.pipe,
                model.num_microbatches, backward=backward, **kw)
        if d_x is not None:
            x.backward(d_x.to(x.dtype))
        params, part = state.params, state.partition
        if mesh.distributed:
            sync_pipe_grads_(model, mesh)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        zero = torch.zeros((), device=x.device)
        packed = torch.stack([val, sums.get("correct", zero),
                              sums.get("mask", zero)]).float()
        mesh.replica_all_reduce_([packed])
        metrics = {"loss": packed[0] / total,
                   "accuracy": packed[1] / torch.clamp(packed[2], min=1.0)}
        if moe:
            parts = torch.stack([aux["load_balance"], aux["z_loss"]])
            mesh.replica_all_reduce_([parts])
            dropped = aux["dropped_fraction"].reshape(1).clone()
            mesh.pipe_all_reduce_([dropped])
            metrics.update(aux_loss=parts[0] / denom, z_loss=parts[1] / denom,
                           dropped_frac=dropped[0] / denom)
        norm = None
        if grad_norm_metric or state.tx.clip_norm:
            norm = (pipe_grad_norm(grads, mesh, model.shell_names(), sharded)
                    if piped else global_norm(list(grads.values())))
        if grad_norm_metric:
            metrics["grad_norm"] = norm
        with torch.no_grad():
            # zero1: this data rank's blocks of the cut leaves, their
            # slots' layout, then the params gathered back.
            views = part.slot_views(params)
            updates = state.tx.update(part.slot_views(grads),
                                      state.opt_state, views, norm=norm)
            torch._foreach_add_(list(views.values()),
                                [updates[n] for n in views])
            if part.kind == "zero1":
                gather_blocked_(params, part)
        finish(state, True, ema_decay)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step

"""The training loop: the port of ``train/loop.py``'s ``train`` and
``evaluate``, on one device or over ``--mesh.seq`` processes.

Same cadence as the JAX loop: the first step runs apart from the timed
span (it carries one-time set-up: CUDA context, library handles, the
kernel build on a fresh checkout), metrics are fetched to the host
every ``log_every`` steps, eval runs every ``eval_every`` steps and once
at the end, and the run ends with a JSON ``done`` record.

With ``--mesh.seq S`` (S processes under torchrun, one GPU each; see
``parallel/mesh.py``) every rank draws the same global batch from the
seeded batcher and keeps its contiguous block ``[d*L/S, (d+1)*L/S)`` of
the sequence axis; the parameters start from rank 0's copy; the step
records, eval records and the ``done`` record come from the chief only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import build_model
from tensorflow_distributed_tpu_torch.parallel import mesh
from tensorflow_distributed_tpu_torch.train.optim import make_optimizer
from tensorflow_distributed_tpu_torch.train.state import (
    TrainState, create_train_state, param_count)
from tensorflow_distributed_tpu_torch.train.step import (
    make_eval_step, make_train_step)
from tensorflow_distributed_tpu_torch.train.tasks import Task, make_task
from tensorflow_distributed_tpu_torch.utils.logging import MetricLogger, Timer


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    train_seconds: float
    eval_seconds: float
    final_metrics: Dict[str, float]
    steps_per_sec: float
    images_per_sec: float
    logger: MetricLogger


def resolve_device(name: str) -> torch.device:
    """The run's device. A CUDA device that is not there is an error:
    the port never drops to the CPU unless asked (``--device cpu``)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; pass "
            f"--device cpu to run the plain (CPU) path")
    return device


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors (pinned, asynchronous copies on a
    GPU so the host keeps dispatching)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def seq_block(batch: Dict[str, np.ndarray], ring
              ) -> Dict[str, np.ndarray]:
    """This rank's contiguous block of the sequence axis of a global
    [B, L] batch (the whole batch without a ring)."""
    if ring is None:
        return batch
    n = next(iter(batch.values())).shape[1] // ring.size
    lo = ring.index * n
    return {k: v[:, lo:lo + n] for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(state: TrainState, eval_fn, task: Task, batch: int,
             device: torch.device, ring=None) -> Dict[str, float]:
    """Full-split eval in fixed-size batches; CLM also reports
    perplexity = exp(mean cross-entropy). With a ``ring`` every rank
    evaluates its block of each batch (the metrics are group means)."""
    batch = min(batch, task.eval_size)
    totals: Dict[str, float] = {}
    count = 0
    for host_batch in task.eval_batches(batch):
        m = eval_fn(state, to_device(seq_block(host_batch, ring), device))
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v) * batch
        count += batch
    out = {k: v / max(count, 1) for k, v in totals.items()}
    if "loss" in out and task.name.endswith("clm"):
        out["perplexity"] = float(np.exp(out["loss"]))
    if count < task.eval_size and mesh.is_chief():
        print(f"[eval] split has {task.eval_size} rows; evaluated "
              f"{count} (remainder dropped by batch size {batch})")
    return out


def _build_model_and_state(cfg: TrainConfig, device: torch.device,
                           init_params=None, ring=None):
    size_kw = {"size": cfg.model_size or "small", "ring": ring}
    if cfg.synthetic_vocab:
        size_kw["vocab_size"] = cfg.synthetic_vocab
    if cfg.seq_len:
        size_kw["max_len"] = cfg.seq_len
    if cfg.tie_embeddings:
        size_kw["tie_embeddings"] = cfg.tie_embeddings
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    with torch.device(device):
        model = build_model(cfg.model, dropout_rate=cfg.dropout_rate,
                            compute_dtype=dtype, **size_kw)
    tx = make_optimizer(cfg, model)
    state = create_train_state(model, tx, cfg.seed, init_params)
    if ring is not None:  # every rank starts from rank 0's parameters
        mesh.broadcast_(model.parameters(), 0, ring.group)
    return model, state


def train(cfg: TrainConfig, logger: Optional[MetricLogger] = None,
          init_params: Optional[Dict[str, torch.Tensor]] = None
          ) -> TrainResult:
    """Train ``cfg`` on its device. ``init_params`` (a state dict)
    replaces the seeded init, so a run can start from the JAX package's
    init (``interop.params_from_flax``) for parity checks. With
    ``cfg.mesh.seq > 1`` this is one rank of the ring (``parallel/
    mesh.py``): the process group is started from torchrun's
    environment unless the caller has started one; the caller ends it
    (``mesh.shutdown``)."""
    cfg.validate()
    device = resolve_device(mesh.rank_device(cfg.device, cfg.mesh.seq))
    ring = mesh.bootstrap(cfg.mesh.seq, device)
    logger = logger or MetricLogger()
    if not mesh.is_chief():
        logger.enabled = False  # every rank keeps its records; one prints
    task = make_task(cfg, ring)
    if task.seq_len % cfg.mesh.seq:
        raise ValueError(f"--mesh.seq {cfg.mesh.seq} must divide the "
                         f"sequence length {task.seq_len}")
    model, state = _build_model_and_state(cfg, device, init_params, ring)
    step_fn = make_train_step(task.loss, device, cfg.seed,
                              grad_norm_metric=cfg.log_grad_norm, ring=ring)
    eval_fn = make_eval_step(task.eval_loss or task.loss)
    logger.log_json({
        "event": "start", "model": cfg.model, "task": task.name,
        "params": param_count(model), "device": str(device),
        "global_batch": cfg.batch_size, "start_step": 0,
        "mesh": {"seq": cfg.mesh.seq},
    })

    def cadence(step_now: int, metrics) -> None:
        if cfg.log_every and step_now % cfg.log_every == 0:
            logger.log(step_now, **{k: float(v) for k, v in metrics.items()})
        if cfg.eval_every and step_now % cfg.eval_every == 0:
            em = evaluate(state, eval_fn, task, cfg.eval_batch_size, device,
                          ring)
            logger.log(step_now, **{f"val_{k}": v for k, v in em.items()})

    stream = task.train_stream(0)

    def next_batch():
        return to_device(seq_block(next(stream), ring), device)

    with Timer() as first_t:
        if cfg.train_steps > 0:
            state, metrics = step_fn(state, next_batch())
            _sync(device)
            cadence(1, metrics)
    steps_done = 1 if cfg.train_steps > 0 else 0
    with Timer() as train_t:
        for i in range(steps_done, cfg.train_steps):
            state, metrics = step_fn(state, next_batch())
            cadence(i + 1, metrics)
        _sync(device)
    with Timer() as eval_t:
        final = evaluate(state, eval_fn, task, cfg.eval_batch_size, device,
                         ring)
    steady = max(state.step - steps_done, 0)
    sps = steady / train_t.elapsed if train_t.elapsed > 0 else 0.0
    result = TrainResult(
        state=state, train_seconds=first_t.elapsed + train_t.elapsed,
        eval_seconds=eval_t.elapsed, final_metrics=final,
        steps_per_sec=sps, images_per_sec=sps * cfg.batch_size,
        logger=logger)
    logger.log_json({
        "event": "done", "steps": state.step,
        "train_seconds": round(result.train_seconds, 3),
        "first_step_seconds": round(first_t.elapsed, 3),
        "steps_per_sec": round(sps, 3),
        "tokens_per_sec": round(sps * cfg.batch_size * task.seq_len, 1),
        **{f"val_{k}": round(v, 5) for k, v in final.items()},
    })
    return result

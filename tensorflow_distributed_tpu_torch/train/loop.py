"""The training loop: the port of ``train/loop.py``'s ``train``,
``evaluate``, ``evaluate_only`` (``--mode eval``) and ``generate_only``
(``--mode generate``), on one device or over a (data, seq) mesh of
processes.

Same cadence as the JAX loop: the first step runs apart from the timed
span (it carries one-time set-up: CUDA context, library handles, the
kernel build on a fresh checkout), metrics are fetched to the host
every ``log_every`` steps, eval runs every ``eval_every`` steps and once
at the end, a checkpoint is saved every ``checkpoint_every`` steps and
once at the end (with ``--checkpoint-dir``), and the run ends with a
JSON ``done`` record. ``--resume`` restores the latest checkpoint and
continues from its step on the batches an uninterrupted run would
draw.

Under ``--mesh.data D --mesh.seq S`` (D*S processes under torchrun, one
GPU each; see ``parallel/mesh.py``) each rank draws only its data
rank's rows of every global batch and keeps its contiguous block
``[s*L/S, (s+1)*L/S)`` of the sequence axis; batches reach the device
through ``data/prefetch.py``; the parameters start from rank 0's copy;
eval metrics are world means; the step records, eval records and the
``done`` record come from the chief only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.data.prefetch import (
    map_batch, prefetch, to_device)
from tensorflow_distributed_tpu_torch.models import build_model
from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train.optim import make_optimizer
from tensorflow_distributed_tpu_torch.train.state import (
    TrainState, create_train_state, ema_init, param_count)
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


def data_rows(batch, mesh: Mesh):
    """This data rank's rows of a global batch (dict or tuple)."""
    if mesh.data == 1:
        return batch
    n = len(next(iter(batch.values())) if isinstance(batch, dict)
            else batch[0]) // mesh.data
    lo = mesh.data_index * n
    return map_batch(lambda v: v[lo:lo + n], batch)


def seq_block(batch, mesh: Mesh, seq_axis: Optional[int]):
    """This rank's contiguous block of the sequence axis (``seq_axis``
    of each array) under ``mesh.seq > 1``; the batch itself otherwise."""
    if seq_axis is None or mesh.seq == 1:
        return batch

    def block(v):
        n = v.shape[seq_axis] // mesh.seq
        return np.take(v, np.arange(mesh.seq_index * n,
                                    (mesh.seq_index + 1) * n), seq_axis)

    return map_batch(block, batch)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(state: TrainState, eval_fn, task: Task, batch: int,
             device: torch.device, mesh: Mesh = ONE_PROCESS
             ) -> Dict[str, float]:
    """Full-split eval in fixed-size batches (clamped to the split,
    rounded to a multiple of the data width, the remainder dropped as
    the JAX loop drops it); CLM also reports perplexity = exp(mean
    cross-entropy). Each rank evaluates its rows and sequence block of
    every batch; the metrics are world means (the loss all-reduces its
    sums)."""
    batch = min(batch, (task.eval_size // mesh.data) * mesh.data)
    if batch == 0:
        raise ValueError(f"validation split ({task.eval_size} rows) smaller "
                         f"than the mesh data axis ({mesh.data})")
    totals: Dict[str, float] = {}
    count = 0
    for host_batch in task.eval_batches(batch):
        local = seq_block(data_rows(host_batch, mesh), mesh, task.seq_axis)
        m = eval_fn(state, to_device(local, device))
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v) * batch
        count += batch
    out = {k: v / max(count, 1) for k, v in totals.items()}
    if "loss" in out and task.name.endswith("clm"):
        out["perplexity"] = float(np.exp(out["loss"]))
    if count < task.eval_size and mesh_lib.is_chief():
        print(f"[eval] split has {task.eval_size} rows; evaluated "
              f"{count} (remainder dropped by batch size {batch})")
    return out


def build_model_for(cfg: TrainConfig, device: torch.device, ring=None):
    """The model ``cfg`` names, built on ``device`` with its weights not
    yet drawn (``init_weights``); ``ring``: the seq group's ring."""
    if cfg.model == "gpt_lm":
        kw = {"size": cfg.model_size or "small", "ring": ring}
        if cfg.synthetic_vocab:
            kw["vocab_size"] = cfg.synthetic_vocab
        if cfg.seq_len:
            kw["max_len"] = cfg.seq_len
        if cfg.tie_embeddings:
            kw["tie_embeddings"] = cfg.tie_embeddings
        # The modern GPT options, passed as the JAX _build_model_and_state
        # passes them (only where they leave their defaults).
        if cfg.remat != "none":
            kw.update(remat=True, remat_policy=cfg.remat)
        if cfg.pos_emb != "learned":
            kw.update(pos_emb=cfg.pos_emb, rope_theta=cfg.rope_theta)
        for name, default in (("n_kv_heads", 0), ("attn_window", 0),
                              ("mlp_variant", "gelu"),
                              ("norm", "layernorm"),
                              ("kv_cache_quant", "none")):
            if getattr(cfg, name) != default:
                kw[name] = getattr(cfg, name)
    else:
        kw = {"init_scheme": cfg.init_scheme}
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    with torch.device(device):
        return build_model(cfg.model, dropout_rate=cfg.dropout_rate,
                           compute_dtype=dtype, **kw)


def _build_model_and_state(cfg: TrainConfig, device: torch.device,
                           init_params=None, mesh: Mesh = ONE_PROCESS):
    model = build_model_for(cfg, device, mesh.ring)
    tx = make_optimizer(cfg, model)
    state = create_train_state(model, tx, cfg.seed, init_params)
    mesh.broadcast_(model.parameters())  # every rank starts from rank 0's
    if cfg.ema_decay:
        state.ema = ema_init(state.params)
    return model, state


def _setup(cfg: TrainConfig, logger: Optional[MetricLogger]):
    """The run's device, mesh and logger: the checks that need no process
    group, then the group (``mesh_lib.bootstrap``)."""
    cfg.validate()
    device = resolve_device(mesh_lib.rank_device(cfg.device))
    data, seq = mesh_lib.mesh_shape(cfg.mesh.data, cfg.mesh.seq)
    why = mesh_lib.mesh_infeasible({"data": data, "seq": seq}, data * seq,
                                   cfg.batch_size)
    if why:
        raise ValueError(f"--mesh.data {data} --mesh.seq {seq}: {why}")
    if (cfg.batch_size // data) % cfg.grad_accum_steps:
        raise ValueError(
            f"grad_accum_steps {cfg.grad_accum_steps} must divide the "
            f"per-rank batch {cfg.batch_size // data} (batch_size / "
            f"mesh.data)")
    mesh = mesh_lib.bootstrap(data, seq, device)
    logger = logger or MetricLogger()
    if not mesh_lib.is_chief():
        logger.enabled = False  # every rank keeps its records; one prints
    return device, mesh, logger


def _make_task(cfg: TrainConfig, mesh: Mesh) -> Task:
    task = make_task(cfg, mesh)
    if task.seq_axis is not None and task.seq_len % mesh.seq:
        raise ValueError(f"--mesh.seq {mesh.seq} must divide the "
                         f"sequence length {task.seq_len}")
    return task


def train(cfg: TrainConfig, logger: Optional[MetricLogger] = None,
          init_params: Optional[Dict[str, torch.Tensor]] = None
          ) -> TrainResult:
    """Train ``cfg`` on its device. ``init_params`` (a state dict)
    replaces the seeded init, so a run can start from the JAX package's
    init (``interop.params_from_flax``) for parity checks. Under
    torchrun this is one rank of the (data, seq) mesh (``parallel/
    mesh.py``): the process group is started from torchrun's
    environment unless the caller has started one; the caller ends it
    (``mesh.shutdown``)."""
    device, mesh, logger = _setup(cfg, logger)
    task = _make_task(cfg, mesh)
    model, state = _build_model_and_state(cfg, device, init_params, mesh)
    start_step = 0
    if cfg.resume and ckpt.latest_step(cfg.checkpoint_dir) is not None:
        state = ckpt.restore(cfg.checkpoint_dir, state)
        start_step = state.step
        logger.log_json({"event": "resumed", "step": start_step})
    step_fn = make_train_step(task.loss, device, cfg.seed,
                              grad_norm_metric=cfg.log_grad_norm, mesh=mesh,
                              accum_steps=cfg.grad_accum_steps,
                              ema_decay=cfg.ema_decay)
    eval_fn = make_eval_step(task.eval_loss or task.loss)
    logger.log_json({
        "event": "start", "model": cfg.model, "task": task.name,
        "params": param_count(model), "device": str(device),
        "global_batch": cfg.batch_size, "start_step": start_step,
        "mesh": {"data": mesh.data, "seq": mesh.seq},
    })
    saved_at = None

    def save() -> None:
        nonlocal saved_at
        ckpt.save(cfg.checkpoint_dir, state, cfg.keep_checkpoints, mesh)
        saved_at = state.step

    def cadence(step_now: int, metrics) -> None:
        if cfg.log_every and step_now % cfg.log_every == 0:
            logger.log(step_now, **{k: float(v) for k, v in metrics.items()})
        if cfg.eval_every and step_now % cfg.eval_every == 0:
            em = evaluate(state, eval_fn, task, cfg.eval_batch_size, device,
                          mesh)
            logger.log(step_now, **{f"val_{k}": v for k, v in em.items()})
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and step_now % cfg.checkpoint_every == 0):
            save()

    batches = prefetch((seq_block(b, mesh, task.seq_axis)
                        for b in task.train_stream(start_step)), device)
    with Timer() as first_t:
        if cfg.train_steps > start_step:
            state, metrics = step_fn(state, next(batches))
            _sync(device)
            cadence(start_step + 1, metrics)
    steps_done = 1 if cfg.train_steps > start_step else 0
    with Timer() as train_t:
        for i in range(start_step + steps_done, cfg.train_steps):
            state, metrics = step_fn(state, next(batches))
            cadence(i + 1, metrics)
        _sync(device)
    with Timer() as eval_t:
        final = evaluate(state, eval_fn, task, cfg.eval_batch_size, device,
                         mesh)
    if cfg.checkpoint_dir and saved_at != state.step:
        save()  # the final state, unless its cadence save just wrote it
    steady = max(state.step - start_step - steps_done, 0)
    sps = steady / train_t.elapsed if train_t.elapsed > 0 else 0.0
    result = TrainResult(
        state=state, train_seconds=first_t.elapsed + train_t.elapsed,
        eval_seconds=eval_t.elapsed, final_metrics=final,
        steps_per_sec=sps, images_per_sec=sps * cfg.batch_size,
        logger=logger)
    done = {"event": "done", "steps": state.step,
            "train_seconds": round(result.train_seconds, 3),
            "first_step_seconds": round(first_t.elapsed, 3),
            "steps_per_sec": round(sps, 3),
            "images_per_sec": round(result.images_per_sec, 1)}
    if task.seq_len:
        done["tokens_per_sec"] = round(sps * cfg.batch_size * task.seq_len, 1)
    logger.log_json({**done,
                     **{f"val_{k}": round(v, 5) for k, v in final.items()}})
    return result


def evaluate_only(cfg: TrainConfig, logger: Optional[MetricLogger] = None
                  ) -> Dict[str, float]:
    """``--mode eval``: restore the latest checkpoint and run one full
    validation pass (on the EMA when the checkpoint tracks one), then an
    ``eval`` record. The caller ends the process group."""
    device, mesh, logger = _setup(cfg, logger)
    task = _make_task(cfg, mesh)
    _, state = _build_model_and_state(cfg, device, mesh=mesh)
    state = ckpt.restore(cfg.checkpoint_dir, state)
    eval_fn = make_eval_step(task.eval_loss or task.loss)
    with Timer() as eval_t:
        metrics = evaluate(state, eval_fn, task, cfg.eval_batch_size, device,
                           mesh)
    logger.log_json({
        "event": "eval", "step": state.step,
        "eval_seconds": round(eval_t.elapsed, 3),
        **{f"val_{k}": round(v, 5) for k, v in metrics.items()}})
    return metrics


def generate_only(cfg: TrainConfig, logger: Optional[MetricLogger] = None
                  ) -> Dict:
    """``--mode generate``: restore a checkpoint and continue
    ``--prompt``, greedy, sampled (a ``torch.Generator`` seeded by
    ``--seed``) or by beam search (``--num-beams`` > 1), on the EMA
    weights when the checkpoint tracks them. The model is built without
    the training task (the checkpoint pins its shapes). Emits and
    returns a ``generate`` record."""
    from tensorflow_distributed_tpu_torch.models.generate import (
        beam_search, generate)

    cfg.validate()
    device = resolve_device(cfg.device)
    logger = logger or MetricLogger()
    try:
        ids = [int(t) for t in cfg.prompt.split(",")]
    except ValueError:
        raise ValueError(
            f"prompt {cfg.prompt!r} is not comma-separated token ids "
            f"(string prompts need --dataset text, which is not ported to "
            f"PyTorch yet; see ROADMAP.md queue A)") from None
    model, state = _build_model_and_state(cfg, device)
    vocab = model.cfg.vocab_size
    bad = [t for t in ids if not 0 <= t < vocab]
    if bad:
        raise ValueError(f"prompt ids {bad} outside the model vocabulary "
                         f"[0, {vocab})")
    state = ckpt.restore(cfg.checkpoint_dir, state)
    if state.ema is not None:
        model.load_state_dict(state.ema)
    prompt = torch.tensor([ids], dtype=torch.long, device=device)
    rec = {"event": "generate", "step": state.step, "prompt": cfg.prompt}
    if cfg.num_beams > 1:
        seqs, scores = beam_search(model, prompt, cfg.max_new_tokens,
                                   num_beams=cfg.num_beams)
        rec["new_tokens"] = seqs[0, 0].tolist()  # the best beam
        rec["beam_score"] = round(float(scores[0, 0]), 5)
    else:
        gen = None
        if cfg.gen_temperature > 0:
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
        rec["new_tokens"] = generate(
            model, prompt, cfg.max_new_tokens,
            temperature=cfg.gen_temperature, top_k=cfg.gen_top_k,
            top_p=cfg.gen_top_p, generator=gen)[0].tolist()
    logger.log_json(rec)
    return rec

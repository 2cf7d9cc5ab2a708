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

Faults (``config.ResilienceConfig``, all off by default): the fault
plan's train points (``resilience/faults.py``); a non-finite loss halts,
skips its update or rewinds to the newest finite checkpoint
(``resilience/policies.py``), and so may a loss spike; watchdogs bound
the next-batch fetch and the wait for each retired step
(``resilience/watchdog.py``); checkpoint writes retry; and a SIGTERM
stops the run at the next step with a save (``train/preemption.py``).
A policy, a detector or a watchdog reads each step once it has retired,
in JAX's bounded window: the oldest step is retired once more than two
trail the dispatch, so a bad step K is seen after step K + 2 is
dispatched (the cadence save between them is the one a rewind
quarantines). Without any of them the loop dispatches as it always did,
with no sync a step beyond the ``log_every`` fetch. Under more than one
process the SIGTERM stop is agreed by the ranks on the host, once a
step (``train/preemption.py``).

``--resume`` from a checkpoint written on another mesh (an elastic
restart after a card loss, ``resilience/supervisor.py --elastic``, or a
run grown back) restores through ``checkpoint.restore_resharded``; the
``resumed`` record then names both meshes, the restore's seconds and
the new per-device batch.

Under ``--mesh.data D --mesh.seq S --mesh.model M --mesh.expert X``
(D*S*M*X processes under torchrun, one GPU each; see
``parallel/mesh.py``) each rank draws only its data
rank's rows of every global batch (under ``--grad-accum-steps A``, its
part of each of JAX's A microbatches: ``data_rows``) and keeps its
contiguous block ``[s*L/S, (s+1)*L/S)`` of the sequence axis (the M
model and X expert ranks of a (data, seq) place read the same rows);
batches reach the device through ``data/prefetch.py``; a transformer is
cut into M tensor-parallel shards, and a MoE model's experts over the
expert group (over the model group without an expert axis)
(``parallel/sharding.py``), each rank keeping its part of the whole
model's seeded init; the parameters start from
the copy of the first rank of their replica group; eval metrics are
means over the mesh; the step records, eval records and the ``done``
record come from the chief only.

``--model pipelined_lm`` cuts its blocks into ``--mesh.pipe`` stages, a
process each (``models/pipelined.py``): the pipe ranks of a data index
read the same rows (their rows of each of the pipeline's microbatches),
``--pipeline-schedule 1f1b`` trains with ``train/pipeline_step.py`` and
``gpipe`` with the standard step; ``--mode eval`` runs the GPipe forward.

``--param-sync-every H`` > 1 (local SGD, ``train/local_sgd.py``) trains
the data ranks' replicas apart, their params averaged every H steps:
the state is a ``StackedState`` (every replica on the stacked
transport), a save holds JAX's replica-stacked state, a resume restores
each replica, and the evals, the result and ``--mode eval`` or generate
read the replicas' mean (``restore_averaged``).

``--param-partition zero1|fsdp`` lays the state out over the data axis
once every rank holds the same init (``train/state.partition_state_``);
``--grad-sync serial|overlap`` builds the explicit step
(``parallel/overlap.py``), whose plan the loop prints as a
``grad_sync`` record. ``--mode eval`` builds the same layout and
restores into it.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.data.batcher import local_rows
from tensorflow_distributed_tpu_torch.data.prefetch import (
    map_batch, prefetch, to_device)
from tensorflow_distributed_tpu_torch.models import build_model
from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    FSDP_MIN_SIZE, is_split, shard_state_dict)
from tensorflow_distributed_tpu_torch.resilience.faults import (
    FaultPlan, parse_fault_plan)
from tensorflow_distributed_tpu_torch.resilience.policies import (
    LossSpikeDetector, NonFinitePolicy, RecoveryBudgetExceeded)
from tensorflow_distributed_tpu_torch.resilience.watchdog import (
    Watchdog, wait_for)
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train.local_sgd import (
    StackedState, averaged_view, make_local_sgd_train_step, stack_state)
from tensorflow_distributed_tpu_torch.train.optim import make_optimizer
from tensorflow_distributed_tpu_torch.train.preemption import PreemptionGuard
from tensorflow_distributed_tpu_torch.train.state import (
    TrainState, create_train_state, ema_init, param_count,
    partition_state_)
from tensorflow_distributed_tpu_torch.train.step import (
    make_eval_step, make_train_step, to_host_async)
from tensorflow_distributed_tpu_torch.train.tasks import Task, make_task
from tensorflow_distributed_tpu_torch.utils.logging import (
    MetricLogger, Timer, emit_event)


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


def data_rows(batch, mesh: Mesh, accum_steps: int = 1):
    """This data rank's rows of a global batch (dict or tuple): with
    ``accum_steps`` A > 1, its part of each of JAX's A microbatches in
    turn (``data/batcher.local_rows``), so that the step's own split
    into A parts hands it its rows of JAX's microbatch i."""
    if mesh.data == 1:
        return batch
    n = len(next(iter(batch.values())) if isinstance(batch, dict)
            else batch[0])
    rows = local_rows(n, mesh.data, mesh.data_index, accum_steps)
    return map_batch(lambda v: v[rows], batch)


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
    every batch; the metrics are means over the mesh (the loss
    all-reduces its sums over the replica group)."""
    batch = min(batch, (task.eval_size // mesh.data) * mesh.data)
    if batch == 0:
        raise ValueError(f"validation split ({task.eval_size} rows) smaller "
                         f"than the mesh data axis ({mesh.data})")
    totals: Dict[str, float] = {}
    count = 0
    for host_batch in task.eval_batches(batch):
        local = seq_block(data_rows(host_batch, mesh, task.microbatches),
                          mesh, task.seq_axis)
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


def build_model_for(cfg: TrainConfig, device: torch.device, ring=None,
                    vocab_size: int = 0, image_shape: tuple = (),
                    bn_group=None, tp=None, ep=None, pipe=None,
                    aux_mesh=None, vocab_shards: Optional[int] = None):
    """The model ``cfg`` names, built on ``device`` with its weights not
    yet drawn (``init_weights``); ``ring``: the seq group's ring; ``tp``:
    the model group's transport (tensor parallelism); ``ep``: the expert
    group's (a MoE model's experts; None: they take ``tp``); ``pipe``:
    the pipe's transport (pipelined_lm; None: one stage) and
    ``aux_mesh`` the mesh whose data group its routers' counts sum over.
    ``vocab_size``: the tokenizer's, which sizes the LM under
    ``--dataset text``; ``image_shape``: the dataset's [H, W, C] (a
    ResNet takes its channels); ``bn_group``: the group of sync BN;
    ``vocab_shards``: a causal LM's ``shard_vocab`` padding multiple
    (``checkpoint_vocab_shards``; None: the model width)."""
    if cfg.model in ("gpt_lm", "bert_mlm", "moe_lm", "pipelined_lm"):
        kw = ({"ring": ring, "tp": tp, "ep": ep}
              if cfg.model != "pipelined_lm" else
              {"pipe": pipe, "num_microbatches": cfg.pipeline_microbatches,
               "virtual_stages": cfg.pipeline_virtual_stages,
               "aux_mesh": aux_mesh, "ring": ring, "tp": tp})
        if cfg.model_size:
            kw["size"] = cfg.model_size
        if vocab_shards:
            kw["vocab_shards"] = vocab_shards
        if cfg.dataset == "text":
            kw["vocab_size"] = vocab_size
        elif cfg.synthetic_vocab:
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
                              ("kv_cache_quant", "none"),
                              ("shard_vocab", False)):
            if getattr(cfg, name) != default:
                kw[name] = getattr(cfg, name)
        # The MoE knobs, as the JAX _build_model_and_state passes them.
        if cfg.moe_experts > 0:
            kw["moe_experts"] = cfg.moe_experts
        if cfg.model == "moe_lm" or cfg.moe_experts > 0:
            kw.update(moe_top_k=cfg.moe_top_k,
                      moe_capacity_factor=cfg.moe_capacity_factor,
                      moe_group_len=cfg.moe_group_len,
                      moe_dispatch=cfg.moe_dispatch)
    elif cfg.model in ("resnet20", "resnet50"):
        kw = {"bn_group": bn_group}
        if image_shape:
            kw["in_channels"] = image_shape[-1]
    else:
        kw = {"init_scheme": cfg.init_scheme}
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    with torch.device(device):
        return build_model(cfg.model, dropout_rate=cfg.dropout_rate,
                           compute_dtype=dtype, **kw)


def checkpoint_vocab_shards(cfg: TrainConfig) -> Optional[int]:
    """``--shard-vocab``'s padding multiple for reading ``cfg``'s
    checkpoint: the model width its newest step was written on (the mesh
    manifest), where that width is a multiple of this run's, so one card
    or a narrower tensor-parallel group takes a wider run's padded
    tables; None (the run's own width) otherwise."""
    if not (cfg.shard_vocab and cfg.checkpoint_dir):
        return None
    step = ckpt.latest_step(cfg.checkpoint_dir)
    manifest = (ckpt.read_mesh_manifest(cfg.checkpoint_dir, step)
                if step is not None else None)
    width = int((manifest or {}).get("mesh", {}).get("model", 1))
    here = max(cfg.mesh.model, cfg.serve.mesh_model)
    return width if width > 1 and width % here == 0 else None


def _build_model_and_state(cfg: TrainConfig, device: torch.device,
                           init_params=None, mesh: Mesh = ONE_PROCESS,
                           task: Optional[Task] = None, vocab_size: int = 0,
                           min_size: int = FSDP_MIN_SIZE,
                           vocab_shards: Optional[int] = None):
    """The model and its train state, laid out as ``cfg.param_partition``
    (``min_size``: the rule's threshold); ``task`` (or, without one, the
    tokenizer's ``vocab_size``, read from the corpus when not given)
    gives the dataset facts the model is sized by; ``vocab_shards``:
    ``build_model_for``'s."""
    if task is not None:
        vocab_size = task.vocab_size
    elif cfg.dataset == "text" and not vocab_size:
        from tensorflow_distributed_tpu_torch.data.lm import text_codec

        vocab_size = text_codec(cfg.data_dir, cfg.text_tokenizer,
                                cfg.bpe_vocab_size)[2]
    # The explicit sync's BatchNorm normalizes with each rank's rows.
    sync_bn = mesh.data > 1 and cfg.grad_sync == "implicit"
    model = build_model_for(
        cfg, device, mesh.ring, vocab_size=vocab_size,
        image_shape=task.image_shape if task is not None else (),
        bn_group=mesh.data_group if sync_bn else None, tp=mesh.tp,
        ep=mesh.ep, pipe=mesh_lib.pipe_transport(mesh), aux_mesh=mesh,
        vocab_shards=vocab_shards)
    piped = mesh.distributed and mesh.pipe > 1
    tx = make_optimizer(cfg, model, group_sum=(
        (lambda t: mesh.pipe_all_reduce_([t])) if piped else None))
    if init_params is not None and is_split(model):
        init_params = shard_state_dict(init_params, model)
    if init_params is not None and getattr(model, "is_pipelined", False):
        mine = dict(model.named_parameters())
        init_params = {n: t for n, t in init_params.items() if n in mine}
    state = create_train_state(model, tx, cfg.seed, init_params)
    # Every rank starts from the first rank of its replica group's copy
    # (over a pipe: of its data group, the ranks of its stage).
    if mesh.pipe > 1:
        mesh.data_broadcast_(model.parameters())
    else:
        mesh.replica_broadcast_(model.parameters())
    partition_state_(state, cfg.param_partition, mesh, min_size)
    if cfg.ema_decay:
        state.ema = ema_init(state.params)
    return model, state


def _setup(cfg: TrainConfig, logger: Optional[MetricLogger]):
    """The run's device, mesh and logger: the checks that need no process
    group, then the group (``mesh_lib.bootstrap``)."""
    cfg.validate()
    device = resolve_device(mesh_lib.rank_device(cfg.device))
    expert, pipe = cfg.mesh.expert, cfg.mesh.pipe
    data, seq, model = mesh_lib.mesh_shape(cfg.mesh.data, cfg.mesh.seq,
                                           cfg.mesh.model, expert, pipe)
    why = mesh_lib.mesh_infeasible(
        {"data": data, "seq": seq, "model": model, "expert": expert,
         "pipe": pipe}, data * pipe * seq * model * expert, cfg.batch_size)
    if why:
        raise ValueError(f"--mesh.data {data} --mesh.pipe {pipe} --mesh.seq "
                         f"{seq} --mesh.model {model} --mesh.expert {expert}"
                         f": {why}")
    if (cfg.batch_size // data) % cfg.grad_accum_steps:
        raise ValueError(
            f"grad_accum_steps {cfg.grad_accum_steps} must divide the "
            f"per-rank batch {cfg.batch_size // data} (batch_size / "
            f"mesh.data)")
    if cfg.model == "pipelined_lm" and data > 1 and (
            cfg.batch_size // data) % (cfg.grad_accum_steps
                                       * cfg.pipeline_microbatches):
        raise ValueError(
            f"the per-rank batch {cfg.batch_size // data} (batch_size / "
            f"mesh.data) must split into grad_accum_steps x "
            f"pipeline_microbatches {cfg.grad_accum_steps} x "
            f"{cfg.pipeline_microbatches} microbatches (a data rank "
            f"holds its rows of each of JAX's)")
    mesh = mesh_lib.bootstrap(data, seq, device, model, expert, pipe)
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


def _make_step(cfg: TrainConfig, task: Task, state: TrainState,
               device: torch.device, mesh: Mesh,
               skip_nonfinite: bool = False, sync=None):
    """The train step ``cfg`` runs: the local-SGD step
    (``train/local_sgd.py``) under ``--param-sync-every`` > 1, of the
    ``StackedState`` ``state``; ``pipelined_lm``'s 1F1B step
    (``train/pipeline_step.py``) under ``--pipeline-schedule 1f1b``;
    else the standard step (GPipe for ``pipelined_lm``)."""
    if cfg.param_sync_every > 1:
        return make_local_sgd_train_step(
            task.loss, device, mesh, cfg.param_sync_every, cfg.seed,
            grad_norm_metric=cfg.log_grad_norm)
    if cfg.model == "pipelined_lm" and cfg.pipeline_schedule == "1f1b":
        from tensorflow_distributed_tpu_torch.train.pipeline_step import (
            make_1f1b_train_step)
        return make_1f1b_train_step(
            state.model, device, mesh, cfg.seed,
            moe_aux_weight=cfg.moe_aux_weight,
            moe_zloss_weight=cfg.moe_zloss_weight,
            grad_norm_metric=cfg.log_grad_norm,
            label_smoothing=cfg.label_smoothing, ema_decay=cfg.ema_decay,
            backward=cfg.pipeline_backward, ce_chunk=cfg.ce_chunk)
    return make_train_step(
        task.loss, device, cfg.seed, grad_norm_metric=cfg.log_grad_norm,
        mesh=mesh, accum_steps=cfg.grad_accum_steps,
        ema_decay=cfg.ema_decay, skip_nonfinite=skip_nonfinite, sync=sync,
        grad_sync=cfg.grad_sync,
        state_template=state,
        bucket_bytes=int((cfg.grad_sync_bucket_mb or 0) * (1 << 20)),
        grad_clip_norm=cfg.grad_clip_norm or 0.0)


def build_stacked(cfg: TrainConfig, device: torch.device,
                  min_size: int = FSDP_MIN_SIZE, init_params=None):
    """``cfg``'s run on the stacked transport of ``cfg.mesh.data`` data
    ranks in this process (``parallel/mesh.stacked_data``), or for
    ``pipelined_lm`` of its ``cfg.mesh.pipe`` stages
    (``parallel/mesh.stacked_pipe``, with its ``cfg.mesh.model`` model
    ranks and ``cfg.mesh.seq`` ring positions stacked too; the tests and
    the one-card smoke):
    (the task, drawing global batches; the state, laid out as
    ``cfg.param_partition``, or under ``--param-sync-every`` > 1 the
    local-SGD replicas (``StackedState``); the train step, which runs
    each data rank's rows, or each stage, in turn). ``min_size``: the
    partition rule's threshold; ``init_params``: as ``train``'s."""
    cfg.validate()
    pipelined = cfg.model == "pipelined_lm"
    if (cfg.moe_experts > 0 or cfg.model == "moe_lm") and not pipelined:
        raise ValueError("the stacked data transport runs dense models (a "
                         "router's load balance is over the global batch)")
    if pipelined and cfg.mesh.data not in (-1, 1):
        raise ValueError("the stacked pipe holds the stages of one data "
                         "rank (--mesh.data 1)")
    mesh = (mesh_lib.stacked_pipe(cfg.mesh.pipe, cfg.mesh.model,
                                  cfg.mesh.seq) if pipelined
            else mesh_lib.stacked_data(cfg.mesh.data))
    task = _make_task(cfg, ONE_PROCESS)
    _, state = _build_model_and_state(cfg, device, init_params, mesh=mesh,
                                      task=task, min_size=min_size)
    if cfg.param_sync_every > 1:
        state = stack_state(state, mesh)
    step = _make_step(cfg, task, state, device, mesh,
                      skip_nonfinite=cfg.resilience.nonfinite == "skip_batch")
    return task, state, step


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
    model, state = _build_model_and_state(cfg, device, init_params, mesh,
                                          task)
    n_params = (param_count(model.whole("meta")) if is_split(model) else
                sum(state.partition.shapes.get(n, p.shape).numel()
                    for n, p in state.params.items()))
    view = lambda s: s  # noqa: E731
    if cfg.param_sync_every > 1:
        # The replicas from here on; saves hold them all (the divergence
        # survives a resume), evals and the result read their mean.
        state = stack_state(state, mesh)
        view = functools.partial(averaged_view, opt_state=False)
    start_step = 0
    if cfg.resume and ckpt.latest_step(cfg.checkpoint_dir) is not None:
        latest = ckpt.latest_step(cfg.checkpoint_dir)
        written = (ckpt.read_mesh_manifest(cfg.checkpoint_dir, latest)
                   or {}).get("mesh")
        current = ckpt.mesh_shape_dict(mesh)
        resumed_extra = {}
        if written and not ckpt.same_mesh(written, current):
            # An elastic resume: the checkpoint was written on another
            # mesh (supervisor --elastic after a card loss, or a run
            # grown onto returned capacity). The global batch is the
            # same; each rank's share follows the new data width.
            state, rinfo = ckpt.restore_resharded(cfg.checkpoint_dir, state,
                                                  mesh=mesh)
            resumed_extra = {"from_mesh": rinfo["from_mesh"],
                             "to_mesh": rinfo["to_mesh"],
                             "reshard_seconds": rinfo["seconds"],
                             "per_device_batch":
                                 cfg.batch_size // current["data"]}
        else:
            state = ckpt.restore(cfg.checkpoint_dir, state, mesh=mesh)
        start_step = state.step
        logger.log_json({"event": "resumed", "step": start_step,
                         **resumed_extra})
    res = cfg.resilience
    plan = (parse_fault_plan(res.fault_plan) if res.fault_plan
            else FaultPlan())
    plan.bind(start_step)
    policy = (NonFinitePolicy(res.nonfinite, res.max_skips, res.max_rewinds)
              if res.nonfinite != "off" else None)
    spikes = (LossSpikeDetector(res.spike_window, res.spike_factor)
              if res.spike_window else None)
    wdog = (Watchdog(res.data_timeout_s, res.sync_timeout_s)
            if (res.data_timeout_s or res.sync_timeout_s) else None)
    ckpt.set_io_policy(res.save_retries, res.save_retry_backoff_s)
    windowed = policy is not None or spikes is not None or wdog is not None
    step_fn = _make_step(
        cfg, task, state, device, mesh,
        skip_nonfinite=policy is not None and policy.mode == "skip_batch",
        sync=wdog.sync if wdog is not None else None)
    eval_fn = make_eval_step(task.eval_loss or task.loss)
    logger.log_json({
        "event": "start", "model": cfg.model, "task": task.name,
        "params": n_params,
        "device": str(device),
        "global_batch": cfg.batch_size, "start_step": start_step,
        "mesh": {"data": mesh.data, "seq": mesh.seq, "model": mesh.model,
                 **({"expert": mesh.expert} if mesh.expert > 1 else {}),
                 **({"pipe": mesh.pipe} if mesh.pipe > 1 else {})},
    })
    if cfg.grad_sync != "implicit":
        logger.log_json({"event": "grad_sync", "mode": cfg.grad_sync,
                         **step_fn.bucket_plan.describe()})
    saved_at = None

    def save() -> None:
        nonlocal saved_at
        ckpt.save(cfg.checkpoint_dir, state, cfg.keep_checkpoints, mesh)
        saved_at = state.step

    def latest() -> Optional[int]:
        return (ckpt.latest_step(cfg.checkpoint_dir) if cfg.checkpoint_dir
                else None)

    def cadence(step_now: int, metrics) -> None:
        if cfg.log_every and step_now % cfg.log_every == 0:
            host = {k: float(v) for k, v in metrics.items()}
            logger.log(step_now, **host)
            if cfg.halt_on_nonfinite and not math.isfinite(host["loss"]):
                raise FloatingPointError(
                    f"non-finite loss {host['loss']} at step {step_now} "
                    f"(halt_on_nonfinite=true); last durable checkpoint: "
                    f"{latest()}")
        if cfg.eval_every and step_now % cfg.eval_every == 0:
            em = evaluate(view(state), eval_fn, task, cfg.eval_batch_size,
                          device, mesh)
            logger.log(step_now, **{f"val_{k}": v for k, v in em.items()})
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and step_now % cfg.checkpoint_every == 0):
            plan.arm_checkpoint_faults(step_now)  # fails inside this save
            save()

    def make_iterator(from_step: int):
        """The task stream from ``from_step`` with the plan's poisoned
        batches, this rank's sequence block, prefetched; rebuilt after a
        rewind, so the replay draws the batches an uninterrupted run
        would (an injected NaN is one-shot: the replay is clean)."""
        stream = plan.wrap_stream(task.train_stream(from_step), from_step)
        return prefetch((seq_block(b, mesh, task.seq_axis) for b in stream),
                        device)

    batches = make_iterator(start_step)

    def fetch(step_id: int):
        def get():
            plan.maybe_stall(step_id)  # inside the watched fetch
            return next(batches)

        return wdog.fetch(get, step_id) if wdog is not None else get()

    def retire_view(metrics):
        """What inspecting a step needs once it retires: its loss, copied
        to the host behind the step (with the event that says the copy
        is done), and whether the step skipped its update."""
        loss, done = to_host_async(metrics["loss"].detach().reshape(1))
        return loss, done, float(metrics.get("skipped_nonfinite", 0.0))

    def inspect(step_id: int, loss, skipped: float) -> Optional[int]:
        """The policy's and the detector's reading of one retired step:
        the step to rewind from, or None; raises on a halt. Reads nothing
        when neither is configured."""
        if policy is None and spikes is None:
            return None
        if policy is None and cfg.log_every and step_id % cfg.log_every:
            # A detector without a policy is advisory: it samples the
            # log cadence, as in JAX.
            return None
        host_loss = float(loss.reshape(-1)[0])
        if not math.isfinite(host_loss) or skipped > 0:
            if policy is None:
                return None
            action = policy.on_nonfinite(step_id, host_loss)
            if action == "halt":
                raise RecoveryBudgetExceeded(
                    policy.halt_message(step_id, host_loss, latest()))
            return None if action == "skip" else step_id
        if spikes is not None:
            med = spikes.observe(host_loss)
            if med is not None:
                if policy is None:
                    emit_event("recovery", kind="loss_spike", step=step_id,
                               loss=round(host_loss, 6),
                               window_median=round(med, 6))
                    return None
                action = policy.on_spike(step_id, host_loss, med)
                if action == "halt":
                    raise RecoveryBudgetExceeded(
                        policy.halt_message(step_id, host_loss, latest()))
                if action == "rewind":
                    return step_id
        return None

    def retire(entry) -> Optional[int]:
        step_id, loss, done, skipped = entry
        if wdog is not None:
            wdog.sync(done, step_id)
        else:
            wait_for(done)
        return inspect(step_id, loss, skipped)

    def rewind(bad_step: int) -> int:
        """Restore, in place, the newest checkpoint from before the bad
        step whose params are finite, and return its step. The saves at
        and after the bad step hold the poisoned state (intact bytes):
        they are quarantined first; a restored candidate whose params
        are not finite (damage older than the detection) is quarantined
        in turn, walking back."""
        nonlocal saved_at
        _sync(device)
        ckpt.quarantine_from(
            cfg.checkpoint_dir, bad_step,
            reason=f"saved at/after non-finite step {bad_step} (rewind)",
            mesh=mesh)
        while True:
            target = ckpt.latest_step(cfg.checkpoint_dir)
            if target is None:
                raise FloatingPointError(
                    "resilience.nonfinite=rewind: non-finite loss at step "
                    f"{bad_step} with no finite durable checkpoint before "
                    "it — nothing to rewind to (checkpoint_dir="
                    f"{cfg.checkpoint_dir!r}, checkpoint_every="
                    f"{cfg.checkpoint_every})")
            ckpt.restore(cfg.checkpoint_dir, state)
            if _params_finite(state):
                break
            ckpt.quarantine_from(
                cfg.checkpoint_dir, target,
                reason=f"restored params non-finite (damage predates step "
                       f"{target})", mesh=mesh)
        saved_at = None
        logger.log_json({"event": "rewound", "step": state.step})
        emit_event("recovery", kind="rewind", from_step=bad_step,
                   to_step=state.step)
        if spikes is not None:
            spikes.reset()  # the replayed steps approach the spike again
        return state.step

    want_rewind = None  # the bad step when a rewind is ordered
    with Timer() as first_t:
        if cfg.train_steps > start_step:
            # A signal planned for this step fires before the guard is
            # armed: a sigterm here is a hard crash of the first leg.
            plan.maybe_device_loss(start_step + 1, cfg.checkpoint_dir)
            plan.maybe_signal(start_step + 1)
            state, metrics = step_fn(state, fetch(start_step + 1))
            _sync(device)
            cadence(start_step + 1, metrics)
            want_rewind = inspect(start_step + 1, metrics["loss"].detach(),
                                  float(metrics.get("skipped_nonfinite", 0)))
    steps_done = 1 if cfg.train_steps > start_step else 0
    # Steps dispatched and not yet retired (windowed runs only).
    inflight: collections.deque = collections.deque()
    guard = PreemptionGuard(enabled=bool(cfg.checkpoint_dir))
    try:
        with Timer() as train_t:
            next_start = start_step + steps_done
            while True:  # a pass a rewind; other exits leave at once
                if want_rewind is not None:
                    next_start = rewind(want_rewind)
                    batches = make_iterator(next_start)
                    want_rewind = None
                for i in range(next_start, cfg.train_steps):
                    if guard.should_stop(i):
                        if mesh.distributed:
                            # Every rank says where it stopped.
                            emit_event("preempted", step=i, rank=mesh.rank)
                        else:
                            logger.log_json({"event": "preempted",
                                             "step": i})
                        break
                    plan.maybe_device_loss(i + 1, cfg.checkpoint_dir)
                    plan.maybe_signal(i + 1)
                    state, metrics = step_fn(state, fetch(i + 1))
                    if windowed:
                        inflight.append((i + 1, *retire_view(metrics)))
                        if len(inflight) > 2:
                            want_rewind = retire(inflight.popleft())
                            if want_rewind is not None:
                                inflight.clear()
                                break
                    cadence(i + 1, metrics)
                if want_rewind is None and guard.fired is None:
                    # The trailing steps pass the same checks: a NaN on
                    # the last steps must not slip out unhandled.
                    while inflight and want_rewind is None:
                        want_rewind = retire(inflight.popleft())
                    inflight.clear()
                if want_rewind is None:
                    break
            _sync(device)
    finally:
        guard.close()
        if wdog is not None:
            wdog.close()
    preempted = guard.fired is not None
    if preempted and cfg.checkpoint_dir:
        save()  # the notice's grace period is for this save: before eval
    with Timer() as eval_t:
        final = ({} if preempted else
                 evaluate(view(state), eval_fn, task, cfg.eval_batch_size,
                          device, mesh))
    if cfg.checkpoint_dir and saved_at != state.step:
        save()  # the final state, unless its cadence save just wrote it
    steady = max(state.step - start_step - steps_done, 0)
    sps = steady / train_t.elapsed if train_t.elapsed > 0 else 0.0
    result = TrainResult(
        state=(averaged_view(state) if isinstance(state, StackedState)
               else state), train_seconds=first_t.elapsed + train_t.elapsed,
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


def _params_finite(state) -> bool:
    """Whether a state's params (every local-SGD replica's) are finite."""
    if isinstance(state, StackedState):
        return state.params_finite()
    return bool(torch.stack([torch.isfinite(p).all()
                             for p in state.params.values()]).all())


def _restore_plain(cfg: TrainConfig, state: TrainState) -> TrainState:
    """The latest checkpoint into the plain template ``state``: a
    local-SGD run's replicas averaged on the host (``--param-sync-every``
    > 1: ``restore_averaged``, on any data width), else ``restore``."""
    if cfg.param_sync_every > 1:
        return ckpt.restore_averaged(cfg.checkpoint_dir, state)
    return ckpt.restore(cfg.checkpoint_dir, state)


def evaluate_only(cfg: TrainConfig, logger: Optional[MetricLogger] = None
                  ) -> Dict[str, float]:
    """``--mode eval``: restore the latest checkpoint and run one full
    validation pass (on the EMA when the checkpoint tracks one), then an
    ``eval`` record. The caller ends the process group."""
    device, mesh, logger = _setup(cfg, logger)
    task = _make_task(cfg, mesh)
    _, state = _build_model_and_state(cfg, device, mesh=mesh, task=task)
    state = _restore_plain(cfg, state)
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
    weights when the checkpoint tracks them. Under ``--dataset text``
    the prompt is text, encoded by the corpus's tokenizer
    (``data/lm.text_codec``), and the record adds the continuation
    decoded (``text``); otherwise comma-separated token ids. The model
    is built without the training task (the checkpoint pins its
    shapes). Emits and returns a ``generate`` record (the chief's).

    Under ``--mesh.model M`` (torchrun, one process a rank, as ``--mode
    eval``) every rank restores its heads' slice of the checkpoint and
    runs the same decode loop on the gathered logits, the chief's picks
    broadcast at every step (``models/generate.py``). The caller ends
    the process group."""
    from tensorflow_distributed_tpu_torch.models.generate import (
        beam_search, generate)

    device, mesh, logger = _setup(cfg, logger)
    # The tokenizer without the training task (which would window the
    # whole corpus, and refuse one smaller than a batch).
    dec, vocab = None, 0
    if cfg.dataset == "text":
        from tensorflow_distributed_tpu_torch.data.lm import text_codec

        enc, dec, vocab = text_codec(cfg.data_dir, cfg.text_tokenizer,
                                     cfg.bpe_vocab_size)
        ids = enc(cfg.prompt)
        if not ids:
            raise ValueError(f"prompt {cfg.prompt!r} encoded to zero "
                             f"tokens")
    else:
        try:
            ids = [int(t) for t in cfg.prompt.split(",")]
        except ValueError:
            raise ValueError(
                f"prompt {cfg.prompt!r} is not comma-separated token "
                f"ids (string prompts need dataset=text, whose "
                f"tokenizer defines a text vocabulary)") from None
    model, state = _build_model_and_state(
        cfg, device, vocab_size=vocab, mesh=mesh,
        vocab_shards=checkpoint_vocab_shards(cfg))
    if cfg.dataset != "text":
        bad = [t for t in ids if not 0 <= t < model.cfg.vocab_size]
        if bad:
            raise ValueError(
                f"prompt ids {bad} outside the model vocabulary "
                f"[0, {model.cfg.vocab_size})")
    state = _restore_plain(cfg, state)
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
    if dec is not None:
        rec["text"] = dec(rec["new_tokens"])
    logger.log_json(rec)
    return rec

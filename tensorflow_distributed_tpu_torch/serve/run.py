"""``--mode serve``: the port of ``serve/run.py``. Build a causal LM, run
a request workload through the continuous-batching engine, report.

Workloads: ``--serve.requests file.jsonl`` (one JSON object per line:
``{"prompt": [ids...], "max_new_tokens": 32, "eos_id": 5,
"arrival_s": 0.25, "session": "conv7", "slo": "high", "tenant": "t0"}``)
or, with no file, a synthetic open-loop workload:
``--serve.num-requests`` random prompts with lengths drawn in
[``--serve.prompt-len-min``, ``--serve.prompt-len-max``], arriving at
``--serve.arrival-rate`` req/s (0 = all queued at t=0) in the shape of
``--serve.trace``: ``poisson``, ``bursty``, ``diurnal``, or a ``.jsonl``
file of per-request ``{"arrival_s": t}`` offsets. With
``--serve.session-turns k`` consecutive synthetic requests form
conversations of k turns, each turn's prompt extending the previous one.
``--serve.slo-mix`` draws the synthetic requests' SLO classes and
``--serve.tenants`` assigns them to tenants round-robin; ``--serve.policy
slo`` (tenant quotas, preemption) reports a ``[serve] slo:`` line.

``--serve.spec-tokens k`` serves speculatively: the k-gram self-draft
(``--serve.spec-kgram``), or a draft GPT with ``--serve.draft-config``
drawn from ``--seed`` + 1, with a ``[serve] speculative:`` line.

``--serve.kv-dtype int8`` (or ``--kv-cache-quant int8``) serves over the
int8 cache; ``--serve.paged`` over the paged engine, whose pool
(``--serve.num-pages``, or sized from the workload and
``--serve.hbm-budget-gb``) and prefix cache (``--serve.radix``) are
reported in a ``[serve] paged:`` line.

With ``--checkpoint-dir`` it serves the latest checkpoint's weights
(its EMA where it tracks one), as JAX's does; a checkpointed model's
``max_len`` is the trained one, so pass that ``--seq-len``. Without it
the params are fresh-init (drawn from ``--seed``) and the summary says
so, as in JAX.

Serving under faults: ``--resilience.fault-plan`` (``slot_nan``,
``reload``, ``decode_stall``, ``sigterm``, ``sigkill`` on the decode-step
clock), ``--resilience.sync-timeout-s`` (the decode watchdog),
``--serve.slot-retries`` and ``--serve.journal`` (a non-empty journal at
start-up RESUMES: finished requests drop, in-flight ones re-admit as
continuations, and the plan is bound past its events, signals
included). A ``reload`` swaps in the newest verifiable checkpoint under
``--checkpoint-dir``. Such a run prints a ``[serve] fire:`` line.

The serve observatory (``observe/hub.py``'s ``ServeObservatory``):
``--observe.metrics-jsonl`` (the run's records), ``--observe.trace``
(the per-request Perfetto span trees), ``--observe.slo`` (the burn-rate
monitor and its status line), ``--observe.export-every`` /
``--observe.export-path`` (the atomic rolling snapshot) and
``--observe.anomaly``; the JSONL and the trace continue across a journal
resume.

``--serve.inbox`` makes this process a fleet replica
(``fleet/replica.py``): no workload of its own, requests and commands
streamed from the inbox file, serving until a ``drain`` command lands;
its journal (``--serve.journal``, required) is always fresh (a restarted
replica gets a new epoch's paths: the router re-dispatched the dead
epoch's work). The checkpoint step restored at start-up rides the
snapshot as ``ckpt_step`` (a swap keeps it current).

``--serve.mesh-model N`` serves one replica over N cards
(``serve/tp_replica.py``): this process is the chief, which starts N - 1
worker processes, runs every host decision and writes the journal, the
summary and the records; JAX's checks (N devices, N dividing n_heads,
n_kv_heads and the vocabulary unless ``--shard-vocab true``) run first.
The synthetic workload's ids are drawn below
``--synthetic-vocab`` (64 when unset, as in JAX): a full-width run
passes ``--synthetic-vocab 50257``. Under ``--dataset text`` the model's
vocabulary is the corpus tokenizer's and a request file's ``text`` key
is encoded by it (``data/lm.text_codec``), as in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.observe.hub import ServeObservatory
from tensorflow_distributed_tpu_torch.observe.registry import host_tags
from tensorflow_distributed_tpu_torch.models.transformer import (
    cast_dense_weights_, kv_heads)
from tensorflow_distributed_tpu_torch.parallel import mesh as mesh_lib
from tensorflow_distributed_tpu_torch.parallel.mesh import ONE_PROCESS, Mesh
from tensorflow_distributed_tpu_torch.resilience.faults import (
    FaultPlan, parse_fault_plan)
from tensorflow_distributed_tpu_torch.resilience.watchdog import Watchdog
from tensorflow_distributed_tpu_torch.serve import journal as journal_mod
from tensorflow_distributed_tpu_torch.serve import tp_replica
from tensorflow_distributed_tpu_torch.serve.buckets import (
    default_buckets, parse_buckets)
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from tensorflow_distributed_tpu_torch.serve.paging.engine import (
    PagedSlotEngine, auto_num_pages, page_bytes_estimate)
from tensorflow_distributed_tpu_torch.serve.scheduler import (
    SLO_CLASSES, Request, Scheduler, parse_slo_mix)
from tensorflow_distributed_tpu_torch.serve.speculate import build_speculator
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train.loop import (
    _build_model_and_state, build_model_for, checkpoint_vocab_shards,
    resolve_device)


def _arrivals(serve, n: int, rng) -> List[float]:
    """Arrival offsets of the synthetic workload, shaped by
    ``serve.trace`` (deterministic under the run seed):

    - ``""``: uniformly spaced at ``arrival_rate`` (0 = all at t=0);
    - ``poisson``: exponential interarrivals at the same mean rate;
    - ``bursty``: bursts of 4 requests landing together, bursts spaced
      to keep the mean rate;
    - ``diurnal``: the rate swept sinusoidally between 0.25x and 1.75x
      over the workload (a traffic day compressed into one run);
    - ``*.jsonl``: explicit ``{"arrival_s": t}`` lines (row i feeds
      request i; the file must cover the workload).
    """
    rate = serve.arrival_rate
    trace = serve.trace
    if trace.endswith(".jsonl"):
        offs = []
        with open(trace) as f:
            for line in f:
                line = line.strip()
                if line:
                    offs.append(float(json.loads(line)["arrival_s"]))
        if len(offs) < n:
            raise ValueError(
                f"--serve.trace {trace}: {len(offs)} arrival rows < "
                f"{n} requests")
        return offs[:n]
    if not rate:
        return [0.0] * n
    if trace == "poisson":
        return list(np.cumsum(rng.exponential(1.0 / rate, size=n)))
    if trace == "bursty":
        burst = 4
        return [(i // burst) * (burst / rate) for i in range(n)]
    if trace == "diurnal":
        out, t = [], 0.0
        for i in range(n):
            lam = rate * (1.0 + 0.75 * np.sin(2 * np.pi * i / max(n, 1)))
            out.append(t)
            t += 1.0 / lam
        return out
    return [i / rate for i in range(n)]


def _read_requests(cfg: TrainConfig, encode=None) -> List[Request]:
    serve = cfg.serve
    reqs = []
    with open(serve.requests) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            where = f"{serve.requests}:{i + 1}"
            if "text" in obj:
                if encode is None:
                    raise ValueError(
                        f"{where}: string prompts need --dataset text (its "
                        f"tokenizer defines the vocabulary)")
                ids = encode(obj["text"])
            else:
                ids = [int(t) for t in obj["prompt"]]
            if not ids:
                raise ValueError(f"{where}: empty prompt")
            slo = str(obj.get("slo", "standard"))
            if slo not in SLO_CLASSES:
                raise ValueError(
                    f"{where}: unknown slo {slo!r}; have {SLO_CLASSES}")
            reqs.append(Request(
                rid=len(reqs), prompt=np.asarray(ids, np.int32),
                max_new_tokens=int(obj.get("max_new_tokens",
                                           serve.max_new_tokens)),
                eos_id=int(obj.get("eos_id", serve.eos_id)),
                arrival_s=float(obj.get("arrival_s", 0.0)), slo=slo,
                tenant=str(obj.get("tenant", "")),
                session=str(obj.get("session", ""))))
    if not reqs:
        raise ValueError(f"{serve.requests} names no requests")
    return reqs


def _workload(cfg: TrainConfig, vocab_size: int,
              encode=None) -> List[Request]:
    """The request file, or the synthetic workload: mixed lengths drawn
    from ``--seed``, prompts drawn BEFORE the arrivals so the token
    content is the same under every trace (JAX's draw order). With
    ``session_turns`` k > 1, requests g .. g + k - 1 form session
    ``s{g // k}``, and turn j's prompt is turn j - 1's followed by its
    own draw (so the first turns equal the session-less workload's).
    The SLO classes of ``slo_mix`` are drawn after the arrivals, and
    request i belongs to tenant ``t{i % tenants}`` when ``tenants`` > 1."""
    serve = cfg.serve
    if serve.requests:
        return _read_requests(cfg, encode)
    rng = np.random.default_rng(cfg.seed)
    prompts = []
    for _ in range(serve.num_requests):
        plen = int(rng.integers(serve.prompt_len_min,
                                serve.prompt_len_max + 1))
        prompts.append(
            rng.integers(0, vocab_size, size=plen).astype(np.int32))
    sessions = [""] * serve.num_requests
    k = serve.session_turns
    if k > 1:
        for g in range(0, serve.num_requests, k):
            for j in range(g, min(g + k, serve.num_requests)):
                sessions[j] = f"s{g // k}"
                if j > g:
                    prompts[j] = np.concatenate([prompts[j - 1], prompts[j]])
    arrivals = _arrivals(serve, serve.num_requests, rng)
    slos = ["standard"] * serve.num_requests
    if serve.slo_mix:
        mix = parse_slo_mix(serve.slo_mix)
        edges = np.cumsum([mix.get(c, 0.0) for c in SLO_CLASSES])
        draws = rng.random(serve.num_requests)
        slos = [SLO_CLASSES[int(np.searchsorted(edges, d, side="right").clip(
            0, len(edges) - 1))] for d in draws]
    return [Request(rid=i, prompt=p, max_new_tokens=serve.max_new_tokens,
                    eos_id=serve.eos_id, arrival_s=float(a), slo=slos[i],
                    tenant=f"t{i % serve.tenants}" if serve.tenants > 1 else "",
                    session=sessions[i])
            for i, (p, a) in enumerate(zip(prompts, arrivals))]


def serve_setup(cfg: TrainConfig, played: Optional[Dict] = None
                ) -> Tuple[TrainConfig, Optional[SlotDecodeEngine],
                           List[Request]]:
    """Everything before the scheduler's clock starts: the workload
    (narrowed by ``played``, a replayed journal: finished requests drop,
    in-flight ones become continuations), the cache length
    (``--seq-len``, or sized to the workload with ``spec_tokens`` of
    verify headroom and, paged, rounded up to a whole page), the bucket
    ladder (covering prompt + new tokens under a fault plan, a resume or
    ``policy slo``, whose continuations re-prefill them), the model (the
    checkpoint's weights with ``--checkpoint-dir``, else fresh-init from
    ``--seed``; its dense weights held in the compute dtype; its cache
    int8 under ``--serve.kv-dtype int8``) and the engine (with
    ``spec_tokens``, the fault plan as ``engine.fault_plan`` (bound past
    every event on a resume) and the decode watchdog; paged with
    ``--serve.paged``, its pool sized by ``auto_num_pages`` unless
    ``--serve.num-pages`` pins it). With ``--serve.mesh-model N`` the
    replica's N - 1 workers start here (``serve/tp_replica.py``) and the
    engine's ``channel`` is the ``Replica``, which the caller closes.
    Returns the config with the cache length it was given, the engine
    and the requests; the engine is None when a resume left nothing to
    serve."""
    cfg.validate()
    device = resolve_device(cfg.device)
    # --serve.kv-dtype is the serve-side spelling of --kv-cache-quant.
    if cfg.serve.kv_dtype == "int8" and cfg.kv_cache_quant == "none":
        cfg = dataclasses.replace(cfg, kv_cache_quant="int8")
    encode, vocab = None, cfg.synthetic_vocab or 64
    if cfg.dataset == "text":
        from tensorflow_distributed_tpu_torch.data.lm import text_codec

        encode, _, vocab = text_codec(cfg.data_dir, cfg.text_tokenizer,
                                      cfg.bpe_vocab_size)
    # A fleet replica has no workload of its own: requests stream in
    # from the router.
    inbox = bool(cfg.serve.inbox)
    requests = [] if inbox else _workload(cfg, vocab, encode)
    if played:
        requests = journal_mod.apply_replay(requests, played)
        if not requests:
            return cfg, None, []
    plan = (parse_fault_plan(cfg.resilience.fault_plan)
            if cfg.resilience.fault_plan else FaultPlan())
    if played and plan:
        # The resumed leg is the recovery under test: every planned
        # event is consumed (a resumed leg must terminate).
        plan.bind(1 << 30)
    if inbox:
        # No workload to measure: the explicit --seq-len is the bound,
        # and a continuation can re-prefill at any depth.
        max_prompt = need = cfg.seq_len
    else:
        max_prompt = max(len(r.prompt) for r in requests)
        # The trajectory bound (what has to fit the cache); bucket
        # padding is prefill-only slack, clamped to the cache by the
        # ladder's cap.
        need = max(len(r.prompt) + r.max_new_tokens for r in requests)
    if cfg.seq_len and need > cfg.seq_len:
        raise ValueError(
            f"--seq-len {cfg.seq_len} cannot hold the workload: the "
            f"longest request (prompt + new tokens) needs a {need}-token "
            f"cache")
    if not cfg.seq_len:
        # Speculation gets spec_tokens of verify write headroom past the
        # last useful position (a pinned tight --seq-len falls back to the
        # plain path near each request's end instead).
        auto_len = max(need + cfg.serve.spec_tokens, 32)
        if cfg.serve.paged:
            # Page-granular: an explicit --seq-len that page_size does
            # not divide is refused by the engine instead.
            ps = cfg.serve.page_size
            auto_len = -(-auto_len // ps) * ps
        cfg = dataclasses.replace(cfg, seq_len=auto_len)
    # A continuation (slot retry, journal resume, preemption) carries up
    # to prompt + new - 1 tokens.
    cover = (need if (plan or played or inbox or cfg.serve.policy == "slo")
             else max_prompt)
    buckets = (parse_buckets(cfg.serve.buckets) if cfg.serve.buckets
               else default_buckets(cover, cap=cfg.seq_len))
    model_cfg = build_model_for(cfg, "meta", vocab_size=vocab).cfg
    for r in requests:
        # The embedding would fail on an id outside the table; name it.
        bad = [int(t) for t in r.prompt
               if not 0 <= t < model_cfg.vocab_size]
        if bad:
            raise ValueError(f"request {r.rid}: prompt ids {bad} outside "
                             f"the model vocabulary [0, "
                             f"{model_cfg.vocab_size})")
    width = cfg.serve.mesh_model
    if width == 1:
        engine = build_engine(cfg, buckets, vocab, need, device=device,
                              mesh=ONE_PROCESS, plan=plan)
        return cfg, engine, requests
    check_tp_serving(cfg, model_cfg, device)
    mesh, replica = tp_replica.start(width, device, build_engine,
                                     (cfg, buckets, vocab, need))
    try:
        print(f"[serve] tensor-parallel replica: model={width} over "
              f"{width} device(s) (params + KV cache head-sharded; "
              f"worker pids {replica.pids})", flush=True)
        t0 = time.perf_counter()
        engine = build_engine(cfg, buckets, vocab, need,
                              device=replica.device, mesh=mesh, plan=plan)
        replica.start_s["build"] = round(time.perf_counter() - t0, 3)
    except BaseException:
        replica.close()
        raise
    engine.channel = replica
    return cfg, engine, requests


def check_tp_serving(cfg: TrainConfig, model_cfg, device) -> None:
    """JAX's checks of ``--serve.mesh-model N`` (``serve/run.py``), with
    its messages: N devices (cards; on the CPU the ranks are processes),
    N dividing n_heads and n_kv_heads (the cache's head axis is cut over
    N), and N dividing the vocabulary (the head is vocab-parallel)
    unless ``--shard-vocab true`` pads it; under ``--dataset text`` the
    tokenizer's."""
    tp = cfg.serve.mesh_model
    if device.type == "cuda":
        first, count = device.index or 0, torch.cuda.device_count()
        if count < tp:
            raise ValueError(
                f"--serve.mesh-model {tp} needs {tp} devices, have {count}")
        if first + tp > count:
            # The port's own: ranks take cuda:K .. cuda:K+N-1.
            raise ValueError(
                f"--serve.mesh-model {tp} on --device {device} needs "
                f"cuda:{first}..cuda:{first + tp - 1}, have {count} "
                f"devices")
    heads, nk = model_cfg.n_heads, kv_heads(model_cfg)
    if heads % tp or nk % tp:
        raise ValueError(
            f"--serve.mesh-model {tp} must divide n_heads {heads} and "
            f"n_kv_heads {nk}: attention heads and the KV cache's head "
            f"axis shard over the model axis")
    vocab = model_cfg.vocab_size
    if not cfg.shard_vocab and vocab % tp:
        if cfg.dataset == "text":
            raise ValueError(
                f"--serve.mesh-model {tp} must divide the tokenizer "
                f"vocab {vocab} (the TP head is vocab-parallel); pass "
                f"--shard-vocab true to pad it")
        raise ValueError(
            f"--serve.mesh-model {tp} must divide the vocab {vocab}: "
            f"the TP head is vocab-parallel. Pass --shard-vocab true "
            f"(pads the table to a multiple of the model axis; the "
            f"checkpoint must be trained with the same flag) or pick a "
            f"width that divides")


def build_engine(cfg: TrainConfig, buckets, vocab: int, need: int, *,
                 device: torch.device, mesh: Mesh,
                 plan: Optional[FaultPlan] = None) -> SlotDecodeEngine:
    """The serving engine of ``cfg`` on ``device``: its model on
    ``mesh``'s model group (a tensor-parallel rank) or whole, with the
    checkpoint's weights or fresh-init ones, its dense weights held in
    the compute dtype, then the dense or paged engine (its pool sized
    for trajectories of ``need`` tokens unless ``--serve.num-pages``
    pins it). Every rank of a replica runs it with the chief's plan
    (``cfg`` with its cache length, the ``buckets``, the workload's
    ``vocab`` and ``need``); the fault ``plan`` and the decode watchdog
    are the chief's alone."""
    chief = mesh_lib.is_chief()
    if device.type == "cuda":
        # The summary's peak_bytes_by_rank counts from here.
        torch.cuda.reset_peak_memory_stats(device)
    model, state = _build_model_and_state(
        cfg, device, vocab_size=vocab, mesh=mesh,
        vocab_shards=checkpoint_vocab_shards(cfg))
    restored_step = None
    if cfg.checkpoint_dir:
        # A local-SGD save serves its replicas' mean, as --mode generate.
        state = (ckpt.restore_averaged(cfg.checkpoint_dir, state)
                 if cfg.param_sync_every > 1
                 else ckpt.restore(cfg.checkpoint_dir, state))
        if state.ema is not None:
            model.load_state_dict(state.ema)
        restored_step = int(state.step)
    del state  # the optimizer's moments are not served
    cast_dense_weights_(model)
    timeout = cfg.resilience.sync_timeout_s
    fire = dict(spec_tokens=cfg.serve.spec_tokens,
                fault_plan=plan if plan else None,
                watchdog=(Watchdog(sync_timeout_s=timeout)
                          if timeout > 0 and chief else None))
    if not cfg.serve.paged:
        engine = SlotDecodeEngine(model, cfg.serve.num_slots,
                                  buckets=buckets, **fire)
        engine.restored_step = restored_step
        return engine
    num_pages = cfg.serve.num_pages
    if not num_pages:
        ps = cfg.serve.page_size
        # The parameters' bytes on this card (a rank's shards under TP).
        reserved = sum(p.numel() * p.element_size()
                       for p in model.parameters())
        num_pages, rationale = auto_num_pages(
            num_slots=cfg.serve.num_slots, need_pages=-(-need // ps),
            page_bytes=page_bytes_estimate(model.cfg, ps,
                                           cfg.serve.mesh_model),
            budget_bytes=int(cfg.serve.hbm_budget_gb * 2 ** 30),
            reserved_bytes=reserved,
            observed_peak=observed_slot_pages_peak(cfg.observe.export_path))
        for line in rationale if chief else ():
            print(f"[serve] paged auto-size: {line}", flush=True)
    engine = PagedSlotEngine(model, cfg.serve.num_slots,
                             page_size=cfg.serve.page_size,
                             num_pages=num_pages, radix=cfg.serve.radix,
                             buckets=buckets, **fire)
    engine.restored_step = restored_step
    return engine


def observed_slot_pages_peak(export_path: str) -> int:
    """A previous run's measured ``slot_pages_peak`` from the standing
    ``--observe.export-path`` snapshot (0 when there is none, or it does
    not parse): the paged pool's auto-size reads it as the prefix
    cache's headroom."""
    if not export_path or not os.path.exists(export_path):
        return 0
    try:
        with open(export_path) as f:
            return int(json.load(f).get("slot_pages_peak", 0))
    except (OSError, ValueError, AttributeError):
        return 0


def reload_from(cfg: TrainConfig, engine: SlotDecodeEngine):
    """The live weight swap's source for ``--checkpoint-dir``: the newest
    verifiable checkpoint's params, cast and placed as ``engine``
    serves them (None without a checkpoint dir). A tensor-parallel
    chief picks the step and tells its workers to swap in their slices
    of the same step."""
    if not cfg.checkpoint_dir:
        return None

    def reload():
        params, step = ckpt.restore_params(cfg.checkpoint_dir, engine.model)
        engine.tell("_reload", cfg.checkpoint_dir, step)
        return params, step

    return reload


def serve_run(cfg: TrainConfig) -> Dict:
    """Run the serve workload (a fleet replica: serve its inbox until a
    drain); prints the ``[serve]`` summary line and the summary as a JSON
    ``serve_summary`` record, and returns it. Raises
    ``SlotRetryExhausted`` (a request quarantined past its budget) or
    ``StallError`` (the decode watchdog), which the CLI maps to exit codes
    2 and 3."""
    # A non-empty journal means a previous leg died mid-traffic: resume.
    # A fleet replica's journal is always fresh (a new epoch's path).
    played = (journal_mod.replay(cfg.serve.journal)
              if cfg.serve.journal and not cfg.serve.inbox else {})
    resumed = bool(played)
    cfg, engine, requests = serve_setup(cfg, played)
    if resumed:
        done_n = sum(1 for e in played.values() if e["done"])
        print(f"[serve] journal resume: {done_n} requests already "
              f"complete, {len(requests)} to serve ({cfg.serve.journal})",
              flush=True)
    if engine is None:
        print("[serve] journal resume: every request already complete — "
              "nothing to serve", flush=True)
        return {"requests": 0, "total_new_tokens": 0, "resumed": True}
    try:
        return _serve(cfg, engine, requests, resumed)
    finally:
        if engine.channel is not None:
            engine.channel.close()
            print(f"[serve] tensor-parallel replica stopped: "
                  f"{json.dumps(engine.channel.stop_s)}", flush=True)


def _serve(cfg: TrainConfig, engine: SlotDecodeEngine,
           requests: List[Request], resumed: bool) -> Dict:
    # The serve observatory: the registry, the per-request tracer, the
    # SLO monitor, the anomaly hub and the export knobs; the trace and
    # the JSONL continue across a journal resume.
    obs = ServeObservatory(
        cfg.observe, resumed=resumed,
        tags=host_tags({"data": 1, "model": cfg.serve.mesh_model}, cfg))
    engine.tracer = obs.tracer
    try:
        return _serve_observed(cfg, engine, requests, resumed, obs)
    finally:
        obs.close()


def _serve_observed(cfg: TrainConfig, engine: SlotDecodeEngine,
                    requests: List[Request], resumed: bool,
                    obs: ServeObservatory) -> Dict:
    # The proposer: the k-gram self-draft, or a draft GPT mirroring the
    # slot cache (serve/speculate.py); a tensor-parallel replica's draft
    # runs whole on the chief's card, as JAX builds it without a mesh.
    speculator = build_speculator(cfg, engine.model, cfg.seed + 1,
                                  cfg.serve.num_slots, engine.buckets)
    # Every first call (the engine's and a draft's) happens before the
    # clock starts, so the first requests' time to first token pays
    # compute only.
    t0 = time.perf_counter()
    engine.warmup(speculator)
    if engine.channel is not None:
        engine.channel.start_s["warmup"] = round(time.perf_counter() - t0, 3)
    on_token = None
    if cfg.serve.stream:
        def on_token(rid: int, tok: int, done: bool) -> None:
            print(f"[serve] rid={rid} tok={tok}"
                  + (" <done>" if done else ""), flush=True)

    status_fn = None
    if obs.status_every:
        def status_fn(line: str) -> None:
            print(line, flush=True)

    feed = None
    if cfg.serve.inbox:
        from tensorflow_distributed_tpu_torch.fleet.replica import InboxFeed

        feed = InboxFeed(cfg.serve.inbox,
                         default_max_new=cfg.serve.max_new_tokens,
                         default_eos=cfg.serve.eos_id)
        print(f"[serve] fleet replica: inbox {cfg.serve.inbox} (serving "
              f"until a drain command)", flush=True)
    trace = cfg.serve.trace or ("file" if cfg.serve.requests else "uniform")
    journal = (journal_mod.RequestJournal(cfg.serve.journal)
               if cfg.serve.journal else None)
    sched = Scheduler(engine, decode_priority=cfg.serve.decode_priority,
                      on_token=on_token, fault_plan=engine.fault_plan,
                      journal=journal, reload_fn=reload_from(cfg, engine),
                      slot_retries=cfg.serve.slot_retries,
                      policy=cfg.serve.policy,
                      tenant_quota=cfg.serve.tenant_quota,
                      preempt=cfg.serve.preempt, speculator=speculator,
                      status_fn=status_fn, feed=feed,
                      served_ckpt_step=engine.restored_step,
                      summary_extra={"seed": cfg.seed, "trace": trace,
                                     "resumed": resumed},
                      **obs.scheduler_kwargs())
    try:
        done = sched.run(requests)
    finally:
        if journal is not None:
            journal.close()
        if engine.watchdog is not None:
            engine.watchdog.close()
    summary = dict(sched.summary)
    if done:
        # A fleet replica can drain without having served a request.
        ttfts = np.asarray([c.ttft_s for c in done])
        for q in (50, 95, 99):
            summary[f"ttft_ms_p{q}"] = round(
                1e3 * float(np.percentile(ttfts, q)), 3)
        summary["tok_ms_mean"] = round(
            float(np.mean([c.tok_ms for c in done])), 4)
    # The p95 TTFT of each SLO class present (JAX's), FIFO runs included.
    by_class: Dict[str, list] = {}
    for c in done:
        by_class.setdefault(c.slo, []).append(c.ttft_s)
    for cls, vals in sorted(by_class.items()):
        summary[f"ttft_ms_p95_{cls}"] = round(
            1e3 * float(np.percentile(np.asarray(vals), 95)), 3)
    summary["params"] = "checkpoint" if cfg.checkpoint_dir else "fresh-init"
    if engine.channel is not None:
        # What the workers' commands cost the chief's host.
        summary["tp_commands"] = engine.channel.sent
        summary["tp_command_s"] = round(engine.channel.send_s, 4)
        # Where the replica's start went (seconds: the workers' spawn and
        # the group's join, the chief's engine build, the warmup).
        summary["tp_start_s"] = dict(engine.channel.start_s)
    if engine.device.type == "cuda":
        # Every rank's peak of allocated memory (the chief's alone on one
        # card).
        summary["peak_bytes_by_rank"] = (
            engine.channel.peak_bytes(engine.device)
            if engine.channel is not None
            else [tp_replica.peak_bytes(engine.device)])
        # Into the run's records too: a fleet replica's standard output
        # is not its controller's to read.
        obs.registry.emit("device_memory",
                          peak_bytes_by_rank=summary["peak_bytes_by_rank"])
    print(f"[serve] {summary['requests']} requests, "
          f"{summary['total_new_tokens']} tokens in "
          f"{summary['wall_s']}s — "
          f"{summary['tokens_per_sec']} tok/s, occupancy "
          f"{summary['mean_slot_occupancy']}, ttft p50 "
          f"{summary.get('ttft_ms_p50')}ms / p95 "
          f"{summary.get('ttft_ms_p95')}ms, "
          f"{summary['prefill_compiles']} prefill programs "
          f"(buckets {summary['buckets']}), "
          f"{summary['params']} params", flush=True)
    if cfg.serve.spec_tokens:
        print(f"[serve] speculative: k={summary.get('spec_tokens')} "
              f"accept_rate={summary.get('accept_rate')} "
              f"verify_steps={summary.get('verify_steps')} "
              f"fallback_slots={summary.get('spec_fallback_slots')} "
              f"batch_fallbacks={summary.get('spec_batch_fallbacks')}",
              flush=True)
    if cfg.serve.paged:
        print(f"[serve] paged: prefix_hit_rate="
              f"{summary.get('prefix_hit_rate')} pool_occupancy="
              f"{summary.get('pool_occupancy')} pages_peak="
              f"{summary.get('pages_peak')}/{summary.get('num_pages')} "
              f"evictions={summary.get('page_evictions')} cow="
              f"{summary.get('cow_copies')} sessions="
              f"{summary.get('sessions')}", flush=True)
    if cfg.serve.policy == "slo":
        cls_bits = " ".join(f"{k.rsplit('_', 1)[-1]}={summary[k]}ms"
                            for k in sorted(summary)
                            if k.startswith("ttft_ms_p95_"))
        print(f"[serve] slo: preemptions={summary['preemptions']} "
              f"p95 ttft by class: {cls_bits}", flush=True)
    if engine.fault_plan or resumed:
        print(f"[serve] fire: retries={summary['retries']} "
              f"swaps={summary['swaps']} "
              f"swap_s={summary['swap_seconds']} "
              f"resumed={summary['resumed']} "
              f"ttft p99 {summary.get('ttft_ms_p99')}ms", flush=True)
    if cfg.observe.slo:
        print(f"[serve] slo monitor: "
              f"alerts={summary.get('slo_alerts', 0)} "
              f"budget_remaining_min="
              f"{summary.get('slo_budget_remaining_min')} "
              f"targets={summary.get('slo_targets')}", flush=True)
    if cfg.observe.trace:
        print(f"[observe] serve trace: {cfg.observe.trace} (open at "
              f"https://ui.perfetto.dev)", flush=True)
    if cfg.observe.export_path:
        print(f"[observe] metrics snapshot: {cfg.observe.export_path} "
              f"(atomic; rewritten every "
              f"{cfg.observe.export_every or 'run-end'}"
              f"{'s' if cfg.observe.export_every else ''})", flush=True)
    if cfg.observe.metrics_jsonl:
        print(f"[observe] serve metrics: {cfg.observe.metrics_jsonl}",
              flush=True)
    print(json.dumps({"event": "serve_summary", **summary}), flush=True)
    return summary

"""``--mode serve``: the port of ``serve/run.py``. Build a causal LM, run
a request workload through the continuous-batching engine, report.

Workloads: ``--serve.requests file.jsonl`` (one JSON object per line:
``{"prompt": [ids...], "max_new_tokens": 32, "eos_id": 5,
"arrival_s": 0.25}``) or, with no file, a synthetic open-loop workload:
``--serve.num-requests`` random prompts with lengths drawn in
[``--serve.prompt-len-min``, ``--serve.prompt-len-max``], arriving at
``--serve.arrival-rate`` req/s (0 = all queued at t=0) in the shape of
``--serve.trace``: ``poisson``, ``bursty``, ``diurnal``, or a ``.jsonl``
file of per-request ``{"arrival_s": t}`` offsets.

With ``--checkpoint-dir`` it serves the latest checkpoint's weights
(its EMA where it tracks one), as JAX's does; a checkpointed model's
``max_len`` is the trained one, so pass that ``--seq-len``. Without it
the params are fresh-init (drawn from ``--seed``) and the summary says
so, as in JAX. The synthetic workload's ids are drawn below
``--synthetic-vocab`` (64 when unset, as in JAX): a full-width run
passes ``--synthetic-vocab 50257``. Text prompts wait for the port of
``--dataset text``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

import numpy as np

from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models.transformer import (
    cast_dense_weights_)
from tensorflow_distributed_tpu_torch.serve.buckets import (
    default_buckets, parse_buckets)
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from tensorflow_distributed_tpu_torch.serve.scheduler import (
    Request, Scheduler)
from tensorflow_distributed_tpu_torch.train import checkpoint as ckpt
from tensorflow_distributed_tpu_torch.train.loop import (
    _build_model_and_state, resolve_device)


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


# Request-file fields of the SLO scheduler and the paged engine's
# sessions, with the values that leave them unused.
_UNPORTED_FIELDS = {"slo": "standard", "tenant": "", "session": ""}


def _read_requests(cfg: TrainConfig) -> List[Request]:
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
                raise NotImplementedError(
                    f"{where}: text prompts need --dataset text, which is "
                    f"not ported to PyTorch yet (see ROADMAP.md queue A)")
            for key, default in _UNPORTED_FIELDS.items():
                if str(obj.get(key, default)) != default:
                    raise NotImplementedError(
                        f"{where}: the request field {key!r} is read by a "
                        f"scheduler or engine that is not ported to "
                        f"PyTorch yet (see ROADMAP.md queue A)")
            ids = [int(t) for t in obj["prompt"]]
            if not ids:
                raise ValueError(f"{where}: empty prompt")
            reqs.append(Request(
                rid=len(reqs), prompt=np.asarray(ids, np.int32),
                max_new_tokens=int(obj.get("max_new_tokens",
                                           serve.max_new_tokens)),
                eos_id=int(obj.get("eos_id", serve.eos_id)),
                arrival_s=float(obj.get("arrival_s", 0.0))))
    if not reqs:
        raise ValueError(f"{serve.requests} names no requests")
    return reqs


def _workload(cfg: TrainConfig, vocab_size: int) -> List[Request]:
    """The request file, or the synthetic workload: mixed lengths drawn
    from ``--seed``, prompts drawn BEFORE the arrivals so the token
    content is the same under every trace (JAX's draw order)."""
    serve = cfg.serve
    if serve.requests:
        return _read_requests(cfg)
    rng = np.random.default_rng(cfg.seed)
    prompts = []
    for _ in range(serve.num_requests):
        plen = int(rng.integers(serve.prompt_len_min,
                                serve.prompt_len_max + 1))
        prompts.append(
            rng.integers(0, vocab_size, size=plen).astype(np.int32))
    arrivals = _arrivals(serve, serve.num_requests, rng)
    return [Request(rid=i, prompt=p, max_new_tokens=serve.max_new_tokens,
                    eos_id=serve.eos_id, arrival_s=float(a))
            for i, (p, a) in enumerate(zip(prompts, arrivals))]


def serve_setup(cfg: TrainConfig
                ) -> Tuple[TrainConfig, SlotDecodeEngine, List[Request]]:
    """Everything before the scheduler's clock starts: the workload, the
    cache length (``--seq-len``, or sized to the workload), the bucket
    ladder, the model (the checkpoint's weights with ``--checkpoint-dir``,
    else fresh-init from ``--seed``; its dense weights held in the
    compute dtype) and the engine. Returns the config with the cache
    length it was given, the engine and the requests."""
    cfg.validate()
    device = resolve_device(cfg.device)
    requests = _workload(cfg, cfg.synthetic_vocab or 64)
    max_prompt = max(len(r.prompt) for r in requests)
    # The trajectory bound (what has to fit the cache); bucket padding is
    # prefill-only slack, clamped to the cache by the ladder's cap.
    need = max(len(r.prompt) + r.max_new_tokens for r in requests)
    if cfg.seq_len and need > cfg.seq_len:
        raise ValueError(
            f"--seq-len {cfg.seq_len} cannot hold the workload: the "
            f"longest request (prompt + new tokens) needs a {need}-token "
            f"cache")
    if not cfg.seq_len:
        cfg = dataclasses.replace(cfg, seq_len=max(need, 32))
    buckets = (parse_buckets(cfg.serve.buckets) if cfg.serve.buckets
               else default_buckets(max_prompt, cap=cfg.seq_len))
    model, state = _build_model_and_state(cfg, device)
    vocab = model.cfg.vocab_size
    for r in requests:
        # The embedding would fail on an id outside the table; name it.
        bad = [int(t) for t in r.prompt if not 0 <= t < vocab]
        if bad:
            raise ValueError(f"request {r.rid}: prompt ids {bad} outside "
                             f"the model vocabulary [0, {vocab})")
    if cfg.checkpoint_dir:
        state = ckpt.restore(cfg.checkpoint_dir, state)
        if state.ema is not None:
            model.load_state_dict(state.ema)
    del state  # the optimizer's moments are not served
    cast_dense_weights_(model)
    engine = SlotDecodeEngine(model, cfg.serve.num_slots, buckets=buckets)
    return cfg, engine, requests


def serve_run(cfg: TrainConfig) -> Dict:
    """Run the serve workload; prints the ``[serve]`` summary line and
    the summary as a JSON ``serve_summary`` record, and returns it."""
    cfg, engine, requests = serve_setup(cfg)
    # Every first call happens before the clock starts, so the first
    # requests' time to first token pays compute only.
    engine.warmup()
    on_token = None
    if cfg.serve.stream:
        def on_token(rid: int, tok: int, done: bool) -> None:
            print(f"[serve] rid={rid} tok={tok}"
                  + (" <done>" if done else ""), flush=True)

    trace = cfg.serve.trace or ("file" if cfg.serve.requests else "uniform")
    sched = Scheduler(engine, decode_priority=cfg.serve.decode_priority,
                      on_token=on_token, policy=cfg.serve.policy,
                      summary_extra={"seed": cfg.seed, "trace": trace,
                                     "resumed": False})
    done = sched.run(requests)
    summary = dict(sched.summary)
    ttfts = np.asarray([c.ttft_s for c in done])
    for q in (50, 95, 99):
        summary[f"ttft_ms_p{q}"] = round(
            1e3 * float(np.percentile(ttfts, q)), 3)
    summary["tok_ms_mean"] = round(
        float(np.mean([c.tok_ms for c in done])), 4)
    summary["params"] = "checkpoint" if cfg.checkpoint_dir else "fresh-init"
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
    print(json.dumps({"event": "serve_summary", **summary}), flush=True)
    return summary

"""Run configuration of the PyTorch port: the subset of the JAX
package's ``TrainConfig`` (and its ``MeshConfig`` and ``ServeConfig``)
that the port runs, with the same flag spellings, plus ``--device``.

The port keeps its own copy of the JAX ``config.py`` dataclass-to-argparse
helper. Flags of the JAX CLI that the port does not parse yet are
rejected with an error that points at ROADMAP.md, never ignored.

Every field shared with the JAX ``TrainConfig``, ``MeshConfig`` and
``ServeConfig`` has the JAX default, ``model`` included: the bare CLI
call trains the reference's ``mnist_cnn`` on the MNIST idx files under
``--data-dir``. Every ``--serve.*``, ``--resilience.*`` and
``--observe.*`` flag of the JAX CLI parses; those of the layers not
ported yet are refused unless they keep their default
(``--resilience.fault-plan`` and ``--resilience.sync-timeout-s`` run
under ``--mode serve``; the serve observatory's ``--observe.*`` flags
and ``--serve.inbox`` under ``--mode serve`` only, naming ROADMAP.md A8
for the rest).
``--param-partition``, ``--grad-sync`` and ``--grad-sync-bucket-mb``
take the JAX values, checks and messages; the port also refuses a
partition under ``--mode serve`` and with ``--optimizer adafactor``.
The mixture-of-experts knobs (``--moe-*``, ``--model moe_lm``,
``--mesh.expert``) take the JAX defaults, checks and messages; MoE under
``--mesh.seq``, a partition or an explicit gradient sync is refused
naming ROADMAP.md, as is ``--compute-dtype float32`` for training or
evaluating the LM on a GPU (the kernels take bf16). The pipeline
(``--model pipelined_lm``, ``--mesh.pipe``, ``--pipeline-*``) and
``--param-sync-every`` (local SGD) take the JAX defaults, checks and
messages; ``pipelined_lm`` trains with a data, model or seq axis and
under ``--param-partition zero1``, and an expert axis with the pipe is
refused with JAX's message (ROADMAP.md A5a). Adafactor under a model or
expert axis or a partition is refused naming A5c.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import typing
from typing import Optional, Sequence

from tensorflow_distributed_tpu_torch.resilience.faults import (
    SERVE_KINDS, TRAIN_KINDS, parse_fault_plan)
from tensorflow_distributed_tpu_torch.serve.buckets import parse_buckets
from tensorflow_distributed_tpu_torch.observe.slo import (
    parse_slo, parse_windows)
from tensorflow_distributed_tpu_torch.serve.scheduler import (
    SLO_CLASSES, parse_slo_mix)

SCHEDULES = ("constant", "cosine", "warmup_cosine")
OPTIMIZERS = ("adam", "sgd", "adafactor")
COMPUTE_DTYPES = ("bfloat16", "float32")
CE_IMPLS = ("scan", "kernel")
MODEL_SIZES = ("", "small", "medium", "large", "xl", "tiny", "base")
LM_MODELS = ("gpt_lm", "bert_mlm", "moe_lm", "pipelined_lm")
# The LM families with the decode cache (generate, serve).
CAUSAL_LM_MODELS = ("gpt_lm", "moe_lm")
# The causal families (a sliding window).
WINDOW_MODELS = ("gpt_lm", "moe_lm", "pipelined_lm")
PIPELINE_SCHEDULES = ("gpipe", "1f1b")
VISION_MODELS = ("mnist_cnn", "resnet20", "resnet50")
DATASETS = ("mnist", "synthetic", "cifar10", "cifar10_synthetic",
            "imagenet_synthetic", "text")
TEXT_TOKENIZERS = ("byte", "bpe")
DATA_BACKENDS = ("numpy", "u8_native")
INIT_SCHEMES = ("improved", "reference")
MODES = ("train", "eval", "generate", "serve")
SERVE_TRACES = ("poisson", "bursty", "diurnal")


class FlagNotPorted(NotImplementedError):
    """A flag of a layer the port does not run yet, set off its default
    (``parse_args`` exits with its message, as for a flag it does not
    parse)."""


@dataclasses.dataclass
class MeshConfig:
    """Logical device-mesh shape, one process (one GPU) per position:
    the JAX ``MeshConfig``'s ``data`` axis (data parallelism, the
    reference's worker replicas; -1 = every process the other axes leave
    over), ``model`` axis (Megatron tensor parallelism of the transformer
    families), ``seq`` axis (sequence parallelism, ring attention over
    ``seq`` processes), ``pipe`` axis (pipeline parallelism:
    ``pipelined_lm``'s blocks cut into ``pipe`` stages, one a process)
    and ``expert`` axis (a MoE model's experts cut over ``expert``
    processes; without one they take the model axis, as in JAX)."""

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def validate(self) -> None:
        for name in ("model", "seq", "pipe", "expert"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"mesh.{name} must be >= 1, got {v}")
        if self.data == 0 or self.data < -1:
            raise ValueError(f"mesh.data must be -1 or >= 1, got {self.data}")


@dataclasses.dataclass
class ObserveConfig:
    """The JAX ``ObserveConfig``: every field with its JAX spelling and
    default, so both CLIs parse the same ``--observe.*`` flags. The port
    runs the serve observatory (``observe/hub.py``'s ``ServeObservatory``)
    under ``--mode serve``: the metrics JSONL, the per-request trace, the
    SLO monitor, the rolling snapshot export and the anomaly detectors.
    The other fields (the CSV sink, MFU's peak and window, the
    compiled-program registry, health telemetry, the flight recorder,
    the autopilot) belong to layers not ported yet and are refused at a
    non-default value, as is every observe flag outside ``--mode serve``
    (ROADMAP.md A8)."""

    # JSONL metrics sink: one JSON object per event (serve_request,
    # serve_summary, metrics_snapshot, slo_alert, anomaly, recovery).
    metrics_jsonl: str = ""
    # CSV sink (training's step records).
    metrics_csv: str = ""
    # mode=serve: the per-request Perfetto trace (observe/serve_trace.py).
    trace: str = ""
    # Rewrite the trace file at every request-lifecycle edge (a
    # SIGKILLed fleet replica leaves its in-flight spans on disk).
    trace_durable: bool = False
    # Per-device peak TFLOP/s for MFU (training).
    peak_tflops: float = 0.0
    # Rolling window (steps) of the step-time stats (training).
    window: int = 200
    # In-memory record ring-buffer cap of the registry.
    max_records: int = 100_000
    # The compiled-program registry (JAX programs).
    programs: bool = True
    # On-device model-health telemetry (training).
    health: bool = False
    health_every: int = 0
    health_taps: bool = False
    # Declared SLO targets (observe/slo.py grammar):
    # "high:ttft_p95=100ms,tok_p50=30ms;standard:ttft_p95=500ms".
    slo: str = ""
    # Burn-rate windows in decode steps, "fast,slow".
    slo_windows: str = "60,600"
    # Burn-rate alert threshold (a multiple of the sustainable rate).
    slo_burn: float = 1.0
    # The live status line's cadence in decode steps (0 = the fast
    # window's when slo is armed, off otherwise).
    slo_status_every: int = 0
    # Rolling-metrics snapshot cadence in seconds (scheduler clock);
    # 0 = one final snapshot when export_path is set.
    export_every: float = 0.0
    # The atomic snapshot file a poller (the fleet router) reads.
    export_path: str = ""
    # Online anomaly detection (serve: TTFT spike, decode-step-time
    # spike, queue growth, slot non-finite).
    anomaly: bool = False
    # The detectors' rolling window (decode steps).
    anomaly_window: int = 64
    # The crash flight recorder.
    flightrec: str = ""
    flightrec_ring: int = 256
    flightrec_snapshot_every: int = 50
    # The autopilot (online controller).
    autopilot: bool = False
    autopilot_every: int = 50
    autopilot_confirm: int = 3
    autopilot_cooldown: int = 200
    autopilot_drift_tol: float = 0.25
    autopilot_pin: str = ""
    autopilot_calibration: str = ""

    def validate(self) -> None:
        """The JAX ObserveConfig's checks, with its messages; then the
        refusal of the fields of layers not ported yet."""
        if self.health_every < 0:
            raise ValueError(
                f"observe.health_every must be >= 0, "
                f"got {self.health_every}")
        if self.health_every and not self.health:
            raise ValueError(
                "observe.health_every has no effect without "
                "observe.health; add --observe.health true")
        if self.health_taps and not self.health:
            raise ValueError(
                "observe.health_taps has no effect without "
                "observe.health; add --observe.health true")
        if self.window < 1:
            raise ValueError(
                f"observe.window must be >= 1, got {self.window}")
        if self.max_records < 1:
            raise ValueError(
                f"observe.max_records must be >= 1, "
                f"got {self.max_records}")
        if self.peak_tflops < 0:
            raise ValueError(
                f"observe.peak_tflops must be >= 0, "
                f"got {self.peak_tflops}")
        if self.trace_durable and not self.trace:
            raise ValueError(
                "observe.trace_durable has no effect without "
                "observe.trace; set a trace path (--observe.trace)")
        if self.slo:
            parse_slo(self.slo)  # grammar at config time
        parse_windows(self.slo_windows)
        if self.slo_burn <= 0:
            raise ValueError(
                f"observe.slo_burn must be > 0, got {self.slo_burn}")
        if not self.slo:
            if self.slo_windows != "60,600":
                raise ValueError(
                    "observe.slo_windows has no effect without "
                    "observe.slo; declare targets (--observe.slo)")
            if self.slo_burn != 1.0:
                raise ValueError(
                    "observe.slo_burn has no effect without "
                    "observe.slo; declare targets (--observe.slo)")
        if self.slo_status_every < 0:
            raise ValueError(
                f"observe.slo_status_every must be >= 0, "
                f"got {self.slo_status_every}")
        if self.export_every < 0:
            raise ValueError(
                f"observe.export_every must be >= 0, "
                f"got {self.export_every}")
        if self.anomaly_window < 8:
            raise ValueError(
                f"observe.anomaly_window must be >= 8, "
                f"got {self.anomaly_window}")
        if self.anomaly_window != 64 and not self.anomaly:
            raise ValueError(
                "observe.anomaly_window has no effect without "
                "observe.anomaly; add --observe.anomaly true")
        if self.flightrec_ring < 8:
            raise ValueError(
                f"observe.flightrec_ring must be >= 8, "
                f"got {self.flightrec_ring}")
        if self.flightrec_snapshot_every < 1:
            raise ValueError(
                f"observe.flightrec_snapshot_every must be >= 1, "
                f"got {self.flightrec_snapshot_every}")
        if not self.flightrec and (
                self.flightrec_ring != 256
                or self.flightrec_snapshot_every != 50):
            raise ValueError(
                "observe.flightrec_ring/flightrec_snapshot_every have "
                "no effect without observe.flightrec; set a bundle "
                "directory (--observe.flightrec DIR)")
        if self.autopilot_every < 1:
            raise ValueError(
                f"observe.autopilot_every must be >= 1, "
                f"got {self.autopilot_every}")
        if self.autopilot_confirm < 1:
            raise ValueError(
                f"observe.autopilot_confirm must be >= 1, "
                f"got {self.autopilot_confirm}")
        if self.autopilot_cooldown < 0:
            raise ValueError(
                f"observe.autopilot_cooldown must be >= 0, "
                f"got {self.autopilot_cooldown}")
        if self.autopilot_drift_tol <= 0:
            raise ValueError(
                f"observe.autopilot_drift_tol must be > 0, "
                f"got {self.autopilot_drift_tol}")
        if self.autopilot_pin:
            bad = sorted(
                {p.strip() for p in self.autopilot_pin.split(",")
                 if p.strip()} - set(AUTOPILOT_KNOBS))
            if bad:
                raise ValueError(
                    f"observe.autopilot_pin: unknown knob(s) "
                    f"{', '.join(bad)} (valid: "
                    f"{', '.join(AUTOPILOT_KNOBS)})")
        if not self.autopilot and (
                self.autopilot_every != 50
                or self.autopilot_confirm != 3
                or self.autopilot_cooldown != 200
                or self.autopilot_drift_tol != 0.25
                or self.autopilot_pin
                or self.autopilot_calibration):
            raise ValueError(
                "observe.autopilot_* knobs have no effect without "
                "observe.autopilot; add --observe.autopilot true")
        unported = self.unported()
        if unported:
            raise FlagNotPorted(
                f"--observe.{unported[0].replace('_', '-')}="
                f"{getattr(self, unported[0])!r} is not ported to PyTorch "
                f"yet (see ROADMAP.md A8)")

    def unported(self) -> list:
        """The fields of layers not ported yet set off their defaults."""
        return [f.name for f in dataclasses.fields(self)
                if f.name not in OBSERVE_SERVE_FIELDS
                and getattr(self, f.name) != f.default]

    def armed(self) -> list:
        """Every field set off its default."""
        return [f.name for f in dataclasses.fields(self)
                if getattr(self, f.name) != f.default]


# The fields of the serve observatory, which the port runs.
OBSERVE_SERVE_FIELDS = (
    "metrics_jsonl", "trace", "trace_durable", "max_records", "slo",
    "slo_windows", "slo_burn", "slo_status_every", "export_every",
    "export_path", "anomaly", "anomaly_window")
# The autopilot's knobs (JAX observe/autopilot.py KNOBS), which
# --observe.autopilot-pin names.
AUTOPILOT_KNOBS = ("calibration", "slot_cap", "spec_k", "decode_priority",
                   "num_pages", "buckets")


@dataclasses.dataclass
class ServeConfig:
    """``--mode serve``'s knobs: the JAX ``ServeConfig``, every field with
    its JAX spelling and default. The port runs the dense slot engine, or
    with ``paged`` the paged one (radix prefix cache, sessions), either
    over a bf16 or an int8 cache, speculative with ``spec_tokens``, under
    the FIFO or the SLO scheduler, on one card or tensor-parallel over
    ``mesh_model`` cards, on a workload of its own or, with ``inbox``, as
    a fleet replica (``fleet/replica.py``)."""

    # Decode batch width: concurrent requests in flight.
    num_slots: int = 8
    # Default per-request generation budget (a request file may
    # override it per request).
    max_new_tokens: int = 64
    # Prefill bucket ladder, e.g. "32,64,128"; "" = the power-of-two
    # ladder covering the workload's longest prompt (serve/buckets.py).
    buckets: str = ""
    # Starvation bound: a queued request with a free slot is admitted
    # after at most this many decode steps.
    decode_priority: int = 4
    # EOS token id ending a request early (-1 = every request runs to
    # its full budget).
    eos_id: int = -1
    # Request file (JSONL: {"prompt": [ids...], "max_new_tokens": n,
    # "eos_id": e, "arrival_s": t}); "" = the synthetic workload below.
    requests: str = ""
    # Synthetic workload: request count, prompt lengths uniform in
    # [min, max] (seeded by --seed), open-loop arrival rate in req/s
    # (0 = every request queued at t=0).
    num_requests: int = 16
    prompt_len_min: int = 8
    prompt_len_max: int = 64
    arrival_rate: float = 0.0
    # Arrival shape of the synthetic workload: "" = uniform at
    # arrival_rate, "poisson", "bursty", "diurnal" (these three need
    # arrival_rate > 0), or a .jsonl file of {"arrival_s": t} offsets.
    trace: str = ""
    # Print each token as it retires.
    stream: bool = False
    # Admission order: "fifo" (arrival order) or "slo" (class priority
    # high > standard > batch, per-tenant token quotas, and
    # preempt-and-requeue as a continuation: token-identical by greedy
    # determinism).
    policy: str = "fifo"  # fifo | slo
    # Decode-cache storage: "bf16" (the compute dtype) or "int8" (per-
    # (token, head) absmax scales; the serve-side spelling of
    # --kv-cache-quant int8, 1.88x fewer bytes a cached token-head at
    # head dim 64).
    kv_dtype: str = "bf16"  # bf16 | int8
    # The paged KV cache (serve/paging): a page pool shared by every
    # slot, each slot reserving pages for its own trajectory.
    paged: bool = False
    # Tokens a page (must divide the cache length; the auto-sized one is
    # rounded up to a whole page).
    page_size: int = 16
    # Pool pages, the write-off page included; 0 = sized from the
    # workload (and --serve.hbm-budget-gb).
    num_pages: int = 0
    # The radix prefix cache over the pool (false: paging alone).
    radix: bool = True
    # Synthetic workload: > 1 groups consecutive requests into sessions
    # of this many turns, each turn's prompt extending the previous
    # turn's (the paged engine re-attaches the conversation).
    session_turns: int = 1
    # Caps the auto-sized pool at (budget - the params' bytes) /
    # page_bytes (GiB; 0 = no cap). Needs --serve.paged and num_pages 0.
    hbm_budget_gb: float = 0.0
    # Speculative decoding: > 0 proposes this many tokens a slot a step
    # and verifies them in one forward (accepted + 1 tokens a dispatch,
    # token-identical to plain greedy).
    spec_tokens: int = 0
    # The proposer: "" = the k-gram self-draft over each request's own
    # history; else a draft GPT ("tiny", or "size=tiny,n_layers=1":
    # TransformerConfig overrides) drawn fresh from --seed + 1.
    draft_config: str = ""
    # The self-draft's suffix length.
    spec_kgram: int = 3
    # Per-tenant decoded-token quota for policy=slo (0 = off): a tenant
    # at or over it is deferred while an under-quota request waits, never
    # dropped.
    tenant_quota: int = 0
    # Let policy=slo preempt a live lower-class (or over-quota) request
    # for a higher-class one that waited out the decode-priority clock.
    preempt: bool = True
    # Synthetic workload's class mix, e.g. "high:0.25,batch:0.25" (the
    # rest "standard"); a request file carries per-request "slo" fields.
    slo_mix: str = ""
    # Synthetic workload's tenant count (round-robin); a request file
    # carries per-request "tenant" fields.
    tenants: int = 1
    # Request journal path (serve/journal.py): admits, tokens and
    # completions append here, flushed every scheduler iteration, so a
    # killed serving process resumes at token granularity; a non-empty
    # journal at start-up means RESUME. "" = off.
    journal: str = ""
    # Per-request slot-retry budget: how many times one request may be
    # quarantined (non-finite logits: free the slot, re-prefill prompt +
    # good tokens) before the run halts with SlotRetryExhausted (exit 2).
    slot_retries: int = 2
    # Tensor-parallel serving: shard the replica itself over N cards
    # (serve/tp_replica.py): attention heads, MLP width and the cache's
    # head axis cut over N, token-identical to one card. The engine's
    # own group, deliberately not --mesh.model (the train mesh flags keep
    # their pure-data contract under mode=serve). N must divide n_heads
    # and n_kv_heads, and the vocabulary unless --shard-vocab true pads
    # it (serve/run.py checks both). 1 = the one-card engine.
    mesh_model: int = 1
    # Fleet serving (fleet/): the inbox file this replica tails for
    # requests and control commands (fleet/replica.py's line protocol).
    # With an inbox the scheduler serves an open-ended stream (no
    # workload of its own) until a drain command lands and the engine
    # runs dry. Needs an explicit --seq-len (no workload to size the
    # cache from) and --serve.journal (the router's data plane).
    inbox: str = ""

    def validate(self) -> None:
        for name in ("num_slots", "max_new_tokens", "decode_priority"):
            if getattr(self, name) < 1:
                raise ValueError(f"serve.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.buckets:
            parse_buckets(self.buckets)  # syntax at config time
        if not self.requests:
            if self.num_requests < 1:
                raise ValueError(f"serve.num_requests must be >= 1, got "
                                 f"{self.num_requests}")
            if not 1 <= self.prompt_len_min <= self.prompt_len_max:
                raise ValueError(
                    f"serve prompt length range [{self.prompt_len_min}, "
                    f"{self.prompt_len_max}] must satisfy 1 <= min <= max")
        if self.arrival_rate < 0:
            raise ValueError(f"serve.arrival_rate must be >= 0, got "
                             f"{self.arrival_rate}")
        if self.slot_retries < 0:
            raise ValueError(
                f"serve.slot_retries must be >= 0, "
                f"got {self.slot_retries}")
        if self.trace and not self.trace.endswith(".jsonl"):
            if self.trace not in SERVE_TRACES:
                raise ValueError(
                    f"unknown serve.trace {self.trace!r}; have "
                    f"{SERVE_TRACES} or a .jsonl file of arrival offsets")
            if not self.arrival_rate:
                raise ValueError(
                    f"serve.trace={self.trace!r} shapes the arrival process "
                    f"around serve.arrival_rate; set a rate > 0")
        if self.trace and self.requests:
            raise ValueError(
                "serve.trace shapes the SYNTHETIC workload's arrivals; a "
                "request file carries its own arrival_s; drop one of the "
                "flags")
        if self.spec_tokens < 0:
            raise ValueError(
                f"serve.spec_tokens must be >= 0, got {self.spec_tokens}")
        if self.draft_config and not self.spec_tokens:
            raise ValueError(
                "serve.draft_config proposes serve.spec_tokens tokens per "
                "step; add --serve.spec-tokens > 0")
        if self.spec_kgram < 1:
            raise ValueError(
                f"serve.spec_kgram must be >= 1, got {self.spec_kgram}")
        if self.mesh_model < 1:
            raise ValueError(
                f"serve.mesh_model must be >= 1, "
                f"got {self.mesh_model}")
        self._validate_paging()
        if self.inbox:
            # Inbox mode replaces the workload: the knobs that shape a
            # synthetic or file workload would do nothing (JAX's checks).
            if self.requests:
                raise ValueError(
                    "serve.inbox streams requests from the fleet "
                    "router; a request file is a fixed workload — "
                    "drop one of the flags")
            if self.trace or self.slo_mix or self.session_turns > 1:
                raise ValueError(
                    "serve.trace/slo_mix/session_turns shape the "
                    "SYNTHETIC workload; with serve.inbox the router "
                    "owns arrivals, classes, and sessions — drop "
                    "them")
            if not self.journal:
                raise ValueError(
                    "serve.inbox needs --serve.journal: the journal "
                    "is how the fleet router reads tokens back and "
                    "re-dispatches after a replica death")
        self._validate_slo()

    def _validate_slo(self) -> None:
        """The JAX ServeConfig's checks of the SLO scheduler's knobs, with
        its messages."""
        if self.policy not in ("fifo", "slo"):
            raise ValueError(f"unknown serve.policy {self.policy!r}; have "
                             f"('fifo', 'slo')")
        if self.tenant_quota < 0:
            raise ValueError(
                f"serve.tenant_quota must be >= 0, got {self.tenant_quota}")
        if self.tenant_quota and self.policy != "slo":
            raise ValueError(
                "serve.tenant_quota is enforced by the SLO scheduler; add "
                "--serve.policy slo")
        if self.tenant_quota and not self.requests and self.tenants <= 1:
            raise ValueError(
                "serve.tenant_quota needs tenants to meter: the synthetic "
                "workload assigns tenants only when --serve.tenants > 1 "
                "(request files carry their own per-request tenant "
                "fields) — without them the quota silently never fires")
        if self.slo_mix:
            if self.policy != "slo":
                raise ValueError(
                    "serve.slo_mix assigns classes the SLO scheduler acts "
                    "on; add --serve.policy slo")
            if self.requests:
                raise ValueError(
                    "serve.slo_mix shapes the SYNTHETIC workload; a request "
                    "file carries its own per-request slo field — drop one "
                    "of the flags")
            parse_slo_mix(self.slo_mix)  # syntax at config time
        if self.tenants < 1:
            raise ValueError(f"serve.tenants must be >= 1, got {self.tenants}")

    def _validate_paging(self) -> None:
        """The JAX ServeConfig's checks of the int8 and paged caches and
        of sessions, with its messages."""
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"unknown serve.kv_dtype {self.kv_dtype!r}; have "
                f"('bf16', 'int8')")
        if self.page_size < 1:
            raise ValueError(
                f"serve.page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 0:
            raise ValueError(
                f"serve.num_pages must be >= 0, got {self.num_pages}")
        if not self.paged:
            # The paged knobs doing nothing without their parent would be
            # a trap.
            if self.page_size != 16:
                raise ValueError(
                    "serve.page_size shapes the paged KV cache; add "
                    "--serve.paged")
            if self.num_pages:
                raise ValueError(
                    "serve.num_pages sizes the paged KV pool; add "
                    "--serve.paged")
            if not self.radix:
                raise ValueError(
                    "serve.radix toggles the paged engine's prefix "
                    "cache; add --serve.paged")
        if self.session_turns < 1:
            raise ValueError(
                f"serve.session_turns must be >= 1, "
                f"got {self.session_turns}")
        if self.session_turns > 1 and self.requests:
            raise ValueError(
                "serve.session_turns shapes the SYNTHETIC workload; a "
                "request file carries its own per-request session "
                "field — drop one of the flags")
        if self.hbm_budget_gb < 0:
            raise ValueError(
                f"serve.hbm_budget_gb must be >= 0, "
                f"got {self.hbm_budget_gb}")
        if self.hbm_budget_gb and not self.paged:
            raise ValueError(
                "serve.hbm_budget_gb caps the paged KV pool's "
                "auto-sizing; add --serve.paged")
        if self.hbm_budget_gb and self.num_pages:
            raise ValueError(
                "serve.hbm_budget_gb sizes num_pages automatically; "
                "an explicit --serve.num-pages already pins the pool "
                "— drop one of the flags")


@dataclasses.dataclass
class ResilienceConfig:
    """The JAX ``ResilienceConfig``: every field with its JAX spelling and
    default (resilience/, train/loop.py, train/checkpoint.py)."""

    # Deterministic fault-injection plan, comma-separated kind@step[:arg]
    # events (resilience/faults.py). Under mode=train: nan_grad (NaN-fill
    # that step's float batch), ckpt_io_fail (:N failures, default 1, in
    # the cadence save at that step), data_stall (:duration, default 5s,
    # slept inside the batch fetch), sigterm and sigkill (self-signal at
    # that step's dispatch, first leg only), device_loss (:N lost cards,
    # default 1: writes the device-mask file under --checkpoint-dir and
    # SIGKILLs every rank, first leg only; supervisor --elastic restarts
    # onto the survivors). Under mode=serve the step counts DECODE
    # steps and the kinds are decode_stall (:duration, slept inside the
    # decode watchdog's window), slot_nan (:slot, NaN-poisons one slot's
    # KV cache -> quarantine and re-prefill of that slot), reload (live
    # weight swap from --checkpoint-dir), sigterm and sigkill.
    fault_plan: str = ""
    # Non-finite-loss policy, checked on each retired step: "off" (train
    # on, unless --halt-on-nonfinite fires at a log), "halt" (raise; exit
    # 2), "skip_batch" (the step discards its update: params, optimizer
    # state and count, and EMA keep their values, the step counter
    # advances; the host charges the skip budget) or "rewind" (restore
    # the newest finite checkpoint in place and go on from there).
    nonfinite: str = "off"  # off | halt | skip_batch | rewind
    # Recovery budgets: spending one more halts the run.
    max_skips: int = 3
    max_rewinds: int = 1
    # Loss spikes over a rolling window: a finite loss > spike_factor x
    # the window median is a recovery record, and under nonfinite=rewind
    # a budgeted rewind. 0 = off.
    spike_window: int = 0
    spike_factor: float = 10.0
    # Watchdogs (seconds; 0 = off): the train loop's next-batch fetch
    # (data) and its wait for each retired step (sync), and the serve
    # engine's token fetch (sync). A breach raises StallError (exit 3)
    # instead of hanging.
    data_timeout_s: float = 0.0
    sync_timeout_s: float = 0.0
    # Capped-exponential-backoff retries of a checkpoint write's I/O.
    save_retries: int = 2
    save_retry_backoff_s: float = 0.05

    def validate(self) -> None:
        """The JAX ResilienceConfig's checks, with its messages."""
        if self.nonfinite not in ("off", "halt", "skip_batch",
                                  "rewind"):
            raise ValueError(
                f"unknown resilience.nonfinite {self.nonfinite!r}; "
                f"have ('off', 'halt', 'skip_batch', 'rewind')")
        if self.max_skips < 0 or self.max_rewinds < 0:
            raise ValueError(
                "resilience.max_skips/max_rewinds must be >= 0")
        if self.spike_window < 0:
            raise ValueError(
                f"resilience.spike_window must be >= 0, "
                f"got {self.spike_window}")
        if self.spike_window and self.spike_factor <= 1.0:
            raise ValueError(
                f"resilience.spike_factor must be > 1, "
                f"got {self.spike_factor}")
        if self.data_timeout_s < 0 or self.sync_timeout_s < 0:
            raise ValueError(
                "resilience timeouts must be >= 0 (0 disables)")
        if self.save_retries < 0 or self.save_retry_backoff_s < 0:
            raise ValueError(
                "resilience.save_retries/save_retry_backoff_s must "
                "be >= 0")
        if self.fault_plan:
            parse_fault_plan(self.fault_plan)  # syntax at config time


@dataclasses.dataclass
class TrainConfig:
    """One job of the port: training (mnist_cnn, resnet20, resnet50,
    bert_mlm, gpt_lm or moe_lm on one device, or on ``mesh.data`` x
    ``mesh.seq`` x ``mesh.model`` x ``mesh.expert`` devices), evaluating
    or continuing a prompt from a checkpoint (``mode="eval"``,
    ``"generate"``, gpt_lm also over ``mesh.model`` devices), or serving
    gpt_lm or moe_lm on one device, gpt_lm also tensor-parallel over
    ``serve.mesh_model`` devices (``mode="serve"``)."""

    # --- model -----------------------------------------------------------
    # mnist_cnn (the reference's CNN, the JAX default) | resnet20 |
    # resnet50 | bert_mlm | gpt_lm.
    model: str = "mnist_cnn"
    # mnist_cnn's init: "improved" (He-normal kernels, zero biases) or
    # "reference" (normal(1) for every weight and bias, as the
    # reference's tf.random_normal).
    init_scheme: str = "improved"
    # GPT-2 ladder size ("small" ... "xl") or "tiny"; empty = "small"
    # (gpt_lm); bert_mlm takes "base" (the empty default) or "tiny".
    model_size: str = ""
    dropout_rate: float = 0.25
    # bfloat16 matmuls (the flash kernels need bf16; float32 trains and
    # evaluates only with --device cpu, and serves and generates
    # anywhere); params/optimizer f32.
    compute_dtype: str = "bfloat16"
    # Share the input embedding as the LM output projection (GPT-2
    # style weight tying).
    tie_embeddings: bool = False
    # Fused head+loss: > 0 runs the head product INSIDE the loss,
    # ce_chunk vocab columns at a time with online-softmax statistics,
    # so the [B, L, V] logits are never materialized (ops/fused_ce.py).
    # 0 = the dense head. 8192 is a good first value at vocab 50257.
    ce_chunk: int = 0
    # Fused-loss formulation when ce_chunk > 0: "scan" (the chunk loop,
    # every shape) or "kernel" (the fused-CE CUDA kernels,
    # ops/fused_ce_kernel.py; kernel_supported() is the authority).
    ce_impl: str = "scan"  # scan | kernel
    # Position encoding of the LM: "learned" (additive table, GPT-2) or
    # "rope" (rotary, applied to q and k in every layer).
    pos_emb: str = "learned"  # learned | rope
    # RoPE base frequency (500000 is the Llama-3 value).
    rope_theta: float = 10000.0
    # Grouped-query attention: K/V head count (0 = n_heads, MHA; 1 =
    # MQA). Shrinks the decode cache by n_heads / n_kv_heads.
    n_kv_heads: int = 0
    # Sliding-window attention (Mistral-style): attend to the last W
    # positions only (0 = full causal). Requires mesh.seq == 1.
    attn_window: int = 0
    # MLP: "gelu" (GPT-2) or "swiglu" (gated, Llama-style).
    mlp_variant: str = "gelu"  # gelu | swiglu
    # Block normalization: "layernorm" or "rmsnorm" (scale only).
    norm: str = "layernorm"  # layernorm | rmsnorm
    # Recompute each block in the backward (torch.utils.checkpoint):
    # "full" keeps only the block inputs, "dots" also keeps the matmul
    # outputs (JAX's dots_saveable policy).
    remat: str = "none"  # none | full | dots
    # Decode-cache storage for generate and serve: "none" (the compute
    # dtype) or "int8" (per-(token, head) absmax scales; the attend
    # reads the int8 cache through exact scale-adjusted dots).
    kv_cache_quant: str = "none"  # none | int8
    # Megatron vocab-parallel input embedding over mesh.model (its rows
    # padded to a multiple of it), with vocab-sharded tied logits.
    shard_vocab: bool = False
    # --- MoE (transformer families only) ---------------------------------
    # > 0 overrides the family's expert count (moe_lm defaults to 4;
    # gpt_lm/bert_mlm default dense). Any transformer family with experts
    # trains with the MoE objective.
    moe_experts: int = 0
    # Switch-Transformer-style load-balancing coefficient.
    moe_aux_weight: float = 0.01
    # ST-MoE router z-loss coefficient (0 = off).
    moe_zloss_weight: float = 0.0
    # Experts each token routes to (1 = Switch-style, 2 = GShard-style).
    moe_top_k: int = 2
    # Per-expert buffer slack over the balanced load: each expert holds
    # ceil(capacity_factor * top_k * tokens / experts) slots of a routing
    # group, and assignments past that are dropped (a train metric).
    moe_capacity_factor: float = 1.25
    # Routing-group length: 0 routes the whole sequence as one group;
    # S' > 0 routes independent chunks of S' tokens.
    moe_group_len: int = 0
    # Token movement: "dense" (one-hot dispatch/combine einsums) or
    # "scatter" (slot index-add and gather; no one-hot tensors).
    moe_dispatch: str = "dense"

    # --- data ------------------------------------------------------------
    # The vision families: "mnist" (the idx files under data_dir, or the
    # synthetic digits with a warning when they are missing) |
    # "synthetic" | "cifar10" (the binary batches under data_dir, or the
    # synthetic twin with a warning) | "cifar10_synthetic" |
    # "imagenet_synthetic" (data/cifar.py). The LM families train on
    # their synthetic token stream whatever this says, EXCEPT "text": a
    # causal LM over the local file named by data_dir (data/lm.py).
    dataset: str = "mnist"
    data_dir: str = "/tmp/mnist-data"
    # Rows carved off the head of the MNIST train split for validation.
    validation_size: int = 5000
    # Sequence length: the data window AND the model's max_len
    # (0 = the family default, 128).
    seq_len: int = 0
    # Vocabulary of the synthetic token stream, and of the model built
    # over it when set; 0 = a 64-token stream under the size's vocab.
    synthetic_vocab: int = 0
    # dataset='text' tokenization: "byte" (vocab = the 256 byte values,
    # any file) or "bpe" (byte-level BPE trained ON the corpus with the
    # ``tokenizers`` package, cached next to the file). The model vocab
    # follows the tokenizer (data/lm.py::text_clm).
    text_tokenizer: str = "byte"  # byte | bpe
    # Target merge count for text_tokenizer='bpe' (uint16 storage caps it
    # at 65536; tiny corpora may train fewer).
    bpe_vocab_size: int = 8192
    batch_size: int = 256
    shuffle_seed: int = 0
    # "u8_native": keep images as uint8 and gather batches with the C++
    # threaded gather (data/u8.py, native/runtime.py; numpy without a
    # toolchain). The same sample stream either way.
    data_backend: str = "numpy"  # numpy | u8_native

    # --- optimization ----------------------------------------------------
    # adam (adamw when weight_decay > 0) | sgd | adafactor
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"  # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    label_smoothing: float = 0.0
    # Polyak/EMA weight averaging: eval runs on the f32 moving average of
    # the params, updated after every step with this decay. 0 = off.
    ema_decay: float = 0.0
    # > 1: split each rank's batch into this many microbatches and
    # accumulate their mean gradient before the one all-reduce and
    # update (1/A the activation memory, same math).
    grad_accum_steps: int = 1
    train_steps: int = 500

    # --- eval / logging --------------------------------------------------
    eval_every: int = 100
    eval_batch_size: int = 1000
    log_every: int = 10
    log_grad_norm: bool = False
    # Raise (exit 2) at the first log whose loss is NaN or inf, read from
    # the log's own fetch (no extra sync); exclusive with
    # --resilience.nonfinite, its per-step superset.
    halt_on_nonfinite: bool = False

    # --- checkpoint ------------------------------------------------------
    # A durable directory of step-tagged checkpoints (train/checkpoint.py,
    # the JAX package's on-disk format); empty disables checkpointing.
    checkpoint_dir: str = ""
    checkpoint_every: int = 200
    resume: bool = False
    keep_checkpoints: int = 3
    # The JAX package's background saves and its orbax backend are not
    # ported (refused unless False / "native").
    checkpoint_async: bool = False
    checkpoint_backend: str = "native"

    # --- misc ------------------------------------------------------------
    seed: int = 0
    # train | eval (restore the latest checkpoint, one validation pass)
    # | generate (restore, continue --prompt) | serve (continuous-
    # batching inference, serve/; fresh-init params without
    # --checkpoint-dir).
    mode: str = "train"

    # --- mode=generate ---------------------------------------------------
    # Text for dataset=text (its tokenizer encodes it and decodes the
    # continuation), else comma-separated token ids.
    prompt: str = ""
    max_new_tokens: int = 64
    # 0 = greedy; > 0 samples (optionally truncated by gen_top_k /
    # nucleus gen_top_p), drawn from a generator seeded by --seed.
    gen_temperature: float = 0.0
    gen_top_k: int = 0
    gen_top_p: float = 1.0
    # > 1: beam search (deterministic; excludes the sampling knobs).
    num_beams: int = 1
    # Where the run executes: "cuda" (default; fails if no GPU) or "cpu"
    # (the plain versions of the kernels; tests). Under torchrun, rank r
    # takes cuda:LOCAL_RANK.
    device: str = "cuda"

    # --- mesh / parallelism ----------------------------------------------
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    # "fsdp": every param of at least 2^14 elements with a dim the data
    # width divides (parallel/sharding.py's rule), its optimizer slots
    # and its EMA live as 1/data blocks on each data rank, gathered at
    # use; "zero1": only the slots do (the params stay whole, all-
    # gathered after the sharded update); "replicated" (default): every
    # rank holds all of them. Both compose with --mesh.model and
    # --mesh.seq (only dims TP leaves whole count).
    param_partition: str = "replicated"  # replicated | zero1 | fsdp
    # The gradient sync (parallel/overlap.py). "implicit" (default): the
    # whole gradient summed over the ranks after the backward.
    # "overlap": bucketed reduce-scatters launched as the backward
    # finishes each bucket's leaves, the update on each rank's blocks
    # against zero1's slot blocks, bucketed all-gathers of the params
    # (needs param_partition=zero1, a pure data mesh with data > 1 and
    # an elementwise optimizer). "serial": one all-reduce of the whole
    # tree, then the whole update (needs param_partition=replicated).
    # Both explicit modes take each rank's own mean loss.
    grad_sync: str = "implicit"  # implicit | serial | overlap
    # Pipeline schedule for model=pipelined_lm: "1f1b" (the hand-
    # scheduled backward interleaved with the forwards: a stage keeps at
    # most min(2 pipe, M) microbatches in flight; train/pipeline_step.py)
    # or "gpipe" (every forward, then autograd's backwards, through the
    # standard step; composes with grad_accum_steps).
    pipeline_schedule: str = "1f1b"
    # Microbatches per pipeline step (M): batch_size % M == 0 and
    # M >= mesh.pipe. More microbatches shrink the bubble.
    pipeline_microbatches: int = 4
    # 1F1B backward: "recompute" (keep each stage's input, re-run its
    # forward at the backward tick) or "stash" (keep the forward tick's
    # autograd graph until the backward tick).
    pipeline_backward: str = "recompute"
    # Interleaved (virtual-stage) layout, V > 1: each stage owns V depth
    # chunks of n_layers / (pipe V) layers (Megatron's assignment: chunk
    # v of stage s is virtual stage v pipe + s). Recompute backward only.
    pipeline_virtual_stages: int = 1
    # Local SGD (train/local_sgd.py): 1 = synchronous data parallelism;
    # H > 1 averages the replicas' params every H steps.
    param_sync_every: int = 1
    # Bucket bound (MiB) of --grad-sync overlap; None = 4 MiB (a
    # sentinel, so that any explicit value without overlap is refused).
    grad_sync_bucket_mb: Optional[float] = None
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    # Observability (observe/): the serve observatory under mode=serve.
    observe: ObserveConfig = dataclasses.field(
        default_factory=ObserveConfig)
    # Fault injection and the decode watchdog (resilience/).
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)

    def _explicit_sync_knob_conflict(self) -> Optional[str]:
        """The first training knob the explicit grad-sync step (serial or
        overlap) cannot take, as the message validate raises; None when
        it takes them all (the JAX config's own check)."""
        if self.grad_accum_steps > 1:
            return ("grad_sync != implicit has no microbatch scan; "
                    "drop grad_accum_steps or use the implicit step")
        if self.param_sync_every > 1:
            return ("grad_sync != implicit does not compose with "
                    "param_sync_every > 1 (local SGD has its own sync "
                    "protocol)")
        if self.ce_chunk:
            return ("ce_chunk's fused loss applies its own sharding "
                    "constraints, which cannot run inside the explicit "
                    "step's shard_map; drop one of the flags")
        if self.shard_vocab:
            return ("shard_vocab annotates params over the model axis; "
                    "the explicit grad-sync step needs plain pure-data "
                    "params — drop one of the flags")
        return None

    def overlap_grad_sync_conflict(self) -> Optional[str]:
        """Why grad_sync=overlap cannot run with this config's training
        knobs, or None (the JAX config's own check and messages)."""
        if self.optimizer not in ("adam", "sgd"):
            return (f"grad_sync=overlap needs an ELEMENTWISE "
                    f"optimizer (adam/sgd; adamw via "
                    f"weight_decay): a device's block must compute "
                    f"exactly the full update's slice, which "
                    f"{self.optimizer!r}'s factored statistics "
                    f"break")
        return self._explicit_sync_knob_conflict()

    def _validate_partition(self) -> None:
        """The JAX config's checks of --param-partition, --grad-sync and
        --grad-sync-bucket-mb, with its messages; then the port's two
        refusals (ROADMAP.md A5, A5c). The pipeline's and local SGD's checks
        come in JAX's order around them."""
        self._validate_pipeline_knobs()
        if self.param_partition not in ("replicated", "zero1", "fsdp"):
            raise ValueError(
                f"unknown param_partition {self.param_partition!r}")
        if (self.param_partition == "fsdp"
                and self.model == "pipelined_lm"):
            raise ValueError(
                "param_partition=fsdp does not compose with "
                "model=pipelined_lm (stage params are shard_map-"
                "managed); use param_partition=zero1 for optimizer-"
                "slot memory, mesh.pipe/mesh.model for param memory")
        if self.grad_sync not in ("implicit", "serial", "overlap"):
            raise ValueError(
                f"unknown grad_sync {self.grad_sync!r}; have "
                f"('implicit', 'serial', 'overlap')")
        if self.grad_sync_bucket_mb is not None:
            if self.grad_sync_bucket_mb <= 0:
                raise ValueError(
                    f"grad_sync_bucket_mb must be > 0, "
                    f"got {self.grad_sync_bucket_mb}")
            if self.grad_sync != "overlap":
                raise ValueError(
                    "grad_sync_bucket_mb sizes the overlap path's "
                    "collective buckets; it has no effect without "
                    "--grad-sync overlap — drop the flag")
        if self.grad_sync != "implicit":
            if self.mode != "train":
                raise ValueError(
                    f"grad_sync={self.grad_sync!r} shapes the TRAIN "
                    f"step's gradient sync; it has no effect under "
                    f"mode={self.mode!r} — drop the flag")
            if self.model == "pipelined_lm":
                raise ValueError(
                    "grad_sync applies to the standard jitted step; "
                    "the hand-scheduled pipeline step owns its own "
                    "collective schedule (use mesh.pipe for that "
                    "family)")
            bad = [a for a in ("model", "seq", "pipe", "expert")
                   if getattr(self.mesh, a) > 1]
            if bad:
                raise ValueError(
                    f"grad_sync={self.grad_sync!r} needs a pure "
                    f"data-parallel mesh; axes {bad} > 1")
            if self.mesh.data == 1:
                raise ValueError(
                    "grad_sync with mesh.data=1 has nothing to "
                    "synchronize; use the implicit step")
            if self.grad_sync == "overlap":
                if self.param_partition != "zero1":
                    raise ValueError(
                        "grad_sync=overlap IS weight-update sharding: "
                        "the per-bucket update runs against zero1's "
                        "sharded optimizer slots — add "
                        "--param-partition zero1")
            elif self.param_partition != "replicated":
                raise ValueError(
                    "grad_sync=serial replicates the full-tree update "
                    "on every device; it requires "
                    "param_partition=replicated (overlap is the mode "
                    "that composes with zero1)")
            conflict = (self.overlap_grad_sync_conflict()
                        if self.grad_sync == "overlap"
                        else self._explicit_sync_knob_conflict())
            if conflict:
                raise ValueError(conflict)
        self._validate_microbatches()
        self._validate_local_sgd()
        if self.param_partition != "replicated":
            if self.mode == "serve":
                raise NotImplementedError(
                    f"--param-partition {self.param_partition} under "
                    f"--mode serve (the engine serves one process's "
                    f"whole params) is not ported to PyTorch yet (see "
                    f"ROADMAP.md A5)")
            if self.optimizer == "adafactor":
                raise NotImplementedError(
                    f"--optimizer adafactor with --param-partition "
                    f"{self.param_partition} (its factored statistics "
                    f"over a 1/data block are not the whole leaf's) is "
                    f"not ported to PyTorch yet (see ROADMAP.md A5c)")

    def _validate_pipeline_knobs(self) -> None:
        """The JAX config's checks of the pipeline schedule and backward,
        with its messages."""
        if self.pipeline_schedule not in PIPELINE_SCHEDULES:
            raise ValueError(
                f"unknown pipeline_schedule {self.pipeline_schedule!r}")
        if self.pipeline_backward not in ("recompute", "stash"):
            raise ValueError(
                f"unknown pipeline_backward {self.pipeline_backward!r}")
        if (self.pipeline_backward != "recompute"
                and not (self.model == "pipelined_lm"
                         and self.pipeline_schedule == "1f1b")):
            raise ValueError(
                "pipeline_backward applies only to model=pipelined_lm "
                "with pipeline_schedule=1f1b")
        if (self.model == "pipelined_lm"
                and self.pipeline_schedule == "1f1b"
                and self.grad_accum_steps > 1):
            raise ValueError(
                "pipeline_schedule=1f1b already accumulates per-"
                "microbatch gradients; raise pipeline_microbatches "
                "instead of grad_accum_steps")

    def _validate_microbatches(self) -> None:
        """The JAX config's checks of the microbatch count and the
        virtual stages, with its messages."""
        if self.pipeline_microbatches < 1:
            raise ValueError(
                f"pipeline_microbatches must be >= 1, "
                f"got {self.pipeline_microbatches}")
        if self.pipeline_virtual_stages < 1:
            raise ValueError(
                f"pipeline_virtual_stages must be >= 1, "
                f"got {self.pipeline_virtual_stages}")
        if self.pipeline_virtual_stages > 1:
            if self.model != "pipelined_lm":
                raise ValueError(
                    "pipeline_virtual_stages > 1 applies only to "
                    "model=pipelined_lm")
            if self.pipeline_backward != "recompute":
                raise ValueError(
                    "pipeline_virtual_stages > 1 supports "
                    "pipeline_backward='recompute' only (the stash "
                    "variant's per-chunk residual treedefs are a "
                    "follow-up; parallel.pipeline."
                    "interleaved_pipeline_value_and_grad)")
            if (self.pipeline_schedule == "1f1b"
                    and self.pipeline_microbatches
                    < self.mesh.pipe * self.pipeline_virtual_stages):
                raise ValueError(
                    f"pipeline_microbatches "
                    f"{self.pipeline_microbatches} < mesh.pipe x "
                    f"virtual stages ({self.mesh.pipe} x "
                    f"{self.pipeline_virtual_stages}): every virtual "
                    f"stage needs a microbatch in flight")
        if (self.model == "pipelined_lm"
                and self.batch_size % self.pipeline_microbatches):
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"pipeline_microbatches {self.pipeline_microbatches}")
        if (self.model == "pipelined_lm"
                and self.pipeline_microbatches < self.mesh.pipe):
            raise ValueError(
                f"pipeline_microbatches {self.pipeline_microbatches} "
                f"< mesh.pipe {self.mesh.pipe}: every stage needs at "
                f"least one microbatch in flight")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(
                f"label_smoothing must be in [0, 1), "
                f"got {self.label_smoothing}")

    def _validate_local_sgd(self) -> None:
        """The JAX config's checks of param_sync_every, with its
        messages."""
        if self.param_sync_every < 1:
            raise ValueError(
                f"param_sync_every must be >= 1, "
                f"got {self.param_sync_every}")
        if self.param_sync_every == 1:
            return
        bad = [a for a in ("model", "seq", "pipe", "expert")
               if getattr(self.mesh, a) > 1]
        if bad:
            raise ValueError(
                "param_sync_every > 1 (local SGD) needs a pure "
                f"data-parallel mesh; axes {bad} > 1")
        if self.param_partition != "replicated":
            raise ValueError(
                "param_sync_every > 1 needs "
                "param_partition=replicated (each replica owns "
                "its full diverged copy)")
        if self.grad_accum_steps > 1:
            raise ValueError(
                "param_sync_every > 1 does not compose with "
                "grad_accum_steps; raise batch_size instead")
        if self.ema_decay:
            raise ValueError(
                "param_sync_every > 1 does not compose with "
                "ema_decay (average-of-averages ambiguity)")
        from tensorflow_distributed_tpu_torch.models import (
            MUTABLE_EXTRA_MODELS)
        if self.model in MUTABLE_EXTRA_MODELS:
            raise ValueError(
                "param_sync_every > 1 needs models without "
                "mutable extra state (BN statistics diverge "
                "with no principled average); "
                f"{self.model} carries them")
        if self.model == "pipelined_lm":
            raise ValueError(
                "param_sync_every > 1 is a pure-DP mode; "
                "pipelined_lm is not supported")
        if self.resilience.nonfinite == "skip_batch":
            raise ValueError(
                "resilience.nonfinite=skip_batch does not compose "
                "with param_sync_every > 1 (the local-SGD step has "
                "no skip path); use nonfinite=rewind or halt")

    def _validate_pipe(self) -> None:
        """The JAX config's pipelined_lm checks of the other knobs, with
        its messages (the expert axis's naming ROADMAP.md A5a, where it
        stays)."""
        pipelined = self.model == "pipelined_lm"
        if self.shard_vocab and pipelined:
            raise ValueError(
                "shard_vocab is not available for pipelined_lm (the "
                "embedding shell carries no TP metadata; use mesh.pipe "
                "for memory)")
        if self.ce_impl == "kernel" and pipelined:
            raise ValueError(
                "ce_impl='kernel' is not available for pipelined_lm "
                "(the 1F1B schedule drives the fused loss through its "
                "own vjp at the last stage — the scan formulation "
                "composes there; the Mosaic kernel's shard_map wrap "
                "does not). Use the default ce_impl='scan'")
        if (self.resilience.nonfinite == "skip_batch" and pipelined
                and self.pipeline_schedule == "1f1b"):
            raise ValueError(
                "resilience.nonfinite=skip_batch is implemented in "
                "the standard jitted step (the update is discarded "
                "on device); the hand-scheduled 1F1B step has no "
                "skip path — use nonfinite=rewind or halt")
        if self.mesh.pipe > 1 and not pipelined:
            raise NotImplementedError(
                f"--mesh.pipe {self.mesh.pipe} for model={self.model!r} "
                f"(only pipelined_lm cuts its blocks into stages) is not "
                f"ported to PyTorch yet (see ROADMAP.md A5)")
        if not pipelined:
            return
        if self.mesh.expert != 1:
            raise ValueError(
                "pipelined variant: mesh expert must be 1 — the "
                "stacked-leaf TP name table (_TP_SUFFIX) pins expert "
                "weights to the \"model\" axis; use mesh.model for EP "
                "with the pipeline (JAX refuses it too; ROADMAP.md A5a)")

    def validate(self) -> None:
        def todo(what: str) -> NotImplementedError:
            return NotImplementedError(
                f"{what} is not ported to PyTorch yet (see ROADMAP.md "
                f"queue A)")

        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; have {MODES}")
        self._validate_partition()
        serving = self.mode == "serve"
        if serving and self.model not in CAUSAL_LM_MODELS:
            raise ValueError(
                f"mode=serve needs a causal LM with the decode cache "
                f"({', '.join(CAUSAL_LM_MODELS)}), got {self.model!r}")
        if serving and (self.mesh.model > 1 or self.mesh.pipe > 1
                        or self.mesh.expert > 1):
            raise ValueError(
                "mode=serve requires a pure data --mesh.* (model/"
                "seq/pipe/expert == 1): the serve engine builds "
                "its OWN tensor-parallel mesh — use "
                "--serve.mesh-model N to shard the replica")
        if serving and (self.mesh.seq != 1 or self.mesh.data not in (-1, 1)):
            raise NotImplementedError(
                "--mode serve over a --mesh.* of more than one process is "
                "not ported to PyTorch yet (see ROADMAP.md A6); "
                "--serve.mesh-model N serves one replica over N cards")
        if self.serve.mesh_model > 1 and not serving:
            raise ValueError(
                "serve.mesh_model shards the mode=serve engine's "
                "mesh; drop the flag or add --mode serve")
        moe = self.moe_experts > 0 or self.model == "moe_lm"
        if serving and self.serve.mesh_model > 1 and moe:
            raise NotImplementedError(
                "MoE under --serve.mesh-model (routing under TP's partial "
                "sums tips near-ties; it needs its own gates) is not "
                "ported to PyTorch yet (see ROADMAP.md A6)")
        self._validate_fire()
        if self.checkpoint_backend not in ("native", "orbax"):
            raise ValueError(f"unknown checkpoint_backend "
                             f"{self.checkpoint_backend!r}")
        if self.checkpoint_backend != "native":
            raise todo("--checkpoint-backend orbax (a JAX library)")
        if self.checkpoint_async:
            raise todo("--checkpoint-async (background saves)")
        if self.checkpoint_every < 0 or self.keep_checkpoints < 1:
            raise ValueError(
                f"checkpoint_every must be >= 0 and keep_checkpoints >= 1, "
                f"got {self.checkpoint_every} and {self.keep_checkpoints}")
        if self.resume and not self.checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        if self.mode == "eval" and not self.checkpoint_dir:
            raise ValueError("mode=eval requires checkpoint_dir")
        if self.mode == "generate":
            if self.model not in CAUSAL_LM_MODELS:
                raise ValueError(
                    f"mode=generate needs a causal LM with the decode "
                    f"cache ({', '.join(CAUSAL_LM_MODELS)}), got "
                    f"{self.model!r}")
            if not self.checkpoint_dir:
                raise ValueError("mode=generate requires checkpoint_dir")
            if not self.prompt:
                raise ValueError(
                    "mode=generate requires --prompt (text for "
                    "dataset=text, else comma-separated token ids)")
            if self.mesh.seq != 1:
                raise ValueError(
                    "mode=generate requires mesh.seq == 1 (single-"
                    "token decode steps can't be seq-sharded)")
            if moe and (self.mesh.model != 1 or self.mesh.expert != 1):
                raise NotImplementedError(
                    "--mode generate of a MoE model over --mesh.model or "
                    "--mesh.expert > 1 (routing under TP's partial sums "
                    "tips near-ties; it needs its own gates) is not "
                    "ported to PyTorch yet (see ROADMAP.md A6)")
            if self.num_beams > 1 and (
                    self.gen_temperature > 0 or self.gen_top_k
                    or self.gen_top_p != 1.0):
                raise ValueError(
                    "num_beams > 1 is deterministic beam search; it "
                    "excludes the sampling knobs (gen_temperature / "
                    "gen_top_k / gen_top_p) — pick one")
        if self.gen_temperature < 0:
            raise ValueError(
                f"gen_temperature must be >= 0, got "
                f"{self.gen_temperature} (negative would sample the "
                f"inverted distribution)")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.num_beams < 1:
            raise ValueError(
                f"num_beams must be >= 1, got {self.num_beams}")
        if self.model not in LM_MODELS + VISION_MODELS:
            raise todo(f"--model {self.model}")
        if self.dataset not in DATASETS:
            raise todo(f"--dataset {self.dataset}")
        if self.data_backend not in DATA_BACKENDS:
            raise ValueError(f"unknown data_backend {self.data_backend!r}")
        if self.text_tokenizer not in TEXT_TOKENIZERS:
            raise ValueError(
                f"unknown text_tokenizer {self.text_tokenizer!r}")
        if self.text_tokenizer == "bpe" and not (
                2 <= self.bpe_vocab_size <= 65536):
            raise ValueError(
                f"bpe_vocab_size must be in [2, 65536], "
                f"got {self.bpe_vocab_size}")
        if self.init_scheme not in INIT_SCHEMES:
            raise ValueError(f"unknown init_scheme {self.init_scheme!r}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; have "
                             f"{OPTIMIZERS}")
        if self.model_size not in MODEL_SIZES:
            raise ValueError(f"model_size {self.model_size!r}; have "
                             f"{MODEL_SIZES}")
        if self.lr_schedule not in SCHEDULES:
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}; have "
                             f"{COMPUTE_DTYPES}")
        if self.device != "cpu" and not self.device.startswith("cuda"):
            raise ValueError(f"device {self.device!r}; have cpu | cuda[:N]")
        lm = self.model in LM_MODELS
        inference = self.mode in ("serve", "generate")  # no B1-B9 runs
        if (lm and not inference and self.device != "cpu"
                and self.compute_dtype != "bfloat16"):
            raise todo(f"--compute-dtype {self.compute_dtype} on a GPU (the "
                       f"flash kernels take bfloat16)")
        for name in ("batch_size", "eval_batch_size"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        for name in ("train_steps", "eval_every", "log_every", "seq_len",
                     "synthetic_vocab", "warmup_steps", "validation_size"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError("dropout_rate must be in [0, 1)")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")
        if self.batch_size % self.grad_accum_steps:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"grad_accum_steps {self.grad_accum_steps}")
        for name in ("seq_len", "synthetic_vocab"):
            if getattr(self, name) and not lm:
                raise ValueError(
                    f"{name} has no effect on model={self.model!r} (LM "
                    f"families only); drop the flag")
        if self.synthetic_vocab and self.dataset == "text":
            raise ValueError(
                "synthetic_vocab has no effect with dataset='text' "
                "(the byte corpus pins vocab to 256); drop the flag")
        if self.ce_chunk < 0:
            raise ValueError(
                f"ce_chunk must be >= 0, got {self.ce_chunk}")
        if self.ce_chunk and not lm:
            raise ValueError(
                f"ce_chunk has no effect on model={self.model!r} (the "
                f"fused head+loss exists for the LM families' 50k-row "
                f"vocabs); drop the flag")
        if self.shard_vocab and not lm:
            raise ValueError(
                f"shard_vocab has no effect on model={self.model!r} "
                f"(transformer families only); drop the flag")
        if self.ce_impl == "kernel" and self.shard_vocab:
            raise ValueError(
                "ce_impl='kernel' does not compose with shard_vocab "
                "(the Mosaic kernel wants the whole head per device); "
                "the default ce_impl='scan' runs the vocab-parallel "
                "form instead")
        if self.ce_impl not in CE_IMPLS:
            raise ValueError(
                f"unknown ce_impl {self.ce_impl!r}; have {CE_IMPLS}")
        if self.ce_impl != "scan" and not self.ce_chunk:
            raise ValueError(
                "ce_impl has no effect without ce_chunk > 0 (the fused "
                "head+loss master switch); add --ce-chunk")
        if self.ce_impl == "kernel" and self.mesh.model > 1:
            raise ValueError(
                "ce_impl='kernel' requires mesh.model == 1 (the "
                "Mosaic kernel wants the whole head per device); the "
                "default ce_impl='scan' runs the Megatron vocab-"
                "parallel form over the model axis instead")
        for axis in ("model", "expert"):
            size = getattr(self.mesh, axis)
            if size > 1 and not lm:
                raise todo(f"--mesh.{axis} {size} for model={self.model!r} "
                           f"(tensor and expert parallelism shard the "
                           f"transformer families, {', '.join(LM_MODELS)})")
            if size > 1 and self.optimizer == "adafactor":
                raise NotImplementedError(
                    f"--optimizer adafactor with --mesh.{axis} > 1 (its "
                    f"block RMS over a sharded leaf needs a sum over the "
                    f"group) is not ported to PyTorch yet (see ROADMAP.md "
                    f"A5c)")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {self.remat!r}")
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}")
        if self.attn_window:
            if self.model not in WINDOW_MODELS:
                raise ValueError(
                    "attn_window needs a causal LM family "
                    "(gpt_lm | moe_lm | pipelined_lm)")
            if self.mesh.seq > 1:
                raise ValueError(
                    "attn_window with mesh.seq > 1 is not "
                    "implemented; at W << L the window replaces "
                    "ring attention — use mesh.seq == 1")
        if self.pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {self.pos_emb!r}")
        if self.rope_theta <= 0:
            raise ValueError(
                f"rope_theta must be > 0, got {self.rope_theta}")
        if self.rope_theta != 10000.0 and self.pos_emb != "rope":
            raise ValueError(
                "rope_theta has no effect without pos_emb=rope; "
                "drop the flag or add --pos-emb rope")
        if self.n_kv_heads < 0:
            raise ValueError(
                f"n_kv_heads must be >= 0, got {self.n_kv_heads}")
        if self.mlp_variant not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp_variant {self.mlp_variant!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.kv_cache_quant not in ("none", "int8"):
            raise ValueError(
                f"unknown kv_cache_quant {self.kv_cache_quant!r}")
        if self.resilience.nonfinite == "rewind" and not self.checkpoint_dir:
            raise ValueError(
                "resilience.nonfinite=rewind restores the newest "
                "verifiable checkpoint in-process; it requires "
                "checkpoint_dir")
        if self.halt_on_nonfinite and self.resilience.nonfinite != "off":
            raise ValueError(
                "halt_on_nonfinite=true and resilience.nonfinite are "
                "two handlers for the same event — drop "
                "halt_on_nonfinite (resilience.nonfinite=halt is its "
                "per-step superset)")
        self._validate_moe()
        self._validate_pipe()
        self.mesh.validate()
        self.observe.validate()
        armed = self.observe.armed()
        if self.mode != "serve" and armed:
            raise FlagNotPorted(
                f"--observe.{armed[0].replace('_', '-')} under --mode "
                f"{self.mode} (the training observatory) is not ported to "
                f"PyTorch yet (see ROADMAP.md A8)")
        self.resilience.validate()
        self.serve.validate()

    def _validate_moe(self) -> None:
        """The JAX TrainConfig's MoE checks, with its messages; then the
        port's refusals of what this slice leaves out (ROADMAP.md A5)."""
        if self.moe_experts < 0:
            raise ValueError(
                f"moe_experts must be >= 0, got {self.moe_experts}")
        if self.moe_experts > 0 and self.model not in LM_MODELS:
            raise ValueError(
                f"moe_experts > 0 needs a transformer family, "
                f"got model={self.model!r}")
        if self.moe_aux_weight < 0 or self.moe_zloss_weight < 0:
            raise ValueError("moe_aux_weight/moe_zloss_weight must be >= 0")
        if self.moe_top_k < 1:
            raise ValueError(f"moe_top_k must be >= 1, got {self.moe_top_k}")
        if 0 < self.moe_experts < self.moe_top_k:
            raise ValueError(
                f"moe_top_k {self.moe_top_k} > moe_experts "
                f"{self.moe_experts}")
        if self.moe_capacity_factor <= 0:
            raise ValueError(
                f"moe_capacity_factor must be > 0, "
                f"got {self.moe_capacity_factor}")
        if self.moe_dispatch not in ("dense", "scatter"):
            raise ValueError(
                f"unknown moe_dispatch {self.moe_dispatch!r}")
        if self.moe_group_len < 0:
            raise ValueError(
                f"moe_group_len must be >= 0, got {self.moe_group_len}")
        if (self.moe_group_len and self.seq_len > self.moe_group_len
                and self.seq_len % self.moe_group_len):
            raise ValueError(
                f"seq_len {self.seq_len} not divisible by "
                f"moe_group_len {self.moe_group_len}")
        moe = self.moe_experts > 0 or self.model == "moe_lm"
        if self.mlp_variant != "gelu" and moe:
            raise ValueError(
                "mlp_variant has no effect with MoE (the block's MLP is "
                "replaced by MoeMlp, whose experts are gelu); drop the "
                "flag or use a dense family")
        if not moe:
            return
        if self.mesh.seq > 1:
            raise NotImplementedError(
                "MoE with --mesh.seq > 1 (the expert positions' cumsum "
                "runs over the whole sequence in order, across the ring's "
                "zigzag blocks) is not ported to PyTorch yet (see "
                "ROADMAP.md A5)")
        if self.param_partition != "replicated":
            raise NotImplementedError(
                f"MoE with --param-partition {self.param_partition} is "
                f"not ported to PyTorch yet (see ROADMAP.md A5)")
        if self.grad_sync != "implicit":
            raise NotImplementedError(
                f"MoE with --grad-sync {self.grad_sync} (the router's "
                f"load balance is over the global batch, the explicit "
                f"step's loss is each rank's own) is not ported to "
                f"PyTorch yet (see ROADMAP.md A5)")

    def _validate_fire(self) -> None:
        """The JAX TrainConfig's phase checks of the fault plan and the
        journal, with its messages."""
        res = self.resilience
        if res.fault_plan:
            # A fault keyed to a phase that never consults it would sit
            # silently unfired: reject it at startup.
            kinds = parse_fault_plan(res.fault_plan).kinds()
            if self.mode == "serve":
                bad = sorted(kinds - set(SERVE_KINDS))
                if bad:
                    raise ValueError(
                        f"fault kinds {bad} are train-phase only; "
                        f"mode=serve consults {sorted(SERVE_KINDS)} "
                        f"on the decode-step clock")
                if "reload" in kinds and not self.checkpoint_dir:
                    raise ValueError(
                        "fault kind 'reload' performs a live weight "
                        "swap from --checkpoint-dir; set one (serve "
                        "needs a swap source)")
            elif self.mode == "train":
                bad = sorted(kinds - set(TRAIN_KINDS))
                if bad:
                    raise ValueError(
                        f"fault kinds {bad} are serve-phase only; "
                        f"mode=train consults {sorted(TRAIN_KINDS)} "
                        f"on the train-step clock")
                if "device_loss" in kinds and not self.checkpoint_dir:
                    raise ValueError(
                        "fault kind 'device_loss' writes the device-"
                        "mask file under --checkpoint-dir (and the "
                        "elastic restart resumes from there); set "
                        "one")
            else:
                raise ValueError(
                    f"resilience.fault_plan has no injection points "
                    f"under mode={self.mode!r}; drop the flag")
        if self.serve.journal and self.mode != "serve":
            raise ValueError(
                "serve.journal is written by the mode=serve "
                "scheduler; drop the flag")
        self._validate_observe()

    def _validate_observe(self) -> None:
        """The JAX TrainConfig's checks of the fleet inbox and of the
        serve observatory's flags against the mode, with its messages;
        the refusal of any observe flag outside mode=serve (the training
        observatory is not ported yet) follows ObserveConfig's own
        checks, as JAX's order has them."""
        if self.serve.inbox:
            if self.mode != "serve":
                raise ValueError(
                    "serve.inbox is the mode=serve fleet-replica "
                    "intake; drop the flag or add --mode serve")
            if not self.seq_len:
                raise ValueError(
                    "serve.inbox has no workload to auto-size the "
                    "cache from — set an explicit --seq-len (the "
                    "fleet's per-request bound)")
        obs = self.observe
        if self.mode != "serve":
            if obs.slo:
                raise ValueError(
                    "observe.slo declares SERVING latency targets "
                    "(mode=serve's live burn-rate monitor); drop the "
                    "flag or add --mode serve")
            if obs.export_every or obs.export_path:
                raise ValueError(
                    "observe.export_every/export_path dump the "
                    "mode=serve scheduler's rolling-metrics "
                    "snapshots; drop the flags or add --mode serve")
            if obs.slo_status_every:
                raise ValueError(
                    "observe.slo_status_every prints the mode=serve "
                    "scheduler's live status line; drop the flag or "
                    "add --mode serve")
        elif obs.slo:
            for tgt in parse_slo(obs.slo):
                if tgt.cls and tgt.cls not in SLO_CLASSES:
                    raise ValueError(
                        f"observe.slo names unknown class "
                        f"{tgt.cls!r}; have {SLO_CLASSES} (or no "
                        f"prefix for all requests)")


def _add_dataclass_args(parser: argparse.ArgumentParser, cls,
                        prefix: str = "") -> None:
    """One ``--flag`` per dataclass field (underscores become dashes; a
    nested dataclass field ``mesh`` gives ``--mesh.seq``), typed from
    the field's default — the JAX config's helper."""
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        ftype = hints.get(f.name, str)
        if dataclasses.is_dataclass(ftype):
            _add_dataclass_args(parser, ftype, prefix=f"{f.name}.")
            continue
        name = f"--{prefix}{f.name}".replace("_", "-")
        default = f.default
        if ftype is bool or isinstance(default, bool):
            parser.add_argument(
                name, default=default,
                type=lambda s: s.lower() in ("1", "true", "yes"))
        elif default is None:
            parser.add_argument(name, type=float, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


def parse_args(argv: Optional[Sequence[str]] = None) -> TrainConfig:
    """Build a TrainConfig from CLI args. A flag the port does not parse
    (any other flag of the JAX CLI) exits with an error naming
    ROADMAP.md."""
    parser = argparse.ArgumentParser(
        prog="tensorflow_distributed_tpu_torch",
        description="PyTorch/CUDA port of tensorflow_distributed_tpu "
        "(the reference's MNIST CNN, ResNet-20/50, BERT masked LM or a GPT "
        "causal LM, dense or mixture-of-experts, on one GPU or on "
        "--mesh.data x --mesh.seq x --mesh.model x --mesh.expert GPUs "
        "under torchrun; --mode serve runs a GPT's continuous-batching "
        "inference on one GPU, or over N with --serve.mesh-model N)",
        allow_abbrev=False)
    _add_dataclass_args(parser, TrainConfig)
    ns, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"not ported to PyTorch yet: {' '.join(unknown)} "
                     f"(see ROADMAP.md queue A)")
    fields = vars(ns)

    def nested(prefix):
        return {k.split(".", 1)[1]: fields.pop(k) for k in list(fields)
                if k.startswith(prefix + ".")}

    cfg = TrainConfig(mesh=MeshConfig(**nested("mesh")),
                      serve=ServeConfig(**nested("serve")),
                      observe=ObserveConfig(**nested("observe")),
                      resilience=ResilienceConfig(**nested("resilience")),
                      **fields)
    try:
        cfg.validate()
    except FlagNotPorted as e:
        parser.error(str(e))
    return cfg


@functools.lru_cache(maxsize=None)
def known_flags() -> frozenset:
    """Every ``--flag`` spelling the CLI parses: the flag namespace of
    the parent-to-child argv protocol (the supervisor spells its child's
    flags through :func:`child_flag`)."""
    parser = argparse.ArgumentParser(add_help=False)
    _add_dataclass_args(parser, TrainConfig)
    return frozenset(parser._option_string_actions)


def child_flag(path: str) -> str:
    """The child-argv spelling of a config field: a dotted dataclass path
    in, ``--flag`` out (``"mesh.data"`` -> ``"--mesh.data"``,
    ``"checkpoint_dir"`` -> ``"--checkpoint-dir"``). Raises KeyError for
    a field the CLI does not parse, so a misspelt flag fails where the
    parent builds it, not as a child's crash loop (JAX's)."""
    flag = "--" + path.replace("_", "-")
    if flag not in known_flags():
        raise KeyError(
            f"{flag!r} (from {path!r}) is not parsed by config.py")
    return flag

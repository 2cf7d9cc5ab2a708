"""Run configuration of the PyTorch port: the subset of the JAX
package's ``TrainConfig`` (and its ``MeshConfig`` and ``ServeConfig``)
that the port runs, with the same flag spellings, plus ``--device``.

The port keeps its own copy of the JAX ``config.py`` dataclass-to-argparse
helper. Flags of the JAX CLI that the port does not parse yet are
rejected with an error that points at ROADMAP.md, never ignored.

Every field shared with the JAX ``TrainConfig``, ``MeshConfig`` and
``ServeConfig`` has the JAX default, ``model`` included: the bare CLI
call trains the reference's ``mnist_cnn`` on the MNIST idx files under
``--data-dir``. Every ``--serve.*`` flag of the JAX CLI parses; those of
the layers not ported yet are refused unless they keep their default.
The model options of layers not ported yet (``--kv-cache-quant``,
``--moe-experts``, ``--shard-vocab``) parse and are refused the same way,
as is ``--compute-dtype float32`` for training or evaluating the LM on a
GPU (the kernels take bf16).
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import Optional, Sequence

from tensorflow_distributed_tpu_torch.serve.buckets import parse_buckets

SCHEDULES = ("constant", "cosine", "warmup_cosine")
OPTIMIZERS = ("adam", "sgd", "adafactor")
COMPUTE_DTYPES = ("bfloat16", "float32")
CE_IMPLS = ("scan", "kernel")
MODEL_SIZES = ("", "small", "medium", "large", "xl", "tiny")
LM_MODELS = ("gpt_lm",)
VISION_MODELS = ("mnist_cnn",)
DATASETS = ("mnist", "synthetic")
INIT_SCHEMES = ("improved", "reference")
MODES = ("train", "eval", "generate", "serve")
SERVE_TRACES = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass
class MeshConfig:
    """Logical device-mesh shape, one process (one GPU) per position:
    the JAX ``MeshConfig``'s ``data`` axis (data parallelism, the
    reference's worker replicas; -1 = every process that ``seq`` leaves
    over) and ``seq`` axis (sequence parallelism, ring attention over
    ``seq`` processes). The model, pipe and expert axes are not ported
    yet (their flags are refused; see ROADMAP.md queue A)."""

    data: int = -1
    seq: int = 1

    def validate(self) -> None:
        if self.seq < 1:
            raise ValueError(f"mesh.seq must be >= 1, got {self.seq}")
        if self.data == 0 or self.data < -1:
            raise ValueError(f"mesh.data must be -1 or >= 1, got {self.data}")


@dataclasses.dataclass
class ServeConfig:
    """``--mode serve``'s knobs: the JAX ``ServeConfig``, every field with
    its JAX spelling and default. The port runs the dense slot engine
    under the FIFO scheduler; the other fields belong to layers not
    ported yet (``_SERVE_NOT_PORTED``) and must keep their defaults."""

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
    # Admission order: "fifo" (arrival order; the port's one policy)
    # or "slo" (not ported yet).
    policy: str = "fifo"
    # --- layers not ported yet (ROADMAP.md queue A) -----------------
    journal: str = ""
    slot_retries: int = 2
    spec_tokens: int = 0
    draft_config: str = ""
    spec_kgram: int = 3
    kv_dtype: str = "bf16"
    paged: bool = False
    page_size: int = 16
    num_pages: int = 0
    radix: bool = True
    session_turns: int = 1
    tenant_quota: int = 0
    preempt: bool = True
    slo_mix: str = ""
    tenants: int = 1
    mesh_model: int = 1
    inbox: str = ""
    hbm_budget_gb: float = 0.0

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
        if self.policy not in ("fifo", "slo"):
            raise ValueError(f"unknown serve.policy {self.policy!r}; have "
                             f"('fifo', 'slo')")
        unported = [name for name, default in _SERVE_NOT_PORTED.items()
                    if getattr(self, name) != default]
        if self.policy != "fifo":
            unported.insert(0, "policy")
        if unported:
            raise NotImplementedError(
                f"--serve.{unported[0].replace('_', '-')}="
                f"{getattr(self, unported[0])!r} is not ported to PyTorch "
                f"yet (see ROADMAP.md queue A)")


# The serve knobs of layers not ported yet (the slo policy and quotas,
# preemption, speculation, int8 and paged caches, slot retry, the
# journal, tensor parallelism, the fleet inbox), at their defaults.
_SERVE_NOT_PORTED = {
    f.name: f.default for f in dataclasses.fields(ServeConfig)
    if f.name in ("journal", "slot_retries", "spec_tokens", "draft_config",
                  "spec_kgram", "kv_dtype", "paged", "page_size",
                  "num_pages", "radix", "session_turns", "tenant_quota",
                  "preempt", "slo_mix", "tenants", "mesh_model", "inbox",
                  "hbm_budget_gb")}


@dataclasses.dataclass
class TrainConfig:
    """One job of the port: training (mnist_cnn or gpt_lm on one device,
    or on ``mesh.data`` x ``mesh.seq`` devices), evaluating or continuing
    a prompt from a checkpoint (``mode="eval"``, ``"generate"``), or
    serving gpt_lm on one device (``mode="serve"``)."""

    # --- model -----------------------------------------------------------
    # mnist_cnn (the reference's CNN, the JAX default) | gpt_lm.
    model: str = "mnist_cnn"
    # mnist_cnn's init: "improved" (He-normal kernels, zero biases) or
    # "reference" (normal(1) for every weight and bias, as the
    # reference's tf.random_normal).
    init_scheme: str = "improved"
    # GPT-2 ladder size ("small" ... "xl") or "tiny"; empty = "small".
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
    # --- model options of layers not ported yet (ROADMAP.md queue A) ---
    kv_cache_quant: str = "none"
    moe_experts: int = 0
    shard_vocab: bool = False

    # --- data ------------------------------------------------------------
    # mnist_cnn: "mnist" (the idx files under data_dir, or the synthetic
    # digits with a warning when they are missing) | "synthetic". The LM
    # trains on its synthetic token stream whatever this says.
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
    batch_size: int = 256
    shuffle_seed: int = 0

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
    # Comma-separated token ids (the port has no text tokenizer yet).
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
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)

    def validate(self) -> None:
        def todo(what: str) -> NotImplementedError:
            return NotImplementedError(
                f"{what} is not ported to PyTorch yet (see ROADMAP.md "
                f"queue A)")

        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; have {MODES}")
        serving = self.mode == "serve"
        if serving and self.model not in LM_MODELS:
            raise ValueError(
                f"mode=serve needs a causal LM with the decode cache "
                f"({', '.join(LM_MODELS)}), got {self.model!r}")
        if serving and (self.mesh.seq != 1 or self.mesh.data not in (-1, 1)):
            raise todo("--mode serve over a --mesh.* of more than one "
                       "process")
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
            if self.model not in LM_MODELS:
                raise ValueError(
                    f"mode=generate needs a causal LM with the decode "
                    f"cache ({', '.join(LM_MODELS)}), got {self.model!r}")
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
        if self.ce_chunk < 0:
            raise ValueError(
                f"ce_chunk must be >= 0, got {self.ce_chunk}")
        if self.ce_chunk and not lm:
            raise ValueError(
                f"ce_chunk has no effect on model={self.model!r} (the "
                f"fused head+loss exists for the LM families' 50k-row "
                f"vocabs); drop the flag")
        if self.ce_impl not in CE_IMPLS:
            raise ValueError(
                f"unknown ce_impl {self.ce_impl!r}; have {CE_IMPLS}")
        if self.ce_impl != "scan" and not self.ce_chunk:
            raise ValueError(
                "ce_impl has no effect without ce_chunk > 0 (the fused "
                "head+loss master switch); add --ce-chunk")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {self.remat!r}")
        if self.attn_window < 0:
            raise ValueError(
                f"attn_window must be >= 0, got {self.attn_window}")
        if self.attn_window:
            if not lm:
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
        for name, default in (("kv_cache_quant", "none"), ("moe_experts", 0),
                              ("shard_vocab", False)):
            if getattr(self, name) != default:
                raise todo(f"--{name.replace('_', '-')}="
                           f"{getattr(self, name)!r}")
        self.mesh.validate()
        self.serve.validate()


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
        "(the reference's MNIST CNN or a GPT causal LM, on one GPU or on "
        "--mesh.data x --mesh.seq GPUs under torchrun; --mode serve runs "
        "a GPT's continuous-batching inference on one GPU)",
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
                      serve=ServeConfig(**nested("serve")), **fields)
    cfg.validate()
    return cfg

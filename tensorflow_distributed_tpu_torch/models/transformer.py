"""GPT-style causal transformer LM: ``models/transformer.py`` in
PyTorch, the training path and the decode-cache path (``decode=True``).

Numerics follow the flax model:

- params stay f32 and are cast to the compute dtype at each dense layer
  (flax ``dtype=``); the residual stream is in the compute dtype;
- the block norms run in f32 with eps 1e-6 (flax's default): LayerNorm,
  or with ``norm="rmsnorm"`` flax's RMSNorm (scale only, no bias);
- the MLP is tanh-approximated GELU (flax ``nn.gelu``'s default), or
  with ``mlp_variant="swiglu"`` the gated ``down(silu(gate(x)) *
  up(x))``;
- positions are the learned table added to the token embedding, or
  with ``pos_emb="rope"`` the rotary embedding applied to q and k in
  every layer (``rope_rotate``) and no table;
- with ``n_kv_heads`` nk < H (grouped-query attention) q and K/V have
  their own projections (``q``, ``kv``) and K/V are widened to H heads
  (``repeat_interleave``, JAX's ``jnp.repeat``) just before the attend;
- logits are cast to f32 at the end;
- ``tie_embeddings`` computes the logits as ``x @ tok_emb.weight.T`` in
  the compute dtype and builds no ``lm_head``;
- ``features_only=True`` hands the loss the pieces of the head instead
  of its product: (ln_f output in the compute dtype, the [V, D] head
  matrix, its bias or None), for the fused head+loss (ops/fused_ce.py).
  Both heads store W as [V, D] (``lm_head.weight``, ``tok_emb.weight``),
  so the JAX ``w_vocab_axis`` is always 0 here;
- with ``remat`` each block is recomputed in the backward
  (``torch.utils.checkpoint``, as ``nn.remat``): ``remat_policy``
  "full" keeps only the block's input, "dots" also the matmul outputs
  (JAX's ``dots_saveable``). The recompute draws its dropout masks from
  the generator's state at the block's entry, as flax replays its rng;
- with a ``ring`` (a ``parallel.ring_attention.ProcessGroupRing`` of
  more than one process), each process holds a contiguous block of the
  sequence: attention is the causal ring (the JAX ``mesh.seq > 1``
  branch), and the positions (the learned table's rows, or RoPE's
  angles) are offset by the block's start (GSPMD sees global positions;
  here each rank is told its offset); a ``StackedRing`` (every position
  in one process: the tests and the one-card smoke) takes the whole
  sequence and cuts it inside the attention (``ring_block``);
- with ``decode=True`` (the JAX dense-layout decode branch) the caller
  passes explicit ``positions`` ([1 | B, L] int) and a :class:`KVCache`
  it owns: each row's L new keys and values (RoPE-rotated when it is
  on, so the cache holds rotated keys) land in the cache at
  ``positions[b, 0] ..`` (one indexed write), and the L queries attend
  the whole ``max_len`` cache under the ``window_keep`` band as a
  NEG_INF bias: through ``full_attention`` (f32) for MHA, through JAX's
  ``grouped_attend`` (f32, the narrow cache never widened) for GQA. A
  [1, L] positions array broadcasts to every row (``generate()``); a
  [B, L] one is per row (the serving engine's slots sit at different
  depths). A row's write starts at ``positions[b, 0]`` clamped to
  ``max_len - L``, as JAX's ``dynamic_update_slice`` clamps it; the
  callers still keep positions in range (``models/generate.py`` and
  ``serve/engine.py`` check on the host);
- with ``kv_cache_quant="int8"`` the cache holds int8 K and V with f32
  per-(token, head) scales (``q8``), and every attend over it, MHA
  included, is the grouped attend with scale-adjusted dots;
- with ``kv_page_size > 0`` (the JAX paged layout) the cache is a pool
  of pages shared by every row, and the forward takes a
  ``page_table`` [B, max_len / kv_page_size]: writes scatter through it
  and the read gathers each row's pages back into the dense layout,
  so the attend is the dense one over the same bytes.

With ``tp`` (a transport of ``parallel/tensor_parallel.py`` over the
mesh's ``model`` axis of M ranks; the JAX model's ``nn.with_partitioning``
layout under GSPMD) each rank holds H/M query heads and d_ff/M hidden
columns of every block (``parallel/sharding.py`` says which part of
each parameter): ``copy_to_tp`` in front of qkv (or q), up and gate,
``reduce_from_tp`` after out and down, whose biases are added once,
after the reduce. Under GQA the K/V projection stays whole on every
rank, and each rank keeps the K/V heads of its own query heads. The
untied head is column-parallel (its rows padded to a multiple of M in
the ranks' parts, or in the parameter under ``shard_vocab``), and
``shard_vocab`` makes the input table vocab-parallel (JAX's padding to
a multiple of M rows; a rank looks up its own rows, zero elsewhere, and
the ranks' lookups are summed) and the tied logits vocab-sharded. Sharded
logits (and, with ``features_only``, a sharded head) come out as a
``VocabShards`` for the vocab-parallel losses; the full [B, L, V] is
never gathered in training. The decode branch runs under ``tp`` too
(JAX's ``--serve.mesh-model`` and ``--mode generate`` under
``--mesh.model``): each rank writes and attends its H/M query heads'
nk/M K/V heads in its slice of the cache's head axis (``KVCache.zeros``
sizes the cache at this process's ranks' heads; ``head_part``), ``out``
is row-parallel, and the head's vocab-parallel logits are gathered to
the whole vocabulary (``full_logits``).

With ``moe_experts`` E > 0 every block's MLP is a top-k mixture of
experts (``models/moe.py``: ``layer_i.moe_mlp`` with ``gate``, ``wi``
and ``wo`` in the flax layout), in training and in the decode branch
alike (a decode step's token is a routing group of one). With an expert
transport ``ep`` (``--mesh.expert X``, or by JAX's default the model
axis's ``tp``) each rank holds E/X experts. The forward appends each
layer's router sums (``MoeAux``) to the list passed as ``moe_aux``.

Parameter names mirror the flax tree (``layer_0.attn.qkv`` for
``layer_0/attn/qkv``), so ``interop.params_from_flax`` is a fixed
renaming plus the kernel reshapes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from tensorflow_distributed_tpu_torch.models.moe import (
    DISPATCHES, MoeMlp, init_moe_)
from tensorflow_distributed_tpu_torch.ops.flash_attention import (
    NEG_INF, attention, window_keep)
from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    ProcessGroupRing, full_attention, ring_attention)
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    shard_state_dict)
from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    VocabShards, full_logits, head_part, local_ranks)

LN_EPS = 1e-6  # flax nn.LayerNorm and nn.RMSNorm default
INIT_STD = 0.02  # the JAX _dense_init (BERT-style normal)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_len: int = 512
    dropout_rate: float = 0.1
    compute_dtype: torch.dtype = torch.bfloat16
    # Recompute each block in the backward; remat_policy "full" keeps
    # only block inputs, "dots" also the matmul outputs.
    remat: bool = False
    remat_policy: str = "full"
    causal: bool = False             # autoregressive (GPT) vs bidirectional
    # Sliding-window attention: attend to the last attn_window positions
    # (0 = full causal). The kernels implement it.
    attn_window: int = 0
    # Share the input embedding as the output projection (GPT-2 style).
    tie_embeddings: bool = False
    # "learned" (additive table) or "rope" (rotary q/k, no table).
    pos_emb: str = "learned"
    rope_theta: float = 10000.0
    # K/V heads (None or 0 = n_heads, MHA; 1 = MQA).
    n_kv_heads: Optional[int] = None
    mlp_variant: str = "gelu"        # gelu | swiglu
    norm: str = "layernorm"          # layernorm | rmsnorm
    # Decode-cache storage: "none" (the compute dtype) or "int8" (per-
    # (token, head) absmax scales in f32; the attend reads the int8
    # cache through scale-adjusted dots, never a dequantized copy).
    kv_cache_quant: str = "none"
    # Paged decode cache (serve/paging): > 0 replaces the per-row
    # [B, max_len, ...] cache with a pool [kv_num_pages, kv_page_size,
    # ...] addressed through a [B, max_len / kv_page_size] page_table;
    # page 0 is the write-off page. 0 = the dense cache.
    kv_page_size: int = 0
    kv_num_pages: int = 0
    # Megatron vocab-parallel input table (and vocab-sharded tied
    # logits) over the model axis; its rows padded to a multiple of it.
    shard_vocab: bool = False
    # Mixture of experts: 0 = the dense MLP; > 0 replaces every block's
    # MLP with a MoeMlp of this many experts (models/moe.py): top-k
    # routing, capacity ceil(c * k * S / E) a routing group of S tokens
    # (moe_group_len, 0 = the whole sequence), dense or scatter token
    # movement.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_group_len: int = 0
    moe_dispatch: str = "dense"


_CHOICES = {"pos_emb": ("learned", "rope"), "mlp_variant": ("gelu", "swiglu"),
            "norm": ("layernorm", "rmsnorm"), "remat_policy": ("full", "dots"),
            "kv_cache_quant": ("none", "int8"), "moe_dispatch": DISPATCHES}
# The expert count moe_lm applies when none is given (JAX's).
MOE_DEFAULT_EXPERTS = 4


def kv_heads(cfg: TransformerConfig) -> int:
    """The K/V head count: n_kv_heads, with None and 0 meaning n_heads
    (MHA), as in JAX."""
    return cfg.n_kv_heads or cfg.n_heads


def _check_config(cfg: TransformerConfig) -> None:
    if cfg.moe_experts > 0 and cfg.mlp_variant != "gelu":
        raise ValueError("mlp_variant has no effect with moe_experts > 0 "
                         "(MoeMlp replaces the block MLP)")
    for name, choices in _CHOICES.items():
        if getattr(cfg, name) not in choices:
            raise ValueError(f"{name} {getattr(cfg, name)!r}; have {choices}")
    if cfg.n_heads % kv_heads(cfg):
        raise ValueError(f"n_heads {cfg.n_heads} not divisible by "
                         f"n_kv_heads {kv_heads(cfg)}")
    if cfg.pos_emb == "rope" and (cfg.d_model // cfg.n_heads) % 2:
        raise ValueError(f"rope needs an even head dim, got "
                         f"Dh={cfg.d_model // cfg.n_heads}")


def check_tp(cfg: TransformerConfig, size: int) -> None:
    """The shapes the port cuts into ``size`` equal shards: JAX's GSPMD
    pads uneven ones, the port refuses them (ROADMAP.md A5). A MoE block
    cuts its experts, not d_ff (``MoeMlp`` checks E)."""
    for name in ("n_heads",) + (("d_ff",) if not cfg.moe_experts else ()):
        if getattr(cfg, name) % size:
            raise ValueError(
                f"--mesh.model {size} must divide {name} "
                f"{getattr(cfg, name)}: the port cuts even tensor-parallel "
                f"shards (uneven ones are not ported; ROADMAP.md A5)")


def bert_base_config(**overrides) -> TransformerConfig:
    """BERT-base: the config's defaults (12L x 768d x 12H, d_ff 3072,
    vocab 30522, max_len 512, bidirectional)."""
    return dataclasses.replace(TransformerConfig(), **overrides)


def tiny_config(**overrides) -> TransformerConfig:
    """Small config for tests: same code paths, toy scale."""
    base = TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, d_ff=64, max_len=128,
                             dropout_rate=0.0, compute_dtype=torch.float32)
    return dataclasses.replace(base, **overrides)


def gpt2_small_config(**overrides) -> TransformerConfig:
    """GPT-2-small (12L x 768d x 12H, learned positions, pre-LN)."""
    return dataclasses.replace(
        TransformerConfig(vocab_size=50257, d_model=768, n_layers=12,
                          n_heads=12, d_ff=3072, max_len=1024,
                          causal=True),
        **overrides)


# The GPT-2 ladder (Radford et al. 2019 table 2): d_ff = 4 * d_model;
# head dim 64.
GPT2_SIZES = {
    "small": dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072),
    "medium": dict(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
    "large": dict(d_model=1280, n_layers=36, n_heads=20, d_ff=5120),
    "xl": dict(d_model=1600, n_layers=48, n_heads=25, d_ff=6400),
}


@dataclasses.dataclass
class KVCache:
    """The decode cache, owned by the caller (the JAX ``cache``
    collection's ``key`` and ``value`` leaves, and under int8 its
    ``key_scale`` and ``value_scale``): per layer, K and V of shape
    [B, max_len, nk, Dh], nk the K/V head count (``kv_heads``: n_heads
    for MHA, fewer under GQA, never widened to n_heads). K and V are in
    the compute dtype, or int8 with ``kv_cache_quant="int8"``, which
    adds the f32 scales [B, max_len, nk]. A paged config
    (``kv_page_size > 0``) holds a pool instead: [kv_num_pages,
    kv_page_size, nk, Dh] (scales [.., .., nk]), shared by every row
    through the forward's ``page_table``. ``decode=True`` forwards write
    into it in place. Under tensor parallelism (``tp``) the head axis
    holds this process's ranks' nk/M K/V heads each, side by side
    (``head_part``): 1/M of the whole cache a rank."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int,
              device=None, tp=None) -> "KVCache":
        """A zeroed cache for ``batch`` rows, or for a paged config the
        zeroed pool (``batch`` is then unused); with ``tp`` (the model's
        transport) at this process's ranks' heads."""
        lead = ((cfg.kv_num_pages, cfg.kv_page_size) if cfg.kv_page_size
                else (batch, cfg.max_len))
        nk, dh = kv_heads(cfg), cfg.d_model // cfg.n_heads
        if tp is not None:
            nk = nk // tp.size * local_ranks(tp)
        quant = cfg.kv_cache_quant == "int8"

        def layers(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(cfg.n_layers)]

        dtype = torch.int8 if quant else cfg.compute_dtype
        k, v = layers(lead + (nk, dh), dtype), layers(lead + (nk, dh), dtype)
        if not quant:
            return cls(k, v)
        return cls(k, v, layers(lead + (nk,), torch.float32),
                   layers(lead + (nk,), torch.float32))

    def leaves(self) -> List[torch.Tensor]:
        """Every tensor of the cache: K, V, then the scales under int8."""
        return self.k + self.v + (self.k_scale or []) + (self.v_scale or [])

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        """Layer ``i``'s (K, V, K scale, V scale); the scales are None
        for a cache in the compute dtype."""
        if self.k_scale is None:
            return self.k[i], self.v[i], None, None
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]

    def map(self, fn) -> "KVCache":
        """A cache of ``fn`` applied to every leaf (the layout kept)."""
        def each(ts):
            return None if ts is None else [fn(t) for t in ts]

        return KVCache(each(self.k), each(self.v), each(self.k_scale),
                       each(self.v_scale))

    def put_row(self, row: "KVCache", slot: int) -> None:
        """Replace row ``slot`` wholesale with the one row of ``row`` (the
        JAX engine's ``_insert_row``): nothing of the stale row survives,
        not even in masked columns, where a non-finite value would still
        reach P @ V as 0 * NaN."""
        for dst, src in zip(self.leaves(), row.leaves()):
            dst[slot].copy_(src[0])

    def copy_page(self, src: int, dst: int) -> None:
        """Copy page ``src`` of a paged pool to page ``dst`` in every
        leaf (the paged engine's copy-on-write)."""
        for t in self.leaves():
            t[dst].copy_(t[src])

    def zero_(self) -> None:
        for t in self.leaves():
            t.zero_()

    def nbytes(self) -> int:
        """Device bytes of every leaf: 2 * n_layers * B * max_len * nk *
        Dh * the dtype's size, plus 2 * n_layers * B * max_len * nk * 4
        for the scales of an int8 cache."""
        return sum(t.numel() * t.element_size() for t in self.leaves())


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax Dense(dtype=...): input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """``_dense`` on one rank's part of a layer (no bias: a row-parallel
    part, whose bias is added after the reduce)."""
    return F.linear(x.to(dtype), w.to(dtype),
                    None if b is None else b.to(dtype))


def _local_linear(d_in: int, d_out: int, ranks: int,
                  split_bias: bool = True) -> nn.Linear:
    """A Linear of one rank's shape, or with ``ranks`` > 1 (``StackedTP``)
    holding that many ranks' weights on a leading dim (and their biases,
    unless ``split_bias`` is False: a row-parallel layer's whole bias)."""
    layer = nn.Linear(d_in, d_out)
    if ranks > 1:
        layer.weight = nn.Parameter(layer.weight.new_empty(ranks, d_out,
                                                           d_in))
        if split_bias:
            layer.bias = nn.Parameter(layer.bias.new_empty(ranks, d_out))
    return layer


@torch.no_grad()
def cast_dense_weights_(model: nn.Module) -> None:
    """Hold every dense layer's kernel and bias in the compute dtype, in
    place, for inference: ``_dense`` then casts nothing at each call (at
    GPT-2-small's decode step the per-call casts move ~0.5 GB), and the
    values it computes with are the same.
    The norms and the embedding tables stay f32, as in the JAX model."""
    dtype = model.cfg.compute_dtype
    for module in model.modules():
        if isinstance(module, nn.Linear):
            module.to(dtype)
        elif isinstance(module, MoeMlp):  # the experts; the router stays f32
            module.wi.data = module.wi.data.to(dtype)
            module.wo.data = module.wo.data.to(dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=f32)``: x * rsqrt(mean(x^2) + eps) * scale
    in f32. ``weight`` is the flax ``scale``; there is no bias."""

    def __init__(self, d: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight, self.eps)


def _make_norm(cfg: TransformerConfig) -> nn.Module:
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.d_model)
    return nn.LayerNorm(cfg.d_model, eps=LN_EPS)


def _norm(x: torch.Tensor, norm: nn.Module) -> torch.Tensor:
    """The block norm in f32 (flax ``dtype=f32``): statistics and output
    in f32."""
    if isinstance(norm, RMSNorm):
        return norm(x)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [1 | B, L, 1, Dh/2] of RoPE's angles ``positions *
    theta ** (-i / half)``, in f32. The frequencies are rounded from
    float64 to f32 as XLA's correctly rounded pow gives them (torch's
    f32 pow is off by an ulp in some, which at position 8191 moves a
    rotated value by ~1e-5)."""
    if head_dim % 2:
        raise ValueError(f"rope needs an even head dim, got Dh={head_dim}")
    half = head_dim // 2
    # Made on the positions' device: a host-to-device copy here would wait
    # for the device at every forward.
    device = positions.device
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    base = torch.full((), theta, dtype=torch.float32, device=device)
    freqs = torch.pow(base.double(), exponent.double()).float()
    angles = positions.to(torch.float32)[..., None] * freqs   # [., L, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _rotate(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """Rotate each (x[i], x[i + half]) pair of x [B, L, H, Dh] by RoPE's
    angles, in f32, returning x's dtype."""
    cos, sin = rope
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (Su et al., RoFormer), the JAX
    ``rope_rotate``: x [B, L, H, Dh] (Dh even), positions [B, L] or
    [1, L] int. Rotates each (x[i], x[i + half]) pair (rotate-half, not
    interleaved) by positions * theta^(-i/half), in f32, and returns
    x's dtype."""
    return _rotate(x, rope_angles(positions, x.shape[-1], theta))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate); drawn from the caller's generator."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def _is_ring(ring) -> bool:
    return ring is not None and ring.size > 1


def ring_block(ring, L: int) -> Tuple[int, int]:
    """(the blocks the sequence is cut into, the first position of this
    rank's ``L`` tokens): under a ring of processes its contiguous block
    (S, index x L); in one process (no ring, or a ``StackedRing``, which
    holds the whole sequence and cuts it inside the attention) (1, 0)."""
    if isinstance(ring, ProcessGroupRing) and ring.size > 1:
        return ring.size, ring.index * L
    return 1, 0


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, ring=None, tp=None):
        super().__init__()
        if _is_ring(ring) and cfg.attn_window:
            raise ValueError(
                "attn_window with mesh.seq > 1 is not implemented (the "
                "zigzag ring schedule is not windowed); at W << L the "
                "window IS the long-context strategy — use mesh.seq == 1")
        self.cfg = cfg
        self.ring = ring
        self.tp = tp
        h, dh, nk = cfg.n_heads, cfg.d_model // cfg.n_heads, kv_heads(cfg)
        # flax DenseGeneral kernels: qkv [D, 3, H, dh] (MHA: one fused
        # projection, the param tree of before GQA), or q [D, H, dh] and
        # kv [D, 2, nk, dh] (GQA); out [H, dh, D]. Here flattened to
        # Linear's [out, in]; under TP the query heads are a rank's H/M.
        hl, ranks = h // (tp.size if tp else 1), local_ranks(tp)
        if nk == h:
            self.qkv = _local_linear(cfg.d_model, 3 * hl * dh, ranks)
        else:
            self.q = _local_linear(cfg.d_model, hl * dh, ranks)
            self.kv = nn.Linear(cfg.d_model, 2 * nk * dh)
        self.out = _local_linear(hl * dh, cfg.d_model, ranks,
                                 split_bias=False)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, ...]] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """With ``kv`` (this layer's cache K, V and scales:
        ``KVCache.layer``), the decode branch at ``positions``, through
        ``page_table`` for a paged pool; the training path otherwise.
        ``rope``: RoPE's (cos, sin) at ``positions`` (``rope_angles``)
        when it is on."""
        if self.tp is not None:
            return self._forward_tp(x, rope, positions, kv, page_table)
        cfg = self.cfg
        B, L, _ = x.shape
        h, dh, nk = cfg.n_heads, cfg.d_model // cfg.n_heads, kv_heads(cfg)
        dtype = cfg.compute_dtype
        if nk == h:
            q, k, v = _dense(x, self.qkv, dtype).view(B, L, 3, h, dh).unbind(2)
        else:
            q = _dense(x, self.q, dtype).view(B, L, h, dh)
            k, v = _dense(x, self.kv, dtype).view(B, L, 2, nk, dh).unbind(2)
        if rope is not None:
            # Before the cache write and the attend: the cache holds
            # rotated keys, as in JAX.
            q, k = _rotate(q, rope), _rotate(k, rope)

        def widen(t):
            """[B, L, nk, Dh] -> [B, L, H, Dh]: query head i reads K/V
            head i // (H / nk), as jnp.repeat(t, H // nk, axis=2)."""
            return t if nk == h else t.repeat_interleave(h // nk, dim=2)

        if kv is not None:
            out = _cached_attend(q, k, v, positions, kv, cfg, page_table)
        elif _is_ring(self.ring):
            out = ring_attention(q, widen(k), widen(v), self.ring,
                                 causal=cfg.causal)
        else:
            out = attention(q, widen(k), widen(v), causal=cfg.causal,
                            window=cfg.attn_window)
        return _dense(out.reshape(B, L, h * dh), self.out, dtype)

    def _attend(self, q, k, v):
        if _is_ring(self.ring):
            return ring_attention(q, k, v, self.ring, causal=self.cfg.causal)
        return attention(q, k, v, causal=self.cfg.causal,
                         window=self.cfg.attn_window)

    def _forward_tp(self, x: torch.Tensor, rope, positions=None, kv=None,
                    page_table=None) -> torch.Tensor:
        """``forward`` on this process's model ranks, each with its H/M
        query heads; ``out`` is row-parallel, its bias added after the
        reduce. Under GQA the whole K/V projection runs on the
        replicated stream and ``copy_to_tp`` carries its output to the
        ranks (JAX's replicated ``kv`` kernel). Training: each rank
        takes the K/V heads its query heads read, widened to [B, L,
        H/M, Dh] as ``jnp.repeat``, and attends through ``attention()``
        (or the ring). Decode (``kv`` given): each rank keeps its nk/M
        K/V heads (M divides nk) and writes and attends them in its
        slice of the cache's head axis (``head_part``: JAX's
        head-sharded ``shard_cache`` layout) through the same
        ``_cached_attend`` as one process."""
        cfg, tp = self.cfg, self.tp
        B, L, _ = x.shape
        h, dh, nk = cfg.n_heads, cfg.d_model // cfg.n_heads, kv_heads(cfg)
        if kv is not None and nk % tp.size:
            raise ValueError(
                f"the model axis {tp.size} must divide n_kv_heads {nk}: "
                f"the decode cache's head axis is cut over it")
        hl, nkl, dtype = h // tp.size, nk // tp.size, cfg.compute_dtype
        xs = tp.copy_to_tp(x)
        if nk == h:
            qkv = [_linear(xi, w, b, dtype).view(B, L, 3, hl, dh).unbind(2)
                   for xi, w, b in zip(xs, tp.split(self.qkv.weight),
                                       tp.split(self.qkv.bias))]
        else:
            kvs = _dense(x, self.kv, dtype).view(B, L, 2, nk, dh)
            qkv = []
            for xi, w, b, kvi, m in zip(xs, tp.split(self.q.weight),
                                        tp.split(self.q.bias),
                                        tp.copy_to_tp(kvs), tp.indices):
                heads = (torch.arange(m * hl, (m + 1) * hl,
                                      device=x.device) // (h // nk)
                         if kv is None else
                         torch.arange(m * nkl, (m + 1) * nkl,
                                      device=x.device))
                k, v = kvi.index_select(3, heads).unbind(2)
                qkv.append((_linear(xi, w, b, dtype).view(B, L, hl, dh),
                            k, v))
        parts = []
        for i, ((q, k, v), w) in enumerate(zip(qkv,
                                               tp.split(self.out.weight))):
            if rope is not None:
                q, k = _rotate(q, rope), _rotate(k, rope)
            if kv is None:
                out = self._attend(q, k, v)
            else:
                mine = tuple(None if t is None else head_part(t, tp, i)
                             for t in kv)
                out = _cached_attend(q, k, v, positions, mine, cfg,
                                     page_table)
            parts.append(_linear(out.reshape(B, L, hl * dh), w, None, dtype))
        return tp.reduce_from_tp(parts) + self.out.bias.to(dtype)


def _grouped_attend(q, k_cache, v_cache, bias, k_scale=None, v_scale=None):
    """JAX's ``grouped_attend``: q [B, L, H, Dh] against K, V [B,
    max_len, nk, Dh] in f32, the H / nk query heads of a group sharing
    their K/V head (g = 1 for MHA), with the additive ``bias`` [1 | B,
    L, max_len]; the cache is never widened to H heads. An int8 cache
    passes its scales [B, max_len, nk]: the scores are scaled by the key
    column's scale before 1/sqrt(Dh), and the probabilities by the value
    column's scale before P @ V, the exact rescalings of
    q . dequant(K) and P . dequant(V), so no dequantized cache is
    built."""
    B, L, h, dh = q.shape
    nk = k_cache.shape[2]
    qg = q.reshape(B, L, nk, h // nk, dh).float()
    s = torch.einsum("bqngd,bknd->bngqk", qg, k_cache.float())
    if k_scale is not None:
        s = s * k_scale.transpose(1, 2)[:, :, None, None]
    s = s / math.sqrt(dh) + bias[:, None, None]
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.transpose(1, 2)[:, :, None, None]
    o = torch.einsum("bngqk,bknd->bqngd", p, v_cache.float())
    return o.reshape(B, L, h, dh).to(q.dtype)


def q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's per-(token, head) absmax quantizer: ``scale = max(max |x|
    over Dh / 127, 1e-8)`` in f32, ``round(x / scale)`` (half to even,
    as ``jnp.round``) clipped to +-127. Returns (int8 x, f32 scale
    [..., nk])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    rounded = torch.round(xf / scale[..., None])
    return rounded.clamp(-127, 127).to(torch.int8), scale


def _write_index(pos, B, L, cfg, page_table):
    """Where row b's L new tokens land: (row, column) of a dense cache,
    or (page, offset) of a paged pool.

    Dense: columns ``start_b .. start_b + L - 1``, ``start_b`` =
    ``positions[b, 0]`` clamped to ``[0, max_len - L]`` as JAX's
    ``dynamic_update_slice`` clamps it (a write that would run past the
    cache end lands shifted back over the row's last columns).

    Paged: position p goes to page ``table[b, min(p // page_size,
    max_pages - 1)]`` at offset ``p % page_size``; positions at or past
    ``max_len`` (the bucket padding of a tail prefill at an offset) go
    to the write-off page 0, which no table shows in an unmasked
    column. Several padding positions may share a (0, offset) target:
    which one lands there is unspecified and harmless."""
    max_len = cfg.max_len
    if not cfg.kv_page_size:
        steps = torch.arange(L, device=pos.device)
        start = pos[:, :1].expand(B, 1).clamp(0, max_len - L)
        rows = torch.arange(B, device=pos.device)[:, None].expand(B, L)
        return rows, start + steps
    psz = cfg.kv_page_size
    posb = pos.expand(B, L)
    logical = torch.clamp(posb // psz, max=page_table.shape[1] - 1)
    pid = torch.gather(page_table, 1, logical)
    pid = torch.where(posb < max_len, pid, torch.zeros_like(pid))
    return pid, posb % psz


def _cached_attend(q, k, v, positions, kv, cfg, page_table):
    """The JAX decode branch: write each row's L new K, V (quantized
    first under int8) in one indexed write per cache leaf
    (``_write_index``), then attend the L queries against the row's
    whole ``max_len`` cache, columns outside each query's (pos - window,
    pos] band masked by a NEG_INF bias [1 | B, L, max_len]. A paged pool
    is first gathered through ``page_table`` back into the dense [B,
    max_len, ...] layout (the same bytes in the same order, so the
    attend is the dense one). The attend is ``full_attention`` for an
    MHA cache in the compute dtype, ``_grouped_attend`` for a narrow
    (GQA) cache and for every int8 cache. The band reads the unclamped
    positions. A table's unreserved entries gather page 0, whose
    columns are masked (p = 0) and finite."""
    k_cache, v_cache, k_scale, v_scale = kv
    B, L = q.shape[:2]
    pos = positions.long()
    quant = k_scale is not None
    max_len = cfg.max_len
    if page_table is not None:
        page_table = page_table.long()
    idx = _write_index(pos, B, L, cfg, page_table)
    if quant:
        (k, ks), (v, vs) = q8(k), q8(v)
        k_scale[idx] = ks
        v_scale[idx] = vs
    k_cache[idx] = k.to(k_cache.dtype)
    v_cache[idx] = v.to(v_cache.dtype)
    if cfg.kv_page_size:
        def gathered(buf):
            return buf[page_table].reshape((B, max_len) + buf.shape[2:])

        k_cache, v_cache = gathered(k_cache), gathered(v_cache)
        if quant:
            k_scale, v_scale = gathered(k_scale), gathered(v_scale)
    keys = torch.arange(max_len, device=q.device)
    keep = window_keep(pos[:, :, None], keys, cfg.attn_window)
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    if quant:
        return _grouped_attend(q, k_cache, v_cache, bias, k_scale, v_scale)
    if k_cache.shape[2] != q.shape[2]:
        return _grouped_attend(q, k_cache, v_cache, bias)
    return full_attention(q, k_cache, v_cache, bias)


class Mlp(nn.Module):
    """flax ``Mlp``: ``down(gelu(up(x)))``, or with ``mlp_variant=
    "swiglu"`` ``down(silu(gate(x)) * up(x))``; gate and up are d_ff
    wide, every product in the compute dtype."""

    def __init__(self, cfg: TransformerConfig, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        ff, ranks = cfg.d_ff // (tp.size if tp else 1), local_ranks(tp)
        if cfg.mlp_variant == "swiglu":
            self.gate = _local_linear(cfg.d_model, ff, ranks)
        self.up = _local_linear(cfg.d_model, ff, ranks)
        self.down = _local_linear(ff, cfg.d_model, ranks, split_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.cfg.compute_dtype
        if self.tp is not None:
            return self._forward_tp(x)
        if self.cfg.mlp_variant == "swiglu":
            x = F.silu(_dense(x, self.gate, dtype)) * _dense(x, self.up, dtype)
        else:
            x = F.gelu(_dense(x, self.up, dtype), approximate="tanh")
        return _dense(x, self.down, dtype)

    def _forward_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Each rank's d_ff/M columns: column-parallel up (and gate),
        row-parallel down, the down bias after the reduce."""
        tp, dtype = self.tp, self.cfg.compute_dtype
        swiglu = self.cfg.mlp_variant == "swiglu"
        gates = tp.split(self.gate.weight) if swiglu else None
        gate_b = tp.split(self.gate.bias) if swiglu else None
        parts = []
        for i, (xi, w, b, wd) in enumerate(zip(
                tp.copy_to_tp(x), tp.split(self.up.weight),
                tp.split(self.up.bias), tp.split(self.down.weight))):
            if swiglu:
                hid = (F.silu(_linear(xi, gates[i], gate_b[i], dtype))
                       * _linear(xi, w, b, dtype))
            else:
                hid = F.gelu(_linear(xi, w, b, dtype), approximate="tanh")
            parts.append(_linear(hid, wd, None, dtype))
        return tp.reduce_from_tp(parts) + self.down.bias.to(dtype)


class Block(nn.Module):
    """Pre-norm transformer block; its MLP is a ``MoeMlp`` (``moe_mlp``)
    when the config has experts."""

    def __init__(self, cfg: TransformerConfig, ring=None, tp=None, ep=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _make_norm(cfg)
        self.attn = SelfAttention(cfg, ring, tp)
        self.ln2 = _make_norm(cfg)
        if cfg.moe_experts > 0:
            self.moe_mlp = MoeMlp(
                cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_top_k,
                cfg.moe_capacity_factor, cfg.compute_dtype,
                cfg.moe_group_len, cfg.moe_dispatch, ep)
        else:
            self.mlp = Mlp(cfg, tp)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                positions: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, ...]] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                page_table: Optional[torch.Tensor] = None,
                moe_aux: Optional[list] = None) -> torch.Tensor:
        """``moe_aux``: a list that a MoE block appends its router sums
        to (``MoeAux``)."""
        cfg = self.cfg
        y = self.attn(_norm(x, self.ln1).to(cfg.compute_dtype), positions,
                      kv, rope, page_table)
        x = x + dropout(y, cfg.dropout_rate, train, generator)
        y = _norm(x, self.ln2).to(cfg.compute_dtype)
        if cfg.moe_experts > 0:
            y, aux = self.moe_mlp(y)
            if moe_aux is not None:
                moe_aux.append(aux)
        else:
            y = self.mlp(y)
        return x + dropout(y, cfg.dropout_rate, train, generator)


# The ops whose outputs ``remat_policy="dots"`` saves: the matmuls that
# F.linear and torch.einsum reach (JAX's dots_saveable saves every
# dot_general). The hand kernels are ctypes launches, not aten ops, so
# they are recomputed, as JAX recomputes a pallas_call under this policy.
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                     torch.ops.aten.bmm.default,
                     torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(block: Block, x: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator], positions, rope,
                 moe_aux: Optional[list] = None) -> torch.Tensor:
    """``block`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward. Dropout draws from
    ``generator``, which ``preserve_rng_state`` does not restore: the
    recompute draws from a copy of its state at the block's entry (the
    masks of the forward), and the live generator stays where the
    forward left it (under gradient accumulation the next microbatch's
    forward runs before this backward). Under a ring every rank
    recomputes its blocks in the same order, so the recompute's permutes
    pair up as the forward's did. A MoE block's router sums are taken
    from the forward (the recompute appends none)."""
    entry = generator.get_state() if generator is not None else None
    calls = 0

    def run(x):
        nonlocal calls
        gen = generator
        if calls and entry is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(entry)
        aux = moe_aux if not calls else None
        calls += 1
        return block(x, train, gen, positions, None, rope, moe_aux=aux)

    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
               if block.cfg.remat_policy == "dots" else noop_context_fn)
    return checkpoint(run, x, use_reentrant=False, context_fn=context,
                      preserve_rng_state=False)


class _LmHead(nn.Linear):
    """The untied output projection (flax ``lm_head``: kernel [D, V] and
    bias [V]; here Linear's [V, D] weight)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(x, self, x.dtype)


def _check_paged(cfg: TransformerConfig, page_table, B: int) -> None:
    """JAX's checks of a paged decode forward, with its messages."""
    if page_table is None:
        raise ValueError("kv_page_size > 0 needs a page_table "
                         "([B, max_pages] int32)")
    npages, psz = cfg.kv_num_pages, cfg.kv_page_size
    if npages < 2:
        raise ValueError(f"kv_num_pages must be >= 2 (page 0 is the "
                         f"write-off page), got {npages}")
    if tuple(page_table.shape) != (B, cfg.max_len // psz) or \
            cfg.max_len % psz:
        raise ValueError(
            f"page_table {tuple(page_table.shape)} must be [B={B}, "
            f"max_len/page_size={cfg.max_len}/{psz}] (max_len must divide "
            f"evenly into pages)")


class TransformerLM(nn.Module):
    """Transformer LM backbone: tokens [B, L] int -> logits [B, L, V] f32.
    With a ``ring`` of S processes, tokens are this rank's contiguous
    [B, L/S] block of the sequence and the outputs cover that block.
    ``extra_vocab`` sentinel rows (BERT's [MASK]) widen the input
    embedding only: the logits, and the head a fused loss is handed,
    cover the ``vocab_size`` real ids."""

    extra_vocab: int = 0

    def __init__(self, cfg: TransformerConfig, ring=None, tp=None,
                 vocab_shards: Optional[int] = None, ep=None):
        """``tp``: the model axis's transport (``parallel/
        tensor_parallel.py``), or None for one whole model. ``ep``: the
        expert group's transport of a MoE config (default: ``tp``, JAX's
        expert axis "model").
        ``vocab_shards``: the M that ``shard_vocab`` pads the tables'
        rows to a multiple of (default: the transport's size, else 1), so
        that a whole model can take a TP run's padded parameters."""
        super().__init__()
        _check_config(cfg)
        if cfg.moe_experts and _is_ring(ring):
            raise NotImplementedError(
                "MoE with a sequence ring (--mesh.seq > 1: the expert "
                "positions' cumsum runs over the whole sequence) is not "
                "ported to PyTorch yet (see ROADMAP.md A5)")
        self.cfg = cfg
        self.ring = ring
        self.tp = tp
        self.ep = (ep if ep is not None else tp) if cfg.moe_experts else None
        size = tp.size if tp is not None else 1
        if tp is not None:
            check_tp(cfg, size)
        self.vocab_shards = vocab_shards or size
        pad = self.vocab_shards if cfg.shard_vocab else 1
        emb_rows = cfg.vocab_size + self.extra_vocab
        emb_rows += (-emb_rows) % pad
        # The head's rows (the param's; the ranks' parts pad it further
        # to a multiple of M without shard_vocab).
        self.head_rows = cfg.vocab_size + (-cfg.vocab_size) % pad
        ranks = local_ranks(tp)
        if cfg.shard_vocab and tp is not None:
            self.tok_emb = nn.Embedding(emb_rows // size, cfg.d_model)
            if ranks > 1:
                self.tok_emb.weight = nn.Parameter(
                    self.tok_emb.weight.new_empty(ranks, emb_rows // size,
                                                  cfg.d_model))
        else:
            self.tok_emb = nn.Embedding(emb_rows, cfg.d_model)
        if cfg.pos_emb == "learned":
            self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg, ring, tp, self.ep))
        self.ln_f = _make_norm(cfg)
        if not cfg.tie_embeddings:
            rows = -(-self.head_rows // size)
            if tp is None:
                self.lm_head = _LmHead(cfg.d_model, self.head_rows)
            else:
                self.lm_head = _local_linear(cfg.d_model, rows, ranks)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The flax initializers: normal(0.02) for kernels and embedding
        tables, zeros for biases, ones/zeros for the norms' scales and
        offsets, drawn in module order from ``generator``. Under TP the
        draw of the whole model without ``shard_vocab``'s padding rows
        (one process's draw), those rows zero, cut to this process's
        ranks (and the experts to the expert group's)."""
        if self.tp is not None or self.ep is not None:
            device = next(self.parameters()).device
            with torch.device(device):
                whole = type(self)(self.cfg)
            whole.init_weights(generator)
            shapes = {n: p.shape for n, p in
                      self.whole("meta").named_parameters()}
            full = {n: F.pad(t, (0, 0) * (t.dim() - 1)
                             + (0, shapes[n][0] - t.shape[0]))
                    for n, t in whole.state_dict().items()}
            self.load_state_dict(shard_state_dict(full, self))
            return
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, INIT_STD, generator=generator)
            elif isinstance(module, (nn.LayerNorm, RMSNorm)):
                module.weight.fill_(1.0)
            elif isinstance(module, MoeMlp):
                init_moe_(module, INIT_STD, generator)
            if isinstance(module, (nn.Linear, nn.LayerNorm)):
                module.bias.zero_()

    def whole(self, device=None) -> "TransformerLM":
        """The unsharded model of this config (its tables padded as this
        model's are), built on ``device``; on ``"meta"`` it allocates
        nothing (a template of names, modules and full shapes)."""
        with torch.device(device or next(self.parameters()).device):
            return type(self)(self.cfg, vocab_shards=self.vocab_shards)

    def moe_layers(self) -> List[MoeMlp]:
        """Every block's MoeMlp, in layer order (none for a dense
        config)."""
        return [m for m in self.modules() if isinstance(m, MoeMlp)]

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False, decode: bool = False,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, page_table=None,
                moe_aux: Optional[list] = None):
        """Logits [B, L, V] f32, or with ``features_only`` the head's
        pieces (features [B, L, D] in the compute dtype, W [V, D], bias
        [V] or None). ``positions`` ([1 | B, L] int) index the learned
        position table or set RoPE's angles (default: the block's
        arange); ``decode=True`` requires them and a ``cache`` (see the
        module docstring). ``moe_aux``: a list each MoE layer appends its
        router sums to."""
        cfg = self.cfg
        B, L = tokens.shape
        if page_table is not None and not (decode and cfg.kv_page_size):
            raise ValueError("a page_table is read only by the decode "
                             "branch of a paged config (kv_page_size > 0)")
        if decode and cfg.kv_page_size:
            _check_paged(cfg, page_table, B)
        if decode:
            if not cfg.causal:
                raise ValueError("decode=True needs a causal config")
            if positions is None:
                raise ValueError("decode=True requires positions")
            if cache is None:
                raise ValueError("decode=True requires a KVCache")
            if _is_ring(self.ring) or self.ep is not None:
                raise ValueError(
                    "decode=True runs without a ring or an expert group "
                    "(mesh.seq and mesh.expert must be 1; a MoE model "
                    "under tensor-parallel decode is ROADMAP.md A6)")
        elif cache is not None:
            raise ValueError("a KVCache is read only with decode=True")
        shards, start = ring_block(self.ring, L)
        if L * shards > cfg.max_len:
            raise ValueError(f"sequence length {L * shards} > max_len "
                             f"{cfg.max_len}")
        if positions is None:
            positions = start + torch.arange(L, device=tokens.device)[None]
        x = self._embed(tokens)
        rope = None
        if cfg.pos_emb == "rope":
            # One (cos, sin) for every layer: JAX computes the same
            # angles in each.
            rope = rope_angles(positions, cfg.d_model // cfg.n_heads,
                               cfg.rope_theta)
        elif decode:
            # A tail prefill at an offset pads past max_len; those rows
            # are garbage nobody attends, and the clamp keeps them (and
            # the write-off page they land in) finite, where JAX's
            # out-of-range lookup fills NaN (ROADMAP.md queue C).
            x = x + self.pos_emb(positions.clamp(max=cfg.max_len - 1))
        else:
            x = x + self.pos_emb(positions)
        x = x.to(cfg.compute_dtype)
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = _remat_block(block, x, train, generator, positions, rope,
                                 moe_aux)
            else:
                kv = cache.layer(i) if decode else None
                x = block(x, train, generator, positions, kv, rope,
                          page_table, moe_aux)
        x = _norm(x, self.ln_f).to(cfg.compute_dtype)
        if self.tp is not None and decode:
            # Inference reads the whole vocabulary: the vocab-parallel
            # logits gathered, shard_vocab's padding columns dropped.
            return full_logits(self._head_tp(x, False))
        if self.tp is not None:
            return self._head_tp(x, features_only)
        if features_only:
            if cfg.tie_embeddings:
                return x, self.tok_emb.weight[:cfg.vocab_size], None
            if self.head_rows != cfg.vocab_size:  # shard_vocab's padding
                return (x, self.lm_head.weight[:cfg.vocab_size],
                        self.lm_head.bias[:cfg.vocab_size])
            return x, self.lm_head.weight, self.lm_head.bias
        if cfg.tie_embeddings:
            # The sentinel rows dropped before the product (JAX slices
            # them off the logits: the same values).
            table = self.tok_emb.weight[:cfg.vocab_size].to(cfg.compute_dtype)
            return F.linear(x, table).float()
        return self.lm_head(x)[..., :cfg.vocab_size].float()

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token lookup; under TP with ``shard_vocab`` each rank
        looks up the ids of its own rows (zero for the others) and the
        ranks' lookups are summed."""
        if self.tp is None or not self.cfg.shard_vocab:
            return self.tok_emb(tokens)
        tp = self.tp
        parts = []
        for w, m in zip(tp.split(self.tok_emb.weight), tp.indices):
            rows = w.shape[0]
            ids = tokens - m * rows
            mine = (ids >= 0) & (ids < rows)
            parts.append(F.embedding(ids.clamp(0, rows - 1), w)
                         * mine[..., None])
        return tp.reduce_from_tp(parts)

    def _head_tp(self, x: torch.Tensor, features_only: bool):
        """The head on the model ranks: vocab-sharded logits (or, with
        ``features_only``, the head's rows for the vocab-parallel fused
        loss) as a ``VocabShards``; the tied head without
        ``shard_vocab`` is whole on every rank, as in JAX (its logits
        replicated; the fused loss cuts the table's rows per rank, its
        gradient summed back by ``copy_to_tp``)."""
        cfg, tp = self.cfg, self.tp
        V = cfg.vocab_size
        biases = None
        if cfg.tie_embeddings and not cfg.shard_vocab:
            table = self.tok_emb.weight[:V]
            if not features_only:
                return F.linear(x, table.to(cfg.compute_dtype)).float()
            rows = -(-V // tp.size)
            weights = [F.pad(t, (0, 0, 0, rows * tp.size - V))[
                m * rows:(m + 1) * rows]
                for t, m in zip(tp.copy_to_tp(table), tp.indices)]
        elif cfg.tie_embeddings:
            weights = tp.split(self.tok_emb.weight)
        else:
            weights = tp.split(self.lm_head.weight)
            biases = tp.split(self.lm_head.bias)
        rows = weights[0].shape[0]
        if features_only:
            return x, VocabShards(weights, rows, V, tp, biases), None
        dtype = cfg.compute_dtype
        logits = [_linear(xi, w, None if biases is None else biases[i],
                          dtype).float()
                  for i, (xi, w) in enumerate(zip(tp.copy_to_tp(x),
                                                  weights))]
        return VocabShards(logits, rows, V, tp)


class BertMLM(TransformerLM):
    """Encoder-only masked LM (bidirectional attention; one [MASK]
    sentinel row, id ``vocab_size``, in the input embedding)."""

    extra_vocab = 1


class CausalLM(TransformerLM):
    """Decoder-only autoregressive LM (the GPT family). Construct with a
    ``causal=True`` config (gpt_lm enforces it)."""


def gpt_lm(size: str = "small", ring=None, tp=None, ep=None,
           vocab_shards: Optional[int] = None, **overrides) -> CausalLM:
    """GPT-style decoder-only LM. ``size``: the GPT-2 ladder
    (GPT2_SIZES) or "tiny" (test scale); ``ring``: the seq group's ring
    (``ProcessGroupRing``) for sequence parallelism, or None; ``tp``:
    the model axis's transport for tensor parallelism, or None; ``ep``:
    the expert group's transport of a MoE config (default ``tp``);
    ``vocab_shards``: ``shard_vocab``'s padding multiple (default the
    transport's size; a checkpoint's own model width where it was
    written wider); ``overrides`` are TransformerConfig fields."""
    overrides["causal"] = True
    if size in GPT2_SIZES:
        cfg = gpt2_small_config(**{**GPT2_SIZES[size], **overrides})
    elif size == "tiny":
        cfg = tiny_config(**overrides)
    else:
        raise ValueError(f"gpt_lm size {size!r}; have "
                         f"({', '.join(GPT2_SIZES)}, tiny)")
    return CausalLM(cfg, ring, tp, vocab_shards=vocab_shards, ep=ep)


def moe_lm(size: str = "small", ring=None, tp=None, ep=None,
           vocab_shards: Optional[int] = None, **overrides) -> CausalLM:
    """``gpt_lm`` with every MLP a top-k MoE (JAX's ``moe_lm``):
    ``moe_experts`` defaults to ``MOE_DEFAULT_EXPERTS``."""
    overrides.setdefault("moe_experts", MOE_DEFAULT_EXPERTS)
    if overrides["moe_experts"] <= 0:
        raise ValueError("moe_lm needs moe_experts > 0")
    return gpt_lm(size, ring, tp, ep, vocab_shards, **overrides)


def bert_base_mlm(size: str = "base", ring=None, tp=None, ep=None,
                  **overrides) -> BertMLM:
    """BERT masked LM. ``size``: "base" (BERT-base) or "tiny" (test
    scale); ``overrides`` are TransformerConfig fields."""
    if size == "base":
        cfg = bert_base_config(**overrides)
    elif size == "tiny":
        cfg = tiny_config(**overrides)
    else:
        raise ValueError(f"bert_mlm size {size!r}; have ('base', 'tiny')")
    return BertMLM(cfg, ring, tp, ep=ep)


def bert_tiny_mlm(ring=None, tp=None, **overrides) -> BertMLM:
    return BertMLM(tiny_config(**overrides), ring, tp)

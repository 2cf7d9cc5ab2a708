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
  here each rank is told its offset);
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
  ``serve/engine.py`` check on the host).

Parameter names mirror the flax tree (``layer_0.attn.qkv`` for
``layer_0/attn/qkv``), so ``interop.params_from_flax`` is a fixed
renaming plus the kernel reshapes. Options of the JAX config that the
port does not run yet (``moe_experts``, ``kv_cache_quant``,
``shard_vocab``) raise ``NotImplementedError`` instead of being ignored.
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

from tensorflow_distributed_tpu_torch.ops.flash_attention import (
    NEG_INF, attention, window_keep)
from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    full_attention, ring_attention)

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
    # Options of the JAX model this port does not run yet (ROADMAP.md
    # queue A); any value but the default raises.
    moe_experts: int = 0
    kv_cache_quant: str = "none"
    shard_vocab: bool = False


_NOT_PORTED = {"moe_experts": 0, "kv_cache_quant": "none",
               "shard_vocab": False}
_CHOICES = {"pos_emb": ("learned", "rope"), "mlp_variant": ("gelu", "swiglu"),
            "norm": ("layernorm", "rmsnorm"), "remat_policy": ("full", "dots")}


def kv_heads(cfg: TransformerConfig) -> int:
    """The K/V head count: n_kv_heads, with None and 0 meaning n_heads
    (MHA), as in JAX."""
    return cfg.n_kv_heads or cfg.n_heads


def _check_config(cfg: TransformerConfig) -> None:
    for name, default in _NOT_PORTED.items():
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"TransformerConfig.{name}={getattr(cfg, name)!r} is not "
                f"ported to PyTorch yet (see ROADMAP.md queue A)")
    for name, choices in _CHOICES.items():
        if getattr(cfg, name) not in choices:
            raise ValueError(f"{name} {getattr(cfg, name)!r}; have {choices}")
    if cfg.n_heads % kv_heads(cfg):
        raise ValueError(f"n_heads {cfg.n_heads} not divisible by "
                         f"n_kv_heads {kv_heads(cfg)}")
    if cfg.pos_emb == "rope" and (cfg.d_model // cfg.n_heads) % 2:
        raise ValueError(f"rope needs an even head dim, got "
                         f"Dh={cfg.d_model // cfg.n_heads}")


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
    collection's ``key`` and ``value`` leaves): per layer, K and V of
    shape [B, max_len, nk, Dh] in the compute dtype, nk the K/V head
    count (``kv_heads``: n_heads for MHA, fewer under GQA, never widened
    to n_heads). ``decode=True`` forwards write into it in place."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int,
              device=None) -> "KVCache":
        shape = (batch, cfg.max_len, kv_heads(cfg),
                 cfg.d_model // cfg.n_heads)

        def layers():
            return [torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
                    for _ in range(cfg.n_layers)]

        return cls(layers(), layers())

    def put_row(self, row: "KVCache", slot: int) -> None:
        """Replace row ``slot`` wholesale with the one row of ``row`` (the
        JAX engine's ``_insert_row``): nothing of the stale row survives,
        not even in masked columns, where a non-finite value would still
        reach P @ V as 0 * NaN."""
        for dst, src in zip(self.k + self.v, row.k + row.v):
            dst[slot].copy_(src[0])

    def zero_(self) -> None:
        for t in self.k + self.v:
            t.zero_()

    def nbytes(self) -> int:
        """Device bytes of every layer's K and V: 2 * n_layers * B *
        max_len * nk * Dh * the dtype's size."""
        return sum(t.numel() * t.element_size() for t in self.k + self.v)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax Dense(dtype=...): input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


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


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, ring=None):
        super().__init__()
        if _is_ring(ring) and cfg.attn_window:
            raise ValueError(
                "attn_window with mesh.seq > 1 is not implemented (the "
                "zigzag ring schedule is not windowed); at W << L the "
                "window IS the long-context strategy — use mesh.seq == 1")
        self.cfg = cfg
        self.ring = ring
        h, dh, nk = cfg.n_heads, cfg.d_model // cfg.n_heads, kv_heads(cfg)
        # flax DenseGeneral kernels: qkv [D, 3, H, dh] (MHA: one fused
        # projection, the param tree of before GQA), or q [D, H, dh] and
        # kv [D, 2, nk, dh] (GQA); out [H, dh, D]. Here flattened to
        # Linear's [out, in].
        if nk == h:
            self.qkv = nn.Linear(cfg.d_model, 3 * h * dh)
        else:
            self.q = nn.Linear(cfg.d_model, h * dh)
            self.kv = nn.Linear(cfg.d_model, 2 * nk * dh)
        self.out = nn.Linear(h * dh, cfg.d_model)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """With ``kv`` (this layer's cache K and V), the decode branch at
        ``positions``; the training path otherwise. ``rope``: RoPE's
        (cos, sin) at ``positions`` (``rope_angles``) when it is on."""
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
            out = _cached_attend(q, k, v, positions, kv, cfg.attn_window)
        elif _is_ring(self.ring):
            out = ring_attention(q, widen(k), widen(v), self.ring,
                                 causal=cfg.causal)
        else:
            out = attention(q, widen(k), widen(v), causal=cfg.causal,
                            window=cfg.attn_window)
        return _dense(out.reshape(B, L, h * dh), self.out, dtype)


def _grouped_attend(q, k_cache, v_cache, bias):
    """JAX's ``grouped_attend`` over a narrow cache: q [B, L, H, Dh]
    against K, V [B, max_len, nk, Dh] in f32, the H / nk query heads of
    a group sharing their K/V head, with the additive ``bias`` [1 | B,
    L, max_len]; the cache is never widened to H heads."""
    B, L, h, dh = q.shape
    nk = k_cache.shape[2]
    qg = q.reshape(B, L, nk, h // nk, dh).float()
    s = torch.einsum("bqngd,bknd->bngqk", qg, k_cache.float())
    s = s / math.sqrt(dh) + bias[:, None, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bknd->bqngd", p, v_cache.float())
    return o.reshape(B, L, h, dh).to(q.dtype)


def _cached_attend(q, k, v, positions, kv, window):
    """The JAX decode branch's dense layout: write each row's L new K, V
    at ``start_b .. start_b + L - 1`` in one indexed write per cache,
    then attend the L queries against the whole cache, columns outside
    each query's (pos - window, pos] band masked by a NEG_INF bias
    [1 | B, L, max_len]: ``full_attention`` for MHA, ``_grouped_attend``
    for a narrow (GQA) cache. ``start_b`` is ``positions[b, 0]`` clamped
    to ``[0, max_len - L]``, as ``dynamic_update_slice`` clamps it in
    JAX: a write that would run past the cache end lands shifted back
    over the row's last columns. The band reads the unclamped
    positions."""
    k_cache, v_cache = kv
    B, L = q.shape[:2]
    pos = positions.long()
    steps = torch.arange(L, device=q.device)
    start = pos[:, :1].expand(B, 1).clamp(0, k_cache.shape[1] - L)
    cols = start + steps                                     # [B, L]
    rows = torch.arange(B, device=q.device)[:, None].expand(B, L)
    k_cache[rows, cols] = k.to(k_cache.dtype)
    v_cache[rows, cols] = v.to(v_cache.dtype)
    keys = torch.arange(k_cache.shape[1], device=q.device)
    keep = window_keep(pos[:, :, None], keys, window)
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    if k_cache.shape[2] != q.shape[2]:
        return _grouped_attend(q, k_cache, v_cache, bias)
    return full_attention(q, k_cache, v_cache, bias)


class Mlp(nn.Module):
    """flax ``Mlp``: ``down(gelu(up(x)))``, or with ``mlp_variant=
    "swiglu"`` ``down(silu(gate(x)) * up(x))``; gate and up are d_ff
    wide, every product in the compute dtype."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.mlp_variant == "swiglu":
            self.gate = nn.Linear(cfg.d_model, cfg.d_ff)
        self.up = nn.Linear(cfg.d_model, cfg.d_ff)
        self.down = nn.Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.cfg.compute_dtype
        if self.cfg.mlp_variant == "swiglu":
            x = F.silu(_dense(x, self.gate, dtype)) * _dense(x, self.up, dtype)
        else:
            x = F.gelu(_dense(x, self.up, dtype), approximate="tanh")
        return _dense(x, self.down, dtype)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, cfg: TransformerConfig, ring=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _make_norm(cfg)
        self.attn = SelfAttention(cfg, ring)
        self.ln2 = _make_norm(cfg)
        self.mlp = Mlp(cfg)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                positions: Optional[torch.Tensor] = None,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        y = self.attn(_norm(x, self.ln1).to(cfg.compute_dtype), positions,
                      kv, rope)
        x = x + dropout(y, cfg.dropout_rate, train, generator)
        y = self.mlp(_norm(x, self.ln2).to(cfg.compute_dtype))
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
                 generator: Optional[torch.Generator], positions, rope
                 ) -> torch.Tensor:
    """``block`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward. Dropout draws from
    ``generator``, which ``preserve_rng_state`` does not restore: the
    recompute draws from a copy of its state at the block's entry (the
    masks of the forward), and the live generator stays where the
    forward left it (under gradient accumulation the next microbatch's
    forward runs before this backward). Under a ring every rank
    recomputes its blocks in the same order, so the recompute's permutes
    pair up as the forward's did."""
    entry = generator.get_state() if generator is not None else None
    calls = 0

    def run(x):
        nonlocal calls
        gen = generator
        if calls and entry is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(entry)
        calls += 1
        return block(x, train, gen, positions, None, rope)

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


class TransformerLM(nn.Module):
    """Transformer LM backbone: tokens [B, L] int -> logits [B, L, V] f32.
    With a ``ring`` of S processes, tokens are this rank's contiguous
    [B, L/S] block of the sequence and the outputs cover that block."""

    def __init__(self, cfg: TransformerConfig, ring=None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.ring = ring
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if cfg.pos_emb == "learned":
            self.pos_emb = nn.Embedding(cfg.max_len, cfg.d_model)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg, ring))
        self.ln_f = _make_norm(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = _LmHead(cfg.d_model, cfg.vocab_size)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The flax initializers: normal(0.02) for kernels and embedding
        tables, zeros for biases, ones/zeros for the norms' scales and
        offsets, drawn in module order from ``generator``."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, INIT_STD, generator=generator)
            elif isinstance(module, (nn.LayerNorm, RMSNorm)):
                module.weight.fill_(1.0)
            if isinstance(module, (nn.Linear, nn.LayerNorm)):
                module.bias.zero_()

    def forward(self, tokens: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False, decode: bool = False,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None, page_table=None):
        """Logits [B, L, V] f32, or with ``features_only`` the head's
        pieces (features [B, L, D] in the compute dtype, W [V, D], bias
        [V] or None). ``positions`` ([1 | B, L] int) index the learned
        position table or set RoPE's angles (default: the block's
        arange); ``decode=True`` requires them and a ``cache`` (see the
        module docstring)."""
        cfg = self.cfg
        B, L = tokens.shape
        if page_table is not None:
            raise NotImplementedError(
                "the paged KV cache (page_table) is not ported to PyTorch "
                "yet (see ROADMAP.md queue A)")
        if decode:
            if not cfg.causal:
                raise ValueError("decode=True needs a causal config")
            if positions is None:
                raise ValueError("decode=True requires positions")
            if cache is None:
                raise ValueError("decode=True requires a KVCache")
            if _is_ring(self.ring):
                raise ValueError("decode=True runs on one process "
                                 "(mesh.seq must be 1)")
        elif cache is not None:
            raise ValueError("a KVCache is read only with decode=True")
        shards, start = ((self.ring.size, self.ring.index * L)
                         if _is_ring(self.ring) else (1, 0))
        if L * shards > cfg.max_len:
            raise ValueError(f"sequence length {L * shards} > max_len "
                             f"{cfg.max_len}")
        if positions is None:
            positions = start + torch.arange(L, device=tokens.device)[None]
        x = self.tok_emb(tokens)
        rope = None
        if cfg.pos_emb == "rope":
            # One (cos, sin) for every layer: JAX computes the same
            # angles in each.
            rope = rope_angles(positions, cfg.d_model // cfg.n_heads,
                               cfg.rope_theta)
        else:
            x = x + self.pos_emb(positions)
        x = x.to(cfg.compute_dtype)
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = _remat_block(block, x, train, generator, positions, rope)
            else:
                kv = (cache.k[i], cache.v[i]) if decode else None
                x = block(x, train, generator, positions, kv, rope)
        x = _norm(x, self.ln_f).to(cfg.compute_dtype)
        if features_only:
            if cfg.tie_embeddings:
                return x, self.tok_emb.weight, None
            return x, self.lm_head.weight, self.lm_head.bias
        if cfg.tie_embeddings:
            table = self.tok_emb.weight.to(cfg.compute_dtype)
            return F.linear(x, table).float()
        return self.lm_head(x).float()


class CausalLM(TransformerLM):
    """Decoder-only autoregressive LM (the GPT family). Construct with a
    ``causal=True`` config (gpt_lm enforces it)."""


def gpt_lm(size: str = "small", ring=None, **overrides) -> CausalLM:
    """GPT-style decoder-only LM. ``size``: the GPT-2 ladder
    (GPT2_SIZES) or "tiny" (test scale); ``ring``: the seq group's ring
    (``ProcessGroupRing``) for sequence parallelism, or None;
    ``overrides`` are TransformerConfig fields."""
    overrides["causal"] = True
    if size in GPT2_SIZES:
        cfg = gpt2_small_config(**{**GPT2_SIZES[size], **overrides})
    elif size == "tiny":
        cfg = tiny_config(**overrides)
    else:
        raise ValueError(f"gpt_lm size {size!r}; have "
                         f"({', '.join(GPT2_SIZES)}, tiny)")
    return CausalLM(cfg, ring)

"""Ring attention: sequence-parallel exact attention, the port of
``parallel/ring_attention.py``.

Each of S ring positions holds Q, K, V for its L/S-token block. K,V
blocks rotate around the ring while queries stay put; every step folds
one block's streaming-softmax partial (row max m, exp-sum l, unnormalized
weighted V o, all f32) into a running accumulator (``_merge``), so no
position ever holds the full [L, L] scores or the full K,V. The causal
ring uses the zigzag schedule (``_zigzag_causal_shard``): the sequence is
cut into 2S half-blocks and position d owns halves d and 2S-1-d, which
skips the fully-masked future blocks and keeps every position equally
busy. The local compute (``_partial_attend``) runs the partial-softmax
kernels (``ops.flash_attention.flash_attention_partial``) where the
shapes allow.

Where JAX's ``shard_map`` body calls ``lax.ppermute``, the per-position
bodies here are written once against a small transport, a ``Ring``:

- ``ProcessGroupRing(group)``: one position per process (the training
  path; NCCL between cards, gloo on the CPU). Each permute is one
  ``dist.batch_isend_irecv`` of a paired send and receive, inside an
  ``autograd.Function`` whose backward runs the inverse permutation (the
  transpose JAX's autodiff takes).
- ``StackedRing(S)``: all S positions in one process, stacked on a
  leading dim; a permute is a differentiable index along that dim (the
  counterpart of the JAX tests' virtual 8-device mesh; tests and
  ``chip_smoke.py`` use it).

The bodies select per position with ``torch.where`` on a rank TENSOR,
never with a Python branch on the rank, so every process builds the same
graph and issues its sends and receives in the same order, forward and
backward (a branch would let two ranks wait on different permutes).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_MASK = -1e30  # large-finite additive mask (matches ops.flash_attention)
SCHEDULES = ("zigzag", "naive")

Perm = Sequence[Tuple[int, int]]  # (source position, destination position)


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor]):
    """One Q-block vs one K,V-block partial attention.

    q: [..., Lq, H, D]; k, v: [..., Lk, H, D]; bias: [..., Lq, Lk]
    (broadcast over heads) or None. Returns (scores_max [..., H, Lq],
    exp-sum [..., H, Lq], weighted-V [..., Lq, H, D]) — the
    streaming-softmax partials, all f32.
    """
    d = q.shape[-1]
    s = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float())
    s = s * (1.0 / d ** 0.5)
    if bias is not None:
        s = s + bias.unsqueeze(-3)
    # Clamp the row max away from the mask value so a fully-masked row
    # (a skipped causal ring block) yields p == exp(-huge) == 0 and a
    # zero l contribution.
    m = torch.clamp(s.amax(dim=-1), min=0.1 * _MASK)   # [..., H, Lq]
    p = torch.exp(s - m[..., None])                     # [..., H, Lq, Lk]
    l = p.sum(dim=-1)                                   # [..., H, Lq]
    o = torch.einsum("...hqk,...khd->...qhd", p.to(v.dtype).float(),
                     v.float())
    return m, l, o


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., H, Lq] row statistics -> [..., Lq, H, 1], broadcastable
    against [..., Lq, H, D] outputs."""
    return x.transpose(-1, -2)[..., None]


def _partial_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False):
    """Block partial attention for the ring: the partial kernels
    (``flash_attention_partial``; their plain versions for CPU tensors)
    when ``supported()`` passes, ``_block_attend`` otherwise. Leading
    dims beyond [B] (the stacked ring positions) fold into the batch."""
    from tensorflow_distributed_tpu_torch.ops.flash_attention import (
        flash_attention_partial, supported)

    Lq, H, D = q.shape[-3:]
    Lk = k.shape[-3]
    if supported(Lq, Lk, D):
        lead = q.shape[:-3]
        m, l, o = flash_attention_partial(
            q.reshape(-1, Lq, H, D), k.reshape(-1, Lk, H, D),
            v.reshape(-1, Lk, H, D), causal=causal)
        return (m.reshape(lead + (H, Lq)), l.reshape(lead + (H, Lq)),
                o.reshape(lead + (Lq, H, D)))
    bias = causal_bias(Lq, Lk, q.device) if causal else None
    return _block_attend(q, k, v, bias)


def _merge(m1, l1, o1, m2, l2, o2):
    """Fold two streaming-softmax partials into one."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * _rows(a1) + o2 * _rows(a2)
    return m, l, o


def causal_bias(Lq: int, Lk: int, device=None) -> torch.Tensor:
    """[1, Lq, Lk] additive causal mask — the one construction shared by
    the ring path and the test oracles."""
    full = torch.full((Lq, Lk), _MASK, dtype=torch.float32, device=device)
    return torch.triu(full, diagonal=1)[None]


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain exact attention (the single-position path, the decode
    cache's attend and the test oracle). q: [B, Lq, H, D]; k, v: [B, Lk,
    H, D]; mask: [1 | B, Lq, Lk] additive or None. Computes in f32 and
    returns q's dtype. A fully-masked query row returns zeros (not NaN)."""
    m, l, o = _block_attend(q, k, v, mask)
    l_safe = torch.clamp(l, min=torch.finfo(torch.float32).tiny)
    return (o / _rows(l_safe)).to(q.dtype)


# ------------------------------------------------------------- transports

def _inverse(perm: Perm) -> List[Tuple[int, int]]:
    return [(dst, src) for src, dst in perm]


def _check_perm(perm: Perm, size: int) -> None:
    srcs = sorted(s for s, _ in perm)
    dsts = sorted(d for _, d in perm)
    if srcs != list(range(size)) or dsts != list(range(size)):
        raise ValueError(f"ring permute needs a permutation of "
                         f"range({size}), got {list(perm)}")


class StackedRing:
    """All S ring positions in one process. ``shard`` stacks the S
    contiguous sequence blocks of a [B, L, ...] tensor on a new leading
    dim ([S, B, L/S, ...]); ``ppermute`` moves position src's slab to
    position dst along that dim (differentiable: an index)."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = size

    def rank(self, device) -> torch.Tensor:
        """Each stacked position's index: [S] int."""
        return torch.arange(self.size, device=device)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        B, L = x.shape[:2]
        n = L // self.size
        return x.reshape(B, self.size, n, *x.shape[2:]).transpose(0, 1)

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        S, B, n = x.shape[:3]
        return x.transpose(0, 1).reshape(B, S * n, *x.shape[3:])

    def ppermute(self, x: torch.Tensor, perm: Perm) -> torch.Tensor:
        _check_perm(perm, self.size)
        src_of = [0] * self.size
        for src, dst in perm:
            src_of[dst] = src
        return x[torch.tensor(src_of, device=x.device)]


class _PermuteExchange(torch.autograd.Function):
    """One ring permute across processes; its backward sends the
    cotangent back along the inverse permutation."""

    @staticmethod
    def forward(ctx, x, ring, perm):
        ctx.ring, ctx.perm = ring, perm
        return ring._exchange(x, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring._exchange(g, _inverse(ctx.perm)), None, None


class ProcessGroupRing:
    """One ring position per process of ``group`` (the default group
    when None): position = rank in the group. The caller holds its own
    contiguous block, so ``shard``/``unshard`` are the identity."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def rank(self, device) -> torch.Tensor:
        """This process's position: a 0-dim int tensor."""
        return torch.tensor(self.index, device=device)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _peer(self, position: int) -> int:
        return (position if self.group is None
                else dist.get_global_rank(self.group, position))

    def _exchange(self, x: torch.Tensor, perm: Perm) -> torch.Tensor:
        _check_perm(perm, self.size)
        dst = dict(perm)[self.index]
        src = next(s for s, d in perm if d == self.index)
        if dst == self.index:  # a fixed point: no one else sends here
            return x.clone()
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self._peer(dst), self.group),
               dist.P2POp(dist.irecv, out, self._peer(src), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def ppermute(self, x: torch.Tensor, perm: Perm) -> torch.Tensor:
        return _PermuteExchange.apply(x, self, perm)


def _where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Per-position select: ``pred`` is [] (one position) or [S]
    (stacked), broadcast over the trailing dims of a and b."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim()
                                                       - pred.dim())), a, b)


# ---------------------------------------------------------------- schedules
# Per-position bodies on the LOCAL blocks q, k, v: [..., n, H, D] (n =
# L/S; the leading dims are [B] under ProcessGroupRing, [S, B] under
# StackedRing). They return the local output block, same shape.

def _naive_shard(ring, q, k, v, causal: bool):
    """Contiguous-block ring: every position visits every K,V block; for
    causal, future blocks are fully masked and contribute zero partials
    (the clamp in _block_attend) — correct but ~2x the minimal causal
    FLOPs and imbalanced (position S-1 is busy every step)."""
    S = ring.size
    i = ring.rank(q.device)
    n = q.shape[-3]
    rows = torch.arange(n, device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]

    def bias_for(src):
        if not causal:
            return None
        lead = src.reshape(src.shape + (1, 1))
        ii = i.reshape(i.shape + (1, 1))
        allowed = (ii * n + rows) >= (lead * n + cols)
        return torch.where(allowed, 0.0, _MASK).unsqueeze(-3)

    m, l, o = _block_attend(q, k, v, bias_for(i))
    k_rot, v_rot = k, v
    perm = [(d, (d + 1) % S) for d in range(S)]
    for s in range(1, S):
        k_rot = ring.ppermute(k_rot, perm)
        v_rot = ring.ppermute(v_rot, perm)
        src = (i - s) % S
        m, l, o = _merge(m, l, o, *_block_attend(q, k_rot, v_rot,
                                                 bias_for(src)))
    return (o / _rows(l)).to(q.dtype)


def _zigzag_perms(S: int):
    """The contiguous <-> zigzag half-block permutations. Position d
    holds contiguous halves h_{2d}, h_{2d+1}; the zigzag owner of h_g is
    g if g < S else 2S-1-g. Route A moves early halves (d -> owner of
    h_{2d}), route B late ones (d -> owner of h_{2d+1})."""
    dst_a = [2 * d if 2 * d < S else 2 * S - 1 - 2 * d for d in range(S)]
    dst_b = [2 * d + 1 if 2 * d + 1 < S else 2 * S - 2 - 2 * d
             for d in range(S)]
    perm_a = [(d, dst_a[d]) for d in range(S)]
    perm_b = [(d, dst_b[d]) for d in range(S)]
    return perm_a, perm_b


def _zigzag_causal_shard(ring, q, k, v):
    """Load-balanced causal ring (the zigzag schedule).

    Position d owns the half-block pair {h_d, h_{2S-1-d}} (size nh =
    L/(2S)): one early half, one mirrored late half. Step 0 attends the
    two triangular diagonal blocks and late-vs-early; every step s > 0
    does exactly two unmasked half-attends (the late half against the
    rotated early K half, and one of {early x rotated early (src < d),
    late x rotated late (src > d)}, chosen elementwise). Total per
    position: 2S + 1 half-attends against the naive 4S. The model's
    activations stay contiguously sharded, so the conversion to and
    from the zigzag layout happens here, as two half-block permutes
    each way.
    """
    S = ring.size
    d = ring.rank(q.device)
    perm_a, perm_b = _zigzag_perms(S)
    even = d % 2 == 0

    def to_zigzag(x):
        """Local contiguous block -> (early half g1, late half g2)."""
        nh = x.shape[-3] // 2
        recv_a = ring.ppermute(x[..., :nh, :, :], perm_a)
        recv_b = ring.ppermute(x[..., nh:, :, :], perm_b)
        # Even positions get their early half via route A, odd via B.
        return _where(even, recv_a, recv_b), _where(even, recv_b, recv_a)

    def from_zigzag(o1, o2):
        """(g1, g2) outputs -> the local contiguous block."""
        first = ring.ppermute(_where(even, o1, o2), _inverse(perm_a))
        second = ring.ppermute(_where(even, o2, o1), _inverse(perm_b))
        return torch.cat([first, second], dim=-3)

    q1, q2 = to_zigzag(q)
    k1, k2 = to_zigzag(k)
    v1, v2 = to_zigzag(v)
    # s = 0: both diagonals (in-half triangles: the q and k halves share
    # global offsets) + late-vs-early (q2's rows start past every k1 col).
    acc1 = _partial_attend(q1, k1, v1, causal=True)
    acc2 = _merge(*_partial_attend(q2, k2, v2, causal=True),
                  *_partial_attend(q2, k1, v1))
    perm = [(i, (i + 1) % S) for i in range(S)]
    k1r, k2r, v1r, v2r = k1, k2, v1, v2
    for s in range(1, S):
        k1r = ring.ppermute(k1r, perm)
        k2r = ring.ppermute(k2r, perm)
        v1r = ring.ppermute(v1r, perm)
        v2r = ring.ppermute(v2r, perm)
        src = (d - s) % S
        # Always needed: late q vs rotated early k (fully visible).
        acc2 = _merge(*acc2, *_partial_attend(q2, k1r, v1r))
        # Exactly one of {q1 x k1r (src < d), q2 x k2r (src > d)} is
        # needed, fully visible: select operands, attend once, fold
        # into the accumulator the same predicate picks.
        pred = src < d
        part = _partial_attend(_where(pred, q1, q2), _where(pred, k1r, k2r),
                               _where(pred, v1r, v2r))
        new1 = _merge(*acc1, *part)
        new2 = _merge(*acc2, *part)
        acc1 = tuple(_where(pred, a, b) for a, b in zip(new1, acc1))
        acc2 = tuple(_where(pred, b, a) for a, b in zip(new2, acc2))

    def finish(acc):
        _, l, o = acc
        return (o / _rows(l)).to(q.dtype)

    return from_zigzag(finish(acc1), finish(acc2))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ring, mask: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   schedule: str = "zigzag") -> torch.Tensor:
    """Exact attention with the sequence axis split over ``ring``'s
    positions.

    q, k, v are what the caller holds: under ``StackedRing`` the global
    [B, L, H, D] tensors (split into S blocks here and joined again),
    under ``ProcessGroupRing`` this process's contiguous [B, L/S, H, D]
    block. ``causal=True`` applies the autoregressive mask across the
    ring; with ``schedule="zigzag"`` (default) the load-balanced
    half-block schedule skips the fully-masked future blocks;
    ``schedule="naive"`` keeps the visit-everything formulation (also
    the fallback when the local block length is odd). An arbitrary
    ``mask`` is not supported with S > 1. A 1-position ring is
    ``full_attention``.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"ring schedule {schedule!r}; have {SCHEDULES}")
    if ring.size == 1:
        if causal:
            cmask = causal_bias(q.shape[1], k.shape[1], q.device)
            mask = cmask if mask is None else mask + cmask
        return full_attention(q, k, v, mask)
    if mask is not None:
        raise NotImplementedError(
            "arbitrary masks don't survive the ring rotation; only "
            "causal=True is supported with a sharded seq axis")
    qs, ks, vs = ring.shard(q), ring.shard(k), ring.shard(v)
    if causal and schedule == "zigzag" and qs.shape[-3] % 2 == 0:
        out = _zigzag_causal_shard(ring, qs, ks, vs)
    else:
        out = _naive_shard(ring, qs, ks, vs, causal)
    return ring.unshard(out)

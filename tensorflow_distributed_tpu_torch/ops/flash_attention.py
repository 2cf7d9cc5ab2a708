"""Flash attention: hand-written CUDA kernels for Hopper, with their
plain PyTorch versions beside them.

The port of ``tensorflow_distributed_tpu/ops/flash_attention.py``. Three
kernels (``csrc/flash_attention.cu``) replace the three Pallas TPU
kernels on the single-shard path:

- ``flash_fwd``  <- ``_fwd_kernel``: streaming-softmax forward, emits the
  output and the per-row logsumexp (flat ``[BH, L]`` f32);
- ``flash_dq``   <- ``_dq_kernel``: dQ recomputed from the saved lse;
- ``flash_dkv``  <- ``_dkv_kernel``: dK and dV, one CTA per key tile.

and three more the ring path (``parallel.ring_attention``) runs:

- ``flash_fwd_partial`` <- ``_fwd_partial_kernel``: one ring step's
  partial attention, the unnormalized output (f32) and the row max m and
  exp-sum l, without the lse fold;
- ``flash_dq_partial``  <- ``_dq_partial_kernel``;
- ``flash_dkv_partial`` <- ``_dkv_partial_kernel``: the partial's
  gradients, with m as the stop-gradient stabilizer.

All six are three Hopper kernels (wgmma, TMA, mbarriers) in two forms:
``flash_fwd_hopper``, ``flash_dq_hopper`` and ``flash_dkv_hopper``. The
partial kernels are their ``PARTIAL`` instantiations: the forward keeps
o unnormalized in f32 and writes m (natural units) and l where the
normalized one writes o / l and lse; the backward takes (m, +dl) where
the normalized one takes (lse, -rowsum(dO*O)) and rounds the f32 dO to
bf16 inside the kernel.

``_FlashAttention`` and ``_FlashPartial`` (``torch.autograd.Function``s)
stand where ``jax.custom_vjp`` stood and save what ``_flash_fwd`` and
``_flash_partial_fwd`` save. Each wrapper launches its kernel for a CUDA
tensor (raising on anything the kernel does not take or on a failed
launch) and runs its plain version only for a CPU tensor; the tests and
the CPU path use the plain versions, and ``chip_smoke.py`` holds each
kernel against its plain version on the card. Each wrapper counts its
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tensorflow_distributed_tpu_torch.ops import cuda_ext
from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    full_attention)

NEG_INF = -1e30  # large-finite: avoids inf-inf=nan in masked rows
BLOCK = 64  # L and Lk must be multiples (the backward kernels' tile)
HEAD_DIMS = (64, 128)
KERNEL_DTYPE = torch.bfloat16


def window_keep(rows: torch.Tensor, cols: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """THE (row - window, row] causal-band predicate, shared by the
    kernels' plain versions and the plain dispatcher path. window 0 =
    unlimited history."""
    keep = cols <= rows
    if window:
        keep = keep & (cols > rows - window)
    return keep


def window_bias(rows: torch.Tensor, cols: torch.Tensor,
                window: int = 0) -> torch.Tensor:
    """Additive-bias form of window_keep ([1, Lq, Lk]-broadcastable,
    NEG_INF outside the band)."""
    keep = window_keep(rows, cols, window)
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)[None]


# ------------------------------------------------------- plain versions

def _scores(q, k, causal, window):
    """f32 scores of [BH, L, D] inputs, scaled then band-masked."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        L, Lk = q.shape[1], k.shape[1]
        rows = torch.arange(L, device=q.device)[:, None]
        cols = torch.arange(Lk, device=q.device)[None, :]
        s = s.masked_fill(~window_keep(rows, cols, window), NEG_INF)
    return s, scale


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              window: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_fwd``: q [BH, L, D], k, v [BH, Lk, D] ->
    (out [BH, L, D] in q's dtype, lse [BH, L] f32). Same numerics as the
    kernel: f32 scores and statistics, P cast to v's dtype before P.V."""
    s, _ = _scores(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _p_and_ds(q, k, v, do, row_sub, row_add, causal, window):
    """Backward block math (the JAX ``_p_and_ds`` over the whole
    sequence): p = exp(s - row_sub), ds = p * (dO.V^T + row_add) * scale.
    The normalized kernels pass (lse, -rowsum(dO*O)); the partial ones
    (m, +dl)."""
    s, scale = _scores(q, k, causal, window)
    p = torch.exp(s - row_sub.float()[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp + row_add.float()[..., None]) * scale


def _dq(ds, q, k):
    """dQ = dS.K with dS cast to k's dtype, in q's dtype."""
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def _dkv(p, ds, q, k, v, do):
    """dK = dS^T.Q, dV = P^T.dO, with P and dS cast to the operand dtype
    first (P to dO's: an f32 product where dO is f32)."""
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _neg_delta(out, do):
    return -(do.float() * out.float()).sum(dim=-1)


def flash_dq_reference(q, k, v, out, lse, do, causal=False, window=0):
    """Plain version of ``flash_dq``: dQ = dS.K, dS cast to k's dtype."""
    _, ds = _p_and_ds(q, k, v, do, lse, _neg_delta(out, do), causal, window)
    return _dq(ds, q, k)


def flash_dkv_reference(q, k, v, out, lse, do, causal=False, window=0):
    """Plain version of ``flash_dkv``: dK = dS^T.Q, dV = P^T.dO, with P
    and dS cast to the operand dtype first."""
    p, ds = _p_and_ds(q, k, v, do, lse, _neg_delta(out, do), causal, window)
    return _dkv(p, ds, q, k, v, do)


def flash_fwd_partial_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Plain version of ``flash_fwd_partial``: q [BH, L, D], k, v
    [BH, Lk, D] -> (o [BH, L, D] f32, unnormalized; m, l [BH, L] f32).
    ``causal`` is the in-block triangle (a ring's diagonal blocks). P is
    cast to v's dtype before P.V, as in the kernel."""
    s, _ = _scores(q, k, causal, 0)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return o, m[..., 0], p.sum(dim=-1)


def flash_dq_partial_reference(q, k, v, m, do, dl, causal=False):
    """Plain version of ``flash_dq_partial``: ds = p * (dO.V^T + dl) *
    scale with p = exp(s - m); dQ = dS.K. dO is taken in f32."""
    _, ds = _p_and_ds(q, k, v, do.float(), m, dl, causal, 0)
    return _dq(ds, q, k)


def flash_dkv_partial_reference(q, k, v, m, do, dl, causal=False):
    """Plain version of ``flash_dkv_partial``: dK = dS^T.Q, dV = P^T.dO
    with dO in f32 (so P stays f32 in dV, as in the JAX kernel)."""
    do = do.float()
    p, ds = _p_and_ds(q, k, v, do, m, dl, causal, 0)
    return _dkv(p, ds, q, k, v, do)


# -------------------------------------------------------------- kernels

def _kernel(name: str, n_ptrs: int) -> cuda_ext.Kernel:
    """An exported kernel of ``csrc/flash_attention.cu``: pointers, then
    (BH, L, Lk, D, scale, causal, window)."""
    return cuda_ext.Kernel("flash_attention", name,
                           [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4
                           + [ctypes.c_float] + [ctypes.c_int] * 2)


FLASH_FWD = _kernel("flash_fwd", 5)
FLASH_DQ = _kernel("flash_dq", 7)
FLASH_DKV = _kernel("flash_dkv", 8)
FLASH_FWD_PARTIAL = _kernel("flash_fwd_partial", 6)
FLASH_DQ_PARTIAL = _kernel("flash_dq_partial", 7)
FLASH_DKV_PARTIAL = _kernel("flash_dkv_partial", 8)
KERNELS = (FLASH_FWD, FLASH_DQ, FLASH_DKV)
PARTIAL_KERNELS = (FLASH_FWD_PARTIAL, FLASH_DQ_PARTIAL, FLASH_DKV_PARTIAL)


def reset_launch_counts() -> None:
    for kern in KERNELS + PARTIAL_KERNELS:
        kern.launches = 0


def build() -> str:
    """Build (or load) the kernel library; returns nvcc's output when
    this call built it."""
    return cuda_ext.build_log("flash_attention")


def _check_window(causal: bool, window: int) -> None:
    if window < 0 or (window and not causal):
        raise ValueError(f"window attention requires causal=True and "
                         f"window >= 0 (got causal={causal}, "
                         f"window={window})")


def _check_kernel_inputs(q, k, v, *tensors):
    """Shapes, dtype, device, contiguity and alignment that every kernel
    needs of q [BH, L, D], k, v [BH, Lk, D] and its other tensors."""
    BH, L, D = q.shape
    Lk = k.shape[1]
    if not supported(L, Lk, D) or q.dtype != KERNEL_DTYPE:
        raise ValueError(
            f"flash kernel: L={L}, Lk={Lk}, D={D}, dtype={q.dtype} not "
            f"supported (L, Lk multiples of {BLOCK}; D in {HEAD_DIMS}; "
            f"{KERNEL_DTYPE} only, see ROADMAP.md)")
    for t in (k, v):
        if t.dtype != q.dtype or t.shape != (BH, Lk, D):
            raise ValueError("flash kernel: k and v must match q's dtype "
                             "and be [BH, Lk, D]")
    for t in (q, k, v) + tensors:
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("flash kernel inputs must be contiguous and "
                             "on one device")
        if t.data_ptr() % 16:
            raise ValueError("flash kernel inputs must be 16-byte aligned")
    return BH, L, Lk, D


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, window: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: [BH, L, D] bf16 -> (out, lse [BH, L] f32)."""
    _check_window(causal, window)
    if cuda_ext.on_cpu("flash attention", q, k, v):
        return flash_attention_reference(q, k, v, causal, window)
    BH, L, Lk, D = _check_kernel_inputs(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((BH, L), dtype=torch.float32, device=q.device)
    FLASH_FWD((q, k, v, out, lse), BH, L, Lk, D, 1.0 / D ** 0.5, causal,
              window)
    return out, lse


def _check_bwd(q, k, v, out, lse, do):
    BH, L, D = q.shape
    if (out.shape != q.shape or do.shape != q.shape
            or out.dtype != q.dtype or do.dtype != q.dtype
            or lse.shape != (BH, L) or lse.dtype != torch.float32):
        raise ValueError("flash backward kernel: out/do must match q, "
                         "lse must be [BH, L] f32")


def flash_dq(q, k, v, out, lse, do, causal=False, window=0) -> torch.Tensor:
    """dQ kernel: the inputs of the forward plus (out, lse, dO)."""
    _check_window(causal, window)
    if cuda_ext.on_cpu("flash attention", q, k, v, out, lse, do):
        return flash_dq_reference(q, k, v, out, lse, do, causal, window)
    BH, L, Lk, D = _check_kernel_inputs(q, k, v, out, lse, do)
    _check_bwd(q, k, v, out, lse, do)
    dq = torch.empty_like(q)
    FLASH_DQ((q, k, v, out, lse, do, dq), BH, L, Lk, D, 1.0 / D ** 0.5,
             causal, window)
    return dq


def flash_dkv(q, k, v, out, lse, do, causal=False, window=0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: the inputs of the forward plus (out, lse, dO)."""
    _check_window(causal, window)
    if cuda_ext.on_cpu("flash attention", q, k, v, out, lse, do):
        return flash_dkv_reference(q, k, v, out, lse, do, causal, window)
    BH, L, Lk, D = _check_kernel_inputs(q, k, v, out, lse, do)
    _check_bwd(q, k, v, out, lse, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_DKV((q, k, v, out, lse, do, dk, dv), BH, L, Lk, D,
              1.0 / D ** 0.5, causal, window)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """[BH, L, D] attention whose forward and backward are the kernels
    (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq = flash_dq(q, k, v, out, lse, do, ctx.causal, ctx.window)
        dk, dv = flash_dkv(q, k, v, out, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def _packed(x: torch.Tensor) -> torch.Tensor:
    """[B, n, H, D] -> [B*H, n, D], contiguous and 16-byte aligned (a
    view of an offset slice, as the ring's half-blocks, may be neither)."""
    B, n, H, D = x.shape
    y = x.permute(0, 2, 1, 3).reshape(B * H, n, D)
    if not y.is_contiguous() or y.data_ptr() % 16:
        y = y.clone(memory_format=torch.contiguous_format)
    return y


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: int = 0) -> torch.Tensor:
    """Fused attention. q, k, v: [B, L, H, D] -> [B, L, H, D].

    Differentiable (the kernels both ways). On a CUDA device the shapes
    must pass ``supported()`` and the dtype must be bf16, else the
    kernels raise; ``window > 0`` needs ``causal``."""
    B, L, H, D = q.shape
    out = _FlashAttention.apply(_packed(q), _packed(k), _packed(v), causal,
                                window)
    return out.reshape(B, H, L, D).permute(0, 2, 1, 3)


# ----------------------------------------------- partial-softmax variant
# Ring attention's building block: one Q block against one K,V block,
# returning the streaming-softmax triple (o unnormalized, m, l) that the
# ring merges across steps. m is the stabilizer the merged result does
# not depend on, so it carries no gradient; with p = exp(s - m),
# ds = p * (dO.V^T + dl) * scale (the normalized backward with -delta
# replaced by the incoming dl).

def flash_fwd_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial forward kernel: [BH, L, D] bf16 -> (o [BH, L, D] f32
    unnormalized, m [BH, L] f32, l [BH, L] f32)."""
    if cuda_ext.on_cpu("flash attention", q, k, v):
        return flash_fwd_partial_reference(q, k, v, causal)
    BH, L, Lk, D = _check_kernel_inputs(q, k, v)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((BH, L, D), **f32)
    m = torch.empty((BH, L), **f32)
    l = torch.empty((BH, L), **f32)
    FLASH_FWD_PARTIAL((q, k, v, o, m, l), BH, L, Lk, D, 1.0 / D ** 0.5,
                      causal, 0)
    return o, m, l


def _check_partial_bwd(q, k, v, m, do, dl):
    BH, L, Lk, D = _check_kernel_inputs(q, k, v, m, do, dl)
    for t in (m, dl):
        if t.shape != (BH, L) or t.dtype != torch.float32:
            raise ValueError("flash partial kernel: m and dl must be "
                             "[BH, L] f32")
    if do.shape != q.shape or do.dtype != torch.float32:
        raise ValueError("flash partial backward kernel: dO must be "
                         "[BH, L, D] f32")
    return BH, L, Lk, D


def flash_dq_partial(q, k, v, m, do, dl, causal=False) -> torch.Tensor:
    """Partial dQ kernel: the forward's inputs plus (m, dO f32, dl) ->
    dQ in q's dtype."""
    if cuda_ext.on_cpu("flash attention", q, k, v, m, do, dl):
        return flash_dq_partial_reference(q, k, v, m, do, dl, causal)
    BH, L, Lk, D = _check_partial_bwd(q, k, v, m, do, dl)
    dq = torch.empty_like(q)
    FLASH_DQ_PARTIAL((q, k, v, m, dl, do, dq), BH, L, Lk, D, 1.0 / D ** 0.5,
                     causal, 0)
    return dq


def flash_dkv_partial(q, k, v, m, do, dl, causal=False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial dK/dV kernel: the forward's inputs plus (m, dO f32, dl) ->
    (dK, dV) in k's dtype."""
    if cuda_ext.on_cpu("flash attention", q, k, v, m, do, dl):
        return flash_dkv_partial_reference(q, k, v, m, do, dl, causal)
    BH, L, Lk, D = _check_partial_bwd(q, k, v, m, do, dl)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_DKV_PARTIAL((q, k, v, m, dl, do, dk, dv), BH, L, Lk, D,
                      1.0 / D ** 0.5, causal, 0)
    return dk, dv


class _FlashPartial(torch.autograd.Function):
    """[BH, L, D] partial attention -> (o, m, l) whose forward and
    backward are the partial kernels (their plain versions for CPU
    tensors). m is non-differentiable: its cotangent is dropped, as the
    JAX ``_flash_partial_bwd`` drops ``_dm``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, m, l = flash_fwd_partial(q, k, v, causal)
        ctx.save_for_backward(q, k, v, m)
        ctx.causal = causal
        ctx.mark_non_differentiable(m)
        return o, m, l

    @staticmethod
    def backward(ctx, do, _dm, dl):
        q, k, v, m = ctx.saved_tensors
        do = do.float().contiguous()
        dl = dl.float().contiguous()
        dq = flash_dq_partial(q, k, v, m, do, dl, ctx.causal)
        dk, dv = flash_dkv_partial(q, k, v, m, do, dl, ctx.causal)
        return dq, dk, dv, None


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False):
    """Partial (unnormalized) attention for the ring path.

    q: [B, Lq, H, D]; k, v: [B, Lk, H, D]. Returns the streaming-softmax
    partials in ``parallel.ring_attention._block_attend``'s layout:
    (m [B, H, Lq] f32, l [B, H, Lq] f32, o [B, Lq, H, D] f32,
    unnormalized). Differentiable through the partial kernels (their
    plain versions for CPU tensors); ``causal`` applies the in-block
    triangle (the ring's diagonal blocks)."""
    B, L, H, D = q.shape
    o, m, l = _FlashPartial.apply(_packed(q), _packed(k), _packed(v), causal)
    o = o.reshape(B, H, L, D).permute(0, 2, 1, 3)
    return m.reshape(B, H, L), l.reshape(B, H, L), o


def supported(L: int, Lk: int, D: int) -> bool:
    """Whether the kernels handle these shapes (else use the plain path,
    parallel.ring_attention.full_attention). A shape gate only, as in
    the JAX package: a supported shape on a CUDA device in another dtype
    than bf16 raises in the kernel wrappers instead of taking the plain
    path."""
    return (L % BLOCK == 0 and Lk % BLOCK == 0 and L > 0 and Lk > 0
            and D in HEAD_DIMS)


def window_edge(L: int, Lk: int, causal: bool, window: int) -> bool:
    """Whether some query row has no key in its band: with causal, a
    window and L >= Lk + window, rows from Lk + window - 1 on see no
    key. The plain path's dense softmax averages all of V there (as the
    JAX package's XLA path does); the kernels do not, so the dispatcher
    sends these shapes to the plain path."""
    return causal and window > 0 and L >= Lk + window


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, *, causal: bool = False,
              window: int = 0) -> torch.Tensor:
    """Dispatcher for the single-device attention path: the flash
    kernels (their plain versions for CPU tensors) when there is no
    mask, ``supported()`` passes and no row falls past the window's edge
    (``window_edge``), the plain ``full_attention`` otherwise."""
    # The plain path must not silently drop the window either.
    _check_window(causal, window)
    B, L, H, D = q.shape
    Lk = k.shape[1]
    if (mask is None and supported(L, Lk, D)
            and not window_edge(L, Lk, causal, window)):
        return flash_attention(q, k, v, causal=causal, window=window)
    if causal:
        cmask = window_bias(torch.arange(L, device=q.device)[:, None],
                            torch.arange(Lk, device=q.device)[None, :],
                            window)
        mask = cmask if mask is None else mask + cmask
    return full_attention(q, k, v, mask)

"""Flash attention: hand-written CUDA kernels for Hopper, with their
plain PyTorch versions beside them.

The port of ``tensorflow_distributed_tpu/ops/flash_attention.py``. Three
kernels (``csrc/flash_attention.cu``) replace the three Pallas TPU
kernels on the single-shard path:

- ``flash_fwd``  <- ``_fwd_kernel``: streaming-softmax forward, emits the
  output and the per-row logsumexp (flat ``[BH, L]`` f32);
- ``flash_dq``   <- ``_dq_kernel``: dQ recomputed from the saved lse;
- ``flash_dkv``  <- ``_dkv_kernel``: dK and dV, one CTA per key tile.

``_FlashAttention`` (a ``torch.autograd.Function``) stands where
``jax.custom_vjp`` stood and saves (q, k, v, out, lse) as ``_flash_fwd``
does. Each wrapper launches its kernel for a CUDA tensor (raising on
anything the kernel does not take or on a failed launch) and runs its
plain version only for a CPU tensor; the tests and the CPU path use the
plain versions, and ``chip_smoke.py`` holds each kernel against its
plain version on the card. Each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tensorflow_distributed_tpu_torch.ops import cuda_ext
from tensorflow_distributed_tpu_torch.parallel.ring_attention import (
    full_attention)

NEG_INF = -1e30  # large-finite: avoids inf-inf=nan in masked rows
BLOCK = 64  # query and key rows per kernel tile; L and Lk must divide it
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


def _p_and_ds(q, k, v, out, lse, do, causal, window):
    """Backward block math (the JAX ``_p_and_ds`` over the whole
    sequence): p = exp(s - lse), ds = p * (dO.V^T - rowsum(dO*O)) * scale."""
    s, scale = _scores(q, k, causal, window)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    return p, p * (dp - delta) * scale


def flash_dq_reference(q, k, v, out, lse, do, causal=False, window=0):
    """Plain version of ``flash_dq``: dQ = dS.K, dS cast to k's dtype."""
    _, ds = _p_and_ds(q, k, v, out, lse, do, causal, window)
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, out, lse, do, causal=False, window=0):
    """Plain version of ``flash_dkv``: dK = dS^T.Q, dV = P^T.dO, with P
    and dS cast to the operand dtype first."""
    p, ds = _p_and_ds(q, k, v, out, lse, do, causal, window)
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


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
KERNELS = (FLASH_FWD, FLASH_DQ, FLASH_DKV)


def reset_launch_counts() -> None:
    for kern in KERNELS:
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


def _check_kernel_inputs(q, k, *tensors):
    BH, L, D = q.shape
    Lk = k.shape[1]
    if not supported(L, Lk, D) or q.dtype != KERNEL_DTYPE:
        raise ValueError(
            f"flash kernel: L={L}, Lk={Lk}, D={D}, dtype={q.dtype} not "
            f"supported (L, Lk multiples of {BLOCK}; D in {HEAD_DIMS}; "
            f"{KERNEL_DTYPE} only, see ROADMAP.md)")
    for t in (q, k) + tensors:
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
    for t in (k, v):
        if t.dtype != q.dtype or t.shape != (BH, Lk, D):
            raise ValueError("flash kernel: k and v must match q's dtype "
                             "and be [BH, Lk, D]")
    out = torch.empty_like(q)
    lse = torch.empty((BH, L), dtype=torch.float32, device=q.device)
    FLASH_FWD((q, k, v, out, lse), BH, L, Lk, D, 1.0 / D ** 0.5, causal,
              window)
    return out, lse


def _check_bwd(q, k, v, out, lse, do):
    BH, L, D = q.shape
    if (out.shape != q.shape or do.shape != q.shape
            or out.dtype != q.dtype or do.dtype != q.dtype
            or k.dtype != q.dtype or v.dtype != q.dtype
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: int = 0) -> torch.Tensor:
    """Fused attention. q, k, v: [B, L, H, D] -> [B, L, H, D].

    Differentiable (the kernels both ways). On a CUDA device the shapes
    must pass ``supported()`` and the dtype must be bf16, else the
    kernels raise; ``window > 0`` needs ``causal``."""
    B, L, H, D = q.shape

    def pack(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, x.shape[1], D)

    out = _FlashAttention.apply(pack(q), pack(k), pack(v), causal, window)
    return out.reshape(B, H, L, D).permute(0, 2, 1, 3)


def supported(L: int, Lk: int, D: int) -> bool:
    """Whether the kernels handle these shapes (else use the plain path,
    parallel.ring_attention.full_attention). A shape gate only, as in
    the JAX package: a supported shape on a CUDA device in another dtype
    than bf16 raises in the kernel wrappers instead of taking the plain
    path."""
    return (L % BLOCK == 0 and Lk % BLOCK == 0 and L > 0 and Lk > 0
            and D in HEAD_DIMS)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, *, causal: bool = False,
              window: int = 0) -> torch.Tensor:
    """Dispatcher for the single-device attention path: the flash
    kernels (their plain versions for CPU tensors) when there is no mask
    and ``supported()`` passes, the plain ``full_attention`` otherwise."""
    # The plain path must not silently drop the window either.
    _check_window(causal, window)
    B, L, H, D = q.shape
    Lk = k.shape[1]
    if mask is None and supported(L, Lk, D):
        return flash_attention(q, k, v, causal=causal, window=window)
    if causal:
        cmask = window_bias(torch.arange(L, device=q.device)[:, None],
                            torch.arange(Lk, device=q.device)[None, :],
                            window)
        mask = cmask if mask is None else mask + cmask
    return full_attention(q, k, v, mask)

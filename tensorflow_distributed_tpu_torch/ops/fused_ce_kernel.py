"""Fused linear + cross-entropy ("flash CE"): hand-written CUDA kernels
for Hopper, with their plain PyTorch versions beside them.

The port of ``tensorflow_distributed_tpu/ops/fused_ce_kernel.py``. Three
kernels (``csrc/fused_ce.cu``) replace the three Pallas TPU kernels:

- ``fused_ce_fwd`` <- ``_fwd_kernel``: per token (ce, correct, lse) from
  an online logsumexp over vocab tiles; the [T, V] logits never reach
  device memory;
- ``fused_ce_dx``  <- ``_dx_kernel``: dx from logits recomputed against
  the saved lse;
- ``fused_ce_dw``  <- ``_dw_kernel``: dW and db, one CTA per vocab tile.

``FusedCETokens`` (a ``torch.autograd.Function``) stands where
``jax.custom_vjp`` stood. Its forward casts W to the features' dtype
once (bf16 on the card) and keeps that copy for the backward; it takes
the targets as int32 and returns dW and db in f32, straight from the
kernels' accumulators. dlogits is rounded to the features' dtype before
the dx and dW products (as ``ops/fused_ce.py``'s scan does); db sums the
unrounded f32 dlogits (as the TPU kernel does). Per-token vectors are
flat [T] (the TPU's lane-replicated [T, 8] rows are a Mosaic layout
rule), and the vocab is not padded: the kernels mask columns >= V.

Each wrapper launches its kernel for CUDA tensors (raising on anything
the kernel does not take, or on a failed launch) and runs its plain
version only for CPU tensors. Each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tensorflow_distributed_tpu_torch.ops import cuda_ext

NEG_INF = -1e30  # large-finite; matches ops/flash_attention.py
KERNEL_DTYPE = torch.bfloat16

Tensor = torch.Tensor


def kernel_supported(T: int, D: int) -> bool:
    """Shape gate of the kernel path (else the scan formulation,
    ops/fused_ce.py). D must give 16-byte bf16 rows; any token count
    works, the kernels mask the ragged token tile themselves. Accepts
    every (T, D) the JAX gate accepts (T % min(256, T) == 0 and
    D % 8 == 0) and more."""
    return T > 0 and D > 0 and D % 8 == 0


# ------------------------------------------------------- plain versions

def _logits(x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
    """Dense f32 logits of the inputs: x [T, D], w [V, D], b [V] | None."""
    logits = x.float() @ w.float().T
    return logits if b is None else logits + b.float()


def fused_ce_fwd_reference(x: Tensor, w: Tensor, b: Optional[Tensor],
                           t: Tensor, vocab_size: int, eps: float = 0.0
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of ``fused_ce_fwd``: (ce, correct, lse), each [T]
    f32; smoothing as the (1-eps)/eps-uniform target mixture, argmax the
    first maximum."""
    logits = _logits(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t.long()[:, None])[:, 0]
    if eps:
        gold = (1.0 - eps) * gold + (eps / vocab_size) * logits.sum(dim=-1)
    correct = (logits.argmax(dim=-1) == t.long()).float()
    return lse - gold, correct, lse


def _dlogits(x, w, b, t, lse, coef, vocab_size, eps) -> Tensor:
    """coef * (softmax - (1-eps) onehot - eps/V) in f32: the TPU
    ``_dlogits`` over the whole vocab."""
    logits = _logits(x, w, b)
    d = torch.exp(logits - lse.float()[:, None]).scatter_add(
        -1, t.long()[:, None],
        torch.full((len(t), 1), eps - 1.0, device=x.device))
    if eps:
        d -= eps / vocab_size
    return d * coef.float()[:, None]


def fused_ce_dx_reference(x, w, b, t, lse, coef, vocab_size: int,
                          eps: float = 0.0) -> Tensor:
    """Plain version of ``fused_ce_dx``: dx [T, D] in x's dtype, from
    dlogits rounded to x's dtype."""
    d = _dlogits(x, w, b, t, lse, coef, vocab_size, eps).to(x.dtype)
    return (d.float() @ w.float()).to(x.dtype)


def fused_ce_dw_reference(x, w, b, t, lse, coef, vocab_size: int,
                          eps: float = 0.0
                          ) -> Tuple[Tensor, Optional[Tensor]]:
    """Plain version of ``fused_ce_dw``: dW [V, D] f32 from dlogits
    rounded to x's dtype, db [V] f32 (None without bias) from the f32
    dlogits."""
    d = _dlogits(x, w, b, t, lse, coef, vocab_size, eps)
    dw = d.to(x.dtype).float().T @ x.float()
    return dw, (None if b is None else d.sum(dim=0))


# -------------------------------------------------------------- kernels

def _kernel(name: str, n_ptrs: int) -> cuda_ext.Kernel:
    """An exported kernel of ``csrc/fused_ce.cu``: pointers, then
    (T, D, V, eps)."""
    return cuda_ext.Kernel("fused_ce", name, [ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * 3 + [ctypes.c_float])


FUSED_CE_FWD = _kernel("fused_ce_fwd", 7)
FUSED_CE_DX = _kernel("fused_ce_dx", 7)
FUSED_CE_DW = _kernel("fused_ce_dw", 8)
KERNELS = (FUSED_CE_FWD, FUSED_CE_DX, FUSED_CE_DW)


def reset_launch_counts() -> None:
    for kern in KERNELS:
        kern.launches = 0


def build() -> str:
    """Build (or load) the kernel library; returns nvcc's output when
    this call built it."""
    return cuda_ext.build_log("fused_ce")


def _check_kernel_inputs(x, w, b, t, vocab_size, *rows):
    """Shapes, dtypes, device and layout the kernels take; (T, D)."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError("fused CE kernel: x must be [T, D] and w [V, D]")
    T, D = x.shape
    if (not kernel_supported(T, D) or x.dtype != KERNEL_DTYPE
            or w.dtype != KERNEL_DTYPE or tuple(w.shape) != (vocab_size, D)):
        raise ValueError(
            f"fused CE kernel: x {tuple(x.shape)} {x.dtype}, w "
            f"{tuple(w.shape)} {w.dtype}, vocab {vocab_size} not supported "
            f"(x [T, D] and w [V, D] in {KERNEL_DTYPE}, D a multiple of 8)")
    if t.dtype != torch.int32 or tuple(t.shape) != (T,):
        raise ValueError("fused CE kernel: targets must be [T] int32")
    if b is not None and (b.dtype != torch.float32
                          or tuple(b.shape) != (vocab_size,)):
        raise ValueError("fused CE kernel: bias must be [V] float32")
    for r in rows:
        if r.dtype != torch.float32 or tuple(r.shape) != (T,):
            raise ValueError("fused CE kernel: lse and coef must be [T] "
                             "float32")
    for ten in (x, w, b, t) + rows:
        if ten is None:
            continue
        if not ten.is_contiguous() or ten.device != x.device:
            raise ValueError("fused CE kernel inputs must be contiguous "
                             "and on one device")
        if ten.data_ptr() % 16:
            raise ValueError("fused CE kernel inputs must be 16-byte "
                             "aligned")
    return T, D


def fused_ce_fwd(x: Tensor, w: Tensor, b: Optional[Tensor], t: Tensor,
                 vocab_size: int, eps: float = 0.0
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Forward kernel: x [T, D] bf16, w [V, D] bf16, b [V] f32 | None,
    t [T] int32 -> (ce, correct, lse), each [T] f32."""
    if cuda_ext.on_cpu("fused CE", x, w, b, t):
        return fused_ce_fwd_reference(x, w, b, t, vocab_size, eps)
    T, D = _check_kernel_inputs(x, w, b, t, vocab_size)
    ce, correct, lse = (torch.empty(T, dtype=torch.float32, device=x.device)
                        for _ in range(3))
    FUSED_CE_FWD((x, w, b, t, ce, correct, lse), T, D, vocab_size,
                 float(eps))
    return ce, correct, lse


def fused_ce_dx(x, w, b, t, lse, coef, vocab_size: int,
                eps: float = 0.0) -> Tensor:
    """dx kernel: the forward's inputs plus (lse, coef) -> dx [T, D] in
    x's dtype."""
    if cuda_ext.on_cpu("fused CE", x, w, b, t, lse, coef):
        return fused_ce_dx_reference(x, w, b, t, lse, coef, vocab_size, eps)
    T, D = _check_kernel_inputs(x, w, b, t, vocab_size, lse, coef)
    dx = torch.empty_like(x)
    FUSED_CE_DX((x, w, b, t, lse, coef, dx), T, D, vocab_size, float(eps))
    return dx


def fused_ce_dw(x, w, b, t, lse, coef, vocab_size: int, eps: float = 0.0
                ) -> Tuple[Tensor, Optional[Tensor]]:
    """dW/db kernel: the forward's inputs plus (lse, coef) -> (dW [V, D]
    f32, db [V] f32, or None when b is None)."""
    if cuda_ext.on_cpu("fused CE", x, w, b, t, lse, coef):
        return fused_ce_dw_reference(x, w, b, t, lse, coef, vocab_size, eps)
    T, D = _check_kernel_inputs(x, w, b, t, vocab_size, lse, coef)
    dw = torch.empty((vocab_size, D), dtype=torch.float32, device=x.device)
    db = (None if b is None else
          torch.empty(vocab_size, dtype=torch.float32, device=x.device))
    FUSED_CE_DW((x, w, b, t, lse, coef, dw, db), T, D, vocab_size,
                float(eps))
    return dw, db


class FusedCETokens(torch.autograd.Function):
    """Per-token (ce, correct) of ``x @ w.T (+ b)``: the port of
    ``fused_ce_tokens``. x [T, D]; w [V, D] (any float dtype, cast to
    x's dtype once here and kept for the backward); b [V] | None;
    t [T] int32. Differentiable w.r.t. x, w and b through ce; correct is
    a metric."""

    @staticmethod
    def forward(ctx, x, w, b, t, vocab_size, eps):
        wk = w.to(x.dtype).contiguous()
        bk = None if b is None else b.float().contiguous()
        ce, correct, lse = fused_ce_fwd(x, wk, bk, t, vocab_size, eps)
        ctx.save_for_backward(x, wk, bk, t, lse)
        ctx.vocab_size, ctx.eps = vocab_size, eps
        ctx.mark_non_differentiable(correct)
        return ce, correct

    @staticmethod
    def backward(ctx, g_ce, _g_correct):
        x, wk, bk, t, lse = ctx.saved_tensors
        coef = g_ce.float().contiguous()
        dx = fused_ce_dx(x, wk, bk, t, lse, coef, ctx.vocab_size, ctx.eps)
        dw, db = fused_ce_dw(x, wk, bk, t, lse, coef, ctx.vocab_size,
                             ctx.eps)
        # dW and db are f32; autograd casts them to W's and b's dtype.
        return dx, dw, db, None, None, None


def fused_ce_sums_kernel(x: Tensor, w: Tensor, bias: Optional[Tensor],
                         targets: Tensor, mask: Tensor, vocab_size: int, *,
                         label_smoothing: float = 0.0
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Drop-in for ops.fused_ce.fused_ce_sums on kernel-supported
    shapes: (ce_sum, correct, mask_sum), differentiable w.r.t. x, w and
    bias. x: [..., D] (leading dims flatten to the token axis); w [V, D];
    targets and mask: x's leading shape."""
    D = x.shape[-1]
    T = x.numel() // D
    if not kernel_supported(T, D):
        raise ValueError(f"fused_ce kernel unsupported for T={T}, D={D}; "
                         f"use ops.fused_ce.fused_ce_sums")
    xf = x.reshape(T, D).contiguous()
    tf = targets.reshape(T).to(torch.int32).contiguous()
    mf = mask.reshape(T).float()
    ce, correct = FusedCETokens.apply(xf, w, bias, tf, vocab_size,
                                      float(label_smoothing))
    return (ce * mf).sum(), (correct * mf).sum(), mf.sum()

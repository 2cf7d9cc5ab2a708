"""Fused (vocab-chunked) linear + softmax cross-entropy: the port of the
single-rank part of ``tensorflow_distributed_tpu/ops/fused_ce.py``.

The dense head writes the full ``[B, L, V]`` logits in the forward and a
gradient of the same size in the backward. This op runs the head product
inside the loss instead, ``chunk`` vocab columns at a time, with an
online softmax (the flash recurrence over vocab chunks): the forward
keeps only per-token running (max, normalizer, gold logit, logit sum,
argmax), and the backward (a ``torch.autograd.Function``, where the JAX
package has a ``custom_vjp``) recomputes each chunk's logits against the
saved logsumexp. Peak logits memory drops from ``[B, L, V]`` to
``[B, L, chunk]``.

The JAX package computes this formulation in XLA, outside any Pallas
kernel; here it is a Python loop over chunks of plain tensor code. Each
chunk's product takes the features' dtype for its operands and
accumulates in f32 (the JAX ``preferred_element_type=f32``): the
operands are cast to the features' dtype and multiplied as f32.

Semantics match ``ops.losses.masked_ce_sums`` on ``x @ w.T (+ bias)``:
unnormalized (ce_sum, correct, mask_sum), f32 statistics, first-max
argmax, label smoothing as the (1-eps)/eps-uniform target mixture.
``w`` is the head matrix as the port stores both heads, ``[V, D]`` (the
JAX ``w_vocab_axis`` is always 0 here).

**Vocab-parallel form** (``mesh.model > 1``: the head is a TP model's
``VocabShards``), JAX's ``vocab_parallel_ce_sums``: each model rank runs
the chunk loop over its own vocab rows (``rows`` a rank, rank m's ids
from ``m * rows``) and keeps partial per-token stats; the global
logsumexp is a max and a sum over the model ranks, and the first-max
argmax keeps the smallest id among the ranks' maxima (JAX's ``pmin``).
``ShardCEGivenLSE`` is this rank's CE term given that global lse, an
``autograd.Function`` with no collective inside: its backward recomputes
the rank's chunks against the global lse, and the features' gradient is
summed over the ranks by ``copy_to_tp``'s backward. Rows past the
vocabulary are masked, and a rank whose every row is padding gives
(m = NEG_INF, l = 0), which the combine weights to zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    VocabShards)

Tensor = torch.Tensor
INT_BIG = 2 ** 30

# Large-finite stand-in for -inf in the running-max init (matches
# ops/fused_ce_kernel.py's NEG_INF): a chunk whose every column is
# padding then yields (m=NEG_INF, l=0) instead of NaN.
NEG_INF = -1e30
IMPLS = ("scan", "kernel")


def _pad_vocab(w: Tensor, bias: Optional[Tensor], rows: int, chunk: int):
    """Zero-pad the vocab rows of ``w`` (and ``bias``) from ``rows`` up
    to a chunk multiple so every step slices a full chunk."""
    pad = (-rows) % chunk
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
        if bias is not None:
            bias = F.pad(bias, (0, pad))
    return w, bias, rows + pad


def _chunk_logits(x: Tensor, w: Tensor, bias: Optional[Tensor], c0: int,
                  chunk: int, vocab_size: int, off: int = 0,
                  rows: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """f32 logits of local vocab columns [c0, c0+chunk) of a head (or a
    rank's shard of ``rows`` rows whose first global id is ``off``); a
    column is valid when it is a real row of the shard and its global id
    a real vocab entry, else it reads -inf. Returns (logits [...,
    chunk], valid [chunk])."""
    wc = w[c0:c0 + chunk].to(x.dtype)
    logits = x.float() @ wc.float().T
    if bias is not None:
        logits = logits + bias[c0:c0 + chunk].float()
    local = torch.arange(c0, c0 + chunk, device=x.device)
    valid = off + local < vocab_size
    if rows is not None:
        valid = valid & (local < rows)
    return logits.masked_fill(~valid, -torch.inf), valid


def _scan_stats(x, wp, bp, targets, n_chunks, chunk, vocab_size,
                label_smoothing, off=0, rows=None):
    """The forward chunk loop: per-token (m, l, gold, lsum, best_v,
    best_i) over the whole head, or a shard of ``rows`` rows from global
    id ``off`` (``best_i`` in global ids, -1 where the shard saw
    nothing)."""
    rows = vocab_size if rows is None else rows
    shape = targets.shape
    targets = targets.long()
    f32 = dict(dtype=torch.float32, device=x.device)
    m = torch.full(shape, NEG_INF, **f32)
    l = torch.zeros(shape, **f32)
    gold = torch.zeros(shape, **f32)
    lsum = torch.zeros(shape, **f32)
    best_v = torch.full(shape, -torch.inf, **f32)
    best_i = torch.full(shape, -1, dtype=torch.long, device=x.device)
    for c in range(n_chunks):
        c0 = c * chunk
        logits, valid = _chunk_logits(x, wp, bp, c0, chunk, vocab_size, off,
                                      rows)
        # Online logsumexp (the flash recurrence over vocab columns).
        cmax = logits.amax(dim=-1)
        new_m = torch.maximum(m, cmax)
        l = l * torch.exp(m - new_m) + torch.exp(
            logits - new_m[..., None]).sum(dim=-1)
        m = new_m
        # Gold logit: at most one (rank, chunk) contains each target.
        idx = targets - off - c0
        hit = (idx >= 0) & (idx < chunk) & (c0 + idx < rows)
        g = logits.gather(-1, idx.clamp(0, chunk - 1)[..., None])[..., 0]
        gold = gold + torch.where(hit, g, 0.0)
        # Smoothing needs sum(logits) over the real vocab only.
        if label_smoothing:
            lsum = lsum + torch.where(valid, logits, 0.0).sum(dim=-1)
        # Running argmax: strict > keeps the first max.
        cidx = logits.argmax(dim=-1) + off + c0
        take = cmax > best_v
        best_v = torch.where(take, cmax, best_v)
        best_i = torch.where(take, cidx, best_i)
    return m, l, gold, lsum, best_v, best_i


def _finish(lse, gold, lsum, best_i, targets, mask, vocab_size,
            label_smoothing):
    """(ce_sum, correct, mask_sum) from finished stats."""
    if label_smoothing:
        gold = ((1.0 - label_smoothing) * gold
                + (label_smoothing / vocab_size) * lsum)
    fmask = mask.float()
    ce_sum = ((lse - gold) * fmask).sum()
    correct = ((best_i == targets.long()).float() * fmask).sum()
    return ce_sum, correct, fmask.sum()


def _bwd_scan(x, wp, bp, targets, lse, coef, n_chunks, chunk, vocab_size,
              label_smoothing, off=0, rows=None):
    """The backward chunk loop: recompute each chunk's logits against
    the saved (global) lse, form coef * (softmax - smoothed onehot),
    rounded to x's dtype, and accumulate (dx f32, per-chunk dW and db);
    on a shard (``off``, ``rows``) dx is this rank's part."""
    rows = vocab_size if rows is None else rows
    targets = targets.long()
    scale = coef[..., None]
    lead = tuple(range(x.dim() - 1))
    cols = torch.arange(chunk, device=x.device)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw_chunks, db_chunks = [], []
    for c in range(n_chunks):
        c0 = c * chunk
        logits, valid = _chunk_logits(x, wp, bp, c0, chunk, vocab_size, off,
                                      rows)
        p = torch.exp(logits - lse[..., None])  # -inf columns -> exactly 0
        idx = targets - off - c0
        hit = ((idx >= 0) & (idx < chunk) & (c0 + idx < rows))[..., None]
        onehot = hit & (cols == idx.clamp(0, chunk - 1)[..., None])
        dlogits = p - (1.0 - label_smoothing) * onehot.float()
        if label_smoothing:
            dlogits = dlogits - (label_smoothing / vocab_size) * valid.float()
        dlogits = (dlogits * scale).to(x.dtype).float()
        wc = wp[c0:c0 + chunk].to(x.dtype).float()
        dx = dx + dlogits @ wc
        dw_chunks.append(torch.einsum("...c,...d->cd", dlogits, x.float()))
        db_chunks.append(dlogits.sum(dim=lead))
    return dx, torch.stack(dw_chunks), torch.stack(db_chunks)


def _reassemble_dw(dw_chunks, db_chunks, rows, padded_rows, w_dtype, bias):
    """Stacked per-chunk head grads -> the [rows]-sliced dW (and db)."""
    dw = dw_chunks.reshape(padded_rows, -1)[:rows].to(w_dtype)
    db = (None if bias is None else
          db_chunks.reshape(padded_rows)[:rows].to(bias.dtype))
    return dw, db


class FusedCESums(torch.autograd.Function):
    """(ce_sum, correct, mask_sum) of ``x @ w.T (+ bias)`` by the chunk
    loop; only ce_sum is differentiable (w.r.t. x, w and bias)."""

    @staticmethod
    def forward(ctx, x, w, bias, targets, mask, vocab_size, chunk,
                label_smoothing):
        wp, bp, vpad = _pad_vocab(w, bias, vocab_size, chunk)
        m, l, gold, lsum, _, best_i = _scan_stats(
            x, wp, bp, targets, vpad // chunk, chunk, vocab_size,
            label_smoothing)
        lse = m + torch.log(l)
        ce_sum, correct, n = _finish(lse, gold, lsum, best_i, targets, mask,
                                     vocab_size, label_smoothing)
        ctx.save_for_backward(x, w, bias, targets, mask, lse)
        ctx.vocab_size, ctx.chunk = vocab_size, chunk
        ctx.label_smoothing = label_smoothing
        ctx.mark_non_differentiable(correct, n)
        return ce_sum, correct, n

    @staticmethod
    def backward(ctx, g_ce, _g_correct, _g_n):
        x, w, bias, targets, mask, lse = ctx.saved_tensors
        vocab_size, chunk = ctx.vocab_size, ctx.chunk
        wp, bp, vpad = _pad_vocab(w, bias, vocab_size, chunk)
        coef = mask.float() * g_ce
        dx, dw_chunks, db_chunks = _bwd_scan(
            x, wp, bp, targets, lse, coef, vpad // chunk, chunk, vocab_size,
            ctx.label_smoothing)
        dw, db = _reassemble_dw(dw_chunks, db_chunks, vocab_size, vpad,
                                w.dtype, bias)
        return dx.to(x.dtype), dw, db, None, None, None, None, None


def fused_ce_sums(x: Tensor, w: Tensor, bias: Optional[Tensor],
                  targets: Tensor, mask: Tensor, vocab_size: int,
                  chunk: int, label_smoothing: float = 0.0
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Unnormalized masked-CE pieces of ``x @ w.T (+ bias)`` without
    materializing the logits: (ce_sum, correct_sum, mask_sum), the
    contract of ops.losses.masked_ce_sums.

    x: [..., D] features (compute dtype); w: [V, D] head matrix (the
    untied ``lm_head.weight`` or the tied ``tok_emb.weight``); targets
    and mask: [...]; ``chunk``: vocab columns per step (the peak-logits
    knob)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be > 0, got {chunk}")
    return FusedCESums.apply(x, w, bias, targets, mask, vocab_size, chunk,
                             float(label_smoothing))


class ShardCEGivenLSE(torch.autograd.Function):
    """One model rank's CE term given the global logsumexp:
    ``-sum_t mask_t * smoothed_gold_shard(t)`` (the caller adds ``sum(mask
    * lse)`` once and sums these over the ranks). Its backward is the
    exact gradient of the global masked CE restricted to this shard's
    columns, ``mask * (softmax - smoothed onehot)`` against the saved
    lse; no collective runs inside (JAX's ``_shard_ce_given_lse``)."""

    @staticmethod
    def forward(ctx, x, w, bias, targets, mask, lse, off, vocab_size, chunk,
                label_smoothing):
        rows = w.shape[0]
        wp, bp, rpad = _pad_vocab(w, bias, rows, chunk)
        _, _, gold, lsum, _, _ = _scan_stats(
            x, wp, bp, targets, rpad // chunk, chunk, vocab_size,
            label_smoothing, off, rows)
        if label_smoothing:
            gold = ((1.0 - label_smoothing) * gold
                    + (label_smoothing / vocab_size) * lsum)
        ctx.save_for_backward(x, w, bias, targets, mask, lse)
        ctx.off, ctx.vocab_size, ctx.chunk = off, vocab_size, chunk
        ctx.label_smoothing = label_smoothing
        return -(gold * mask.float()).sum()

    @staticmethod
    def backward(ctx, g_ce):
        x, w, bias, targets, mask, lse = ctx.saved_tensors
        rows, chunk = w.shape[0], ctx.chunk
        wp, bp, rpad = _pad_vocab(w, bias, rows, chunk)
        dx, dw_chunks, db_chunks = _bwd_scan(
            x, wp, bp, targets, lse, mask.float() * g_ce, rpad // chunk,
            chunk, ctx.vocab_size, ctx.label_smoothing, ctx.off, rows)
        dw, db = _reassemble_dw(dw_chunks, db_chunks, rows, rpad, w.dtype,
                                bias)
        return (dx.to(x.dtype), dw, db) + (None,) * 7


def vocab_parallel_ce_sums(x: Tensor, head: VocabShards, targets: Tensor,
                           mask: Tensor, chunk: int,
                           label_smoothing: float = 0.0
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """The Megatron vocab-parallel fused CE (see the module docstring):
    (ce_sum, correct, mask_sum) over this rank's tokens, replicated over
    the model ranks. ``x`` [..., D] is replicated; ``head`` holds this
    process's ranks' head rows (and bias rows)."""
    tp, V, rows = head.tp, head.vocab_size, head.rows
    xs = tp.copy_to_tp(x)
    biases = head.biases or [None] * len(head.parts)
    with torch.no_grad():
        stats = []
        for xi, w, b, off in zip(xs, head.parts, biases, head.offsets()):
            wp, bp, rpad = _pad_vocab(w.detach(), None if b is None
                                      else b.detach(), rows, chunk)
            stats.append(_scan_stats(xi.detach(), wp, bp, targets,
                                     rpad // chunk, chunk, V, 0.0, off,
                                     rows))
        top = tp.max([st[0] for st in stats])
        lse = top + torch.log(tp.sum([st[1] * torch.exp(st[0] - top)
                                      for st in stats]))
        # First max across ranks: the highest value, ties to the smallest
        # global id; a rank that saw nothing holds (-inf, -1).
        best_v = tp.max([st[4] for st in stats])
        best_i = tp.min([torch.where((st[4] == best_v) & (st[5] >= 0),
                                     st[5], INT_BIG) for st in stats])
    fmask = mask.float()
    ce_sum = tp.reduce_from_tp([
        ShardCEGivenLSE.apply(xi, w, b, targets, mask, lse, off, V, chunk,
                              float(label_smoothing))
        for xi, w, b, off in zip(xs, head.parts, biases, head.offsets())])
    ce_sum = ce_sum + (lse * fmask).sum()
    correct = ((best_i == targets.long()).float() * fmask).sum()
    return ce_sum, correct, fmask.sum()


def fused_ce_sums_by(impl: str, x: Tensor, w: Tensor,
                     bias: Optional[Tensor], targets: Tensor, mask: Tensor,
                     *, vocab_size: int, chunk: int,
                     label_smoothing: float = 0.0
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """(ce_sum, correct, mask_sum) of the fused head by ``impl``: "scan"
    (this module's chunk loop, every shape) or "kernel" (the fused-CE
    kernels, ops/fused_ce_kernel.py: the logits never reach device
    memory; raises on a shape ``kernel_supported`` refuses; ``chunk`` is
    not used). A TP model's sharded head (``VocabShards``) takes the
    vocab-parallel form of the scan; the kernels want the whole head, as
    JAX's."""
    if isinstance(w, VocabShards):
        if impl != "scan":
            raise ValueError(
                "ce_impl='kernel' requires mesh.model == 1 (the "
                "Mosaic kernel wants the whole head per device); the "
                "default ce_impl='scan' runs the Megatron vocab-"
                "parallel form over the model axis instead")
        return vocab_parallel_ce_sums(x, w, targets, mask, chunk,
                                      label_smoothing)
    if impl == "kernel":
        from tensorflow_distributed_tpu_torch.ops.fused_ce_kernel import (
            fused_ce_sums_kernel)
        return fused_ce_sums_kernel(x, w, bias, targets, mask, vocab_size,
                                    label_smoothing=label_smoothing)
    if impl == "scan":
        return fused_ce_sums(x, w, bias, targets, mask, vocab_size, chunk,
                             label_smoothing)
    raise ValueError(f"impl {impl!r}; have {IMPLS}")


def fused_masked_cross_entropy(x: Tensor, w: Tensor,
                               bias: Optional[Tensor], targets: Tensor,
                               mask: Tensor, *, vocab_size: int, chunk: int,
                               label_smoothing: float = 0.0,
                               impl: str = "scan") -> Tuple[Tensor, Tensor]:
    """Mean masked CE and accuracy from the fused pieces: the drop-in for
    masked_softmax_cross_entropy + masked_accuracy when the caller holds
    features instead of logits. Returns (loss, accuracy); ``impl`` as in
    :func:`fused_ce_sums_by`."""
    ce_sum, correct, n = fused_ce_sums_by(
        impl, x, w, bias, targets, mask, vocab_size=vocab_size, chunk=chunk,
        label_smoothing=label_smoothing)
    n = n.clamp(min=1.0)
    return ce_sum / n, correct / n

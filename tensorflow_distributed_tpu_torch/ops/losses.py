"""Cross-entropy and accuracy: the port of ``ops/losses.py``.

The reference's classification loss (mean softmax cross-entropy over
int labels, with a label-smoothing knob) and argmax accuracy, and the
masked sequence losses of the LM families. Computed in float32
regardless of the model's compute dtype, as the JAX package does.
Argmax takes the first maximum, as ``jnp.argmax`` does.

``masked_ce_sums`` also takes vocab-sharded logits (a TP model's
``VocabShards``): the Megatron vocab-parallel form that JAX gets from
GSPMD over the same function. Each model rank holds its vocab columns'
logits; the global max is a max over the ranks, and the exp-sum, the
gold logit and the smoothing sum are ``reduce_from_tp`` sums (identity
backward), so the plain differentiable code gives each rank the exact
gradient of its columns. The first-max argmax across ranks keeps the
smallest id among the ranks' maxima. Columns past the vocabulary
(padding, BERT's sentinel) are masked.
"""

from __future__ import annotations

import torch

from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    VocabShards)

INT_BIG = 2 ** 30


def _smoothed_gold(logits: torch.Tensor, gold: torch.Tensor,
                   label_smoothing: float) -> torch.Tensor:
    """Replace the one-hot target term with the smoothed mixture
    (1-eps)*onehot + eps*uniform: CE becomes logz - [(1-eps)*gold +
    (eps/V)*sum(logits)]."""
    if not label_smoothing:
        return gold
    v = logits.shape[-1]
    return ((1.0 - label_smoothing) * gold
            + (label_smoothing / v) * logits.sum(dim=-1))


def masked_ce_sums(logits, targets: torch.Tensor,
                   mask: torch.Tensor, label_smoothing: float = 0.0):
    """UNNORMALIZED masked-CE pieces: (ce_sum, correct_sum, mask_sum).
    ``logits``: [..., V], or a TP model's ``VocabShards``."""
    if isinstance(logits, VocabShards):
        return vocab_parallel_ce_sums(logits, targets, mask, label_smoothing)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    gold = _smoothed_gold(logits, gold, label_smoothing)
    mask = mask.float()
    ce_sum = ((logz - gold) * mask).sum()
    pred = logits.argmax(dim=-1)
    correct = ((pred == targets).float() * mask).sum()
    return ce_sum, correct, mask.sum()


def vocab_parallel_ce_sums(logits: VocabShards, targets: torch.Tensor,
                           mask: torch.Tensor, label_smoothing: float = 0.0):
    """``masked_ce_sums`` of vocab-sharded logits, replicated over the
    model ranks (see the module docstring)."""
    tp, V = logits.tp, logits.vocab_size
    targets = targets.long()
    cols = torch.arange(logits.rows, device=targets.device)
    parts, valid = [], []
    for part, off in zip(logits.parts, logits.offsets()):
        ok = off + cols < V
        parts.append(part.float().masked_fill(~ok, -torch.inf))
        valid.append(ok)
    with torch.no_grad():
        top = tp.max([p.amax(dim=-1) for p in parts])
    logz = top + torch.log(tp.reduce_from_tp(
        [torch.exp(p - top[..., None]).sum(dim=-1) for p in parts]))
    golds = []
    for p, off in zip(parts, logits.offsets()):
        idx = targets - off
        hit = (idx >= 0) & (idx < logits.rows)
        g = p.gather(-1, idx.clamp(0, logits.rows - 1)[..., None])[..., 0]
        golds.append(torch.where(hit, g, 0.0))
    gold = tp.reduce_from_tp(golds)
    if label_smoothing:
        lsum = tp.reduce_from_tp([torch.where(ok, p, 0.0).sum(dim=-1)
                                  for p, ok in zip(parts, valid)])
        gold = ((1.0 - label_smoothing) * gold
                + (label_smoothing / V) * lsum)
    mask = mask.float()
    ce_sum = ((logz - gold) * mask).sum()
    with torch.no_grad():
        best = [p.amax(dim=-1) for p in parts]
        best_all = tp.max(best)
        pred = tp.min([torch.where(b == best_all, p.argmax(dim=-1) + off,
                                   INT_BIG)
                       for b, p, off in zip(best, parts, logits.offsets())])
    correct = ((pred == targets).float() * mask).sum()
    return ce_sum, correct, mask.sum()


def ce_sums(logits: torch.Tensor, labels: torch.Tensor,
            label_smoothing: float = 0.0):
    """(ce_sum, correct_sum, row count) of classification logits [B, C]
    against int labels [B]: every row counts."""
    ones = torch.ones(labels.shape, device=labels.device)
    return masked_ce_sums(logits, labels, ones, label_smoothing)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy; ``labels`` are int class ids (the
    reference fed one-hot labels: the same math)."""
    ce_sum, _, n = ce_sums(logits, labels, label_smoothing)
    return ce_sum / n


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax predictions equal to labels."""
    _, correct, n = ce_sums(logits, labels)
    return correct / n


def masked_softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 mask: torch.Tensor,
                                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over masked positions only.

    logits: [B, L, V]; targets: [B, L] ints; mask: [B, L] {0,1}.
    """
    ce_sum, _, n = masked_ce_sums(logits, targets, mask, label_smoothing)
    return ce_sum / torch.clamp(n, min=1.0)


def masked_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    _, correct, n = masked_ce_sums(logits, targets, mask)
    return correct / torch.clamp(n, min=1.0)

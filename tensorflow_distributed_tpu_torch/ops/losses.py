"""Cross-entropy and accuracy: the port of ``ops/losses.py``.

The reference's classification loss (mean softmax cross-entropy over
int labels, with a label-smoothing knob) and argmax accuracy, and the
masked sequence losses of the LM families. Computed in float32
regardless of the model's compute dtype, as the JAX package does.
Argmax takes the first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch


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


def masked_ce_sums(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor, label_smoothing: float = 0.0):
    """UNNORMALIZED masked-CE pieces: (ce_sum, correct_sum, mask_sum)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    gold = _smoothed_gold(logits, gold, label_smoothing)
    mask = mask.float()
    ce_sum = ((logz - gold) * mask).sum()
    pred = logits.argmax(dim=-1)
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

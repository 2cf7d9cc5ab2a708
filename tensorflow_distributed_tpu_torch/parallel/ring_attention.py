"""Plain exact attention: the port of ``parallel/ring_attention.py``'s
``_block_attend`` and ``full_attention``.

This is the attention the dispatcher (``ops.flash_attention.attention``)
takes when a mask is given or the kernels do not support the shapes.
The ring itself (sequence parallelism over several GPUs, and its partial
kernels) is not ported yet; see ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK = -1e30  # large-finite additive mask (matches ops.flash_attention)


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor]):
    """One Q-block vs one K,V-block partial attention.

    q: [B, Lq, H, D]; k, v: [B, Lk, H, D]; bias: [B, Lq, Lk] or None.
    Returns (scores_max [B,H,Lq], exp-sum [B,H,Lq], weighted-V
    [B,Lq,H,D]) — the streaming-softmax partials, all f32.
    """
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / d ** 0.5)
    if bias is not None:
        s = s + bias[:, None, :, :]
    # Clamp the row max away from the mask value so a fully-masked row
    # yields p == exp(-huge) == 0 and a zero l contribution.
    m = torch.clamp(s.amax(dim=-1), min=0.1 * _MASK)   # [B,H,Lq]
    p = torch.exp(s - m[..., None])                     # [B,H,Lq,Lk]
    l = p.sum(dim=-1)                                   # [B,H,Lq]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, l, o


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain exact attention. q,k,v: [B, L, H, D]; mask: [B, L, L]
    additive or None. A fully-masked query row returns zeros (not NaN)."""
    m, l, o = _block_attend(q, k, v, mask)
    l_safe = torch.clamp(l, min=torch.finfo(torch.float32).tiny)
    out = o / l_safe.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)

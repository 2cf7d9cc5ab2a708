"""Mixture-of-experts MLP (GShard-style top-k routing): the port of
``models/moe.py``.

``MoeMlp`` replaces a block's MLP when ``moe_experts > 0``. Routing
follows the JAX layer step for step, in f32:

- gate logits ``x @ gate`` ([G, S, E]), their softmax, and the top-k
  one-hot masks by repeated argmax (the first maximum wins, as in JAX);
- each (token, k) slot's position in its expert's buffer by a cumsum
  over the group, every top-2 slot placed after all top-1 slots;
- capacity ``C = max(1, ceil(c * K * S / E))`` over the routing group's
  length S; a slot at or past C is dropped (its combine weight is 0, so
  the token passes through the residual);
- the gates normalised over the K picks (K > 1);
- GELU experts (tanh approximation) on ``wi [E, D, F]`` and ``wo [E, F,
  D]``, no biases, every product in the compute dtype.

``group_len`` splits each row into independent routing groups of that
length; a sequence no longer than it routes as one group (decode and
short prefills). Two token movements share the routing: ``dense``, the
one-hot [G, S, E, C] dispatch and combine einsums, and ``scatter``, an
index-add into a [G, E*C + 1, D] buffer (row E*C collects the dropped
slots and is never read) and a gather back.

The parameters keep the flax layout (``gate [D, E]``, ``wi [E, D, F]``,
``wo [E, F, D]``) so ``interop`` copies them as they are.

With an expert transport ``ep`` (``parallel/tensor_parallel.py``: the
expert group's processes, or the model group's by JAX's default, or
``StackedTP(X)`` in one process) each rank holds E/X consecutive
experts (``wi``/``wo`` cut on dim 0; stacked, a leading X). Routing runs
whole on every rank; ``x`` and the K gates enter the expert branch
through ``copy_to_tp`` (their gradients from the ranks' partial branches
are summed over the group), each rank moves only its experts' slots,
and ``reduce_from_tp`` sums the partial outputs in f32 (a token's output
is rounded to the compute dtype once, after the sum, as the whole
layer's combine rounds it). The router's own terms are whole on every
rank and are not summed.

The aux terms leave the layer as a :class:`MoeAux` of this rank's sums
(routed counts, router-probability sums, squared-logsumexp sum, kept
slots, tokens), not as JAX's means: ``moe_objective`` turns every
layer's sums into the load-balance, z-loss and dropped-fraction terms
over the global batch (one all-reduce over the replica group), so that
data ranks' gradients sum to JAX's, whose means run over the global
rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_distributed_tpu_torch.parallel.tensor_parallel import (
    local_ranks)

# The aux names every MoE layer reports (JAX's sow names, in its order).
AUX_NAMES = ("load_balance", "z_loss", "dropped_fraction")
DISPATCHES = ("dense", "scatter")


def collect_aux(layers: Sequence[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """The mean per name over the layers' aux dicts (JAX's
    ``collect_aux`` over the sown collection)."""
    acc: Dict[str, List[torch.Tensor]] = {}
    for layer in layers:
        for name, value in layer.items():
            acc.setdefault(name, []).append(value)
    return {name: sum(vals) / len(vals) for name, vals in acc.items()}


@dataclasses.dataclass
class MoeAux:
    """One layer's router sums on this rank: ``counts`` [E] the (token,
    k) slots routed to each expert (detached), ``prob_sum`` [E] the
    router probabilities summed over tokens, ``z_sum`` the squared
    logsumexp summed over tokens, ``kept`` the slots within capacity
    (detached), ``tokens`` the tokens routed, ``top_k`` K."""

    counts: torch.Tensor
    prob_sum: torch.Tensor
    z_sum: torch.Tensor
    kept: torch.Tensor
    tokens: float
    top_k: int


def moe_objective(auxes: Sequence[MoeAux], mesh=None):
    """(load-balance term, z-loss term, metrics) of every layer's sums,
    over the rows of ``mesh``'s replica group (this process's alone
    without one). The terms are this rank's parts: E * sum_e f_e *
    p_sum_e / N and z_sum / N with f and N global, averaged over the
    layers; summed over the replica group they are JAX's load_balance
    and z_loss, and so are their gradients. The metrics are the global
    values of the three JAX names (detached)."""
    packed = torch.stack([torch.cat([a.counts, a.prob_sum.detach(),
                                     a.z_sum.detach().reshape(1),
                                     a.kept.reshape(1)])
                          for a in auxes]).float()
    tokens = torch.tensor([a.tokens for a in auxes], dtype=torch.float32,
                          device=packed.device)
    total = torch.cat([packed.reshape(-1), tokens])
    if mesh is not None:
        mesh.replica_all_reduce_([total])
    n = total[packed.numel():]
    packed = total[:packed.numel()].view_as(packed)
    lb_parts, z_parts, metrics = [], [], []
    for i, a in enumerate(auxes):
        E, K = a.counts.numel(), a.top_k
        counts, probs = packed[i, :E], packed[i, E:2 * E]
        z_all, kept = packed[i, 2 * E], packed[i, 2 * E + 1]
        f = counts / n[i] / K
        lb_parts.append(E * torch.sum(f * a.prob_sum) / n[i])
        z_parts.append(a.z_sum / n[i])
        metrics.append({"load_balance": E * torch.sum(f * probs / n[i]),
                        "z_loss": z_all / n[i],
                        "dropped_fraction": 1.0 - kept / (n[i] * K)})
    return (sum(lb_parts) / len(auxes), sum(z_parts) / len(auxes),
            collect_aux(metrics))


def _experts(xin: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The experts' MLPs on their buffers xin [E, N, D] (GELU with flax
    ``nn.gelu``'s tanh approximation), one batched product each way:
    both dispatches call it on the same shapes, so they compute the
    same experts' outputs."""
    h = F.gelu(torch.bmm(xin.to(dtype), wi.to(dtype)), approximate="tanh")
    return torch.bmm(h, wo.to(dtype))


class MoeMlp(nn.Module):
    """Drop-in replacement for the dense MLP inside a Block; ``forward``
    returns (output, ``MoeAux``)."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 group_len: int = 0, dispatch: str = "dense", ep=None):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(f"top_k {top_k} > num_experts {num_experts}")
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch {dispatch!r}; have {DISPATCHES}")
        size = ep.size if ep is not None else 1
        if num_experts % size:
            raise ValueError(
                f"the expert group of {size} must divide moe_experts "
                f"{num_experts}: the port cuts whole experts (uneven "
                f"groups are not ported; ROADMAP.md A5)")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.group_len, self.dispatch, self.ep = group_len, dispatch, ep
        lead = (local_ranks(ep),) if local_ranks(ep) > 1 else ()
        local = num_experts // size
        self.gate = nn.Parameter(torch.empty(d_model, num_experts))
        self.wi = nn.Parameter(torch.empty(*lead, local, d_model, d_ff))
        self.wo = nn.Parameter(torch.empty(*lead, local, d_ff, d_model))

    def capacity(self, group: int) -> int:
        """Slots an expert holds in a routing group of ``group`` tokens."""
        return max(1, math.ceil(self.capacity_factor * self.top_k * group
                                / self.num_experts))

    def route(self, x: torch.Tensor, picks: torch.Tensor = None):
        """JAX's routing of x [G, S, D]: (masks, positions, gates
        normalised over the K picks, kept flags, aux sums); masks
        [G, S, E] one-hot f32, the rest [G, S] per pick. ``picks``
        (expert ids [G, S, K]) stands in for the top-k choice: the rest
        is computed from them as from the router's own."""
        G, S, _ = x.shape
        E, K = self.num_experts, self.top_k
        C = self.capacity(S)
        logits = x.float() @ self.gate                       # [G, S, E]
        probs = torch.softmax(logits, dim=-1)
        masks, gates = [], []
        remaining = probs
        for k in range(K):
            idx = (torch.argmax(remaining, dim=-1) if picks is None
                   else picks[..., k])
            mask = F.one_hot(idx, E).float()
            gates.append(torch.sum(probs * mask, dim=-1))
            masks.append(mask)
            remaining = remaining * (1.0 - mask)
        pos, used = [], x.new_zeros((G, 1, E), dtype=torch.float32)
        for mask in masks:
            cum = torch.cumsum(mask, dim=1) - mask + used
            pos.append(torch.sum(cum * mask, dim=-1))
            used = used + torch.sum(mask, dim=1, keepdim=True)
        denom = sum(gates) if K > 1 else None
        gks = [g / torch.clamp(denom, min=1e-9) if denom is not None else g
               for g in gates]
        withins = [(ps < C).float() * torch.sum(mask, -1)
                   for mask, ps in zip(masks, pos)]
        z = torch.logsumexp(logits, dim=-1)
        aux = MoeAux(counts=sum(masks).sum((0, 1)).detach(),
                     prob_sum=probs.sum((0, 1)),
                     z_sum=torch.sum(z * z),
                     kept=sum(w.sum() for w in withins).detach(),
                     tokens=float(G * S), top_k=K)
        return masks, pos, gks, withins, aux

    def forward(self, x: torch.Tensor):
        G0, S0, D0 = x.shape
        if self.group_len and S0 > self.group_len:
            if S0 % self.group_len:
                raise ValueError(f"seq {S0} not divisible by group_len "
                                 f"{self.group_len}")
            x = x.reshape(G0 * (S0 // self.group_len), self.group_len, D0)
        masks, pos, gks, withins, aux = self.route(x)
        C = self.capacity(x.shape[1])
        ep = self.ep
        if ep is None:
            xs, gk_parts = [x], [gks]
            wis, wos, starts = [self.wi], [self.wo], [0]
        else:
            xs = ep.copy_to_tp(x)
            per_pick = [ep.copy_to_tp(g) for g in gks]
            gk_parts = [list(p) for p in zip(*per_pick)]
            wis, wos = ep.split(self.wi), ep.split(self.wo)
            starts = [m * wis[0].shape[0] for m in ep.indices]
        move = self._scatter if self.dispatch == "scatter" else self._dense
        parts = [move(xi, wi, wo, e0, masks, pos, gk, withins, C)
                 for xi, wi, wo, e0, gk in zip(xs, wis, wos, starts,
                                               gk_parts)]
        y = parts[0] if ep is None else ep.reduce_from_tp(parts)
        return y.to(x.dtype).reshape(G0, S0, D0), aux

    def _dense(self, x, wi, wo, e0, masks, pos, gks, withins, C):
        """The one-hot formulation on the experts [e0, e0 + len(wi))."""
        G, S, _ = x.shape
        el, dt = wi.shape[0], self.compute_dtype
        dispatch = x.new_zeros((G, S, el, C), dtype=torch.float32)
        combine = torch.zeros_like(dispatch)
        for mask, gk, ps, within in zip(masks, gks, pos, withins):
            # A position at or past C is dropped (within 0): clamped only
            # to stay a valid class for one_hot.
            loc = F.one_hot(ps.long().clamp(max=C - 1), C).float()
            sel = mask[..., e0:e0 + el, None] * loc[..., None, :]
            sel = sel * within[..., None, None]
            dispatch = dispatch + sel
            combine = combine + sel * gk[..., None, None]
        xin = torch.einsum("gsec,gsm->egcm", dispatch.to(dt), x.to(dt))
        out = _experts(xin.reshape(el, G * C, -1), wi, wo, dt)
        if self.ep is not None:  # a partial sum, kept in f32
            return torch.einsum("gsec,egcm->gsm", combine.to(dt).float(),
                                out.view(el, G, C, -1).float())
        return torch.einsum("gsec,egcm->gsm", combine.to(dt),
                            out.view(el, G, C, -1))

    def _scatter(self, x, wi, wo, e0, masks, pos, gks, withins, C):
        """The slot formulation on the experts [e0, e0 + len(wi)): kept
        slots of these experts go to row (e - e0) * C + pos of the
        buffer, every other slot to the dump row el * C. The gathered
        outputs are weighted and summed in f32 and rounded once, as the
        dense combine's product accumulates."""
        G, S, D = x.shape
        el, dt = wi.shape[0], self.compute_dtype
        dump = el * C
        rows = torch.arange(G, device=x.device)[:, None].expand(G, S)
        buf = x.new_zeros((G, dump + 1, D), dtype=dt)
        slots = []
        for mask, ps, within in zip(masks, pos, withins):
            e = torch.argmax(mask, dim=-1) - e0
            mine = (within > 0) & (e >= 0) & (e < el)
            d = torch.where(mine, e * C + ps.long(),
                            torch.full_like(e, dump))
            buf = buf.index_put((rows, d), x.to(dt) * within[..., None].to(dt),
                                accumulate=True)
            slots.append(d)
        xin = buf[:, :dump].reshape(G, el, C, D).transpose(0, 1)
        out = _experts(xin.reshape(el, G * C, D), wi, wo, dt)
        out = out.view(el, G, C, D).transpose(0, 1).reshape(G, dump, D)
        out_pad = torch.cat([out, out.new_zeros((G, 1, D))], dim=1)
        y = sum(out_pad[rows, d].float() * gk[..., None].to(dt).float()
                for d, gk in zip(slots, gks))
        return y if self.ep is not None else y.to(dt)  # a partial: f32


@torch.no_grad()
def init_moe_(layer: MoeMlp, std: float,
              generator: Optional[torch.Generator]) -> None:
    """The flax initializer of the three leaves: normal(std)."""
    for p in (layer.gate, layer.wi, layer.wo):
        p.normal_(0.0, std, generator=generator)

"""Pipeline parallelism over the mesh's ``pipe`` axis: the port of
``parallel/pipeline.py``.

The block stack is cut into S stages, one per pipe rank; with V > 1
virtual stages (Megatron's interleaved layout) stage s holds V depth
chunks, virtual stage j = v S + s holding layers [j lps, (j + 1) lps)
(``stage_layers``). A batch splits into M microbatches, and the
schedules run in ticks: at each tick every virtual stage runs its slot
for one microbatch, then one ``exchange`` of the pipe's transport
(``parallel/mesh.py``: ``ProcessGroupPipe``'s ``batch_isend_irecv``
between processes, ``StackedPipe``'s hand-over in one process) moves
each finished activation down to the next virtual stage and each input
cotangent up to the previous one. The messages a stage sends to one
other stage in a tick travel as one stacked tensor, and a slot outside
the schedule (the ramp and the drain) sends nothing: both sides compute
from the tick which slots run, so every send meets its receive.

- ``pipeline_apply``: GPipe. Every forward runs, then autograd runs the
  backwards (the standard step's ``backward()``), each stage keeping M
  microbatches of activations. Between processes a hop is an autograd
  function whose backward is the reverse exchange, and a token threads
  the hops of one rank in tick order, so the backward visits them in
  reverse tick order on every rank and the pairs of P2P calls meet.
- ``pipeline_value_and_grad``: 1F1B over T = M + 2(S - 1) ticks. At tick
  t stage s runs the forward of microbatch t - s and the backward of
  t - 2(S - 1) + s; the last stage's loss (``last_fn``) seeds the
  backward in the tick of its forward. ``backward="recompute"`` keeps
  each slot's input and re-runs its forward under autograd at the
  backward tick; ``"stash"`` keeps the forward tick's autograd graph.
  The gradients accumulate in the parameters' ``.grad`` (autograd's
  graph holds the weights by reference); at most min(2 S, M)
  microbatches are in flight a stage.
- ``interleaved_pipeline_value_and_grad``: the same over S V virtual
  stages and T = M + 2(S V - 1) ticks, recompute only.

Dropout is the stage function's: ``models/pipelined.py`` seeds a
generator by (step, microbatch, virtual stage), so a recomputed forward,
GPipe and 1F1B all draw the same masks. MoE router losses leave a stage
as ``stage_aux`` sums; 1F1B seeds their cotangents
(``stage_aux_cotangent``) beside the activation's.

Collectives inside a stage: under ``--mesh.model`` a stage's blocks
are Megatron blocks (``copy_to_tp`` and ``reduce_from_tp`` over the
model group), and under ``--mesh.seq`` its attention is the ring (its
permutes over the seq group). Every model rank and every seq rank of a
stage runs the same slots in the same tick (the schedule is a function
of the tick and the stage alone), so their collectives pair up in
order, and the pipe's hops go to the same (data, seq, model) place of
the next stage over groups of their own.

JAX's ``variant_residual_mask``, ``split_by_mask``, ``merge_by_mask``
and ``_select_tree`` have no twin: they sort a jaxpr's vjp residuals
into per-microbatch and per-step leaves for a ring buffer, and
PyTorch's autograd graph keeps its saved tensors, the weights by
reference, itself. Nor has the ``bubble="cond|where"`` switch: this
eager schedule runs no bubble slot and sends nothing for one. JAX's
where-masked bubble exists so that the ring's permutes inside a
``shard_map`` run on every pipe rank at every tick; here the seq ranks
of a stage skip the same bubble slots together, and the ranks of other
stages are not in their seq group, so no permute is left unpaired.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.parallel.mesh import StackedPipe

StageFn = Callable[[int, torch.Tensor, int], Any]
LastFn = Callable[[torch.Tensor, Sequence[torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def bubble_fraction(num_microbatches: int, num_stages: int,
                    schedule: str = "gpipe") -> float:
    """Fraction of stage-ticks idle: (S-1)/(M+S-1) for gpipe's M+S-1
    forward ticks; 2(S-1)/(M+2(S-1)) for 1f1b's tick pairs (JAX's)."""
    M, S = num_microbatches, num_stages
    if schedule == "gpipe":
        return (S - 1) / (M + S - 1)
    if schedule == "1f1b":
        return 2 * (S - 1) / (M + 2 * (S - 1))
    raise ValueError(f"schedule {schedule!r}; have ('gpipe', '1f1b')")


def _swap01(p):
    return (p.transpose(0, 1) if isinstance(p, torch.Tensor)
            else np.swapaxes(p, 0, 1))


def stack_stage_params(layer_params: Any, num_stages: int,
                       virtual: int = 1) -> Any:
    """[n_layers, ...] stacked layer leaves (a dict tree of numpy arrays
    or tensors) -> [S, lps, ...], or [S, V, lps, ...] with virtual > 1
    (virtual stage j = v S + s owns layers [j lps, (j + 1) lps)), as
    JAX's."""
    def regroup(p):
        n = p.shape[0]
        if n % (num_stages * virtual):
            raise ValueError(
                f"{n} layers not divisible by {num_stages} stages"
                + (f" x {virtual} virtual chunks" if virtual > 1
                   else ""))
        lps = n // (num_stages * virtual)
        if virtual == 1:
            return p.reshape(num_stages, lps, *p.shape[1:])
        return _swap01(p.reshape(virtual, num_stages, lps, *p.shape[1:]))
    return _tree_map(regroup, layer_params)


def unstack_stage_params(staged: Any, virtual: int = 1) -> Any:
    """The inverse of ``stack_stage_params``: [S, lps, ...] or
    [S, V, lps, ...] -> [n_layers, ...]."""
    def flat(p):
        if virtual == 1:
            return p.reshape(p.shape[0] * p.shape[1], *p.shape[2:])
        q = _swap01(p)
        q = q.contiguous() if isinstance(q, torch.Tensor) else q
        return q.reshape(q.shape[0] * q.shape[1] * q.shape[2],
                         *q.shape[3:])
    return _tree_map(flat, staged)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_layers(j: int, n_layers: int, num_stages: int,
                 virtual: int = 1) -> range:
    """The global layer indices of virtual stage ``j``."""
    lps = n_layers // (num_stages * virtual)
    return range(j * lps, (j + 1) * lps)


def local_virtual_stages(pipe, virtual: int = 1) -> List[int]:
    """The virtual stages this process runs, in ascending order."""
    return sorted(v * pipe.size + s for s in pipe.stages
                  for v in range(virtual))


class _Hop(torch.autograd.Function):
    """One tick's exchange between processes under autograd: forward
    sends ``tensors`` (under ``keys``) and returns the token and what
    arrives under ``expect``; backward sends the arrivals' gradients
    back to their senders and receives the gradients of what it sent.
    The token (a scalar) orders one rank's hops in tick order."""

    @staticmethod
    def forward(ctx, pipe, keys, expect, token, *tensors):
        got = pipe.exchange(dict(zip(keys, tensors)), expect)
        ctx.pipe, ctx.keys, ctx.recv = pipe, keys, list(expect)
        ctx.recv_specs = [expect[k] for k in ctx.recv]
        ctx.specs = [(t.shape, t.dtype, t.device) for t in tensors]
        return (token.clone(), *[got[k] for k in ctx.recv])

    @staticmethod
    def backward(ctx, g_token, *g_recv):
        back = {}
        for (src, dst, tag), g, spec in zip(ctx.recv, g_recv,
                                            ctx.recv_specs):
            back[(dst, src, tag)] = (g if g is not None else torch.zeros(
                spec[0], dtype=spec[1], device=spec[2]))
        expect = {(dst, src, tag): spec
                  for (src, dst, tag), spec in zip(ctx.keys, ctx.specs)}
        got = ctx.pipe.exchange(back, expect)
        return (None, None, None, g_token,
                *[got[(dst, src, tag)] for src, dst, tag in ctx.keys])


class _Exchanger:
    """One schedule's messages: which slots send in a tick, stacked per
    (source stage, destination stage, tag), and where each arrival
    goes."""

    def __init__(self, pipe, virtual: int, act: Tuple[torch.Size, Any,
                                                       Any]):
        self.pipe, self.S, self.V = pipe, pipe.size, virtual
        self.Sv = pipe.size * virtual
        self.local = set(pipe.stages)
        self.act = act
        self.token = None

    def tick(self, fwd: Dict[int, Optional[torch.Tensor]],
             bwd: Dict[int, Optional[torch.Tensor]],
             fwd_valid: Callable[[int], bool],
             bwd_valid: Callable[[int], bool]
             ) -> Tuple[Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
        """``fwd``: virtual stage j -> its output going to j + 1 (local j
        only); ``bwd``: j -> its input cotangent going to j - 1.
        ``fwd_valid(j)`` / ``bwd_valid(j)``: whether j's forward /
        backward slot ran this tick (on any stage). Returns the arrivals
        (j -> the activation for j, j -> the cotangent for j)."""
        S, Sv = self.S, self.Sv
        sends: Dict[tuple, List[torch.Tensor]] = collections.defaultdict(list)
        recvs: Dict[tuple, List[Tuple[str, int]]] = collections.defaultdict(
            list)
        for j in range(Sv - 1):
            if fwd_valid(j):
                key = (j % S, (j + 1) % S, "f")
                if key[0] in self.local:
                    sends[key].append(fwd[j])
                if key[1] in self.local:
                    recvs[key].append(("f", j + 1))
        for j in range(1, Sv):
            if bwd_valid(j):
                key = (j % S, (j - 1) % S, "b")
                if key[0] in self.local:
                    sends[key].append(bwd[j])
                if key[1] in self.local:
                    recvs[key].append(("b", j - 1))
        shape, dtype, device = self.act
        out = {k: torch.stack(v) for k, v in sends.items()}
        expect = {k: ((len(v),) + tuple(shape), dtype, device)
                  for k, v in recvs.items()}
        if not out and not expect:
            return {}, {}
        keys = sorted(out)
        if self.token is not None and torch.is_grad_enabled():
            got_list = _Hop.apply(self.pipe, keys, expect, self.token,
                                  *[out[k] for k in keys])
            self.token = got_list[0]
            got = dict(zip(list(expect), got_list[1:]))
        else:
            got = self.pipe.exchange(out, expect)
        acts: Dict[int, torch.Tensor] = {}
        cots: Dict[int, torch.Tensor] = {}
        for key, dests in recvs.items():
            for i, (tag, j) in enumerate(dests):
                (acts if tag == "f" else cots)[j] = got[key][i]
        return acts, cots


def _check_microbatches(B: int, M: int, Sv: int, what: str) -> None:
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if M < Sv:
        raise ValueError(f"need microbatches >= {what} ({M} < {Sv})")


def _add(acc: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]):
    for k, v in aux.items():
        v = v.detach().float()
        acc[k] = acc[k] + v if k in acc else v.clone()


def pipeline_apply(stage_fn: StageFn, x: torch.Tensor, pipe,
                   num_microbatches: int, virtual_stages: int = 1,
                   stage_aux: bool = False,
                   link: Optional[list] = None):
    """GPipe: ``x`` [B, ...] through the S V virtual stages with an
    M-microbatch schedule of M + S V - 1 forward ticks (JAX's V chained
    passes of M + S - 1 ticks compute the same slots). ``stage_fn(j,
    x_mb, m) -> y_mb`` (or ``(y_mb, aux)`` with ``stage_aux``: a dict of
    scalars) runs virtual stage j on microbatch m; every process passes
    the same ``x`` (its shape and dtype size the arrivals; only the
    holder of stage 0 reads its values). Returns the output [B, ...] on
    the process that holds the last virtual stage and None elsewhere;
    with ``stage_aux`` also the aux summed over this process's (stage,
    microbatch) slots (differentiable). Between processes under
    autograd ``link`` (a list) receives the token that ties this rank's
    hops into its loss: the caller adds ``0 * token`` to the value it
    differentiates."""
    V, S = virtual_stages, pipe.size
    Sv, M = S * V, num_microbatches
    _check_microbatches(x.shape[0], M, S, "stages")
    xm = x.tensor_split(M)
    local = local_virtual_stages(pipe, V)
    ex = _Exchanger(pipe, V, (xm[0].shape, x.dtype, x.device))
    if torch.is_grad_enabled() and not isinstance(pipe, StackedPipe):
        ex.token = torch.zeros((), device=x.device, requires_grad=True)
    inbox: Dict[int, torch.Tensor] = {}
    outs: List[Optional[torch.Tensor]] = [None] * M
    aux_tot: Dict[str, torch.Tensor] = {}
    for t in range(M + Sv - 1):
        ys: Dict[int, torch.Tensor] = {}
        for j in local:
            m = t - j
            if not 0 <= m < M:
                continue
            inp = xm[m] if j == 0 else inbox.pop(j)
            out = stage_fn(j, inp, m)
            y, aux = out if stage_aux else (out, {})
            for k, v in aux.items():
                aux_tot[k] = aux_tot[k] + v if k in aux_tot else v
            if j == Sv - 1:
                outs[m] = y
            else:
                ys[j] = y
        arrived, _ = ex.tick(ys, {}, lambda j, t=t: 0 <= t - j < M,
                             lambda j: False)
        inbox.update(arrived)
    if link is not None and ex.token is not None:
        link.append(ex.token)
    out = torch.cat(outs) if (Sv - 1) in local else None
    return (out, aux_tot) if stage_aux else out


def _one_f_one_b(stage_fn: StageFn, last_fn: LastFn, x: torch.Tensor,
                 aux: Sequence[torch.Tensor], pipe, num_microbatches: int,
                 virtual: int, cotangent_scale,
                 stage_aux_cotangent: Optional[Dict[str, float]],
                 backward: str):
    """The 1F1B schedule over S V virtual stages (see the module
    docstring). Returns (value sum, metric sums, aux sums, d_x): sums
    over this process's slots (the last stage's for the value and the
    metrics), d_x [B, ...] on the holder of stage 0, else None."""
    V, S = virtual, pipe.size
    Sv, M = S * V, num_microbatches
    stash_graph = backward == "stash"
    aux_on = stage_aux_cotangent is not None
    xm = x.detach().tensor_split(M)
    auxm = [a.tensor_split(M) for a in aux]
    local = local_virtual_stages(pipe, V)
    ex = _Exchanger(pipe, V, (xm[0].shape, x.dtype, x.device))
    depth = min(2 * Sv, M)
    weights = {k: w for k, w in (stage_aux_cotangent or {}).items() if w}

    def call(j, inp, m):
        out = stage_fn(j, inp, m)
        return out if aux_on else (out, {})

    def backprop(y, aux_v, leaf, cot):
        outs, grads = [y], [cot.to(y.dtype)]
        for k, w in weights.items():
            if aux_v[k].requires_grad:
                outs.append(aux_v[k])
                grads.append(torch.full_like(aux_v[k], w))
        torch.autograd.backward(outs, grads)
        return leaf.grad

    inbox_f: Dict[int, torch.Tensor] = {}
    inbox_b: Dict[int, torch.Tensor] = {}
    stash: Dict[Tuple[int, int], Any] = {}
    dx: List[Optional[torch.Tensor]] = [None] * M
    val = torch.zeros((), device=x.device)
    met: Dict[str, torch.Tensor] = {}
    aux_acc: Dict[str, torch.Tensor] = {}
    for t in range(M + 2 * (Sv - 1)):
        ys: Dict[int, torch.Tensor] = {}
        head_dy = None
        for j in local:  # the forward half
            m = t - j
            if not 0 <= m < M:
                continue
            inp = xm[m] if j == 0 else inbox_f.pop(j)
            if stash_graph:
                leaf = inp.detach().requires_grad_()
                with torch.enable_grad():
                    y, aux_v = call(j, leaf, m)
                stash[(j, m)] = (leaf, y, aux_v)
            else:
                with torch.no_grad():
                    y, aux_v = call(j, inp, m)
                stash[(j, m)] = inp
            _add(aux_acc, aux_v)
            y = y.detach()
            if j < Sv - 1:
                ys[j] = y
                continue
            # The loss at the last virtual stage seeds this tick's
            # backward of the same microbatch.
            y_leaf = y.requires_grad_()
            with torch.enable_grad():
                v, mets = last_fn(y_leaf, [a[m] for a in auxm])
                torch.autograd.backward(v, torch.as_tensor(
                    cotangent_scale, dtype=v.dtype, device=v.device))
            val = val + v.detach()
            _add(met, mets)
            head_dy = y_leaf.grad
        if len(stash) > depth * len(local):
            raise AssertionError(f"{len(stash)} microbatches in flight on "
                                 f"{len(local)} stages (bound {depth})")
        dxs: Dict[int, torch.Tensor] = {}
        for j in reversed(local):  # the backward half
            m = t - 2 * (Sv - 1) + j
            if not 0 <= m < M:
                continue
            cot = head_dy if j == Sv - 1 else inbox_b.pop(j)
            if stash_graph:
                leaf, y, aux_v = stash.pop((j, m))
            else:
                leaf = stash.pop((j, m)).detach().requires_grad_()
                with torch.enable_grad():
                    y, aux_v = call(j, leaf, m)
            d = backprop(y, aux_v, leaf, cot)
            if j == 0:
                dx[m] = d
            else:
                dxs[j] = d
        arrived_f, arrived_b = ex.tick(
            ys, dxs, lambda j, t=t: 0 <= t - j < M,
            lambda j, t=t: 0 <= t - 2 * (Sv - 1) + j < M)
        inbox_f.update(arrived_f)
        inbox_b.update(arrived_b)
    if stash or inbox_f or inbox_b:
        raise AssertionError("the 1F1B schedule left work in flight")
    d_x = torch.cat(dx) if 0 in local else None
    return val, met, aux_acc, d_x


def pipeline_value_and_grad(stage_fn: StageFn, last_fn: LastFn,
                            x: torch.Tensor, aux: Sequence[torch.Tensor],
                            pipe, num_microbatches: int,
                            cotangent_scale=1.0,
                            stage_aux_cotangent: Optional[
                                Dict[str, float]] = None,
                            backward: str = "recompute"):
    """1F1B: forwards and backwards in one schedule of M + 2(S - 1)
    ticks (see the module docstring). ``last_fn(y_mb, aux_mb) ->
    (scalar sum, metric sums)`` runs at the last stage on the
    microbatch's rows of ``aux`` (a sequence of [B, ...] tensors:
    targets, mask); its sum is differentiated with ``cotangent_scale``
    (a float or a 0-dim tensor: 1 / the global count, the gradients of
    the mean). With
    ``stage_aux_cotangent`` (a dict of weights), ``stage_fn`` returns
    ``(y, aux)`` and each aux term's gradient enters with its weight.
    The stage and head gradients accumulate in the parameters' ``.grad``.
    Returns (value sum, metric sums, aux sums, d_x), each this process's
    share; d_x [B, ...] (the embedding's cotangent) on the holder of
    stage 0, else None."""
    if backward not in ("recompute", "stash"):
        raise ValueError(f"backward {backward!r}; "
                         "have ('recompute', 'stash')")
    _check_microbatches(x.shape[0], num_microbatches, pipe.size, "stages")
    return _one_f_one_b(stage_fn, last_fn, x, aux, pipe, num_microbatches,
                        1, cotangent_scale, stage_aux_cotangent, backward)


def interleaved_pipeline_value_and_grad(
        stage_fn: StageFn, last_fn: LastFn, x: torch.Tensor,
        aux: Sequence[torch.Tensor], pipe, num_microbatches: int,
        virtual_stages: int, cotangent_scale=1.0,
        stage_aux_cotangent: Optional[Dict[str, float]] = None):
    """Interleaved 1F1B over S V virtual stages and M + 2(S V - 1) ticks
    (virtual stage j = v S + s on stage s; a hop from stage S - 1 wraps
    to stage 0's next chunk); the recompute backward only. Same contract
    as ``pipeline_value_and_grad``."""
    Sv = pipe.size * virtual_stages
    _check_microbatches(x.shape[0], num_microbatches, Sv,
                        f"virtual stages ({pipe.size} stages x "
                        f"{virtual_stages} chunks)")
    return _one_f_one_b(stage_fn, last_fn, x, aux, pipe, num_microbatches,
                        virtual_stages, cotangent_scale,
                        stage_aux_cotangent, "recompute")


# --- the pipe's gradient sync --------------------------------------------

def sync_pipe_grads_(model: torch.nn.Module, mesh) -> None:
    """Sum a pipelined model's gradients over the mesh: a block's over
    the data and seq groups (the ranks of its stage that hold the same
    part of it), the shell's over the pipe group (stage 0 holds the
    embedding's part, the last stage the head's) and then the data and
    seq groups. Nothing is summed over the model group: a leaf cut over
    it holds this rank's part's gradient, and a leaf whole on every
    model rank (the shell, the norms, the row-parallel biases) already
    has the whole gradient on each (``copy_to_tp`` sums the stream's
    gradient over the group). A parameter without a gradient takes
    zeros first, so every rank sums the same tensors."""
    shell = set(model.shell_names())
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    named = list(model.named_parameters())
    head = [p.grad for n, p in named if n in shell]
    blocks = [p.grad for n, p in named if n not in shell]
    mesh.pipe_all_reduce_(head)
    for grads in (head, blocks):
        mesh.data_all_reduce_(grads)
        mesh.seq_all_reduce_(grads)


def pipe_grad_norm(grads: Dict[str, torch.Tensor], mesh,
                   shell: Sequence[str],
                   sharded: frozenset = frozenset()) -> torch.Tensor:
    """optax.global_norm of the whole model's gradient (summed as
    ``sync_pipe_grads_`` leaves it): the blocks' squares summed over the
    pipe group, those of the blocks' leaves cut over the model group
    (``sharded``) over the model group first; the shell's counted
    once."""
    shell = set(shell)
    zero = torch.zeros((), device=next(iter(grads.values())).device)

    def total(keep):
        # In the gradients' order: every rank adds the same terms.
        return sum((torch.sum(g.float() ** 2) for n, g in grads.items()
                    if keep(n)), zero)

    blocks = torch.stack([
        total(lambda n: n in sharded),
        total(lambda n: n not in shell and n not in sharded)])
    mesh.model_all_reduce_([blocks[:1]])
    mesh.pipe_all_reduce_([blocks])
    return torch.sqrt(blocks.sum() + total(lambda n: n in shell))

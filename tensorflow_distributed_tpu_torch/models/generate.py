"""Autoregressive generation with a KV cache: the port of
``models/generate.py``.

Prefill the prompt in one pass that fills every layer's cache
([B, max_len, nk, Dh], nk the K/V heads: H, or fewer under GQA; a
:class:`~..models.transformer.KVCache` the caller owns), then decode one token per step against it: O(L) attention per new
token instead of re-running the whole sequence. The tokens stay on the
device between steps, so a greedy loop never waits for the host.

``beam_search`` keeps K beams a prompt row on the same cached decode
path: the cache is prefilled once a row and repeated K times, and after
each step's top-K its rows are reordered by the beams' parents
(``index_select``).

The JAX module compiles one program per (model, N, sampler knobs) and
counts the hits and misses of that compile cache (``lookup_program``,
``compile_cache_stats``). The port runs eagerly and has no compile
cache, so neither exists here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tensorflow_distributed_tpu_torch.models.transformer import KVCache
from tensorflow_distributed_tpu_torch.ops.flash_attention import NEG_INF


@torch.no_grad()
def prefill_cache(model, prompt: torch.Tensor, positions=None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """One forward over ``prompt`` [B, P] into a fresh cache, at
    positions 0 .. P-1: THE prefill of ``generate()`` and the serving
    engine. Returns (logits [B, P, V] f32, cache)."""
    if positions is not None:
        # JAX prefills at an offset for a continuation (slot retry,
        # preemption, journal resume); none of those is ported, and its
        # clamped write has no counterpart here.
        raise NotImplementedError(
            "prefill at an offset (a continuation's re-prefill) is not "
            "ported to PyTorch yet (see ROADMAP.md queue A)")
    B, P = prompt.shape
    if P > model.cfg.max_len:
        raise ValueError(f"prompt {P} > max_len {model.cfg.max_len}")
    cache = KVCache.zeros(model.cfg, B, prompt.device)
    pos = torch.arange(P, device=prompt.device)[None]
    logits = model(prompt, decode=True, positions=pos, cache=cache)
    return logits, cache


@torch.no_grad()
def decode_token(model, cache: KVCache, tok: torch.Tensor, positions
                 ) -> Tuple[torch.Tensor, KVCache]:
    """One single-token step against ``cache``, updated in place: THE
    decode step of ``generate()`` and the serving engine. ``tok`` [B];
    ``positions`` [B] (per-row depths: the engine's slots differ) or
    [1] (every row in lockstep). Returns (last-position logits [B, V],
    cache)."""
    pos = torch.as_tensor(positions, dtype=torch.long, device=tok.device)
    if pos.ndim == 0:
        pos = pos[None]
    logits = model(tok[:, None], decode=True, positions=pos[:, None],
                   cache=cache)
    return logits[:, -1, :], cache


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float
                   ) -> torch.Tensor:
    """Mask logits outside the top-k / nucleus (top-p) candidate set to
    -inf, as the JAX filter does: top-k thresholds at the k-th value;
    top-p keeps the smallest prefix of the sorted distribution whose
    mass reaches p (never empty) and thresholds at its last logit."""
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        boundary = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < boundary, -torch.inf, logits)
    return logits


@torch.no_grad()
def generate(model, prompt: torch.Tensor, max_new_tokens: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Continue ``prompt`` [B, P] by ``max_new_tokens`` greedy
    (temperature 0) or sampled tokens; returns [B, max_new_tokens].

    Sampling (``temperature > 0``) draws from ``generator`` (a
    ``torch.Generator`` on the prompt's device), after ``top_k > 0``
    keeps the k highest logits and ``top_p < 1`` the smallest nucleus of
    mass p (k first, then p over the survivors)."""
    cfg = model.cfg
    if not cfg.causal:
        raise ValueError("generate() needs a causal model")
    B, P = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if P + max_new_tokens > cfg.max_len:
        raise ValueError(
            f"prompt {P} + {max_new_tokens} new > max_len {cfg.max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    def pick(last):
        if temperature == 0.0:
            return last.argmax(dim=-1)
        probs = torch.softmax(
            _filter_logits(last / temperature, top_k, top_p), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    logits, cache = prefill_cache(model, prompt)
    toks = [pick(logits[:, -1, :])]
    fed_at = torch.arange(P, P + max_new_tokens, device=prompt.device)
    for i in range(max_new_tokens - 1):
        last, cache = decode_token(model, cache, toks[-1], fed_at[i:i + 1])
        toks.append(pick(last))
    return torch.stack(toks, dim=1)


@torch.no_grad()
def beam_search(model, prompt: torch.Tensor, max_new_tokens: int, *,
                num_beams: int = 4, length_penalty: float = 1.0,
                eos_id: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search continuation of ``prompt`` [B, P]: returns (sequences
    [B, num_beams, max_new_tokens], scores [B, num_beams]), beams sorted
    best first by length-normalized log-probability (GNMT
    ``length_penalty``: the score over length ** penalty; 0 turns the
    normalization off).

    The first expansion is a top-K over the vocabulary. ``eos_id``: a
    beam that emits it freezes (its score kept, padded with eos); None
    runs every beam to the full budget. ``num_beams=1`` is greedy
    decoding. The same requirements as ``generate``."""
    cfg = model.cfg
    if not cfg.causal:
        raise ValueError("beam_search() needs a causal model")
    B, P = prompt.shape
    if P + max_new_tokens > cfg.max_len:
        raise ValueError(
            f"prompt {P} + {max_new_tokens} new > max_len {cfg.max_len}")
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    V = cfg.vocab_size
    if num_beams > V:
        raise ValueError(
            f"num_beams {num_beams} > vocab_size {V} "
            "(the first expansion is a top-k over the vocabulary)")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if eos_id is not None and not 0 <= eos_id < V:
        raise ValueError(f"eos_id {eos_id} outside vocab [0, {V})")
    K, dev = num_beams, prompt.device
    logits, cache = prefill_cache(model, prompt)
    # The K copies of a row's cache are identical: prefill once a row.
    rows = torch.arange(B, device=dev).repeat_interleave(K)
    cache = KVCache([c.index_select(0, rows) for c in cache.k],
                    [c.index_select(0, rows) for c in cache.v])
    logp0 = torch.log_softmax(logits[:, -1, :].float(), dim=-1)  # [B, V]
    scores, tok0 = torch.topk(logp0, K, dim=-1)                  # [B, K]
    alive = (tok0 != eos_id if eos_id is not None
             else torch.ones((B, K), dtype=torch.bool, device=dev))
    frozen = None
    if eos_id is not None:
        # A finished beam emits only eos, at no cost: it keeps its score.
        frozen = torch.full((V,), NEG_INF, device=dev)
        frozen[eos_id] = 0.0
    tok, toks, parents = tok0.reshape(B * K), [], []
    for i in range(max_new_tokens - 1):
        last, cache = decode_token(model, cache, tok,
                                   torch.tensor([P + i], device=dev))
        logp = torch.log_softmax(last.float(), dim=-1).reshape(B, K, V)
        if frozen is not None:
            logp = torch.where(alive[..., None], logp, frozen)
        cand = (scores[..., None] + logp).reshape(B, K * V)
        scores, flat = torch.topk(cand, K, dim=-1)               # [B, K]
        beam = flat // V
        new_tok = flat % V
        gather = (torch.arange(B, device=dev)[:, None] * K
                  + beam).reshape(B * K)
        cache = KVCache([c.index_select(0, gather) for c in cache.k],
                        [c.index_select(0, gather) for c in cache.v])
        alive = torch.gather(alive, 1, beam)
        if eos_id is not None:
            alive = alive & (new_tok != eos_id)
        tok = new_tok.reshape(B * K)
        toks.append(new_tok)
        parents.append(beam)
    # Backtrack the parent pointers into each beam's token path.
    ptr = torch.arange(K, device=dev).repeat(B, 1)
    path = []
    for t, par in zip(reversed(toks), reversed(parents)):
        path.append(torch.gather(t, 1, ptr))
        ptr = torch.gather(par, 1, ptr)
    path.append(torch.gather(tok0, 1, ptr))
    seq = torch.stack(path[::-1], dim=2)                         # [B, K, n]
    n = seq.shape[2]
    if eos_id is not None:
        # Tokens up to and including the first eos.
        is_eos = seq == eos_id
        length = torch.where(is_eos.any(dim=2),
                             is_eos.int().argmax(dim=2) + 1, n)
    else:
        length = torch.full((B, K), n, device=dev)
    norm = scores / length.float() ** length_penalty
    order = torch.argsort(-norm, dim=1, stable=True)
    seq = torch.gather(seq, 1, order[:, :, None].expand(B, K, n))
    return seq, torch.gather(norm, 1, order)

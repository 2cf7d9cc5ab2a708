"""Speculative decoding for the slot engine, the port of
``serve/speculate.py``: propose k, verify once.

A decode step retires one token a slot. With speculation a cheap draft
proposes ``spec_tokens`` tokens a slot, and one verify forward
(``SlotDecodeEngine.verify_step``) feeds each slot's pending token and
its proposals at positions ``pos .. pos + k`` over the slot's cache: the
longest prefix of proposals that matches the target's own greedy chain
is accepted, plus the verify's next token (the bonus), so one dispatch
retires ``accepted + 1`` tokens. Every emitted token is the target's own
argmax given the accepted prefix, so the output is token-identical to
plain greedy decoding; the draft decides only how many tokens a dispatch
yields.

Two proposers:

- :class:`SelfDraft` (``--serve.draft-config`` unset): k-gram prompt
  lookup over the request's own history (prompt and tokens so far):
  the most recent earlier occurrence of the last ``spec_kgram`` tokens,
  and what followed it. Host work only, no second model;
- :class:`DraftSpeculator` (``--serve.draft-config "tiny"`` or
  ``"size=tiny,n_layers=1"``): a smaller GPT mirrors the slot cache
  (its own bucketed prefill and row insert at each admission) and runs
  ``k + 1`` single-token decode ticks a round. Its weights are drawn
  fresh from a seed: its quality moves the accept rate, never the
  output.

Rollback on reject is position bookkeeping: a rejected proposal's cache
row lies past the slot's new position, and the next write covers it
before any attend reaches it (the caches are written in place here; the
argument is the same as for JAX's functional caches).

Known limitation, as in JAX: a plain-step fallback round (the engine's
headroom guard) advances the engine without running the draft, so
``DraftSpeculator.sync_from`` adopts positions whose draft-cache rows
were never written. The output stays correct (the draft only proposes),
but later draft attends read those holes and the accept rate can drop
after fallback rounds; a draft re-prefill on resync would close it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.models.generate import (
    decode_token, prefill_cache)
from tensorflow_distributed_tpu_torch.models.transformer import KVCache
from tensorflow_distributed_tpu_torch.serve.buckets import pick_bucket


def accept_length(props, nxt) -> int:
    """How many leading proposals match the target's argmax chain.
    ``props`` [K]: what the draft proposed; ``nxt`` [K + 1]: the verify's
    argmax at each fed position (``nxt[j]`` is the target's token after
    the prefix through proposal j - 1)."""
    props = np.asarray(props).reshape(-1)
    nxt = np.asarray(nxt).reshape(-1)
    k = len(props)
    if len(nxt) != k + 1:
        raise ValueError(
            f"verify returned {len(nxt)} tokens for {k} proposals "
            f"(want k + 1: one per proposal plus the bonus)")
    a = 0
    while a < k and props[a] == nxt[a]:
        a += 1
    return a


def kgram_propose(history: Sequence[int], k: int, g: int = 3) -> List[int]:
    """Prompt-lookup proposal: the ``k`` tokens that followed the most
    recent earlier occurrence of the history's last ``g`` tokens (a
    shorter continuation is padded by repeating its last token). No
    match, or a history shorter than the suffix, repeats the last token
    (right for the argmax loops a fresh-init model falls into)."""
    hist = [int(t) for t in history]
    if not hist:
        return [0] * k
    n = len(hist)
    g = min(g, n)
    suffix = hist[n - g:]
    # Right to left: the suffix itself ends at n, so an earlier match
    # starts at n - g - 1 or before.
    for i in range(n - g - 1, -1, -1):
        if hist[i:i + g] == suffix:
            out = hist[i + g:i + g + k]
            while len(out) < k:
                out.append(out[-1] if out else hist[-1])
            return out
    return [hist[-1]] * k


class SelfDraft:
    """The k-gram self-draft: proposals from each live request's own
    token history, which the scheduler passes a slot at a time."""

    #: The scheduler builds the per-slot histories (prompt + tokens, host
    #: work a step) only for a proposer that reads them.
    needs_histories = True

    def __init__(self, num_slots: int, k: int, g: int = 3):
        if k < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {k}")
        self.num_slots = num_slots
        self.k = k
        self.g = g

    def propose(self, histories: Dict[int, Sequence[int]]) -> np.ndarray:
        """[num_slots, k] int32 proposals; the rows of slots without a
        history (inactive) are zeros the scheduler never reads."""
        props = np.zeros((self.num_slots, self.k), np.int32)
        for slot, hist in histories.items():
            props[slot] = kgram_propose(hist, self.k, self.g)
        return props

    # The lifecycle hooks the scheduler calls on every proposer; the
    # self-draft holds no device state.
    def observe_admit(self, slot, prompt, first_tok) -> None:
        pass

    def observe_free(self, slot) -> None:
        pass

    def sync_from(self, engine) -> None:
        pass

    def warmup(self) -> None:
        pass


def parse_draft_config(spec: str) -> dict:
    """``--serve.draft-config``: a bare size preset ("tiny") or
    comma-separated ``key=value`` TransformerConfig overrides with an
    optional ``size=`` entry (ints parsed, anything else kept as a
    string). Returns {"size": ..., "overrides": {...}}."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty draft_config")
    if "=" not in spec:
        return {"size": spec, "overrides": {}}
    size = "tiny"
    overrides = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"draft_config entry {part!r} is not key=value (or "
                f"pass a bare size preset like 'tiny')")
        key, val = (x.strip() for x in part.split("=", 1))
        if key == "size":
            size = val
            continue
        try:
            overrides[key] = int(val)
        except ValueError:
            overrides[key] = val
    return {"size": size, "overrides": overrides}


class DraftSpeculator:
    """A draft model proposing ``k`` tokens a slot a round from its own
    mirror of the slot cache: admitted through the same bucket ladder
    as the engine, its positions synced from the engine after every
    dispatch. Rejected draft rows lie past those positions and are
    written over by the next round before any attend reads them."""

    needs_histories = False   # the draft's cache is its history

    def __init__(self, model, num_slots: int, buckets: Sequence[int],
                 k: int):
        if k < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {k}")
        self.model = model
        self.device = next(model.parameters()).device
        self.num_slots = num_slots
        self.buckets = tuple(buckets)
        self.k = k
        self.cache = KVCache.zeros(model.cfg, num_slots, self.device)
        self.tok = np.zeros((num_slots,), np.int64)
        self.pos = np.zeros((num_slots,), np.int64)

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def _prefill_row(self, prompt: np.ndarray, slot: int) -> None:
        """The prompt padded to its bucket, prefilled into a fresh row
        that replaces ``slot``'s."""
        bucket = pick_bucket(len(prompt), self.buckets)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(prompt)] = prompt
        _, row = prefill_cache(self.model, self._h2d(padded))
        self.cache.put_row(row, slot)

    @torch.no_grad()
    def _ticks(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """``k + 1`` greedy decode ticks from every slot's pending token
        (JAX's scan): the last tick feeds the k-th proposal, so its K/V
        lands in the draft cache and a fully accepted round leaves no
        hole. Returns the first k ticks' tokens, [num_slots, k]."""
        out = []
        for _ in range(self.k + 1):
            last, _ = decode_token(self.model, self.cache, tok, pos)
            tok = last.argmax(dim=-1)
            pos = pos + 1
            out.append(tok)
        return torch.stack(out[:self.k], dim=1)

    def observe_admit(self, slot: int, prompt, first_tok: int) -> None:
        """Mirror an admission: prefill the draft's row for ``slot``; the
        pending token is the target's first token (the draft proposes,
        it never emits)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        self._prefill_row(prompt, slot)
        self.tok[slot] = first_tok
        self.pos[slot] = len(prompt)

    def observe_free(self, slot: int) -> None:
        self.tok[slot] = 0
        self.pos[slot] = 0

    def warmup(self) -> None:
        """Run each bucket's prefill, a row insert and a proposal round,
        then zero the draft cache: first-call costs move out of the
        first speculative round, and the cache and positions are left as
        a fresh draft's (a torch cache cannot be rolled back to an old
        object, as JAX's is, so it is zeroed)."""
        for b in self.buckets:
            self._prefill_row(np.zeros((b,), np.int64), 0)
        self._ticks(self._h2d(self.tok), self._h2d(self.pos))
        self.cache.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sync_from(self, engine) -> None:
        """Adopt the engine's pending token and position a slot after a
        verify (or plain) dispatch; the draft rows past them are dead
        and the next round writes over them."""
        self.tok[:] = engine.tok
        self.pos[:] = engine.pos

    def propose(self, histories: Dict[int, Sequence[int]]) -> np.ndarray:
        """[num_slots, k] proposals from the draft model (``histories``
        is ignored: the draft's cache is its history). One fetch of the
        proposals a round."""
        props = self._ticks(self._h2d(self.tok), self._h2d(self.pos))
        return props.cpu().numpy().astype(np.int32)


def build_speculator(cfg, model, seed: int, num_slots: int,
                     buckets: Sequence[int]) -> Optional[object]:
    """serve/run.py's factory: None when ``spec_tokens`` is 0; a
    :class:`SelfDraft` without ``draft_config``; else a draft GPT of the
    configured size with the target's vocabulary, ``max_len`` and
    compute dtype on the target's device, its weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (serve/run.py passes the
    run seed + 1, as JAX does), in a :class:`DraftSpeculator`."""
    from tensorflow_distributed_tpu_torch.models.transformer import (
        cast_dense_weights_, gpt_lm)

    serve = cfg.serve
    if not serve.spec_tokens:
        return None
    if not serve.draft_config:
        return SelfDraft(num_slots, serve.spec_tokens, g=serve.spec_kgram)
    parsed = parse_draft_config(serve.draft_config)
    overrides = dict(parsed["overrides"])
    overrides.setdefault("vocab_size", model.cfg.vocab_size)
    overrides.setdefault("max_len", model.cfg.max_len)
    overrides.setdefault("compute_dtype", model.cfg.compute_dtype)
    device = next(model.parameters()).device
    with torch.device(device):
        draft = gpt_lm(parsed["size"], dropout_rate=0.0, **overrides)
    draft.init_weights(torch.Generator(device=device).manual_seed(seed))
    cast_dense_weights_(draft)
    return DraftSpeculator(draft.eval(), num_slots, buckets,
                           serve.spec_tokens)

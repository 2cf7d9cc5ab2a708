"""Slot-based continuous-batching decode engine: the port of
``serve/engine.py``'s ``SlotDecodeEngine`` in its dense layout.

The engine owns one [num_slots, max_len, nk, Dh] K and V cache per
layer (a :class:`~..models.transformer.KVCache`; nk = H, or the K/V
heads under GQA) for its whole life. Slots are
occupied and freed between steps, so the request set changes while every
shape stays fixed per (num_slots, bucket):

- **prefill**: the prompt is padded to its bucket, ``prefill_cache``
  fills a fresh [1, max_len] cache row, the greedy first token is read
  at the TRUE last position, and the row replaces the slot's row
  wholesale (``KVCache.put_row``; a stale row is never written into);
- **step**: one ``decode_token`` over every slot at its own depth
  (per-row positions), then one fetch of the [num_slots] argmax;
- **free**: host bookkeeping only. A freed slot keeps riding the batched
  step, writing into its own row at position 0 with one column visible:
  garbage that the next prefill's row replaces and that no other row can
  attend.

Greedy only: the contract is token identity with one-shot greedy
``generate()`` per request. Speculation (``spec_tokens``), fault plans,
the decode watchdog, tensor parallelism and the verify / poison /
weight-swap surface are not ported yet and are refused (ROADMAP.md
queue A).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflow_distributed_tpu_torch.models.generate import (
    decode_token, prefill_cache)
from tensorflow_distributed_tpu_torch.models.transformer import KVCache
from tensorflow_distributed_tpu_torch.serve.buckets import (
    default_buckets, pick_bucket)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (see ROADMAP.md queue A)")


def zero_cache(model, num_slots: int) -> KVCache:
    """A zeroed [num_slots, max_len, nk, Dh] decode cache for ``model``,
    on its device."""
    device = next(model.parameters()).device
    return KVCache.zeros(model.cfg, num_slots, device)


class SlotDecodeEngine:
    """The slot cache and its prefill and decode step, with host-side
    slot bookkeeping. The scheduler (``serve/scheduler.py``) decides
    when to prefill and when to decode; this class owns what runs on
    the device."""

    def __init__(self, model, num_slots: int,
                 buckets: Optional[Sequence[int]] = None,
                 min_bucket: int = 16, spec_tokens: int = 0,
                 fault_plan=None, watchdog=None):
        cfg = model.cfg
        if not cfg.causal:
            raise ValueError("SlotDecodeEngine needs a causal model")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if spec_tokens:
            raise _not_ported("speculative decoding (spec_tokens > 0)")
        if fault_plan is not None:
            raise _not_ported("the serve fault plan")
        if watchdog is not None:
            raise _not_ported("the decode watchdog")
        self.model = model
        self.device = next(model.parameters()).device
        self.num_slots = num_slots
        self.max_len = cfg.max_len
        self.buckets: Tuple[int, ...] = (
            tuple(buckets) if buckets
            else default_buckets(cfg.max_len, min_bucket, cap=cfg.max_len))
        if max(self.buckets) > cfg.max_len:
            raise ValueError(
                f"largest bucket {max(self.buckets)} exceeds the model's "
                f"max_len {cfg.max_len}")
        self.cache = zero_cache(model, num_slots)
        self.tok = np.zeros((num_slots,), np.int64)
        self.pos = np.zeros((num_slots,), np.int64)
        self.active = np.zeros((num_slots,), bool)
        self._buckets_used: set = set()
        self.prefills = 0
        self.decode_steps = 0

    def cache_bytes_per_slot(self) -> int:
        """Device memory the decode cache spends per slot."""
        return self.cache.nbytes() // self.num_slots

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run (one per bucket used); the JAX
        engine compiles one program for each."""
        return len(self._buckets_used)

    def warmup(self) -> None:
        """Run each bucket's prefill, a row insert and a decode step
        against throwaway inputs, then zero the cache again: first-call
        costs (library handles, the allocator's growth) move to start-up
        instead of the first requests' time to first token. Host
        bookkeeping is untouched, so a warmed engine equals a fresh
        one."""
        for b in self.buckets:
            _, row = prefill_cache(
                self.model, torch.zeros((1, b), dtype=torch.long,
                                        device=self.device))
            self.cache.put_row(row, 0)
        decode_token(self.model, self.cache, self._h2d(self.tok),
                     self._h2d(self.pos))
        self.cache.zero_()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free_slots(self):
        return [s for s in range(self.num_slots) if not self.active[s]]

    def occupancy(self) -> float:
        return float(self.active.sum()) / self.num_slots

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Would this request's whole trajectory fit the cache?"""
        return (prompt_len <= max(self.buckets)
                and prompt_len + max_new_tokens <= self.max_len)

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def prefill(self, prompt, slot: int) -> int:
        """Admit a request into ``slot``: bucketed prefill, row insert,
        greedy first token. Returns the first generated token."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = len(prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if self.active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        bucket = pick_bucket(plen, self.buckets)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = prompt
        self._buckets_used.add(bucket)
        logits, row = prefill_cache(self.model, self._h2d(padded))
        self.cache.put_row(row, slot)
        # The time-to-first-token point: one scalar per admission.
        first = int(logits[0, plen - 1].argmax())
        self.tok[slot] = first
        self.pos[slot] = plen
        self.active[slot] = True
        self.prefills += 1
        return first

    @torch.no_grad()
    def step(self) -> np.ndarray:
        """One decode step over every slot; returns the [num_slots]
        next-token array (entries of inactive slots are garbage the
        scheduler never reads)."""
        if (self.pos[self.active] >= self.max_len).any():
            raise RuntimeError(
                "an active slot is at max_len: the scheduler admitted a "
                "request that cannot fit (fits() is the guard)")
        last, _ = decode_token(self.model, self.cache, self._h2d(self.tok),
                               self._h2d(self.pos))
        # The engine's output: one [num_slots] fetch a step drives
        # EOS/budget termination and streaming.
        nxt = last.argmax(dim=-1).cpu().numpy()
        act = self.active
        self.tok[act] = nxt[act]
        self.pos[act] += 1
        self.decode_steps += 1
        return nxt

    def free(self, slot: int) -> None:
        """Release a slot (host bookkeeping only; the next prefill
        replaces the row wholesale)."""
        self.active[slot] = False
        self.tok[slot] = 0
        self.pos[slot] = 0

    # -- the JAX engine's speculation and serve-under-fire surface ------

    def verify_step(self, *args, **kwargs):
        raise _not_ported("speculative verify (verify_step)")

    def set_spec_k(self, k: int) -> None:
        raise _not_ported("speculative decoding (set_spec_k)")

    def poison_slot(self, slot: int) -> None:
        raise _not_ported("the slot_nan fault drill (poison_slot)")

    def swap_params(self, new_params) -> None:
        raise _not_ported("the live weight swap (swap_params)")

"""PyTorch port: speculative decoding (``serve/speculate.py`` and the
engines' verify) against the JAX package.

- ``accept_length``, ``kgram_propose`` and ``parse_draft_config`` equal
  JAX's on tests/test_serve_slo.py's cases and on seeded random ones,
  errors included.
- The dense and the paged ``verify_step`` (tiny GPT, f32, weights carried
  from JAX) return JAX's chains and accept counts and move the slots to
  JAX's tokens and positions, round after round: with random proposals,
  with the target's own chain (everything accepted), and in a cache
  sized exactly to prompt + budget, where slots short of headroom take
  the plain path inside the verify (``tails``; ``last_verify_fallback``
  equal). The paged engine refuses a re-feed below ``private_start``.
- ``DraftSpeculator`` with the JAX draft's weights proposes JAX's tokens
  across admissions, syncs and frees; ``build_speculator`` builds JAX's
  kinds, the draft seeded by an explicit generator.
- Warmups leave the caches as fresh ones (zero), with the draft's too.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.serve import speculate as jspec
from tensorflow_distributed_tpu.serve.engine import (
    SlotDecodeEngine as JaxEngine)
from tensorflow_distributed_tpu.serve.paging import engine as jpe
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.serve import speculate as tspec
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from tensorflow_distributed_tpu_torch.serve.paging import engine as tpe
from torch_threads import _one_thread  # noqa: F401


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


# --- the host math ------------------------------------------------------

ACCEPT_CASES = [([5, 6, 7], [5, 6, 7, 8]), ([5, 6, 9], [5, 6, 7, 8]),
                ([1, 2, 3], [9, 9, 9, 9]), ([1, 2], [1, 2]), ([], [4]),
                ([3], [3, 3]), (np.array([[1, 2]]), np.array([[1, 2, 5]]))]


@pytest.mark.parametrize("props,nxt", ACCEPT_CASES)
def test_accept_length_equals_jax(props, nxt):
    assert (_outcome(tspec.accept_length, props, nxt)
            == _outcome(jspec.accept_length, props, nxt))


def _kgram_cases():
    cases = [([1, 2, 3, 4] * 3, 4, 3), ([1, 2, 3, 4] * 3, 6, 3),
             ([7, 8, 9], 3, 3), ([], 2, 3), ([4], 2, 3),
             ([5, 1, 2, 3, 5, 1, 2, 3], 6, 3), ([2, 2, 2], 4, 1)]
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(1, 40))
        cases.append((rng.integers(0, 4, n).tolist(), int(rng.integers(1, 6)),
                      int(rng.integers(1, 5))))
    return cases


@pytest.mark.parametrize("hist,k,g", _kgram_cases())
def test_kgram_propose_equals_jax(hist, k, g):
    assert tspec.kgram_propose(hist, k, g) == jspec.kgram_propose(hist, k, g)


@pytest.mark.parametrize("spec", ["tiny", "size=tiny,n_layers=1,pos_emb=rope",
                                  "tiny,n_layers=1", "", "  ", "small",
                                  "n_layers=1", "size=tiny, d_model=64 ,"])
def test_parse_draft_config_equals_jax(spec):
    assert (_outcome(tspec.parse_draft_config, spec)
            == _outcome(jspec.parse_draft_config, spec))


def test_self_draft_proposes_as_jax():
    hists = {0: [1, 2, 3, 1, 2, 3, 1], 2: [9], 3: list(range(10)) * 2}
    t, j = tspec.SelfDraft(4, 3, g=2), jspec.SelfDraft(4, 3, g=2)
    np.testing.assert_array_equal(t.propose(hists), j.propose(hists))
    assert t.needs_histories and j.needs_histories
    for cls in (tspec.SelfDraft, jspec.SelfDraft):
        with pytest.raises(ValueError, match="spec_tokens must be >= 1"):
            cls(2, 0)


# --- the verify on real engines -------------------------------------------

def _pair(**kw):
    jmodel = jtr.CausalLM(jtr.tiny_config(causal=True,
                                          compute_dtype=jnp.float32, **kw))
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32, **kw)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def _engines(kind, k, max_len=128, slots=3):
    """The port's and JAX's engine of ``kind`` on one tiny model, and the
    port's (dense) model."""
    jm, params, tm = _pair(max_len=max_len)
    if kind == "paged":
        return (tpe.PagedSlotEngine(tm, slots, page_size=8, spec_tokens=k),
                jpe.PagedSlotEngine(jm, params, slots, page_size=8,
                                    spec_tokens=k), tm)
    return (SlotDecodeEngine(tm, slots, spec_tokens=k),
            JaxEngine(jm, params, slots, spec_tokens=k), tm)


def _admit(engines, prompts, budget):
    for s, p in prompts.items():
        firsts = []
        for eng in engines:
            if getattr(eng, "paged", False):
                firsts.append(eng.prefill(p, s, max_new_tokens=budget))
            else:
                firsts.append(eng.prefill(p, s))
        assert firsts[0] == firsts[1]


def _same_verify(t, j, props, tails=None):
    """One verify on both engines: equal chains on the active rows, accept
    counts, fallbacks and the slots' tokens and positions."""
    tt, ta = t.verify_step(props, tails=tails)
    jt, ja = j.verify_step(props, tails=tails)
    act = t.active
    np.testing.assert_array_equal(act, j.active)
    np.testing.assert_array_equal(tt[act], np.asarray(jt)[act])
    np.testing.assert_array_equal(ta, ja)
    assert t.last_verify_fallback == j.last_verify_fallback
    np.testing.assert_array_equal(t.tok[act], j.tok[act])
    np.testing.assert_array_equal(t.pos, j.pos)
    assert (t.verify_steps, t.decode_steps) == (j.verify_steps,
                                                j.decode_steps)
    return tt, ta


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_step_equals_jax(kind):
    """Random proposals, then the target's own chain (the next round's
    proposals are this round's tail, so acceptance climbs), then the
    k-gram self-draft: every round's chain, accept counts and slot state
    equal JAX's."""
    k = 3
    t, j, tm = _engines(kind, k)
    rng = np.random.default_rng(1)
    prompts = {0: rng.integers(0, 64, 9), 2: rng.integers(0, 64, 21)}
    _admit((t, j), prompts, 40)
    assert t.verify_fallback_slots() == j.verify_fallback_slots() == []
    hist = {s: list(map(int, p)) + [int(t.tok[s])] for s, p in prompts.items()}
    accepted = 0
    for rnd in range(9):
        if rnd < 3:
            props = rng.integers(0, 64, (3, k))
        elif rnd < 6:
            props = tspec.SelfDraft(3, k).propose(hist)
        else:
            # The target's own greedy chain.
            props = np.zeros((3, k), np.int64)
            for s in prompts:
                props[s] = _greedy_chain(tm, hist[s], k)
        toks, acc = _same_verify(t, j, props)
        for s in prompts:
            hist[s] += [int(x) for x in toks[s, :acc[s]]]
            accepted += int(acc[s]) - 1
        if rnd >= 6:
            assert all(acc[s] == k + 1 for s in prompts)
    assert accepted > 0


def _greedy_chain(model, hist, k):
    """The next k greedy tokens after ``hist[:-1]`` fed with its pending
    last token (the verify's own chain), by one-shot ``generate``."""
    from tensorflow_distributed_tpu_torch.models.generate import generate

    out = generate(model, torch.tensor([hist[:-1]]), k + 1)[0].tolist()
    assert out[0] == hist[-1]
    return out[1:]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_fallback_tails_equal_jax(kind):
    """Two requests whose trajectories end exactly at a 32-token cache:
    near its end a slot short of verify headroom is re-fed its own last
    k + 1 tokens (``tails``) inside the verify while the other slot
    speculates; the chains, accept counts and fallbacks equal JAX's, and
    a missing or wrong tail raises JAX's message. A request leaves at its
    budget, as the scheduler frees it."""
    k = 3
    rng = np.random.default_rng(4)
    prompts = {0: rng.integers(0, 64, 20), 1: rng.integers(0, 64, 5)}
    budget = {0: 12, 1: 27}
    t, j, _ = _engines(kind, k, max_len=32, slots=2)
    _admit((t, j), prompts, 27)
    hist = {s: list(map(int, p)) + [int(t.tok[s])] for s, p in prompts.items()}
    live, mixed, fell = set(prompts), 0, set()
    while live:
        fb = t.verify_fallback_slots()
        assert fb == j.verify_fallback_slots() and fb is not None
        props = tspec.SelfDraft(2, k).propose({s: hist[s] for s in live})
        if fb:
            with pytest.raises(RuntimeError, match="no usable tail"):
                t.verify_step(props)
            bad = {s: hist[s][:-1] + [hist[s][-1] + 1] for s in fb}
            with pytest.raises(RuntimeError, match="must end in the pending"):
                t.verify_step(props, tails=bad)
            mixed += len(fb) < len(live)
            fell |= set(fb)
        toks, acc = _same_verify(t, j, props, tails={s: hist[s] for s in fb})
        for s in list(live):
            hist[s] += [int(x) for x in toks[s, :acc[s]]]
            if s in fb:
                assert acc[s] == 1
            if len(hist[s]) - len(prompts[s]) >= budget[s]:
                live.discard(s)
                t.free(s)
                j.free(s)
    assert mixed >= 1 and fell == {0, 1}


def test_paged_fallback_never_refeeds_shared_pages():
    """A slot whose re-feed would reach below its private start (into a
    shared prefix page) makes the whole batch step plainly (None), as
    JAX's guard does."""
    k = 3
    t, j, _ = _engines("paged", k, max_len=32, slots=2)
    prefix = np.random.default_rng(7).integers(0, 64, 24)
    for eng in (t, j):
        first = eng.prefill(prefix, 0, max_new_tokens=2)
        eng.step()
        eng.release(0, tokens=list(map(int, prefix)) + [first,
                                                        int(eng.tok[0])])
        # Three full pages of the prefix come back from the radix tree.
        eng.prefill(np.concatenate([prefix, [5, 6]]), 1, max_new_tokens=4)
    assert t.private_start[1] == j.private_start[1] == 24
    assert t.verify_fallback_slots() == j.verify_fallback_slots() == []
    for eng in (t, j):
        eng.pos[1] = 29              # short of headroom: re-feed from 26
    assert t.verify_fallback_slots() == j.verify_fallback_slots() == [1]
    for eng in (t, j):
        eng.private_start[1] = 27    # 26 would then lie in a shared page
    assert t.verify_fallback_slots() is None
    assert j.verify_fallback_slots() is None


# --- the draft model ---------------------------------------------------

class _Synced:
    """An engine's slot state as ``sync_from`` reads it."""

    def __init__(self, tok, pos):
        self.tok, self.pos = tok, pos


def test_draft_speculator_proposes_as_jax():
    """The JAX draft's weights carried into the port's: the mirrored
    prefill, the k + 1 ticks, syncs and frees give JAX's proposals."""
    k, slots = 4, 3
    jm, params, tm = _pair(max_len=64, n_layers=1)
    buckets = (8, 16, 32)
    t = tspec.DraftSpeculator(tm, slots, buckets, k)
    j = jspec.DraftSpeculator(jm, params, slots, buckets, k)
    assert not t.needs_histories and not j.needs_histories
    rng = np.random.default_rng(2)
    prompts = {0: rng.integers(0, 64, 7), 2: rng.integers(0, 64, 19)}
    for s, p in prompts.items():
        t.observe_admit(s, p, 11 + s)
        j.observe_admit(s, p, 11 + s)
    tok, pos = np.zeros(slots, np.int64), np.zeros(slots, np.int64)
    for s, p in prompts.items():
        tok[s], pos[s] = 11 + s, len(p)
    for rnd in range(4):
        tp, jp = t.propose({}), j.propose({})
        np.testing.assert_array_equal(tp[list(prompts)],
                                      np.asarray(jp)[list(prompts)])
        # The engine accepted a prefix of each row: resync.
        for s in prompts:
            a = (rnd + s) % (k + 1)
            tok[s] = tp[s, a - 1] + 1 if a else 3
            pos[s] += a + 1
        t.sync_from(_Synced(tok, pos))
        j.sync_from(_Synced(tok.astype(np.int32), pos.astype(np.int32)))
    t.observe_free(2)
    j.observe_free(2)
    assert t.pos[2] == j.pos[2] == 0 and t.tok[2] == j.tok[2] == 0
    np.testing.assert_array_equal(t.propose({})[0], np.asarray(j.propose({}))[0])


def _serve_cfg(**serve):
    cfg = TrainConfig(mode="serve", model="gpt_lm", model_size="tiny",
                      device="cpu")
    for name, value in serve.items():
        setattr(cfg.serve, name, value)
    return cfg


def test_build_speculator_makes_jax_kinds():
    """None without spec_tokens, the self-draft without a draft config,
    else a draft GPT of the target's vocab, max_len and compute dtype,
    on its device, its weights drawn from the given seed."""
    tm = ttr.gpt_lm("tiny", compute_dtype=torch.float32, max_len=48)
    assert tspec.build_speculator(_serve_cfg(), tm, 1, 2, (8,)) is None
    sd = tspec.build_speculator(_serve_cfg(spec_tokens=3, spec_kgram=2), tm,
                                1, 2, (8,))
    assert isinstance(sd, tspec.SelfDraft) and (sd.k, sd.g) == (3, 2)
    cfg = _serve_cfg(spec_tokens=2, draft_config="size=tiny,n_layers=1")
    d1 = tspec.build_speculator(cfg, tm, 5, 2, (8, 16))
    assert isinstance(d1, tspec.DraftSpeculator)
    dc = d1.model.cfg
    assert (dc.vocab_size, dc.max_len, dc.compute_dtype, dc.n_layers) == (
        tm.cfg.vocab_size, 48, torch.float32, 1)
    assert d1.buckets == (8, 16) and d1.k == 2
    d2 = tspec.build_speculator(cfg, tm, 5, 2, (8, 16))
    d3 = tspec.build_speculator(cfg, tm, 6, 2, (8, 16))
    w = [d.model.tok_emb.weight for d in (d1, d2, d3)]
    assert torch.equal(w[0], w[1]) and not torch.equal(w[0], w[2])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_warmup_leaves_fresh_caches(kind):
    """The engine's warmup (the verify included) and a draft's leave
    their caches zero and the host books untouched, as JAX's restore
    their old cache objects."""
    t, _, _ = _engines(kind, 2, max_len=32, slots=2)
    draft = tspec.DraftSpeculator(_pair(max_len=32)[2], 2, (8, 32), 2)
    t.warmup(draft)
    for cache in (t.cache, draft.cache):
        assert all(float(x.abs().sum()) == 0 for x in cache.leaves())
    assert not t.active.any() and not t.pos.any() and not draft.pos.any()
    assert t.verify_steps == t.decode_steps == 0

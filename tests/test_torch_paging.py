"""PyTorch port: the paged KV cache (``serve/paging``) against the JAX
package.

- ``PagePool`` and ``RadixCache`` replay 24 seeded random sequences of
  alloc, retain, release, insert, lookup (with a cap), session_store and
  evict_one beside JAX's own classes: every return, page id, refcount,
  free list, ``stats()`` and raised error is equal.
- The paged forward (the model's ``page_table`` branch) equals JAX's
  paged forward on the same tables, with a tail prefill at an offset
  whose bucket padding runs past ``max_len`` into the write-off page:
  logits and the gathered cache within 1e-5, and the port's paged
  logits equal its dense logits exactly (f32, the same bytes).
- ``PagedSlotEngine`` equals JAX's on tests/test_paging.py's workload (a
  shared prefix, an aligned prompt thrice for copy-on-write, a session
  re-attach), in f32 and int8: greedy streams, tables, page
  counts, private starts and ``paging_stats()`` after every request;
  the copy-on-write page that ``can_admit`` reserves; int8 paging equal
  to int8 dense.
- Both schedulers over both paged engines give the same completions
  with sessions and under pool pressure, and on host-only fake paged
  engines make the same decisions.
- The sizing (``page_bytes_estimate``, ``auto_num_pages``) and the
  config's checks equal JAX's.
"""

import dataclasses
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import TrainConfig as JaxConfig
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve.paging import engine as jpe
from tensorflow_distributed_tpu.serve.paging import pool as jpool
from tensorflow_distributed_tpu.serve.paging import radix as jradix
from tensorflow_distributed_tpu_torch import interop
from tensorflow_distributed_tpu_torch.config import TrainConfig
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from tensorflow_distributed_tpu_torch.serve.paging import engine as tpe
from tensorflow_distributed_tpu_torch.serve.paging import pool as tpool
from tensorflow_distributed_tpu_torch.serve.paging import radix as tradix
from torch_threads import _one_thread  # noqa: F401


# --- the pool and the radix cache against JAX's classes ----------------

def _call(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the error's kind and message must match
        return (type(e).__name__, str(e))


class _Pair:
    """One pool and radix cache of each package, driven in lockstep."""

    def __init__(self, num_pages, page_size):
        self.t = tradix.RadixCache(tpool.PagePool(num_pages, page_size))
        self.j = jradix.RadixCache(jpool.PagePool(num_pages, page_size))

    def both(self, name, *args, on="radix"):
        got = _call(getattr(self.t if on == "radix" else self.t.pool, name),
                    *args)
        want = _call(getattr(self.j if on == "radix" else self.j.pool, name),
                     *args)
        assert got == want, (name, args)
        return got

    def check_state(self):
        t, j = self.t, self.j
        np.testing.assert_array_equal(t.pool.ref, j.pool.ref)
        assert list(t.pool._free) == list(j.pool._free)
        assert t.pool.stats() == j.pool.stats()
        assert t.stats() == j.stats()
        assert (t.reclaimable_pages, t.cached_pages, t.sessions_live) == (
            j.reclaimable_pages, j.cached_pages, j.sessions_live)


@pytest.mark.parametrize("seed", range(24))
def test_pool_and_radix_replay_equal_jax(seed):
    rng = np.random.default_rng(seed)
    ps = int(rng.integers(1, 5))
    pair = _Pair(int(rng.integers(2, 24)), ps)
    # Prompts over a 3-token alphabet from a few stems: shared prefixes.
    stems = [list(rng.integers(0, 3, 12)) for _ in range(3)]
    owned = []                        # one entry per reference we hold

    def prompt():
        stem = stems[int(rng.integers(len(stems)))]
        n = int(rng.integers(0, 13))
        return [int(t) for t in stem[:n]] + [
            int(t) for t in rng.integers(0, 3, int(rng.integers(0, 4)))]

    def distinct(k):
        return list(dict.fromkeys(owned))[:k]

    for _ in range(60):
        op = rng.choice(["alloc", "retain", "release", "bad_release",
                         "insert", "lookup", "store", "evict", "retain_bad"])
        if op == "alloc":
            kind, out = pair.both("alloc", int(rng.integers(-1, 5)),
                                  on="pool")
            if kind == "ok":
                owned += out
        elif op == "retain" and owned:
            pids = distinct(2)
            if pair.both("retain", pids, on="pool")[0] == "ok":
                owned += pids
        elif op == "release" and owned:
            rng.shuffle(owned)
            k = int(rng.integers(1, len(owned) + 1))
            pair.both("release", owned[:k], on="pool")
            del owned[:k]
        elif op == "bad_release":
            pair.both("release", [int(rng.integers(-1, 26))], on="pool")
        elif op == "retain_bad":
            pair.both("retain", [int(rng.integers(-1, 26))], on="pool")
        elif op == "insert":
            toks = prompt()
            pair.both("insert", toks, distinct(-(-len(toks) // ps)))
        elif op == "lookup":
            sess = str(rng.choice(["", "a", "b"]))
            toks = prompt()
            kind, out = pair.both("lookup", sess, toks,
                                  int(rng.integers(-1, len(toks) + 2)))
            if kind == "ok":
                owned += out[0]
        elif op == "store":
            toks = prompt()
            pair.both("session_store", str(rng.choice(["", "a", "b"])), toks,
                      distinct(-(-len(toks) // ps)))
        elif op == "evict":
            pair.both("evict_one")
        pair.check_state()


def test_pool_surface_equals_jax():
    for args in [(6, 8), (1, 4), (4, 0), (2, 1)]:
        assert _call(tpool.PagePool, *args)[0] == _call(jpool.PagePool,
                                                        *args)[0]
    assert tpool.GARBAGE_PAGE == jpool.GARBAGE_PAGE == 0
    assert issubclass(tpool.PoolExhausted, RuntimeError)


# --- tiny models carried from JAX -------------------------------------

def _pair(**kw):
    jcfg = jtr.tiny_config(causal=True, compute_dtype=jnp.float32,
                           max_len=64, **kw)
    jmodel = jtr.CausalLM(jcfg)
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32, max_len=64,
                        **kw)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def tiny():
    return _pair()


@pytest.fixture(scope="module")
def tiny_int8():
    return _pair(kv_cache_quant="int8")


# --- the paged forward ---------------------------------------------------

PAGED = dict(kv_page_size=8, kv_num_pages=12)


def _gathered(cache, table):
    """A paged pool's leaves gathered through ``table`` into the dense
    [B, max_len, ...] layout."""
    return [t[torch.as_tensor(table).long()].reshape(
        (table.shape[0], -1) + tuple(t.shape[2:])) for t in cache.leaves()]


def _close_leaves(got, want, what):
    """Float leaves within 1e-5; int8 leaves equal, but for a step of one
    at a rounding tie in at most 0.1% of the entries (reported)."""
    for t, j in zip(got, want):
        if t.dtype == torch.int8:
            diff = (t.int() - j.int()).abs()
            off = int((diff > 0).sum())
            print(f"{what}: {off} of {diff.numel()} int8 entries one step off")
            assert int(diff.max()) <= 1 and off <= 1e-3 * diff.numel()
        else:
            torch.testing.assert_close(t, j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("opts", [dict(pos_emb="rope"),
                                  dict(pos_emb="rope", n_kv_heads=2,
                                       kv_cache_quant="int8"),
                                  dict(kv_cache_quant="int8")],
                         ids=["rope", "gqa_int8", "learned_int8"])
def test_paged_forward_equals_jax_and_the_dense_forward(opts):
    """Row 0 holds 3 pages (24 positions; the rest of its table is page
    0), row 1 all 8: a prefill of 20 tokens, then a tail of 3 at offset
    20 padded to a bucket of 16 (row 0's padding past its pages lands in
    page 0), then, for row 1, a tail at offset 57 whose padding runs past
    max_len 64 into page 0. Logits at the positions a row holds, and the
    cache gathered through the tables, within 1e-5 of JAX's; the port's
    paged logits equal its dense logits exactly."""
    jm, params, tm = _pair(**opts)
    jmp = jtr.CausalLM(dataclasses.replace(jm.cfg, **PAGED))
    tmp = ttr.gpt_lm("tiny", compute_dtype=torch.float32, max_len=64,
                     **opts, **PAGED)
    tmp.load_state_dict(tm.state_dict())
    rng = np.random.default_rng(7)
    table = np.zeros((2, 8), np.int32)
    table[0, :3] = [3, 7, 1]
    table[1, :] = [2, 4, 5, 6, 8, 9, 10, 11]
    held = np.array([24, 64])
    tcache, tdense = ttr.KVCache.zeros(tmp.cfg, 2), ttr.KVCache.zeros(tm.cfg, 2)
    jcache = None
    japply = jax.jit(lambda v, t, p, g: jmp.apply(
        v, t, decode=True, positions=p, page_table=g, mutable=["cache"]))
    for pos, rows in [(np.arange(20)[None].repeat(2, 0), [0, 1]),
                      (20 + np.arange(16)[None].repeat(2, 0), [0, 1]),
                      (57 + np.arange(16)[None], [1])]:
        toks = rng.integers(0, 64, pos.shape).astype(np.int32)
        variables = {"params": params}
        if jcache is not None:
            variables["cache"] = jcache
        jl, state = japply(variables, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(table[rows]))
        jcache = state["cache"]
        with torch.no_grad():
            tl = tmp(torch.from_numpy(toks).long(), decode=True,
                     positions=torch.from_numpy(pos), cache=tcache,
                     page_table=torch.from_numpy(table[rows]))
        # Positions past a row's pages are bucket padding nobody reads
        # (several of them share page 0's slots; JAX's learned lookup
        # fills NaN past max_len, ROADMAP.md queue C).
        real = pos < held[rows][:, None]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   rtol=0, atol=1e-5)
        if len(rows) == 2:
            with torch.no_grad():
                dl = tm(torch.from_numpy(toks).long(), decode=True,
                        positions=torch.from_numpy(pos), cache=tdense)
            assert torch.equal(tl[torch.from_numpy(real)],
                               dl[torch.from_numpy(real)])
    jgot = interop.cache_from_flax(jax.device_get(jcache))
    for row in (0, 1):
        n = int(held[row])
        _close_leaves([t[row, :n] for t in _gathered(tcache, table)],
                      [t[row, :n] for t in _gathered(jgot, table)],
                      f"row {row}")
    # The port's write-off page stays finite whatever lands in it.
    for t in tcache.leaves():
        assert torch.isfinite(t[0].float()).all()


def test_paged_forward_refusals(tiny):
    _, _, tm = tiny
    tok, pos = torch.tensor([[1]]), torch.tensor([[0]])
    dense = ttr.KVCache.zeros(tm.cfg, 1)
    with pytest.raises(ValueError, match="kv_page_size"):
        tm(tok, decode=True, positions=pos, cache=dense,
           page_table=torch.zeros((1, 8), dtype=torch.long))
    paged = ttr.gpt_lm("tiny", compute_dtype=torch.float32, max_len=64,
                       kv_page_size=8, kv_num_pages=4)
    pool = ttr.KVCache.zeros(paged.cfg, 1)
    assert pool.k[0].shape == (4, 8, 4, 8)
    with pytest.raises(ValueError, match="needs a page_table"):
        paged(tok, decode=True, positions=pos, cache=pool)
    with pytest.raises(ValueError, match="max_len/page_size"):
        paged(tok, decode=True, positions=pos, cache=pool,
              page_table=torch.zeros((1, 4), dtype=torch.long))
    one = ttr.gpt_lm("tiny", compute_dtype=torch.float32, max_len=64,
                     kv_page_size=8, kv_num_pages=1)
    with pytest.raises(ValueError, match="write-off"):
        one(tok, decode=True, positions=pos, cache=pool,
            page_table=torch.zeros((1, 8), dtype=torch.long))


# --- the paged engine against JAX's -----------------------------------

def _decode(eng, prompt, n, session=""):
    """tests/test_paging.py's helper: admit, decode to n tokens,
    release with the request's tokens."""
    slot = eng.free_slots()[0]
    if getattr(eng, "paged", False):
        first = eng.prefill(prompt, slot, max_new_tokens=n, session=session)
    else:
        first = eng.prefill(prompt, slot)
    toks = [first]
    while len(toks) < n:
        toks.append(int(eng.step()[slot]))
    if getattr(eng, "paged", False):
        eng.release(slot, tokens=list(prompt) + toks, session=session)
    else:
        eng.free(slot)
    return toks


def _same_books(t, j):
    np.testing.assert_array_equal(t.tables, j.tables)
    np.testing.assert_array_equal(t.page_count, j.page_count)
    np.testing.assert_array_equal(t.private_start, j.private_start)
    np.testing.assert_array_equal(t.pool.ref, j.pool.ref)
    assert t.paging_stats() == j.paging_stats()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_engine_equals_jax(quant, tiny, tiny_int8):
    """tests/test_paging.py's e2e workload on both packages' engines:
    radix hits, copy-on-write and a session re-attach, token for token,
    with the same books after every request."""
    jm, params, tm = tiny if quant == "none" else tiny_int8
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 64, 24).astype(np.int32)
    reqs = [np.concatenate([prefix, rng.integers(0, 64, 4 + i).astype(
        np.int32)]) for i in range(3)]
    aligned = rng.integers(0, 64, 32).astype(np.int32)  # COW trigger
    tp = tpe.PagedSlotEngine(tm, 2, page_size=8)
    jp = jpe.PagedSlotEngine(jm, params, 2, page_size=8)
    dense = SlotDecodeEngine(tm, 2)
    for r in reqs + [aligned] * 3:
        got = _decode(tp, r, 6)
        assert got == _decode(jp, r, 6)
        assert got == _decode(dense, r, 6)
        _same_books(tp, jp)
    assert tp.prefix_hits >= 2 and tp.cow_copies >= 1
    conv = list(reqs[0]) + _decode(dense, reqs[0], 6)
    turn2 = np.asarray(conv + [9, 8, 7], np.int32)
    tp2 = tpe.PagedSlotEngine(tm, 2, page_size=8)
    jp2 = jpe.PagedSlotEngine(jm, params, 2, page_size=8)
    for eng in (tp2, jp2):
        _decode(eng, reqs[0], 6, session="sess")
    assert (_decode(tp2, turn2, 5, session="sess")
            == _decode(jp2, turn2, 5, session="sess")
            == _decode(dense, turn2, 5))
    _same_books(tp2, jp2)
    assert tp2.prefix_hits == 1 and tp2.radix.sessions_live == 1


def test_can_admit_reserves_the_cow_page(tiny):
    """tests/test_paging.py's pin: a mid-page match needs one more page
    for its copy, and can_admit counts it, on both engines."""
    jm, params, tm = tiny
    rng = np.random.default_rng(6)
    cached = rng.integers(0, 64, 32).astype(np.int32)
    other = rng.integers(0, 64, 16).astype(np.int32)
    engines = [tpe.PagedSlotEngine(tm, 2, page_size=16, num_pages=6),
               jpe.PagedSlotEngine(jm, params, 2, page_size=16, num_pages=6)]
    outs = []
    for eng in engines:
        _decode(eng, cached, 4)
        eng.prefill(other, 0, max_new_tokens=16)
        assert eng.pool.free_count == 1
        assert not eng.can_admit(32, 1)
        eng.free(0)
        assert eng.can_admit(32, 1)
        outs.append(_decode(eng, cached, 4))
        assert eng.cow_copies == 1
    _same_books(*engines)
    assert outs[0] == outs[1] == _decode(SlotDecodeEngine(tm, 2), cached, 4)


def test_int8_paging_equals_int8_dense_and_thins_the_page(tiny, tiny_int8):
    _, _, tm = tiny
    _, _, tq = tiny_int8
    rng = np.random.default_rng(5)
    d8, p8 = SlotDecodeEngine(tq, 2), tpe.PagedSlotEngine(tq, 2, page_size=8)
    for i in range(3):
        pr = rng.integers(0, 64, 12 + 3 * i).astype(np.int32)
        assert _decode(p8, pr, 6) == _decode(d8, pr, 6)
    bf = tpe.PagedSlotEngine(tm, 2, page_size=8)
    assert p8.page_bytes() < bf.page_bytes()
    assert p8.page_bytes() == tpe.page_bytes_estimate(p8.model.cfg, 8)


def test_paged_engine_surface_and_refusals(tiny):
    _, _, tm = tiny
    with pytest.raises(ValueError, match="must divide"):
        tpe.PagedSlotEngine(tm, 2, page_size=7)
    with pytest.raises(ValueError, match="cannot hold even one"):
        tpe.PagedSlotEngine(tm, 2, page_size=8, num_pages=8)
    eng = tpe.PagedSlotEngine(tm, 2, page_size=8)
    assert eng.pool.num_pages == 1 + 2 * 2 * 8
    # The engine's model shares the caller's parameters.
    assert (eng.model.tok_emb.weight.data_ptr()
            == tm.tok_emb.weight.data_ptr())
    assert eng.cache.k[0].shape[:2] == (33, 8)
    eng.warmup()
    assert all(float(t.abs().sum()) == 0 for t in eng.cache.leaves())
    # Without spec_tokens there is no verify, as in JAX.
    assert eng.verify_fallback_slots() is None
    with pytest.raises(RuntimeError, match="spec_tokens > 0"):
        eng.verify_step(np.zeros((2, 1)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.set_spec_k(2)
    # The fire drills (tests/test_torch_serve_fire.py holds their parity):
    # an empty slot owns no page to poison, and the swap checks names.
    with pytest.raises(ValueError, match="no private pages"):
        eng.poison_slot(0)
    with pytest.raises(ValueError, match="tree structure"):
        eng.swap_params({})
    # Decode uploads the tables once, not every step.
    eng.prefill(np.arange(5), 0, max_new_tokens=4)
    eng.step()
    dev = eng._tables_dev
    eng.step()
    assert eng._tables_dev is dev
    eng.release(0)
    assert eng._tables_dev is None and eng.pool.pages_in_use == 0
    with pytest.raises(tpool.PoolExhausted, match="num-pages"):
        small = tpe.PagedSlotEngine(tm, 2, page_size=8, num_pages=9,
                                    radix=False)
        small.prefill(np.arange(40), 0, max_new_tokens=24)
        small.prefill(np.arange(40), 1, max_new_tokens=24)


# --- the scheduler over the paged engines -------------------------------

def _run_both(tiny_models, reqs_np, num_pages, sessions, max_new=6, dp=2):
    jm, params, tm = tiny_models
    out = []
    for mod, eng in ((tsched, tpe.PagedSlotEngine(tm, 2, page_size=8,
                                                  num_pages=num_pages)),
                     (jsched, jpe.PagedSlotEngine(jm, params, 2, page_size=8,
                                                  num_pages=num_pages))):
        reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=max_new,
                            session=sessions[i])
                for i, p in enumerate(reqs_np)]
        sched = mod.Scheduler(eng, decode_priority=dp)
        done = sched.run(reqs)
        out.append(({c.rid: (c.tokens, c.finish, c.queue_steps)
                     for c in done}, sched.summary, eng))
    return out


PAGING_KEYS = ("page_size", "num_pages", "page_bytes", "pages_per_max_len",
               "pages_in_use", "pages_peak", "pool_occupancy", "prefix_hits",
               "prefix_hit_tokens", "prompt_tokens", "prefix_hit_rate",
               "prefill_tokens_computed", "prefill_tokens_dense",
               "cow_copies", "page_evictions", "slot_pages_peak",
               "cached_pages", "sessions")


@pytest.mark.parametrize("case", ["sessions", "pressure"])
def test_schedulers_over_paged_engines_equal_jax(case, tiny):
    rng = np.random.default_rng(11)
    if case == "sessions":
        # Two conversations of three turns, each turn extending the last.
        base = [rng.integers(0, 64, n).astype(np.int32)
                for n in (9, 5, 4, 12, 3, 6)]
        prompts, sessions = [], []
        for g in (0, 3):
            for j in range(g, g + 3):
                prompts.append(base[j] if j == g
                               else np.concatenate([prompts[-1], base[j]]))
                sessions.append(f"s{g // 3}")
        num_pages = 0
    else:
        # A pool of 10 pages for 2 slots: admissions defer while live
        # slots hold the pages, evictions reclaim the cache.
        prompts = [rng.integers(0, 64, n).astype(np.int32)
                   for n in (30, 26, 17, 33, 8, 20)]
        sessions = [""] * len(prompts)
        num_pages = 10
    (tdone, tsum, teng), (jdone, jsum, jeng) = _run_both(
        tiny, prompts, num_pages, sessions)
    assert tdone == jdone
    for key in PAGING_KEYS:
        assert tsum[key] == jsum[key], key
    for key in ("requests", "total_new_tokens", "decode_steps", "prefills"):
        assert tsum[key] == jsum[key], key
    if case == "sessions":
        assert tsum["prefix_hits"] >= 4 and tsum["sessions"] == 2
    else:
        assert tsum["page_evictions"] > 0
    dense = SlotDecodeEngine(tiny[2], 2)
    for i, p in enumerate(prompts):
        assert tdone[i][0] == _decode(dense, p, 6), i


class _Clock:
    """test_torch_serve.py's fake clock."""

    STEP_S, PREFILL_S = 0.01, 0.003

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(seconds, 1e-9)


class _FakePagedEngine:
    """tests/test_paging.py's host-only paged stand-in (token stream
    rid*100 + step; the rid rides the prompt's head) on a fake clock."""

    paged = True

    def __init__(self, clock, num_slots=2, admit_ok=True):
        self.clock = clock
        self.num_slots = num_slots
        self.max_len = 256
        self.buckets = (32, 64)
        self.active = np.zeros((num_slots,), bool)
        self.slot_rid, self.counts = {}, {}
        self.prefills = self.prefill_compiles = self.decode_steps = 0
        self.admit_ok = admit_ok
        self.released, self.admitted, self.events = [], [], []

    def fits(self, plen, max_new):
        return plen + max_new <= self.max_len

    def free_slots(self):
        return [s for s in range(self.num_slots) if not self.active[s]]

    def occupancy(self):
        return float(self.active.sum()) / self.num_slots

    def can_admit(self, plen, max_new):
        return (self.admit_ok if isinstance(self.admit_ok, bool)
                else self.admit_ok(self, plen, max_new))

    def prefill(self, prompt, slot, max_new_tokens=0, session=""):
        rid = int(prompt[0])
        self.active[slot] = True
        self.slot_rid[slot] = rid
        self.counts[rid] = 1
        self.prefills += 1
        self.admitted.append((rid, max_new_tokens, session))
        self.events.append(("admit", rid))
        self.clock.t += self.clock.PREFILL_S
        return rid * 100

    def step(self):
        out = np.zeros((self.num_slots,), np.int32)
        for s in range(self.num_slots):
            if self.active[s]:
                rid = self.slot_rid[s]
                out[s] = rid * 100 + self.counts[rid]
                self.counts[rid] += 1
        self.decode_steps += 1
        self.clock.t += self.clock.STEP_S
        return out

    def release(self, slot, tokens=None, session=""):
        self.released.append((self.slot_rid.get(slot), tokens, session))
        self.events.append(("release", self.slot_rid.get(slot)))
        self.active[slot] = False

    def free(self, slot):
        self.release(slot)

    def paging_stats(self):
        return {"pool_occupancy": 0.5, "prefix_hit_rate": 0.25,
                "page_evictions": 2, "cow_copies": 1}


FAKE_CASES = {
    "context": dict(sessions=["conv0", "conv1", "conv2"], admit=True),
    "turn_order": dict(sessions=["conv", "conv", "", "conv", "x", "x"],
                       admit=True),
    "pressure": dict(sessions=[""] * 4,
                     admit=lambda e, p, n: not e.active.any()),
}


@pytest.mark.parametrize("name", sorted(FAKE_CASES))
def test_schedulers_make_jax_paged_decisions_on_fake_engines(name,
                                                             monkeypatch):
    case = FAKE_CASES[name]
    runs = []
    for mod in (tsched, jsched):
        clock = _Clock()
        monkeypatch.setattr(time, "sleep", clock.sleep)
        eng = _FakePagedEngine(clock, admit_ok=case["admit"])
        reqs = [mod.Request(rid=i, prompt=np.asarray([i], np.int32),
                            max_new_tokens=3 + i % 3, session=s,
                            arrival_s=0.004 * i)
                for i, s in enumerate(case["sessions"])]
        sched = mod.Scheduler(eng, decode_priority=1, clock=clock)
        done = sched.run(reqs)
        runs.append(([(c.rid, c.tokens, c.finish, c.queue_steps)
                      for c in done], eng.admitted, eng.released, eng.events,
                     {k: sched.summary[k] for k in
                      ("pool_occupancy", "prefix_hit_rate", "page_evictions",
                       "cow_copies", "decode_steps", "total_new_tokens")}))
    assert runs[0] == runs[1]
    events = runs[0][3]
    assert all(tokens is not None for _, tokens, _ in runs[0][2])
    if name == "turn_order":
        # A session's turn admits only after its earlier turn released.
        for a, b in ((0, 1), (1, 3), (4, 5)):
            assert events.index(("release", a)) < events.index(("admit", b))
    if name == "pressure":
        # One request at a time: each admission follows a release.
        assert events == [(kind, rid) for rid in range(4)
                          for kind in ("admit", "release")]


def test_idle_engine_that_cannot_admit_raises_like_jax(monkeypatch):
    for mod in (tsched, jsched):
        clock = _Clock()
        monkeypatch.setattr(time, "sleep", clock.sleep)
        with pytest.raises(RuntimeError, match="raise --serve.num-pages"):
            mod.Scheduler(_FakePagedEngine(clock, admit_ok=False),
                          clock=clock).run(
                [mod.Request(rid=0, prompt=np.asarray([0], np.int32),
                             max_new_tokens=3)])


# --- sizing and config ---------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(compute_dtype=torch.float32),
    dict(compute_dtype=torch.bfloat16),
    dict(compute_dtype=torch.bfloat16, kv_cache_quant="int8"),
    dict(compute_dtype=torch.float32, kv_cache_quant="int8", n_kv_heads=2),
    dict(compute_dtype=torch.bfloat16, n_kv_heads=1)])
def test_page_bytes_estimate_equals_the_engine_and_jax(opts):
    tm = ttr.gpt_lm("tiny", max_len=64, **opts)
    jdtype = {torch.float32: jnp.float32,
              torch.bfloat16: jnp.bfloat16}[opts["compute_dtype"]]
    jcfg = jtr.tiny_config(causal=True, max_len=64, **dict(
        opts, compute_dtype=jdtype))
    for ps in (4, 8, 16):
        eng = tpe.PagedSlotEngine(tm, 2, page_size=ps)
        assert eng.page_bytes() == tpe.page_bytes_estimate(tm.cfg, ps)
        assert (tpe.page_bytes_estimate(tm.cfg, ps)
                == jpe.page_bytes_estimate(jcfg, ps))
        assert eng.cache_bytes_per_slot() == eng.page_bytes() * 64 // ps


@pytest.mark.parametrize("slots", [1, 4, 8])
@pytest.mark.parametrize("budget", [0, 2 ** 19, 2 ** 20, 3 * 2 ** 20, 10,
                                    2 ** 30])
def test_auto_num_pages_equals_jax(slots, budget):
    for need in (1, 9, 64):
        kw = dict(num_slots=slots, need_pages=need, page_bytes=36864,
                  budget_bytes=budget, reserved_bytes=2 ** 19)
        assert tpe.auto_num_pages(**kw) == jpe.auto_num_pages(**kw)


CONFIG_CASES = [
    dict(paged=True, page_size=8, num_pages=64, session_turns=2),
    dict(page_size=8), dict(num_pages=64), dict(radix=False),
    dict(paged=True, page_size=0), dict(paged=True, num_pages=-1),
    dict(session_turns=0), dict(session_turns=2, requests="r.jsonl"),
    dict(kv_dtype="fp8"), dict(kv_dtype="int8"),
    dict(hbm_budget_gb=-1.0), dict(hbm_budget_gb=2.0),
    dict(paged=True, hbm_budget_gb=2.0),
    dict(paged=True, hbm_budget_gb=2.0, num_pages=32),
]


@pytest.mark.parametrize("serve", CONFIG_CASES, ids=range(len(CONFIG_CASES)))
def test_paged_config_validation_equals_jax(serve):
    def outcome(cls):
        cfg = cls(mode="serve", model="gpt_lm")
        for k, v in serve.items():
            setattr(cfg.serve, k, v)
        try:
            cfg.validate()
            return "ok"
        except ValueError as e:
            return str(e)

    assert outcome(TrainConfig) == outcome(JaxConfig)


@pytest.mark.parametrize("value", ["none", "int8", "int4"])
def test_kv_cache_quant_validation_equals_jax(value):
    def outcome(cls):
        try:
            cls(model="gpt_lm", mode="serve", kv_cache_quant=value).validate()
            return "ok"
        except ValueError as e:
            return str(e)

    assert outcome(TrainConfig) == outcome(JaxConfig)

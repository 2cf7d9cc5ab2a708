"""PyTorch port: the SLO scheduler (classes, tenant quotas,
preempt-and-requeue) and the speculative dispatch, against the JAX
package.

- ``parse_slo_mix`` and ``SLO_CLASSES`` equal JAX's, errors included.
- On copies of tests/test_serve_slo.py's fake engines (continuation-aware
  token streams, a verify that accepts a set count) advancing one fake
  clock, the port's and JAX's schedulers make the same decisions:
  admission order, completions (tokens, finish, queue steps, preemptions,
  class, tenant), ``on_token`` streams, the speculator's lifecycle calls
  and the summary's counts. The cases: no priority inversion, quota
  deferral, preemption on and off, victim choice (class, tokens
  delivered, quota, a ladder too tight), speculative retirement with
  truncation at the budget and at EOS, and the headroom fallback.
- On real tiny engines (f32, weights carried from JAX), dense and paged,
  with and without speculation: the SLO run's completions equal JAX's
  (``preempts`` per request included) and every stream equals one-shot
  ``generate()``; the paged engine's hit and compute counters equal
  JAX's, each preemption coming back as a prefix hit; a cache sized
  exactly to prompt + budget runs mixed verify dispatches.
- ``--mode serve --serve.spec-tokens 4 --serve.policy slo`` through the
  CLI serves every token and prints JAX's speculative and slo lines.
"""

import json
import re
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu.config import parse_args as jax_parse_args
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.serve import run as jrun
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve import speculate as jspec
from tensorflow_distributed_tpu.serve.buckets import default_buckets
from tensorflow_distributed_tpu.serve.engine import (
    SlotDecodeEngine as JaxEngine)
from tensorflow_distributed_tpu.serve.paging import engine as jpe
from tensorflow_distributed_tpu_torch import cli, interop
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.models.generate import generate
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve import speculate as tspec
from tensorflow_distributed_tpu_torch.serve.engine import SlotDecodeEngine
from tensorflow_distributed_tpu_torch.serve.paging import engine as tpe
from torch_threads import _one_thread  # noqa: F401


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", [
    "high:0.25,batch:0.25", "high:1", "", " high : 0.5 , ", "gold:0.5",
    "high=0.5", "high:0.2,high:0.2", "high:0.8,batch:0.4", "batch:1.5",
    "standard:0.3", "standard:0.25,high:0.25,batch:0.5"])
def test_parse_slo_mix_equals_jax(spec):
    assert (_outcome(tsched.parse_slo_mix, spec)
            == _outcome(jsched.parse_slo_mix, spec))
    assert tsched.SLO_CLASSES == jsched.SLO_CLASSES


@pytest.mark.parametrize("n", [1, 2, 5, 20])
@pytest.mark.parametrize("q", [0, 50, 95, 100])
def test_percentile_is_nearest_rank_as_jax(n, q):
    from tensorflow_distributed_tpu.observe.slo import percentile

    vals = sorted(np.random.default_rng(n).random(n).tolist())
    assert tsched.percentile(vals, q) == percentile(vals, q)


# --- the schedulers on fake engines --------------------------------------

class _Clock:
    """A fake clock: reads cost nothing; a decode or verify step advances
    it by STEP_S, a prefill by PREFILL_S, ``time.sleep`` by its argument
    (at least a nanosecond)."""

    STEP_S, PREFILL_S = 0.01, 0.003

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(seconds, 1e-9)


class _SLOFakeEngine:
    """tests/test_serve_slo.py's host-only engine, advancing a fake
    clock: the token stream is a pure function of (rid, tokens emitted
    so far), so a continuation's prefill resumes the same stream. The
    rid rides prompt[0]; emitted count = len(prompt) - 1."""

    def __init__(self, clock, num_slots=1, max_len=256):
        self.clock = clock
        self.num_slots = num_slots
        self.max_len = max_len
        self.buckets = (64, 128)
        self.active = np.zeros((num_slots,), bool)
        self.slot_rid = {}
        self.counts = {}
        self.prefills = 0
        self.prefill_compiles = 0
        self.decode_steps = 0

    def fits(self, plen, max_new):
        return plen + max_new <= self.max_len

    def free_slots(self):
        return [s for s in range(self.num_slots) if not self.active[s]]

    def occupancy(self):
        return float(self.active.sum()) / self.num_slots

    def prefill(self, prompt, slot):
        rid = int(prompt[0])
        self.active[slot] = True
        self.slot_rid[slot] = rid
        self.counts[rid] = len(prompt) - 1   # continuation-aware
        self.prefills += 1
        self.clock.t += self.clock.PREFILL_S
        return rid * 100 + self.counts[rid]

    def step(self):
        out = np.zeros((self.num_slots,), np.int32)
        for s in range(self.num_slots):
            if self.active[s]:
                rid = self.slot_rid[s]
                self.counts[rid] += 1
                out[s] = rid * 100 + self.counts[rid]
        self.decode_steps += 1
        self.clock.t += self.clock.STEP_S
        return out

    def free(self, slot):
        self.active[slot] = False


class _SpecFakeEngine(_SLOFakeEngine):
    """The speculative surface: every verify accepts ``accept`` proposals
    (+ the bonus), emitting the same stream in chunks."""

    def __init__(self, clock, num_slots=1, max_len=256, spec_tokens=3,
                 accept=None):
        super().__init__(clock, num_slots, max_len)
        self.spec_tokens = spec_tokens
        self.accept = spec_tokens if accept is None else accept
        self.verify_steps = 0

    def can_verify(self):
        return True

    def verify_step(self, props):
        k = self.spec_tokens
        assert np.asarray(props).shape == (self.num_slots, k)
        toks = np.zeros((self.num_slots, k + 1), np.int32)
        acc = np.zeros((self.num_slots,), np.int32)
        for s in range(self.num_slots):
            if not self.active[s]:
                continue
            rid = self.slot_rid[s]
            a = min(self.accept, k)
            for j in range(a + 1):
                self.counts[rid] += 1
                toks[s, j] = rid * 100 + self.counts[rid]
            acc[s] = a + 1
        self.decode_steps += 1
        self.verify_steps += 1
        self.clock.t += self.clock.STEP_S
        return toks, acc


class _FlakyFakeEngine(_SpecFakeEngine):
    """Verify headroom every other step only (JAX's fallback case)."""

    def can_verify(self):
        return self.decode_steps % 2 == 0


class _CountingSpeculator:
    """Records the scheduler's lifecycle calls; proposes zeros."""

    def __init__(self, num_slots, k):
        self.num_slots, self.k = num_slots, k
        self.admits, self.frees, self.hists = [], [], []
        self.syncs = 0

    def propose(self, histories):
        assert all(len(h) > 0 for h in histories.values())
        self.hists.append({s: list(h) for s, h in histories.items()})
        return np.zeros((self.num_slots, self.k), np.int32)

    def observe_admit(self, slot, prompt, first_tok):
        self.admits.append((slot, int(first_tok)))

    def observe_free(self, slot):
        self.frees.append(slot)

    def sync_from(self, engine):
        self.syncs += 1


def _r(rid, new, slo="standard", tenant="", at=0.0, plen=1, eos=-1):
    return dict(rid=rid, prompt=[rid] * plen, max_new_tokens=new, slo=slo,
                tenant=tenant, arrival_s=at, eos_id=eos)


FAKE_CASES = {
    # tests/test_serve_slo.py's cases, on the step clock.
    "inversion_fifo": dict(reqs=[_r(0, 4), _r(1, 4, "batch"), _r(2, 4),
                                 _r(3, 4, "high"), _r(4, 4, "high")],
                           sched=dict(policy="fifo")),
    "inversion_slo": dict(reqs=[_r(0, 4), _r(1, 4, "batch"), _r(2, 4),
                                _r(3, 4, "high"), _r(4, 4, "high")],
                          sched=dict(policy="slo")),
    "quota": dict(reqs=[_r(0, 6, tenant="a"), _r(1, 6, tenant="a"),
                        _r(2, 6, tenant="b")],
                  sched=dict(policy="slo", tenant_quota=4)),
    "no_quota": dict(reqs=[_r(0, 6, tenant="a"), _r(1, 6, tenant="a"),
                           _r(2, 6, tenant="b")], sched=dict(policy="slo")),
    "preempt": dict(reqs=[_r(0, 12, "batch"), _r(1, 4, "high", at=0.035)],
                    sched=dict(policy="slo")),
    "preempt_off": dict(reqs=[_r(0, 12, "batch"),
                              _r(1, 4, "high", at=0.035)],
                        sched=dict(policy="slo", preempt=False)),
    "preempt_fifo": dict(reqs=[_r(0, 12, "batch"),
                               _r(1, 4, "high", at=0.035)],
                         sched=dict(policy="fifo")),
    # Two slots: the batch request that delivered the most is evicted.
    "victim_tokens": dict(reqs=[_r(0, 30, "batch"),
                                _r(1, 30, "batch", at=0.052),
                                _r(2, 5, "high", at=0.1)],
                          slots=2, sched=dict(policy="slo")),
    # A standard and a batch request live: the batch one goes.
    "victim_class": dict(reqs=[_r(0, 30, "batch", at=0.02), _r(1, 30),
                               _r(2, 5, "high", at=0.1)],
                         slots=2, sched=dict(policy="slo")),
    # Equal classes: an over-quota tenant is evicted for an under-quota
    # one, never the other way round.
    "victim_quota": dict(reqs=[_r(0, 30, tenant="a"),
                               _r(1, 8, tenant="b", at=0.12),
                               _r(2, 6, tenant="a", at=0.3)],
                         sched=dict(policy="slo", tenant_quota=5)),
    # A victim whose continuation outgrows the ladder is skipped.
    "ladder": dict(reqs=[_r(0, 10, "batch", plen=7),
                         _r(1, 3, "high", at=0.04)],
                   buckets=(8,), sched=dict(policy="slo")),
    # Preempted twice: the continuation of a continuation.
    "preempt_twice": dict(reqs=[_r(0, 40, "batch"),
                                _r(1, 4, "high", at=0.05),
                                _r(2, 4, "high", at=0.2)],
                          sched=dict(policy="slo", decode_priority=1)),
    # Speculation: retirement, budget and EOS cut mid-chain, fallback.
    "spec_stats": dict(reqs=[_r(i, 9) for i in range(3)], slots=2,
                       spec=3, sched=dict()),
    "spec_budget": dict(reqs=[_r(1, 7)], spec=4, sched=dict()),
    "spec_eos": dict(reqs=[_r(1, 20, eos=103)], spec=4, sched=dict()),
    "spec_partial": dict(reqs=[_r(i, 11, at=0.01 * i) for i in range(4)],
                         slots=2, spec=4, accept=2, sched=dict()),
    "spec_fallback": dict(reqs=[_r(2, 10)], spec=3, flaky=True,
                          sched=dict()),
    "spec_slo_preempt": dict(reqs=[_r(0, 30, "batch"),
                                   _r(1, 9, "high", at=0.03),
                                   _r(2, 9, "standard", at=0.05)],
                             spec=2, accept=1, sched=dict(policy="slo")),
}


def _drive_fake(module, case, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    slots = case.get("slots", 1)
    if case.get("spec"):
        cls = _FlakyFakeEngine if case.get("flaky") else _SpecFakeEngine
        eng = cls(clock, slots, spec_tokens=case["spec"],
                  accept=case.get("accept"))
        spec = _CountingSpeculator(slots, case["spec"])
    else:
        eng, spec = _SLOFakeEngine(clock, slots), None
    if "buckets" in case:
        eng.buckets = case["buckets"]
    seen = []
    kw = dict(case["sched"])
    sched = module.Scheduler(eng, decode_priority=kw.pop("decode_priority", 2),
                             clock=clock, speculator=spec,
                             on_token=lambda *a: seen.append(a), **kw)
    reqs = [module.Request(**dict(r, prompt=np.asarray(r["prompt"], np.int32)))
            for r in case["reqs"]]
    done = sched.run(reqs)
    comps = [(c.rid, c.tokens, c.finish, c.queue_steps, c.prompt_len,
              c.preempts, c.slo, c.tenant, c.decoded) for c in done]
    lifecycle = ((spec.admits, spec.frees, spec.syncs, spec.hists)
                 if spec else None)
    return (comps, seen, sched.summary, lifecycle,
            (eng.decode_steps, getattr(eng, "verify_steps", 0), eng.prefills))


def _expected(rid, new, plen=1):
    return [rid * 100 + plen - 1 + j for j in range(new)]


@pytest.mark.parametrize("name", sorted(FAKE_CASES))
def test_schedulers_make_jax_slo_and_spec_decisions(name, monkeypatch):
    case = FAKE_CASES[name]
    t = _drive_fake(tsched, case, monkeypatch)
    j = _drive_fake(jsched, case, monkeypatch)
    assert t[0] == j[0]                  # completions, in finish order
    assert t[1] == j[1]                  # the on_token stream
    assert t[3] == j[3]                  # the speculator's calls
    assert t[4] == j[4]                  # engine dispatches
    tsum, jsum = t[2], j[2]
    ints = [k for k, v in tsum.items()
            if isinstance(v, int) and not isinstance(v, bool) and k in jsum]
    assert {"requests", "total_new_tokens", "decoded_tokens", "decode_steps",
            "preemptions"} <= set(ints)
    assert {k: tsum[k] for k in ints} == {k: jsum[k] for k in ints}
    for key in ("accept_rate", "policy", "mean_slot_occupancy"):
        assert tsum.get(key) == jsum.get(key), key
    # Every stream is the request's own, whatever the policy did.
    for rid, tokens, finish, *_ in t[0]:
        req = next(r for r in case["reqs"] if r["rid"] == rid)
        want = _expected(rid, req["max_new_tokens"], len(req["prompt"]))
        if req["eos_id"] in want:
            want = want[:want.index(req["eos_id"]) + 1]
        assert tokens == want, rid
    # The streamed tokens are exactly the retired ones.
    for rid, tokens, *_ in t[0]:
        assert [tok for r, tok, _ in t[1] if r == rid] == tokens


def test_fake_cases_pin_jax_outcomes(monkeypatch):
    """The cases do what tests/test_serve_slo.py pins (a guard on the
    sweep above: it compares the schedulers, these name the behavior)."""
    def run(name):
        comps, seen, summary, _, disp = _drive_fake(tsched, FAKE_CASES[name],
                                                    monkeypatch)
        order = []
        for rid, *_ in seen:
            if rid not in order:
                order.append(rid)
        return {c[0]: c for c in comps}, order, summary, disp

    assert run("inversion_fifo")[1] == [0, 1, 2, 3, 4]
    assert run("inversion_slo")[1] == [3, 4, 0, 2, 1]
    assert run("quota")[1] == [0, 2, 1] and run("no_quota")[1] == [0, 1, 2]
    comps, _, summary, _ = run("preempt")
    assert summary["preemptions"] == 1 and comps[0][5] == 1
    assert comps[1][8] == 4          # the high request decoded in full
    assert run("preempt_off")[2]["preemptions"] == 0
    assert run("ladder")[2]["preemptions"] == 0
    assert run("preempt_twice")[0][0][5] == 2
    comps = run("victim_tokens")[0]
    assert (comps[0][5], comps[1][5], comps[2][5]) == (1, 0, 0)
    comps = run("victim_class")[0]
    assert (comps[0][5], comps[1][5]) == (1, 0)
    comps = run("victim_quota")[0]
    assert (comps[0][5], comps[1][5], comps[2][5]) == (1, 0, 0)
    _, _, summary, (steps, verifies, _) = run("spec_fallback")
    assert 0 < verifies < steps and summary["spec_batch_fallbacks"] > 0
    comps, _, summary, _ = run("spec_budget")
    assert len(comps[1][1]) == 7 and comps[1][2] == "length"
    assert run("spec_eos")[0][1][2] == "eos"
    assert run("spec_stats")[2]["accept_rate"] == 1.0


# --- real engines ----------------------------------------------------------

def _pair(**kw):
    jmodel = jtr.CausalLM(jtr.tiny_config(causal=True,
                                          compute_dtype=jnp.float32, **kw))
    params = nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tmodel = ttr.gpt_lm("tiny", compute_dtype=torch.float32, **kw)
    tmodel.load_state_dict(interop.params_from_flax(jax.device_get(params)))
    return jmodel, params, tmodel


def _clocked(eng, clock):
    """The engine's dispatches advance the fake clock (so both packages'
    schedulers see the same times whatever their speed)."""
    for name, dt in (("prefill", clock.PREFILL_S), ("step", clock.STEP_S),
                     ("verify_step", clock.STEP_S)):
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, _dt=dt, **kw):
            clock.t += _dt
            return _fn(*a, **kw)

        setattr(eng, name, wrapped)
    return eng


REAL_REQS = [  # rid, prompt length, budget, class, tenant, arrival
    (0, 10, 16, "batch", "a", 0.0), (1, 9, 16, "standard", "b", 0.0),
    (2, 12, 8, "high", "a", 0.035), (3, 8, 12, "standard", "b", 0.05),
    (4, 9, 8, "high", "b", 0.12), (5, 14, 10, "batch", "a", 0.13)]


def _real_run(module, kind, model, spec_k, max_len, monkeypatch, policy,
              page_size=8):
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    rng = np.random.default_rng(8)
    prompts = {rid: rng.integers(0, 64, n).astype(np.int32)
               for rid, n, *_ in REAL_REQS}
    need = max(n + new for _, n, new, *_ in REAL_REQS)
    buckets = default_buckets(need, cap=max_len)
    jax_side = module is jsched
    args = (model if not jax_side else model[0],)
    if jax_side:
        args += (model[1],)
    if kind == "paged":
        eng = (jpe if jax_side else tpe).PagedSlotEngine(
            *args, 2, page_size=page_size, buckets=buckets,
            spec_tokens=spec_k)
    else:
        eng = (JaxEngine if jax_side else SlotDecodeEngine)(
            *args, 2, buckets=buckets, spec_tokens=spec_k)
    spec = None
    if spec_k:
        spec = (jspec if jax_side else tspec).SelfDraft(2, spec_k)
    sched = module.Scheduler(_clocked(eng, clock), decode_priority=2,
                             clock=clock, policy=policy, tenant_quota=20,
                             speculator=spec)
    done = sched.run([module.Request(rid=rid, prompt=prompts[rid],
                                     max_new_tokens=new, slo=slo,
                                     tenant=tenant, arrival_s=at)
                      for rid, _, new, slo, tenant, at in REAL_REQS])
    return ({c.rid: (c.tokens, c.finish, c.queue_steps, c.preempts,
                     c.prompt_len, c.decoded) for c in done},
            sched.summary, eng, prompts)


@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_real_slo_runs_equal_jax_and_generate(kind, spec_k, monkeypatch):
    """Six requests of three classes and two tenants (quota 20) arriving
    while two slots are busy: preemptions happen, and the port's
    completions, summary counts and (paged) hit and compute counters
    equal JAX's; every stream equals one-shot greedy ``generate()``,
    and the FIFO run's."""
    jm, params, tm = _pair(max_len=64)
    got, tsum, teng, prompts = _real_run(tsched, kind, tm, spec_k, 64,
                                         monkeypatch, "slo")
    want, jsum, jeng, _ = _real_run(jsched, kind, (jm, params), spec_k, 64,
                                    monkeypatch, "slo")
    assert got == want
    assert tsum["preemptions"] == jsum["preemptions"] >= 1
    for key in ("requests", "total_new_tokens", "decoded_tokens",
                "decode_steps", "prefills", "verify_steps", "spec_proposed",
                "spec_accepted", "spec_fallback_slots", "accept_rate"):
        assert tsum.get(key) == jsum.get(key), key
    fifo, _, _, _ = _real_run(tsched, kind, tm, spec_k, 64, monkeypatch,
                              "fifo")
    for rid, new in ((r[0], r[2]) for r in REAL_REQS):
        ref = generate(tm, torch.from_numpy(prompts[rid])[None].long(),
                       new)[0].tolist()
        assert got[rid][0] == ref == fifo[rid][0], rid
    if kind == "paged":
        assert teng.paging_stats() == jeng.paging_stats()
        # Each preemption's continuation re-attached its retained pages.
        assert tsum["prefix_hits"] == tsum["preemptions"]
        assert tsum["prefill_tokens_computed"] < tsum["prefill_tokens_dense"]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_exact_cache_runs_mixed_verify_dispatches_as_jax(kind, monkeypatch):
    """A cache sized exactly to the longest prompt + budget (no verify
    slack): slots near their end take the plain path inside the verify
    while others speculate; the counts and streams equal JAX's and
    ``generate()``."""
    need = max(n + new for _, n, new, *_ in REAL_REQS)
    assert need == 26     # pages of 13 tokens for the paged engine
    jm, params, tm = _pair(max_len=need)
    got, tsum, _, prompts = _real_run(tsched, kind, tm, 3, need,
                                      monkeypatch, "fifo", page_size=13)
    want, jsum, _, _ = _real_run(jsched, kind, (jm, params), 3, need,
                                 monkeypatch, "fifo", page_size=13)
    assert got == want
    assert tsum["spec_fallback_slots"] == jsum["spec_fallback_slots"] > 0
    assert tsum["spec_batch_fallbacks"] == 0
    for rid, new in ((r[0], r[2]) for r in REAL_REQS):
        ref = generate(tm, torch.from_numpy(prompts[rid])[None].long(),
                       new)[0].tolist()
        assert got[rid][0] == ref, rid


def test_perfect_draft_accepts_everything():
    """tests/test_serve_slo.py's pin: a DraftSpeculator whose draft is
    the target proposes the target's own chain, so every proposal is
    accepted (accept rate exactly 1.0) and the streams equal the plain
    engine's."""
    _, _, tm = _pair(max_len=96)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, int(n)).astype(np.int32)
               for n in rng.integers(4, 16, size=4)]
    buckets = default_buckets(16)

    def run(k):
        eng = SlotDecodeEngine(tm, 2, buckets=buckets, spec_tokens=k)
        draft = tspec.DraftSpeculator(tm, 2, buckets, k) if k else None
        eng.warmup(draft)
        sched = tsched.Scheduler(eng, decode_priority=3, speculator=draft)
        done = sched.run([tsched.Request(rid=i, prompt=p, max_new_tokens=16)
                          for i, p in enumerate(prompts)])
        return {c.rid: c.tokens for c in done}, sched.summary

    ref, _ = run(0)
    out, summary = run(3)
    assert out == ref
    assert summary["accept_rate"] == 1.0 and summary["verify_steps"] > 0


# --- the CLI ----------------------------------------------------------------

SPEC_SLO_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
                 "--serve.spec-tokens", "4", "--serve.policy", "slo",
                 "--serve.slo-mix", "high:0.25,batch:0.25", "--serve.tenants",
                 "2"]


def test_cli_serves_spec_and_slo_as_jax_prints(capsys):
    """The acceptance run on the CPU: every token served, and the
    speculative and slo lines JAX's run prints (accept_rate,
    verify_steps, preemptions and the per-class p95 TTFT)."""
    assert cli.main(SPEC_SLO_ARGV + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(next(l for l in out.splitlines()
                              if '"serve_summary"' in l))
    want = jrun.serve_run(jax_parse_args(SPEC_SLO_ARGV))
    for key in ("requests", "total_new_tokens", "policy", "spec_tokens",
                "buckets", "num_slots"):
        assert summary[key] == want[key], key
    assert summary["total_new_tokens"] == 16 * 64
    assert re.search(r"^\[serve\] speculative: k=4 accept_rate=[0-9.]+ "
                     r"verify_steps=\d+ ", out, re.M)
    assert re.search(r"^\[serve\] slo: preemptions=\d+ p95 ttft by class: "
                     r"(\w+=[0-9.]+ms ?)+$", out, re.M)
    assert summary["verify_steps"] > 0 and 0 <= summary["accept_rate"] <= 1

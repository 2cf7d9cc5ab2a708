"""PyTorch port: serving under faults, against the JAX package.

- The fault-plan grammar (``parse_fault_plan``) equals JAX's on good and
  bad specs, messages included, and the serve phase's points fire once
  each, as JAX's do; ``bind`` consumes events and silences signals.
- The ``ResilienceConfig`` has JAX's fields and defaults, and the phase
  and journal checks raise JAX's messages on the same configs; the train
  loop's knobs that were once refused, ``device_loss`` included, are
  accepted as in JAX.
- On a fake fire engine (continuation-aware token streams, a poisoned
  slot's row garbage and flagged) advancing one fake clock, the port's
  and JAX's schedulers make the same decisions: quarantines (records and
  per-request retries), retry exhaustion, weight swaps with and without
  ``reload_fn``, under speculation too, and byte-identical journals.
- The journal: a round trip, a truncated tail, ``apply_replay``'s
  continuations and arrival shift as JAX's; a journal cut short by a
  kill, written by either package, resumes in the other to the
  uninterrupted streams; a resumed continuation reports the whole one.
- The watchdog: JAX's stall message and record, errors passed through,
  a stress of many watched calls, and its daemon worker.
- The real tiny engines (f32, weights carried from JAX), next to JAX's
  engines on the same weights: ``slot_nan`` containment token-identical
  on the dense, int8 and paged engines, with and without speculation;
  one host copy a step carries tokens and flags; a poisoned int8 scale
  gives non-finite logits through the real attend; the paged quarantine
  scrubs private pages to 0 and keeps shared ones; ``swap_params``
  takes a checkpoint's params and refuses drift with JAX's message; a
  swap to the same checkpoint is token-identical; ``restore_params``
  walks back past a non-finite step and prefers the EMA.
- The CLI exits 2 (retry budget) and 3 (decode stall, a separate process
  that exits while the stall still sleeps).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_distributed_tpu import config as jconfig
from tensorflow_distributed_tpu.models import transformer as jtr
from tensorflow_distributed_tpu.observe.registry import MetricsRegistry
from tensorflow_distributed_tpu.resilience import faults as jfaults
from tensorflow_distributed_tpu.resilience import watchdog as jwatchdog
from tensorflow_distributed_tpu.serve import journal as jjournal
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve import speculate as jspec
from tensorflow_distributed_tpu.serve.buckets import default_buckets
from tensorflow_distributed_tpu.serve.engine import (
    SlotDecodeEngine as JaxEngine)
from tensorflow_distributed_tpu.serve.paging import engine as jpe
from tensorflow_distributed_tpu_torch import cli, interop
from tensorflow_distributed_tpu_torch import config as tconfig
from tensorflow_distributed_tpu_torch.models import transformer as ttr
from tensorflow_distributed_tpu_torch.models.generate import generate
from tensorflow_distributed_tpu_torch.resilience import faults as tfaults
from tensorflow_distributed_tpu_torch.resilience import watchdog as twatchdog
from tensorflow_distributed_tpu_torch.serve import engine as tengine
from tensorflow_distributed_tpu_torch.serve import journal as tjournal
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve import speculate as tspec
from tensorflow_distributed_tpu_torch.serve.paging import engine as tpe
from tensorflow_distributed_tpu_torch.train import checkpoint as tckpt
from tensorflow_distributed_tpu_torch.train.state import ema_init
from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


def _records(out: str, kind=None):
    """The recovery records printed on standard output (of ``kind``)."""
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith('{"event": "recovery"')]
    return [r for r in recs if kind is None or r["kind"] == kind]


# --- the fault-plan grammar ------------------------------------------------

SPECS = ["decode_stall@3:0.5s,slot_nan@5:1,reload@8,sigkill@12",
         "slot_nan@2", "decode_stall@4", "decode_stall@7:2",
         "nan_grad@40,ckpt_io_fail@80:2,data_stall@120:5s,sigterm@200,"
         "device_loss@9:2", " , slot_nan@3:0 ,", "", "slot_nan@5:1.5",
         "reload@5:2", "decode_stall@5:0s", "slot_nan@0:1", "bogus@3",
         "slot_nan", "slot_nan@3:-1", "data_stall@4:2x", "ckpt_io_fail@3:0",
         "device_loss@2:1.5", "sigterm@4:1", "reload@-2", "Reload@3"]


def _plan_view(plan):
    return sorted((e.kind, e.step, e.arg) for e in plan._by_step.values())


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_grammar_equals_jax(spec):
    def view(mod):
        got = _outcome(mod.parse_fault_plan, spec)
        if got[0] != "ok":
            return got
        return ("ok", _plan_view(got[1]), sorted(got[1].kinds()),
                bool(got[1]))

    assert view(tfaults) == view(jfaults)
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.TRAIN_KINDS == jfaults.TRAIN_KINDS
    assert tfaults.SERVE_KINDS == jfaults.SERVE_KINDS


def _drive_points(mod, spec, start, monkeypatch):
    """A script of serve-phase calls over steps 1-9 (twice, for the
    one-shot rule), with sleeps and signals recorded, not done."""
    slept, killed = [], []
    monkeypatch.setattr(time, "sleep", slept.append)
    monkeypatch.setattr(os, "kill", lambda pid, sig: killed.append(sig))
    plan = mod.parse_fault_plan(spec)
    if start is not None:
        plan.bind(start)
    out = []
    for _ in range(2):
        for step in range(1, 10):
            out.append((step, plan.take_slot_nan(step),
                        plan.take_reload(step)))
            plan.decode_stall_sleep(step)
            plan.maybe_signal(step)
    return out, slept, killed


@pytest.mark.parametrize("start", [None, 0, 4])
def test_serve_points_fire_once_as_jax(start, monkeypatch, capsys):
    spec = "decode_stall@3:0.25s,slot_nan@5:1,slot_nan@2,reload@8,sigkill@6"
    got = _drive_points(tfaults, spec, start, monkeypatch)
    records = _records(capsys.readouterr().out)
    assert got == _drive_points(jfaults, spec, start, monkeypatch)
    steps = {r["step"]: r for r in records}
    if start == 4:
        # Bound past step 4: those events are consumed, signals silenced.
        assert got[0][1] == (2, None, False) and got[1] == [] == got[2]
        assert sorted(steps) == [5, 8]
    else:
        assert got[1] == [0.25] and len(got[2]) == 1
        assert sorted(steps) == [2, 3, 5, 6, 8]
        assert steps[3] == {"event": "recovery", "kind": "fault_injected",
                            "fault": "decode_stall", "step": 3,
                            "seconds": 0.25}
        assert steps[6]["fault"] == "sigkill"
    assert steps[5] == {"event": "recovery", "kind": "fault_injected",
                        "fault": "slot_nan", "step": 5, "slot": 1}
    assert steps[8]["fault"] == "reload"
    assert not tfaults.parse_fault_plan("") and not tfaults.FaultPlan()


# --- the config ------------------------------------------------------------

def test_resilience_config_has_the_jax_fields_and_defaults():
    port, ref = tconfig.ResilienceConfig(), jconfig.ResilienceConfig()
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    # Every field runs in the port: none is refused at its default's side.
    assert not hasattr(tconfig, "_RESILIENCE_NOT_PORTED")


CKPT = "/tmp/never-read"
FIRE_CONFIGS = [
    # (TrainConfig kwargs, resilience kwargs, serve kwargs)
    (dict(mode="serve", model="gpt_lm", checkpoint_dir=CKPT),
     dict(fault_plan="slot_nan@2:0,reload@4,sigkill@9,decode_stall@3:1s",
          sync_timeout_s=2.0), dict(journal="j.jsonl", slot_retries=0)),
    (dict(mode="serve", model="gpt_lm"), dict(fault_plan="nan_grad@2"), {}),
    (dict(mode="serve", model="gpt_lm"),
     dict(fault_plan="slot_nan@2,data_stall@3:1s,device_loss@4"), {}),
    (dict(), dict(fault_plan="slot_nan@2:0"), {}),
    (dict(), dict(fault_plan="reload@2,sigterm@3"), {}),
    (dict(mode="serve", model="gpt_lm"), dict(fault_plan="reload@4"), {}),
    (dict(mode="eval", model="gpt_lm", checkpoint_dir="/t"),
     dict(fault_plan="sigterm@2"), {}),
    (dict(mode="generate", model="gpt_lm", checkpoint_dir="/t",
          prompt="1,2"), dict(fault_plan="sigkill@2"), {}),
    (dict(mode="serve", model="gpt_lm"), dict(fault_plan="slot_nan@0"), {}),
    (dict(mode="serve", model="gpt_lm"), dict(fault_plan="x@1"), {}),
    (dict(), dict(fault_plan="device_loss@3:2"), {}),
    (dict(mode="serve", model="gpt_lm"), dict(sync_timeout_s=-1.0), {}),
    (dict(mode="serve", model="gpt_lm"), {}, dict(slot_retries=-1)),
    (dict(), {}, dict(journal="j.jsonl")),
    (dict(mode="eval", model="gpt_lm", checkpoint_dir="/t"), {},
     dict(journal="j.jsonl")),
]


def _validate(mod, cfg_kw, res_kw, serve_kw):
    cfg = mod.TrainConfig(**cfg_kw,
                          resilience=mod.ResilienceConfig(**res_kw),
                          serve=mod.ServeConfig(**serve_kw))
    return _outcome(cfg.validate)


@pytest.mark.parametrize("case", FIRE_CONFIGS, ids=range(len(FIRE_CONFIGS)))
def test_fire_config_checks_equal_jax(case):
    got, want = _validate(tconfig, *case), _validate(jconfig, *case)
    if want[0] == "ok":
        assert got == ("ok", None)
    else:
        assert got == want


@pytest.mark.parametrize("case", [
    (dict(), dict(fault_plan="nan_grad@2,sigterm@5"), "fault-plan under"),
    (dict(mode="serve", model="gpt_lm"), dict(nonfinite="halt"),
     "resilience.nonfinite"),
    (dict(mode="serve", model="gpt_lm"), dict(data_timeout_s=3.0),
     "resilience.data-timeout-s"),
    (dict(), dict(sync_timeout_s=3.0), "sync-timeout-s under --mode train"),
    (dict(mode="serve", model="gpt_lm"), dict(save_retries=5),
     "resilience.save-retries"),
    (dict(checkpoint_dir=CKPT), dict(fault_plan="device_loss@3:2"),
     "device_loss"),
])
def test_train_loop_resilience_is_refused_naming_a8(case):
    """The five train-loop knobs the port once refused (naming ROADMAP.md
    A8) now run: both packages accept each, and so ``device_loss`` (with
    the checkpoint directory its mask file needs), once refused naming
    A7, which the elastic restart now takes."""
    cfg_kw, res_kw, what = case
    got = _validate(tconfig, cfg_kw, res_kw, {})
    # JAX runs each of these.
    assert _validate(jconfig, cfg_kw, res_kw, {})[0] == "ok"
    assert got == ("ok", None), what


def test_fire_flags_parse_as_jax(tmp_path):
    argv = ["--mode", "serve", "--model", "gpt_lm", "--checkpoint-dir",
            str(tmp_path), "--serve.journal", str(tmp_path / "j.jsonl"),
            "--serve.slot-retries", "1", "--resilience.sync-timeout-s",
            "0.5", "--resilience.fault-plan", "slot_nan@5:2,reload@12"]
    port = tconfig.parse_args(argv)
    ref = jconfig.parse_args(argv)
    for part in ("resilience", "serve"):
        for f in dataclasses.fields(getattr(port, part)):
            assert (getattr(getattr(port, part), f.name)
                    == getattr(getattr(ref, part), f.name)), f.name


# --- the schedulers on a fake fire engine ----------------------------------

class _Clock:
    """A fake clock: reads cost nothing; the engine's work advances it,
    and ``time.sleep`` by its argument (at least a nanosecond)."""

    STEP_S, PREFILL_S, SWAP_S = 0.01, 0.003, 0.002

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(seconds, 1e-9)


class _FireFakeEngine:
    """tests/test_serve_fire.py's host-only engine with the fire surface,
    advancing a fake clock. The token stream is a pure function of (rid,
    tokens emitted so far): a continuation's prefill resumes the SAME
    stream, so identity through quarantine is exact. The rid rides
    prompt[0]; base prompts are one token long. A poisoned slot's row is
    garbage for the dispatch and flagged (take_bad_slots)."""

    def __init__(self, clock, num_slots=2, max_len=256, spec_tokens=0):
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
        self.verify_steps = 0
        self.spec_tokens = spec_tokens
        self.swaps = 0
        self.params = object()
        self._poisoned = set()
        self._bad = []
        self.log = []

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
        self.counts[rid] = len(prompt) - 1
        self.prefills += 1
        self._poisoned.discard(slot)
        self.clock.t += self.clock.PREFILL_S
        self.log.append(("prefill", rid, slot, len(prompt)))
        return rid * 100 + self.counts[rid]

    def step(self):
        out = np.zeros((self.num_slots,), np.int32)
        self._bad = []
        for s in range(self.num_slots):
            if not self.active[s]:
                continue
            if s in self._poisoned:
                out[s] = 999_999
                self._bad.append(s)
                continue
            rid = self.slot_rid[s]
            self.counts[rid] += 1
            out[s] = rid * 100 + self.counts[rid]
        self.decode_steps += 1
        self.clock.t += self.clock.STEP_S
        return out

    def can_verify(self):
        return self.spec_tokens > 0

    def verify_step(self, props):
        k = self.spec_tokens
        toks = np.zeros((self.num_slots, k + 1), np.int32)
        acc = np.zeros((self.num_slots,), np.int32)
        self._bad = []
        for s in range(self.num_slots):
            if not self.active[s]:
                continue
            acc[s] = k + 1
            if s in self._poisoned:
                toks[s, :] = 999_999
                self._bad.append(s)
                continue
            rid = self.slot_rid[s]
            for j in range(k + 1):
                self.counts[rid] += 1
                toks[s, j] = rid * 100 + self.counts[rid]
        self.decode_steps += 1
        self.verify_steps += 1
        self.clock.t += self.clock.STEP_S
        return toks, acc

    def take_bad_slots(self):
        bad, self._bad = self._bad, []
        return bad

    def poison_slot(self, slot):
        self._poisoned.add(slot)
        self.log.append(("poison", slot))

    def swap_params(self, new_params):
        self.params = new_params
        self.swaps += 1
        self.clock.t += self.clock.SWAP_S
        self.log.append(("swap", new_params))

    def free(self, slot):
        self.active[slot] = False
        self._poisoned.discard(slot)
        self.log.append(("free", slot))


class _FakeSpeculator:
    """Proposals for the fake verify (their content is ignored)."""

    needs_histories = False

    def __init__(self, num_slots, k):
        self.num_slots, self.k = num_slots, k
        self.calls = []

    def propose(self, histories):
        return np.zeros((self.num_slots, self.k), np.int32)

    def observe_admit(self, slot, prompt, first_tok):
        self.calls.append(("admit", slot, int(first_tok)))

    def observe_free(self, slot):
        self.calls.append(("free", slot))

    def sync_from(self, engine):
        pass


def _reqs(module, n, max_new=8, eos=None, arrivals=None):
    return [module.Request(rid=i, prompt=np.asarray([i], np.int32),
                           max_new_tokens=max_new,
                           eos_id=(eos or {}).get(i, -1),
                           arrival_s=(arrivals or [0.0] * n)[i])
            for i in range(n)]


def _expected(rid, max_new, plen=1):
    return [rid * 100 + (plen - 1) + j for j in range(max_new)]


def _fire_run(module, case, monkeypatch, capsys, tmp_path, reqs=None):
    """One scheduler run of ``case`` over the fake fire engine. Returns
    (completions, on_token stream, summary, quarantine and swap records,
    engine log, journal text) or the exhaustion's message."""
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    eng = _FireFakeEngine(clock, num_slots=case["slots"],
                          spec_tokens=case.get("k", 0))
    faults = tfaults if module is tsched else jfaults
    plan = faults.parse_fault_plan(case["plan"])
    jmod = tjournal if module is tsched else jjournal
    jpath = tmp_path / f"{module.__name__.split('.')[0]}.jsonl"
    journal = jmod.RequestJournal(str(jpath))
    reg = MetricsRegistry()
    seen = []
    kw = dict(decode_priority=case["dp"], clock=clock, fault_plan=plan,
              journal=journal, slot_retries=case.get("retries", 2),
              on_token=lambda *a: seen.append(a))
    if case.get("reload", True):
        kw["reload_fn"] = lambda: ("fresh", 7)
    if case.get("k"):
        kw["speculator"] = _FakeSpeculator(case["slots"], case["k"])
    if module is jsched:
        kw["registry"] = reg
    sched = module.Scheduler(eng, **kw)
    capsys.readouterr()
    try:
        done = sched.run(reqs if reqs is not None else _reqs(
            module, case["n"], case.get("max_new", 8), case.get("eos"),
            case.get("arrivals")))
    except (tsched.SlotRetryExhausted, jsched.SlotRetryExhausted,
            ValueError) as e:
        return (type(e).__name__, str(e))
    finally:
        journal.close()
    if module is tsched:
        recs = _records(capsys.readouterr().out)
    else:
        recs = [r for r in reg.records if r["event"] == "recovery"]
    recs = [{k: r[k] for k in sorted(r) if k not in ("event", "t")}
            for r in recs if r["kind"] in ("slot_quarantine",
                                           "weight_swap")]
    comps = [(c.rid, list(c.tokens), c.finish, c.queue_steps, c.retries,
              c.preempts, c.recovery_window, c.prompt_len, c.decoded,
              round(c.ttft_s, 9), round(c.decode_s, 9)) for c in done]
    summary = {k: sched.summary[k] for k in (
        "requests", "total_new_tokens", "decoded_tokens", "decode_steps",
        "prefills", "retries", "swaps", "swap_seconds", "preemptions",
        "mean_slot_occupancy")}
    if case.get("k"):
        summary.update({k: sched.summary[k] for k in (
            "verify_steps", "spec_proposed", "spec_accepted")})
        eng.log.append(kw["speculator"].calls)
    return comps, seen, summary, recs, eng.log, jpath.read_text()


FIRE_CASES = [
    dict(plan="slot_nan@3:0,slot_nan@7:1", slots=2, n=5, dp=3),
    dict(plan="slot_nan@2:1", slots=2, n=1, dp=3),        # empty slot 1
    dict(plan="slot_nan@2:0,slot_nan@4:0,slot_nan@6:0", slots=1, n=1,
         dp=2, max_new=12, retries=1),                    # exhausted
    dict(plan="slot_nan@2:0,slot_nan@4:0,slot_nan@6:0", slots=1, n=2,
         dp=2, max_new=12, retries=3),
    dict(plan="reload@4", slots=2, n=3, dp=3),
    dict(plan="reload@2", slots=2, n=1, dp=3, reload=False),  # no fn
    dict(plan="reload@3,slot_nan@5:0,slot_nan@6:1,reload@9", slots=3, n=7,
         dp=2, max_new=6, eos={2: 203, 5: 501},
         arrivals=[0, 0, 0.02, 0.02, 0.05, 0.3, 0.31]),
    dict(plan="slot_nan@2:0,slot_nan@3:1", slots=2, n=5, dp=3, k=3),
    dict(plan="slot_nan@1:0,reload@2,slot_nan@4:2", slots=3, n=6, dp=1,
         k=2, max_new=9),
]


@pytest.mark.parametrize("case", FIRE_CASES, ids=range(len(FIRE_CASES)))
def test_fire_scheduler_makes_jax_decisions(case, monkeypatch, capsys,
                                            tmp_path):
    got = _fire_run(tsched, case, monkeypatch, capsys, tmp_path)
    want = _fire_run(jsched, case, monkeypatch, capsys, tmp_path)
    assert got == want
    if got[0] in ("SlotRetryExhausted", "ValueError"):
        assert ("quarantined 2" in got[1] if got[0] == "SlotRetryExhausted"
                else "no reload_fn" in got[1])
        return
    comps, _, summary, recs, log, journal = got
    n_slot_nan = case["plan"].count("slot_nan")
    assert summary["retries"] == n_slot_nan == sum(c[4] for c in comps)
    assert summary["swaps"] == case["plan"].count("reload")
    assert [r["kind"] for r in recs].count("slot_quarantine") == n_slot_nan
    for rid, tokens, finish, *_ in comps:
        eos = case.get("eos", {}).get(rid)
        want_toks = _expected(rid, case.get("max_new", 8))
        if eos is not None:
            want_toks = want_toks[:want_toks.index(eos) + 1]
        assert tokens == want_toks, f"rid {rid} drifted"
    if n_slot_nan:
        assert any(c[6] for c in comps)      # recovery_window
    # The journal folds back to the completions.
    played = {}
    for line in journal.splitlines():
        tjournal.fold_record(played, json.loads(line))
    assert {rid: (e["done"], e["tokens"]) for rid, e in played.items()} == {
        c[0]: (True, c[1]) for c in comps}


def test_slot_nan_names_the_lowest_live_slot_when_empty(monkeypatch, capsys,
                                                        tmp_path):
    case = FIRE_CASES[1]
    comps, _, summary, recs, log, _ = _fire_run(tsched, case, monkeypatch,
                                                capsys, tmp_path)
    assert ("poison", 0) in log and summary["retries"] == 1
    assert recs[0]["slot"] == 0 and comps[0][1] == _expected(0, 8)


def test_quarantine_is_released_without_retention_on_a_paged_engine():
    """The scheduler hands a quarantined slot to the paged engine's
    release with no tokens (nothing is retained), a finished one with
    its prompt and tokens."""
    calls = []

    class Paged(_FireFakeEngine):
        paged = True

        def prefill(self, prompt, slot, max_new_tokens=0, session=""):
            return super().prefill(prompt, slot)

        def can_admit(self, plen, max_new):
            return True

        def release(self, slot, tokens=None, session=""):
            calls.append((slot, tokens))
            self.free(slot)

        def paging_stats(self):
            return {}

    clock = _Clock()
    eng = Paged(clock, num_slots=2)
    sched = tsched.Scheduler(eng, decode_priority=2, clock=clock,
                             fault_plan=tfaults.parse_fault_plan(
                                 "slot_nan@4:1"))
    done = {c.rid: c for c in sched.run(_reqs(tsched, 2, max_new=6))}
    assert done[1].tokens == _expected(1, 6) and done[1].retries == 1
    assert calls[0] == (1, None)
    finished = dict(calls[1:])
    assert finished[0] == [0] + _expected(0, 6)


# --- the journal -------------------------------------------------------------

def test_journal_round_trip_and_truncated_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = tjournal.RequestJournal(path)
    j.admit(0, np.asarray([5, 6]), 8, -1, slo="high", tenant="t1",
            session="s0")
    j.token(0, 100, 0.12345)
    j.admit(1, [7], 4, 3)
    j.token(1, 3, 0.2)
    j.done(1)
    j.close()
    with open(path, "a") as f:
        # The JAX fleet intake's reject record, then the kill's tail.
        f.write('{"e": "reject", "rid": 2}\n')
        f.write('{"e": "tok", "rid": 0, "t": 1')
    played = tjournal.replay(path)
    assert played == jjournal.replay(path)
    assert played[0]["tokens"] == [100] and not played[0]["done"]
    assert played[0]["req"] == {"prompt": [5, 6], "max_new": 8, "eos": -1}
    assert played[1]["done"] and played[2]["reject"]
    assert played[0]["last_s"] == 0.1235
    lines = open(path).read().splitlines()
    assert json.loads(lines[0]) == {"e": "admit", "rid": 0,
                                    "prompt": [5, 6], "max_new": 8,
                                    "eos": -1, "slo": "high",
                                    "tenant": "t1", "sess": "s0"}
    assert tjournal.replay(str(tmp_path / "absent.jsonl")) == {}


def _replay_view(out):
    return [(r.rid, [int(t) for t in r.prompt], r.max_new_tokens,
             round(r.arrival_s, 9), getattr(r, "_base_tokens", None))
            for r in out]


def test_apply_replay_continuations_and_arrival_shift_equal_jax():
    def reqs(module):
        return [module.Request(rid=0, prompt=np.asarray([0], np.int32),
                               max_new_tokens=6),
                module.Request(rid=1, prompt=np.asarray([1], np.int32),
                               max_new_tokens=6),
                module.Request(rid=2, prompt=np.asarray([2], np.int32),
                               max_new_tokens=6, arrival_s=9.0),
                module.Request(rid=3, prompt=np.asarray([3], np.int32),
                               max_new_tokens=6, eos_id=305),
                module.Request(rid=4, prompt=np.asarray([4, 9], np.int32),
                               max_new_tokens=6, arrival_s=1.0),
                module.Request(rid=5, prompt=np.asarray([5], np.int32),
                               max_new_tokens=2, arrival_s=0.5)]

    played = {
        0: {"req": None, "tokens": [100, 101, 102], "done": False,
            "last_s": 2.0},                      # in flight -> cont.
        1: {"req": None, "tokens": [100] * 6, "done": True,
            "last_s": 1.0},                      # finished -> drop
        3: {"req": None, "tokens": [303, 304, 305], "done": False,
            "last_s": 1.5},                      # EOS tail -> drop
        4: {"req": None, "tokens": [], "done": False,
            "last_s": 0.0},                      # admitted, no token
        5: {"req": None, "tokens": [500, 501], "done": False,
            "last_s": 0.7},                      # budget spent -> drop
    }
    got = tjournal.apply_replay(reqs(tsched), played)
    assert _replay_view(got) == _replay_view(
        jjournal.apply_replay(reqs(jsched), played))
    by_rid = {r.rid: r for r in got}
    assert list(by_rid[0].prompt) == [0, 100, 101, 102]
    assert by_rid[0].max_new_tokens == 3 and by_rid[0]._base_tokens == [
        100, 101, 102]
    assert by_rid[2].arrival_s == pytest.approx(7.0)
    assert by_rid[4].arrival_s == 0.0 and sorted(by_rid) == [0, 2, 4]


def _serve_fake(module, reqs, journal_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    jmod = tjournal if module is tsched else jjournal
    journal = jmod.RequestJournal(journal_path)
    try:
        return {c.rid: c for c in module.Scheduler(
            _FireFakeEngine(clock, num_slots=2), decode_priority=2,
            clock=clock, journal=journal).run(reqs)}
    finally:
        journal.close()


ARRIVALS = [0.0, 0.0, 0.01, 0.04, 0.05, 0.2]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cut", [7, 23, 40])
def test_a_killed_journal_resumes_in_the_other_package(writer, cut, tmp_path,
                                                       monkeypatch):
    """A leg of one package is cut short after ``cut`` journal lines (a
    kill after a flush, with half a line written); the other package
    replays it, serves the unfinished work and appends to the same
    journal: every request ends with the uninterrupted stream, and no
    request finished before the kill is served again."""
    first, second = ((jsched, tsched) if writer == "jax"
                     else (tsched, jsched))
    full = str(tmp_path / "full.jsonl")
    _serve_fake(first, _reqs(first, 6, 8, arrivals=ARRIVALS), full,
                monkeypatch)
    lines = open(full).read().splitlines(keepends=True)
    cut_path = str(tmp_path / "cut.jsonl")
    with open(cut_path, "w") as f:
        f.writelines(lines[:cut])
        f.write(lines[cut][:9])
    jmod = tjournal if second is tsched else jjournal
    played = jmod.replay(cut_path)
    finished = {rid for rid, e in played.items() if e["done"]}
    narrowed = jmod.apply_replay(_reqs(second, 6, 8, arrivals=ARRIVALS),
                                 played)
    with open(cut_path, "a") as f:
        f.write("\n")    # the next leg's records start on a line of their own
    done = _serve_fake(second, narrowed, cut_path, monkeypatch)
    assert not finished & set(done)
    assert set(done) | finished == set(range(6))
    for rid, c in done.items():
        assert c.tokens == _expected(rid, 8), f"rid {rid}"
    final = tjournal.replay(cut_path)
    assert final == jjournal.replay(cut_path)
    assert {rid: (e["done"], e["tokens"]) for rid, e in final.items()} == {
        rid: (True, _expected(rid, 8)) for rid in range(6)}


def test_resumed_continuation_serves_to_token_identity(monkeypatch):
    reqs = _reqs(tsched, 2, max_new=7)
    played = {0: {"req": None, "tokens": _expected(0, 7)[:3],
                  "done": False, "last_s": 0.5}}
    narrowed = tjournal.apply_replay(reqs, played)
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    done = {c.rid: c for c in tsched.Scheduler(
        _FireFakeEngine(clock, num_slots=2), decode_priority=2,
        clock=clock).run(narrowed)}
    assert done[0].tokens == _expected(0, 7)
    assert done[1].tokens == _expected(1, 7)
    assert done[0].prompt_len == 1 and done[0].decoded == 4
    assert done[0].recovery_window and not done[1].recovery_window


# --- the watchdog --------------------------------------------------------------

def test_watchdog_stall_equals_jax(capsys):
    msgs = []
    for mod in (twatchdog, jwatchdog):
        dog = mod.Watchdog(sync_timeout_s=0.05)
        with pytest.raises(mod.StallError) as e:
            dog.decode(lambda: time.sleep(0.5), 7)
        msgs.append(str(e.value))
        dog.close()
    assert msgs[0] == msgs[1]
    assert "decode step for step 7 exceeded the 0.05s" in msgs[0]
    rec = _records(capsys.readouterr().out, "stall")
    assert rec == [{"event": "recovery", "kind": "stall",
                    "what": "decode step", "step": 7, "timeout_s": 0.05,
                    "multihost": False}]
    # The abandoned worker is a daemon: it cannot hold the exit.
    assert all(t.daemon for t in threading.enumerate()
               if t.name == "tfd-watchdog")


def test_watchdog_passes_values_and_errors_through():
    dog = twatchdog.Watchdog(sync_timeout_s=5.0)
    assert dog.decode(lambda: threading.current_thread().name, 1) == (
        "tfd-watchdog")
    x = torch.arange(3)
    assert dog.decode(lambda: {"a": [x]}, 3)["a"][0] is x
    with pytest.raises(KeyError):
        dog.decode(lambda: {}["missing"], 4)
    # A timeout of 0 runs inline, on the caller's thread.
    off = twatchdog.Watchdog()
    assert off.decode(lambda: threading.current_thread().name, 5) == (
        threading.current_thread().name)
    dog.close()


def test_watchdog_stress():
    """Thousands of watched calls through one worker, with the interpreter
    switching threads as often as it can: every call returns its own
    value, in order, within the time bound."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    dog = twatchdog.Watchdog(sync_timeout_s=30.0)
    try:
        t0 = time.time()
        got = [dog.decode(lambda i=i: i * i, i) for i in range(3000)]
        assert got == [i * i for i in range(3000)]
        assert time.time() - t0 < 60
    finally:
        sys.setswitchinterval(old)
        dog.close()


# --- the real engines, tiny GPT ------------------------------------------------

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


def _clocked(eng, clock):
    """The engine's dispatches advance the fake clock (both packages'
    schedulers then see the same times whatever their speed)."""
    for name, dt in (("prefill", clock.PREFILL_S), ("step", clock.STEP_S),
                     ("verify_step", clock.STEP_S)):
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, _dt=dt, **kw):
            clock.t += _dt
            return _fn(*a, **kw)

        setattr(eng, name, wrapped)
    return eng


REAL_LENS, REAL_NEW = (3, 9, 17, 5), 10


def _prompts():
    return [np.random.default_rng(i).integers(0, 64, size=n).astype(np.int32)
            for i, n in enumerate(REAL_LENS)]


def _real_run(module, pair, kind, plan, monkeypatch, spec_k=0, reload=None):
    """The four mixed requests through 2 slots of the package's engine
    (``kind``: dense | paged) under ``plan``; returns ({rid: tokens},
    summary, engine)."""
    jm, params, tm = pair
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    jax_side = module is jsched
    faults = jfaults if jax_side else tfaults
    fp = faults.parse_fault_plan(plan) if plan else None
    args = (jm, params) if jax_side else (tm,)
    buckets = default_buckets(max(REAL_LENS) + REAL_NEW, cap=64)
    kw = dict(buckets=buckets, spec_tokens=spec_k, fault_plan=fp)
    if kind == "paged":
        eng = (jpe if jax_side else tpe).PagedSlotEngine(*args, 2,
                                                         page_size=8, **kw)
    else:
        eng = (JaxEngine if jax_side else tengine.SlotDecodeEngine)(
            *args, 2, **kw)
    eng.warmup()
    spec = ((jspec if jax_side else tspec).SelfDraft(2, spec_k)
            if spec_k else None)
    sched = module.Scheduler(_clocked(eng, clock), decode_priority=3,
                             clock=clock, fault_plan=fp, slot_retries=2,
                             speculator=spec, reload_fn=reload)
    done = sched.run([module.Request(rid=i, prompt=p,
                                     max_new_tokens=REAL_NEW)
                      for i, p in enumerate(_prompts())])
    return ({c.rid: (c.tokens, c.retries, c.queue_steps) for c in done},
            sched.summary, eng)


REAL_CASES = [("dense", "tiny", 0, "slot_nan@3:0,slot_nan@8:1"),
              ("dense", "tiny_int8", 0, "slot_nan@3:0,slot_nan@8:1"),
              ("paged", "tiny", 0, "slot_nan@3:0,slot_nan@8:1"),
              ("paged", "tiny_int8", 0, "slot_nan@4:1"),
              ("dense", "tiny", 3, "slot_nan@2:0,slot_nan@4:1"),
              ("paged", "tiny", 3, "slot_nan@2:0,slot_nan@4:1")]


@pytest.mark.parametrize("case", REAL_CASES,
                         ids=["-".join(map(str, c[:3])) for c in REAL_CASES])
def test_slot_nan_containment_is_token_identical_and_equals_jax(
        case, request, monkeypatch, capsys):
    """A NaN-poisoned slot is flagged by the step's (or the verify's)
    device flag, quarantined and re-prefilled; every stream equals the
    unfaulted run's and JAX's engine under the same plan, quarantine for
    quarantine."""
    kind, pair_name, spec_k, plan = case
    pair = request.getfixturevalue(pair_name)
    base, _, _ = _real_run(tsched, pair, kind, None, monkeypatch, spec_k)
    got, tsum, teng = _real_run(tsched, pair, kind, plan, monkeypatch,
                                spec_k)
    want, jsum, _ = _real_run(jsched, pair, kind, plan, monkeypatch, spec_k)
    assert {r: v[0] for r, v in got.items()} == {r: v[0]
                                                 for r, v in base.items()}
    assert got == want
    n = plan.count("slot_nan")
    assert tsum["retries"] == jsum["retries"] == n == teng.flagged_slots
    quarantined = _records(capsys.readouterr().out, "slot_quarantine")
    assert len(quarantined) == n
    if spec_k:
        # Every dispatch was a verify: the flags came with its chain.
        assert teng.verify_steps == teng.decode_steps >= 1
    if kind == "paged":
        # Quarantined pages went back scrubbed; nothing is poisoned now.
        assert not teng._poisoned and not teng._flagged
        assert all(bool(torch.isfinite(t.float()).all())
                   for t in teng.cache.leaves())


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("pair_name", ["tiny", "tiny_int8"])
def test_one_host_copy_carries_tokens_and_flags(kind, pair_name, request,
                                                monkeypatch):
    """A decode step and a verify read the device once each (one numpy
    view of one tensor: on a card, one device-to-host copy), and that
    copy holds the argmax tokens and the per-slot finite flags; a
    poisoned slot (under int8 only its f32 scales are float) turns its
    logits non-finite through the real attend and only its flag drops."""
    _, _, tm = request.getfixturevalue(pair_name)
    kw = dict(page_size=8) if kind == "paged" else {}
    cls = tpe.PagedSlotEngine if kind == "paged" else tengine.SlotDecodeEngine
    eng = cls(tm, 2, spec_tokens=2, **kw)
    for slot, n in ((0, 5), (1, 9)):
        extra = dict(max_new_tokens=10) if kind == "paged" else {}
        eng.prefill(np.arange(n), slot, **extra)
    reads = []
    for name in ("numpy", "cpu", "item", "tolist"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    logits = eng._dispatch_step(eng._h2d(eng.tok), eng._h2d(eng.pos))
    reads.clear()
    nxt = eng.step()
    assert reads == ["numpy"]
    assert (nxt == logits.argmax(-1).numpy()).all()
    assert eng.take_bad_slots() == [] and eng._last_ok.all()
    before = [t.clone() for t in eng.cache.leaves()]
    eng.poison_slot(1)
    for t, b in zip(eng.cache.leaves(), before):
        if not t.is_floating_point():
            assert torch.equal(t, b)          # int8 K/V untouched
    logits = eng._dispatch_step(eng._h2d(eng.tok), eng._h2d(eng.pos))
    assert bool(torch.isfinite(logits[0]).all())
    assert not bool(torch.isfinite(logits[1]).any())
    reads.clear()
    eng.verify_step(np.zeros((2, 2)))
    assert reads == ["numpy"]
    assert list(eng._last_ok) == [True, False]
    assert eng.take_bad_slots() == [1]


@pytest.mark.parametrize("shape", [(5, 11), (5, 3, 11)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_flag_is_the_all_finite_flag(shape, dtype):
    """The packed flag equals ``isfinite(row).all()`` for a clean row, a
    NaN, a +inf, a -inf, and a +inf beside a -inf; the tokens are the
    argmax. Finite rows whose sum overflows (f32: 50257 logits of 1e34;
    bf16: eight of 3e38) are flagged finite, as JAX's flag does."""
    g = torch.Generator().manual_seed(0)
    logits = (torch.randn(shape, generator=g) * 30).to(dtype)
    row = (0,) * (len(shape) - 2)
    for slot, bad in ((1, [math.nan]), (2, [math.inf]), (3, [-math.inf]),
                      (4, [math.inf, -math.inf])):
        for i, v in enumerate(bad):
            logits[(slot, *row, 2 + i)] = v
    packed = tengine.SlotDecodeEngine._pack(logits)
    flat = logits.reshape(shape[0], -1, shape[-1])
    assert packed.dtype == torch.int64
    assert packed[:, -1].tolist() == [1, 0, 0, 0, 0]
    assert packed[:, -1].tolist() == (
        torch.isfinite(flat).flatten(1).all(1).long().tolist())
    assert torch.equal(packed[:, :-1], flat.argmax(-1))
    big = {torch.float32: ((2, 1, 50257), 1e34),
           torch.bfloat16: ((2, 1, 8), 3e38)}[dtype]
    huge = torch.full(big[0], big[1], dtype=dtype)
    if len(shape) == 2:
        huge = huge[:, 0]
    jax_ok = jnp.isfinite(jnp.asarray(huge.float().numpy(), dtype=(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16))).all(
            axis=tuple(range(1, huge.ndim)))
    assert bool(torch.isinf(huge.sum(dim=tuple(range(1, huge.ndim)),
                                     dtype=torch.float32)).all())
    got = tengine.SlotDecodeEngine._pack(huge)[:, -1]
    assert got.tolist() == np.asarray(jax_ok).astype(int).tolist() == [1, 1]


def test_paged_quarantine_scrubs_private_pages_and_keeps_shared(tiny):
    """A slot attached to a cached prefix is poisoned: only its private
    pages turn NaN; its release (a quarantine retains nothing) scrubs
    them to 0 and leaves the shared pages' bytes as they were; a later
    request on the same prefix hits the cache and decodes as
    ``generate()``."""
    _, _, tm = tiny
    eng = tpe.PagedSlotEngine(tm, 2, page_size=8)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 64, 16)
    a = np.concatenate([prefix, rng.integers(0, 64, 4)])
    eng.prefill(a, 0, max_new_tokens=4)
    eng.step()
    eng.release(0, tokens=list(a) + [int(eng.tok[0])])
    b = np.concatenate([prefix, rng.integers(0, 64, 6)])
    eng.prefill(b, 1, max_new_tokens=8)
    assert eng.prefix_hits == 1
    n = int(eng.page_count[1])
    pages = [int(p) for p in eng.tables[1, :n]]
    shared = [p for p in pages if eng.pool.ref[p] > 1]
    private = [p for p in pages if eng.pool.ref[p] == 1]
    assert len(shared) == 2 and private
    shared_bytes = [t[shared].clone() for t in eng.cache.leaves()]
    eng.poison_slot(1)
    for t in eng.cache.leaves():
        assert bool(torch.isnan(t[private]).all())
        assert not bool(torch.isnan(t[shared]).any())
    eng.step()
    assert eng.take_bad_slots() == [1]
    eng.release(1)
    for t, keep in zip(eng.cache.leaves(), shared_bytes):
        assert float(t[private].abs().sum()) == 0.0
        assert torch.equal(t[shared], keep)
    c = np.concatenate([prefix, rng.integers(0, 64, 3)])
    first = eng.prefill(c, 0, max_new_tokens=6)
    toks = [first] + [int(eng.step()[0]) for _ in range(5)]
    assert eng.prefix_hits == 2
    assert toks == generate(tm, torch.from_numpy(c)[None].long(),
                            6)[0].tolist()
    with pytest.raises(ValueError, match="no private pages"):
        eng.poison_slot(1)
    with pytest.raises(ValueError, match="out of range"):
        eng.poison_slot(2)


def test_paged_warmup_runs_the_drills_and_leaves_a_fresh_pool(tiny,
                                                              monkeypatch):
    _, _, tm = tiny
    eng = tpe.PagedSlotEngine(tm, 2, page_size=8)
    fills = []
    real = eng._fill_pages
    monkeypatch.setattr(eng, "_fill_pages", lambda *a, **k: (
        fills.append(a), real(*a, **k)))
    eng.warmup()
    assert [f[0] for f in fills] == [[0], [0]]
    assert np.isnan(fills[0][1]) and fills[1][1] == 0.0
    assert all(float(t.float().abs().sum()) == 0 for t in eng.cache.leaves())
    assert eng.pool.pages_in_use == 0 and not eng._poisoned


def _tiny_state(tmp_path, **overrides):
    """A tiny gpt_lm train state built as the CLI builds it, f32."""
    from tensorflow_distributed_tpu_torch.train.loop import (
        _build_model_and_state)

    argv = ["--model", "gpt_lm", "--model-size", "tiny", "--seq-len", "64",
            "--compute-dtype", "float32", "--device", "cpu"]
    for k, v in overrides.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    cfg = tconfig.parse_args(argv)
    return cfg, *_build_model_and_state(cfg, torch.device("cpu"))


def test_swap_to_the_same_checkpoint_is_token_identical(tmp_path, tiny,
                                                        monkeypatch, capsys):
    """A live swap mid-traffic to the checkpoint being served: slots stay
    live (one prefill a request), every stream equals the no-swap run's,
    and the swap is counted and timed."""
    jm, params, tm = tiny
    cfg, model, state = _tiny_state(tmp_path)
    model.load_state_dict(tm.state_dict())
    tckpt.save(str(tmp_path), state)
    pair = (jm, params, model)
    base, _, _ = _real_run(tsched, pair, "dense", None, monkeypatch)
    holder = {}

    def reload():
        return tckpt.restore_params(str(tmp_path), holder["eng"].model)

    real = tengine.SlotDecodeEngine.__init__

    def grab(self, *a, **k):
        real(self, *a, **k)
        holder["eng"] = self

    monkeypatch.setattr(tengine.SlotDecodeEngine, "__init__", grab)
    got, summary, eng = _real_run(tsched, pair, "dense", "reload@5",
                                  monkeypatch, reload=reload)
    assert got == base
    assert eng.swaps == summary["swaps"] == 1 and eng.prefills == 4
    swap = _records(capsys.readouterr().out, "weight_swap")
    assert len(swap) == 1 and swap[0]["ckpt_step"] == 0
    # The serving tensors were written in place, not replaced.
    assert model.tok_emb.weight is dict(model.named_parameters())[
        "tok_emb.weight"]


def test_swap_params_takes_a_checkpoint_and_refuses_drift(tmp_path, tiny):
    """The paged engine shares the caller's tensors: a swap writes through
    to both. Names, shapes and dtypes that drift are refused with JAX's
    messages; so is another device. bf16 serving weights: the checkpoint's
    dense weights are cast as serving casts them."""
    jm, params, tm = tiny
    model = ttr.gpt_lm("tiny", compute_dtype=torch.float32, max_len=64)
    model.load_state_dict(tm.state_dict())
    eng = tpe.PagedSlotEngine(model, 2, page_size=8)
    new = {n: p.detach() + 1.0 for n, p in model.named_parameters()}
    eng.swap_params(new)
    assert torch.equal(model.tok_emb.weight, new["tok_emb.weight"])
    assert torch.equal(eng.model.tok_emb.weight, new["tok_emb.weight"])
    assert eng.swaps == 1
    jeng = JaxEngine(jm, params, num_slots=1)
    jax_msgs = []
    for bad in (jax.tree_util.tree_map(lambda x: x[..., :1], params),
                {k: v for k, v in params.items() if k != "ln_f"}):
        with pytest.raises(ValueError) as e:
            jeng.swap_params(bad)
        jax_msgs.append(str(e.value).splitlines()[0])
    sliced = {n: t[..., :1] for n, t in new.items()}
    missing = {n: t for n, t in new.items() if not n.startswith("ln_f")}
    for bad, want in zip((sliced, missing), jax_msgs):
        with pytest.raises(ValueError) as e:
            eng.swap_params(bad)
        assert str(e.value).splitlines()[0] == want
    with pytest.raises(ValueError, match="shape/dtype drift"):
        eng.swap_params({n: t.double() for n, t in new.items()})
    with pytest.raises(ValueError, match="device drift"):
        eng.swap_params({n: t.to("meta") for n, t in new.items()})
    # bf16 serving: restore_params casts what cast_dense_weights_ casts.
    cfg, m16, state = _tiny_state(tmp_path, compute_dtype="bfloat16")
    tckpt.save(str(tmp_path), state)
    ttr.cast_dense_weights_(m16)
    swap, step = tckpt.restore_params(str(tmp_path), m16)
    assert step == 0
    live = dict(m16.named_parameters())
    assert {n: t.dtype for n, t in swap.items()} == {
        n: t.dtype for n, t in live.items()}
    assert live["layer_0.attn.qkv.weight"].dtype == torch.bfloat16
    assert live["tok_emb.weight"].dtype == torch.float32
    tengine.SlotDecodeEngine(m16, 1).swap_params(swap)


def _poison_step(ckpt_dir, step):
    """NaN every param of a saved step, with intact bytes (the manifest's
    sha256 rewritten)."""
    import hashlib

    from tensorflow_distributed_tpu_torch.utils import serialization

    sd = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(sd, "state.msgpack"), "rb") as f:
        raw = serialization.msgpack_restore(f.read())

    def nan(tree):
        return {k: nan(v) if isinstance(v, dict) else np.full_like(v, np.nan)
                for k, v in tree.items()}

    raw["params"] = nan(raw["params"])
    blob = b"".join(serialization.encode_chunks(raw))
    with open(os.path.join(sd, "state.msgpack"), "wb") as f:
        f.write(blob)
    with open(os.path.join(sd, "manifest.json")) as f:
        man = json.load(f)
    man["sha256"] = hashlib.sha256(blob).hexdigest()
    with open(os.path.join(sd, "manifest.json"), "w") as f:
        json.dump(man, f)
    return sd


def test_restore_params_walks_back_past_nonfinite_and_prefers_ema(
        tmp_path, capsys):
    """The newest step holds NaN params with intact bytes: it is skipped
    (a swap_skip record, not quarantined) and the older finite step is
    read, as JAX's restore_params reads it; a step with torn bytes is
    quarantined. A checkpoint with an EMA swaps in the EMA, not the
    raw params."""
    from tensorflow_distributed_tpu.train import checkpoint as jckpt

    cfg, model, state = _tiny_state(tmp_path)
    d = str(tmp_path / "ck")
    tckpt.save(d, state)
    state.step = 1
    tckpt.save(d, state)
    sd = _poison_step(d, 1)
    params, step = tckpt.restore_params(d, model)
    assert step == 0 and os.path.isdir(sd)
    assert all(bool(torch.isfinite(t).all()) for t in params.values())
    for name, t in model.named_parameters():
        assert torch.equal(params[name], t.detach())
    skip = _records(capsys.readouterr().out, "swap_skip")
    assert skip == [{"event": "recovery", "kind": "swap_skip", "step": 1,
                     "reason": "non-finite params"}]
    jm = jtr.CausalLM(jtr.tiny_config(causal=True, compute_dtype=jnp.float32,
                                      max_len=64))
    jparams = nn.meta.unbox(jm.init(jax.random.key(0),
                                    jnp.zeros((1, 8), jnp.int32))["params"])
    jgot, jstep = jckpt.restore_params(d, jparams)
    assert jstep == 0
    jflat = interop.params_from_flax(jax.device_get(jgot))
    assert all(torch.equal(jflat[n], params[n]) for n in params)
    # A newer step with torn bytes is quarantined on the way back.
    state.step = 2
    tckpt.save(d, state)
    torn = os.path.join(d, "step_00000002", "state.msgpack")
    with open(torn, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    assert tckpt.restore_params(d, model)[1] == 0
    assert os.path.isdir(os.path.join(d, "quarantined_step_00000002"))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tckpt.restore_params(str(tmp_path / "none"), model)
    # The EMA is preferred.
    e = str(tmp_path / "ema")
    state.ema = ema_init(state.params)
    for t in state.ema.values():
        t.mul_(0.5)
    tckpt.save(e, state)
    ema, _ = tckpt.restore_params(e, model)
    for name, t in model.named_parameters():
        assert torch.equal(ema[name], state.ema[name])
        assert not torch.equal(ema[name], t.detach()) or not t.any()


# --- the CLI -------------------------------------------------------------------

FIRE_ARGV = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
             "--seq-len", "48", "--compute-dtype", "float32", "--device",
             "cpu", "--serve.num-slots", "2", "--serve.num-requests", "6",
             "--serve.prompt-len-min", "4", "--serve.prompt-len-max", "10",
             "--serve.max-new-tokens", "10"]


def test_cli_exits_2_past_the_retry_budget(capsys):
    rc = cli.main(FIRE_ARGV + ["--serve.slot-retries", "0",
                               "--resilience.fault-plan", "slot_nan@3:0"])
    err = capsys.readouterr().err
    assert rc == 2 and "serve diverged" in err and "slot-quarantined" in err


def test_cli_exits_3_on_a_decode_stall_while_the_stall_sleeps():
    """A decode stall past the watchdog's deadline ends the process with
    exit 3 at once: the worker still sleeping in the stall is a daemon
    and does not hold the exit."""
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflow_distributed_tpu_torch.cli",
         *FIRE_ARGV, "--resilience.sync-timeout-s", "0.5",
         "--resilience.fault-plan", "decode_stall@4:30s"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        t_stall = None
        for line in proc.stdout:
            if '"fault": "decode_stall"' in line:
                t_stall = time.time()
        rc = proc.wait(timeout=120)
        t_exit = time.time()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    assert rc == 3, err[-2000:]
    assert "serve stalled: decode step for step 4" in err
    assert t_stall is not None and t_exit - t_stall < 10.0


def test_cli_fire_run_equals_jax_and_resumes_its_journal(tmp_path, capsys):
    """The CLI under two quarantines and a swap from a checkpoint, with a
    journal: the port's journal streams and fire line equal the JAX CLI's
    on the same checkpoint (one on-disk format); then the port resumes a
    journal cut after the kill's flush to the same streams."""
    from tensorflow_distributed_tpu import cli as jcli

    cfg, model, state = _tiny_state(tmp_path, seq_len=48)
    ck = str(tmp_path / "ck")
    tckpt.save(ck, state)
    argv = FIRE_ARGV + ["--checkpoint-dir", ck, "--resilience.fault-plan",
                        "slot_nan@3:0,slot_nan@6:1,reload@8"]
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    streams, fire = [], []
    for main, name, args in ((cli.main, "port", argv),
                             (jcli.main, "jax", jargv)):
        path = str(tmp_path / f"{name}.jsonl")
        assert main(args + ["--serve.journal", path]) == 0
        out = capsys.readouterr().out
        # The swap's seconds are each run's own wall time.
        fire.append(next(l for l in out.splitlines()
                         if l.startswith("[serve] fire:")).split(" swap_s")[0])
        streams.append({rid: (e["done"], e["tokens"]) for rid, e in
                        tjournal.replay(path).items()})
    assert streams[0] == streams[1]
    assert fire[0] == fire[1] == "[serve] fire: retries=2 swaps=1"
    # A kill after a flush: the journal cut at half its lines.
    lines = open(tmp_path / "port.jsonl").read().splitlines(keepends=True)
    cut = str(tmp_path / "cut.jsonl")
    with open(cut, "w") as f:
        f.writelines(lines[:len(lines) // 2])
    before = {rid for rid, e in tjournal.replay(cut).items() if e["done"]}
    assert cli.main(argv + ["--serve.journal", cut]) == 0
    out = capsys.readouterr().out
    assert "journal resume:" in out and "resumed=True" in out
    summary = json.loads(next(l for l in out.splitlines()
                              if l.startswith('{"event": "serve_summary"')))
    assert summary["requests"] == 6 - len(before) and summary["retries"] == 0
    assert {rid: (e["done"], e["tokens"]) for rid, e in
            tjournal.replay(cut).items()} == streams[0]

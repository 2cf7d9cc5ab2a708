"""PyTorch port: the scheduler's serve observatory and fleet intake
against the JAX package's scheduler.

- JAX's own scheduler tests, each run twice through ``torch_parity.run``
  (over JAX's ``Scheduler``, ``Request``, journal, ``auto_num_pages`` and
  configs, then over the port's) with both records equal: from
  tests/test_serve_observe.py the request span trees, the quarantine's
  trace, ``metrics_snapshot`` and its pinned percentiles, the export
  cadence and its atomic file, the final-only export, ``slo_alert`` /
  ``slo_ok`` through the scheduler, the status line, the serving wall,
  the verify fallback's accounting; from tests/test_incident.py the
  anomaly hub's feeds and the snapshot's incident state; from
  tests/test_fleet.py the feed's drain and the snapshot's liveness
  triplet, a reject into the journal, a re-dispatch superseding a stale
  copy, an impossible page reservation, a cancel of a live request, a
  swap updating the served checkpoint step, ``hold_export``,
  ``auto_num_pages`` with ``observed_peak`` and the fleet config
  matrix. A scheduler built without a clock gets a ticking fake one in
  both runs.
- One scripted run with everything armed (registry, tracer, SLO
  monitor, anomaly hub, export file, status line, journal, a feed
  sending requests, a cancel, a swap, a hold, a bad request and a drain)
  on one fake engine and clock: completions, records, the trace file,
  the export file, the status lines and the journal equal JAX's.
- ``ObserveConfig`` and ``--serve.inbox``: every case of the serve half
  gets JAX's outcome and message; the fields of layers not ported and
  any observe flag outside ``--mode serve`` are refused naming
  ROADMAP.md A8.
- ``--mode serve`` through the CLI on a tiny GPT with the observatory
  armed: the records, the balanced trace, the snapshot and the streams
  (JAX's ``serve_run`` on the same flags serves the same tokens); the
  paged auto-size reads a standing snapshot's ``slot_pages_peak``.
"""

import json
import os
import time

import numpy as np
import pytest

import test_fleet as jf
import test_incident as jinc
import test_serve_observe as jso
import torch_parity
from tensorflow_distributed_tpu import config as jconfig
from tensorflow_distributed_tpu.fleet import controller as jctl
from tensorflow_distributed_tpu.fleet import router as jrt
from tensorflow_distributed_tpu.observe import anomaly as janom
from tensorflow_distributed_tpu.observe import serve_trace as jst
from tensorflow_distributed_tpu.observe import slo as jslo
from tensorflow_distributed_tpu.observe import trace as jtrace
from tensorflow_distributed_tpu.serve import journal as jjournal
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu.serve.paging import engine as jpe
from tensorflow_distributed_tpu_torch import config as tconfig
from tensorflow_distributed_tpu_torch.fleet import controller as tctl
from tensorflow_distributed_tpu_torch.fleet import router as trt
from tensorflow_distributed_tpu_torch.observe import anomaly as tanom
from tensorflow_distributed_tpu_torch.observe import serve_trace as tst
from tensorflow_distributed_tpu_torch.observe import slo as tslo
from tensorflow_distributed_tpu_torch.observe import trace as ttrace
from tensorflow_distributed_tpu_torch.serve import journal as tjournal
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from tensorflow_distributed_tpu_torch.serve.paging import engine as tpe
from torch_threads import _one_thread  # noqa: F401


def _tick_clock(step=0.001):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]
    return clock


def _ticked(sched_mod):
    """The module's Scheduler with a ticking fake clock where the caller
    passes none (the JAX tests that read no times pass none)."""
    class Scheduler(sched_mod.Scheduler):
        def __init__(self, *a, **k):
            k.setdefault("clock", _tick_clock())
            super().__init__(*a, **k)
    return Scheduler


def _targets(slo, st, trace, anom, sched, journal, pe, cfg, rt, ctl):
    S = _ticked(sched)
    out = {(jso, n): getattr(slo, n) for n in (
        "SLOMonitor", "SLOTarget", "parse_slo", "parse_windows",
        "percentile")}
    out.update({
        (jso, "ServeTracer"): st.ServeTracer,
        (jso, "ChromeTracer"): trace.ChromeTracer,
        (jso, "load_trace"): trace.load_trace,
        (jso, "unbalanced_async"): trace.unbalanced_async,
        (jso, "Request"): sched.Request, (jso, "Scheduler"): S,
        (jinc, "AnomalyHub"): anom.AnomalyHub,
        # The names the JAX tests import inside their bodies.
        (jsched, "Scheduler"): S, (jsched, "Request"): sched.Request,
        (jjournal, "RequestJournal"): journal.RequestJournal,
        (jjournal, "replay"): journal.replay,
        (jpe, "auto_num_pages"): pe.auto_num_pages,
        (jconfig, "ServeConfig"): cfg.ServeConfig,
        (jconfig, "TrainConfig"): cfg.TrainConfig,
        (jf, "RouterConfig"): rt.RouterConfig,
        (jf, "ControllerConfig"): ctl.ControllerConfig})
    return out


JAX = _targets(jslo, jst, jtrace, janom, jsched, jjournal, jpe, jconfig,
               jrt, jctl)
PORT = _targets(tslo, tst, ttrace, tanom, tsched, tjournal, tpe, tconfig,
                trt, tctl)

SCENARIOS = [(jso, n) for n in (
    "test_scheduler_traces_requests_fake_engine",
    "test_scheduler_quarantine_traced_and_balanced",
    "test_metrics_snapshot_fields_and_pinned_percentiles",
    "test_export_cadence_atomic_file_and_records",
    "test_export_final_only_with_path",
    "test_slo_events_flow_through_scheduler",
    "test_status_line_cadence_and_content",
    "test_summary_wall_excludes_prerun_clock",
    "test_spec_fallback_scheduler_accounting",
    "test_fallback_engine_contract_matches_real_engine_guard")] + [
    (jinc, n) for n in (
        "test_scheduler_feeds_hub_and_snapshot_carries_anomaly_state",
        "test_scheduler_without_hub_shape_stable")] + [
    (jf, n) for n in (
        "test_scheduler_feed_drain_and_snapshot_liveness",
        "test_scheduler_feed_rejects_unservable_into_journal",
        "test_scheduler_feed_redispatch_supersedes_stale_copy",
        "test_scheduler_feed_rejects_impossible_page_reservation",
        "test_scheduler_feed_cancel_drops_live_without_completion",
        "test_scheduler_feed_swap_updates_served_ckpt_step",
        "test_scheduler_hold_export_freezes_snapshot_file",
        "test_auto_num_pages_arithmetic",
        "test_fleet_config_validation_matrix")]


@pytest.mark.parametrize("module,name", SCENARIOS,
                         ids=[n for _, n in SCENARIOS])
def test_scheduler_scenario_equals_jax(module, name, tmp_path, capsys):
    fn = getattr(module, name)
    jcalls, jfiles = torch_parity.run(fn, JAX, tmp_path / "jax")
    tcalls, tfiles = torch_parity.run(fn, PORT, tmp_path / "port")
    assert len(tcalls) == len(jcalls)
    for i, (j, t) in enumerate(zip(jcalls, tcalls)):
        assert t == j, f"call {i}: {j[0]}.{j[1]}"
    assert tfiles == jfiles


# --- everything armed, one scripted feed ---------------------------------

class _Clock:
    """Reads cost nothing; a prefill advances it 3 ms, a decode step
    10 ms, ``time.sleep`` by its argument."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += max(seconds, 1e-9)


class _Engine:
    """Tokens a pure function of (rid, emitted count): a continuation
    resumes the same stream (rid in prompt[0]). Slot 1 reads non-finite
    once at step 4; a swap counts; steps advance the clock."""

    def __init__(self, clock, num_slots=2, max_len=64):
        self.clock, self.num_slots, self.max_len = clock, num_slots, max_len
        self.buckets = (16, 32)
        self.active = np.zeros((num_slots,), bool)
        self.slot_rid, self.counts = {}, {}
        self.prefills = self.prefill_compiles = self.decode_steps = 0
        self.swaps = 0
        self._bad = []

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
        self.clock.t += 0.003
        return rid * 100 + self.counts[rid]

    def step(self):
        out = np.zeros((self.num_slots,), np.int32)
        for s in range(self.num_slots):
            if self.active[s]:
                rid = self.slot_rid[s]
                self.counts[rid] += 1
                out[s] = rid * 100 + self.counts[rid]
        self.decode_steps += 1
        if self.decode_steps == 4 and self.active[1]:
            self._bad = [1]
        self.clock.t += 0.010
        return out

    def take_bad_slots(self):
        bad, self._bad = self._bad, []
        return bad

    def free(self, slot):
        self.active[slot] = False

    def swap_params(self, params):
        self.swaps += 1


class _Feed:
    """Scripted batches, one a poll (requests interleaved with commands),
    then empty polls; ``lag_stats`` as the inbox feed's."""

    def __init__(self, batches):
        self.batches = list(batches)

    def poll(self):
        return self.batches.pop(0) if self.batches else []

    def lag_stats(self):
        return {"inbox_poll_lag_ms": 1.5}


def _armed_run(sched_mod, slo_mod, st_mod, anom_mod, journal_mod, tmp,
               monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "sleep", clock.sleep)
    records = []

    class Reg:
        def emit(self, event, **fields):
            records.append({"event": event, **fields})

    reg = Reg()
    R = sched_mod.Request

    def req(rid, n, slo="standard", plen=1):
        return R(rid=rid, prompt=np.asarray([rid] * plen, np.int32),
                 max_new_tokens=n, slo=slo)

    feed = _Feed([
        [req(1, 6, "high"), req(2, 9), {"cmd": "hold_export", "secs": 0.03}],
        [],
        [req(3, 5, "batch"), req(4, 90)],          # 4 cannot fit: reject
        [{"cmd": "cancel", "rid": 2}, req(2, 4, plen=3), {"cmd": "swap"}],
        [], [], [req(5, 3, "high")],
        [{"cmd": "drain"}, req(6, 2)],             # 6 arrives draining
    ])
    tracer = st_mod.ServeTracer(str(tmp / "trace.json"), clock=clock)
    mon = slo_mod.SLOMonitor(
        slo_mod.parse_slo("high:ttft_p95=5ms;ttft_p50=40ms"),
        fast_window=3, slow_window=6, emit=reg.emit, tracer=tracer)
    hub = anom_mod.AnomalyHub(emit=reg.emit, window=8, phase="serve")
    journal = journal_mod.RequestJournal(str(tmp / "journal.jsonl"))
    lines = []
    sched = sched_mod.Scheduler(
        _Engine(clock), decode_priority=2, registry=reg, clock=clock,
        journal=journal, reload_fn=lambda: ({"w": 2}, 7), tracer=tracer,
        slo_monitor=mon, anomaly_hub=hub, export_every=0.02,
        export_path=str(tmp / "snap.json"), status_fn=lines.append,
        status_every=3, feed=feed, served_ckpt_step=5, policy="slo")
    done = sched.run([req(0, 7, "standard")])
    journal.close()
    tracer.close()
    snap = sched.metrics_snapshot()
    out = {"done": done, "records": records, "lines": lines,
           "summary": sched.summary, "snap": snap,
           "files": torch_parity._files(str(tmp))}
    return torch_parity.norm(out, str(tmp))


def test_armed_scheduler_with_a_feed_equals_jax(tmp_path, monkeypatch,
                                                capsys):
    os.makedirs(tmp_path / "j")
    os.makedirs(tmp_path / "t")
    want = _armed_run(jsched, jslo, jst, janom, jjournal, tmp_path / "j",
                      monkeypatch)
    got = _armed_run(tsched, tslo, tst, tanom, tjournal, tmp_path / "t",
                     monkeypatch)
    for key in ("done", "records", "lines", "summary", "snap", "files"):
        assert got[key] == want[key], key
    events = [r["event"] for r in got["records"]]
    for ev in ("serve_request", "serve_reject", "serve_cancel", "recovery",
               "metrics_snapshot", "serve_summary", "anomaly", "slo_alert"):
        assert ev in events, ev
    assert got["snap"]["ckpt_step"] == 7 and got["snap"]["draining"]
    assert sorted(d["rid"] for d in got["done"]) == [0, 1, 2, 3, 5]
    played = got["files"]["journal.jsonl"]
    assert {"e": "reject", "rid": 4} in played
    assert {"e": "reject", "rid": 6} in played


def test_scheduler_takes_every_jax_argument_but_the_autopilot():
    import inspect

    jparams = set(inspect.signature(jsched.Scheduler).parameters)
    tparams = set(inspect.signature(tsched.Scheduler).parameters)
    assert tparams == jparams
    clock = _Clock()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8"):
        tsched.Scheduler(_Engine(clock), autopilot=object())
    feed = _Feed([[{"cmd": "tune", "knob": "slot_cap", "value": 1}]])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A8"):
        tsched.Scheduler(_Engine(clock), feed=feed, clock=clock).run([])


# --- ObserveConfig and --serve.inbox against JAX's messages --------------

OBSERVE_SERVE_CASES = [
    dict(), dict(metrics_jsonl="m.jsonl"), dict(trace="t.json"),
    dict(trace_durable=True), dict(trace="t.json", trace_durable=True),
    dict(max_records=0), dict(max_records=10),
    dict(slo="high:ttft_p95=100ms"), dict(slo="gold:ttft_p95=100ms"),
    dict(slo="ttft_p95=100"), dict(slo_windows="10,100"),
    dict(slo="ttft_p95=1ms", slo_windows="10,5"),
    dict(slo="ttft_p95=1ms", slo_windows="x"), dict(slo_burn=2.0),
    dict(slo="ttft_p95=1ms", slo_burn=0.0),
    dict(slo="ttft_p95=1ms", slo_burn=2.0), dict(slo_status_every=-1),
    dict(slo_status_every=5), dict(export_every=-1.0),
    dict(export_every=0.5, export_path="s.json"), dict(anomaly=True),
    dict(anomaly_window=4, anomaly=True), dict(anomaly_window=32),
    dict(anomaly_window=32, anomaly=True)]
UNPORTED_CASES = [
    dict(metrics_csv="m.csv"), dict(peak_tflops=100.0), dict(window=50),
    dict(programs=False), dict(health=True), dict(flightrec="fr"),
    dict(flightrec="fr", flightrec_ring=64), dict(autopilot=True),
    dict(autopilot=True, autopilot_every=10)]


def _check(cfg_mod, mode, observe=None, **serve):
    cfg = cfg_mod.TrainConfig(mode=mode, model="gpt_lm", seq_len=64,
                              observe=cfg_mod.ObserveConfig(**(observe or {})),
                              serve=cfg_mod.ServeConfig(**serve))
    try:
        cfg.validate()
        return ("ok",)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", OBSERVE_SERVE_CASES)
def test_serve_observe_flags_check_as_jax(kw):
    assert (_check(tconfig, "serve", kw) == _check(jconfig, "serve", kw))


@pytest.mark.parametrize("kw", OBSERVE_SERVE_CASES[1:] + UNPORTED_CASES)
def test_observe_outside_serve_checks_as_jax_or_names_a8(kw):
    """Outside --mode serve: JAX's ValueError where JAX has one (a flag
    of the serve observatory under another mode), else the refusal
    naming A8 (the training observatory)."""
    want = _check(jconfig, "train", kw)
    try:
        got = _check(tconfig, "train", kw)
    except NotImplementedError as e:
        assert "ROADMAP.md A8" in str(e)
        assert want == ("ok",) or set(kw) - set(
            tconfig.OBSERVE_SERVE_FIELDS)
    else:
        assert got == want and want[0] == "ValueError"


@pytest.mark.parametrize("kw", UNPORTED_CASES + [
    dict(health_every=10), dict(flightrec_ring=64),
    dict(autopilot_pin="bogus"), dict(autopilot_every=0)])
def test_unported_observe_fields_check_as_jax_or_name_a8(kw, capsys):
    """A field of a layer not ported: JAX's ObserveConfig message where
    JAX's validate refuses the value, else the refusal naming A8 (and
    the CLI exits with it)."""
    want = _check(jconfig, "serve", kw)
    try:
        got = _check(tconfig, "serve", kw)
    except NotImplementedError as e:
        assert "ROADMAP.md A8" in str(e)
        with pytest.raises(SystemExit):
            tconfig.parse_args(["--mode", "serve", "--model", "gpt_lm",
                                *[x for k, v in kw.items() for x in (
                                    "--observe." + k.replace("_", "-"),
                                    str(v).lower())]])
        assert "ROADMAP.md A8" in capsys.readouterr().err
    else:
        assert got == want and want[0] == "ValueError"


@pytest.mark.parametrize("kw", [
    dict(inbox="i.jsonl", journal="j.jsonl"), dict(inbox="i.jsonl"),
    dict(inbox="i.jsonl", journal="j.jsonl", requests="r.jsonl"),
    dict(inbox="i.jsonl", journal="j.jsonl", trace="poisson",
         arrival_rate=1.0),
    dict(inbox="i.jsonl", journal="j.jsonl", slo_mix="high:0.5",
         policy="slo"),
    dict(inbox="i.jsonl", journal="j.jsonl", session_turns=2),
    dict(inbox="i.jsonl", journal="j.jsonl", policy="slo", paged=True)])
def test_inbox_checks_as_jax(kw):
    assert _check(tconfig, "serve", **kw) == _check(jconfig, "serve", **kw)
    for mode in ("train", "generate"):
        assert (_check(tconfig, mode, **kw)[:1]
                == _check(jconfig, mode, **kw)[:1])


def test_inbox_needs_an_explicit_seq_len_as_jax():
    for cfg_mod in (tconfig, jconfig):
        cfg = cfg_mod.TrainConfig(mode="serve", model="gpt_lm",
                                  serve=cfg_mod.ServeConfig(
                                      inbox="i", journal="j"))
        with pytest.raises(ValueError, match="explicit --seq-len"):
            cfg.validate()


def test_observe_config_has_the_jax_fields_and_defaults():
    import dataclasses

    port, ref = tconfig.ObserveConfig(), jconfig.ObserveConfig()
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    from tensorflow_distributed_tpu.observe.autopilot import KNOBS

    assert tconfig.AUTOPILOT_KNOBS == KNOBS


# --- through the CLI ----------------------------------------------------

SERVE = ["--mode", "serve", "--model", "gpt_lm", "--model-size", "tiny",
         "--compute-dtype", "float32", "--serve.num-slots", "2",
         "--serve.num-requests", "5", "--serve.prompt-len-min", "4",
         "--serve.prompt-len-max", "12", "--serve.max-new-tokens", "8",
         "--serve.slo-mix", "high:0.4", "--serve.policy", "slo",
         "--seq-len", "32"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny GPT trained two steps and saved by the port's CLI (its
    checkpoints are the JAX package's bytes), so both packages serve the
    same weights."""
    from tensorflow_distributed_tpu_torch import cli

    d = str(tmp_path_factory.mktemp("ckpt"))
    assert cli.main(["--model", "gpt_lm", "--model-size", "tiny",
                     "--seq-len", "32", "--compute-dtype", "float32",
                     "--device", "cpu", "--dataset", "synthetic",
                     "--train-steps", "2", "--batch-size", "8",
                     "--eval-every", "0", "--log-every", "0",
                     "--checkpoint-dir", d, "--checkpoint-every", "2"]) == 0
    return d


def test_cli_serve_with_the_observatory_armed(tmp_path, capsys, ckpt):
    from tensorflow_distributed_tpu.config import parse_args as jparse
    from tensorflow_distributed_tpu.serve import run as jrun
    from tensorflow_distributed_tpu_torch import cli

    def flags(d):
        os.makedirs(d, exist_ok=True)
        return ["--observe.metrics-jsonl", f"{d}/m.jsonl",
                "--observe.trace", f"{d}/t.json",
                "--observe.slo", "high:ttft_p95=1s;ttft_p50=2s",
                "--observe.slo-status-every", "4",
                "--observe.export-every", "0.01",
                "--observe.export-path", f"{d}/s.json",
                "--observe.anomaly", "true",
                "--serve.journal", f"{d}/j.jsonl", "--checkpoint-dir", ckpt]

    assert cli.main(SERVE + flags(tmp_path / "t") + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] slo monitor: alerts=" in out
    assert "[observe] serve trace:" in out and "[serve] step=" in out
    jrun.serve_run(jparse(SERVE + flags(tmp_path / "j")))
    recs = {d: [json.loads(line) for line in open(tmp_path / d / "m.jsonl")]
            for d in "tj"}
    kinds = {d: {r["event"] for r in recs[d]} for d in "tj"}
    assert {"serve_request", "serve_summary", "metrics_snapshot"} <= kinds["t"]
    assert kinds["t"] <= kinds["j"] | {"recovery"}
    streams = {d: {rid: e["tokens"] for rid, e in jjournal.replay(
        str(tmp_path / d / "j.jsonl")).items()} for d in "tj"}
    assert streams["t"] == streams["j"] and len(streams["t"]) == 5
    ev = jtrace.load_trace(str(tmp_path / "t" / "t.json"))
    assert not jtrace.unbalanced_async(ev)
    names = {e["name"] for e in ev}
    assert {"request", "queue", "prefill", "decode", "decode_step"} <= names
    snap = json.load(open(tmp_path / "t" / "s.json"))
    want = json.load(open(tmp_path / "j" / "s.json"))
    assert snap["requests_done"] == want["requests_done"] == 5
    assert snap["ckpt_step"] == want["ckpt_step"] == 2
    assert set(snap) <= set(want)
    assert {"seq", "wall_ts", "pid", "slo", "anomaly"} <= set(snap)


def test_paged_auto_size_reads_the_standing_snapshot(tmp_path, capsys):
    from tensorflow_distributed_tpu_torch.serve import run as trun

    snap = tmp_path / "s.json"
    argv = SERVE + ["--serve.paged", "true", "--serve.page-size", "8",
                    "--device", "cpu", "--observe.export-path", str(snap)]
    _, engine, _ = trun.serve_setup(tconfig.parse_args(argv))
    fresh = engine.pool.capacity
    snap.write_text(json.dumps({"slot_pages_peak": 3}))
    _, engine, _ = trun.serve_setup(tconfig.parse_args(argv))
    out = capsys.readouterr().out
    assert "observed slot_pages_peak 3" in out
    serving = (fresh - 1) // 2
    assert engine.pool.capacity == 1 + serving + 3
    assert trun.observed_slot_pages_peak(str(tmp_path / "none.json")) == 0
    snap.write_text("{torn")
    assert trun.observed_slot_pages_peak(str(snap)) == 0

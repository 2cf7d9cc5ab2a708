"""PyTorch port: the serve observatory's host modules against the JAX
package's: ``observe/{slo,trace,serve_trace,registry,anomaly}.py``.

Each case is one of the JAX package's own tests, run twice through
``torch_parity.run``, over the JAX modules' names and then over the
port's, with both records compared (every public call's result: parsed
targets and their rejections, burn-rate alerts on one fake clock,
snapshots, status bits, span trees and the trace files, including the
resume across a killed leg and the event cap's balance, the registry's
records and sink files, the detectors' and the hub's verdicts on JAX's
canned streams in both phases). The JAX test's assertions hold the port
on each run.

- tests/test_serve_observe.py: the SLO grammar and its rejections, the
  windows, the burn-rate alert and its clearing, the budget, the class
  filter; the Chrome tracer's async spans, cap and preload; the serve
  tracer's request tree, eviction, resume and close.
- tests/test_observe.py: the JSONL sink (round trip, truncation of a
  previous run), chief-only emission and the ring buffer, the CSV
  sink's union header, the stdout sink, ``config_hash``; the Chrome
  trace's validity, cap and disabled path.
- tests/test_incident.py: every detector on its canned stream and the
  hub in the train and serve phases (the train feeds are wired with the
  training observatory, ROADMAP.md A8), its snapshot and validation.

The scheduler's use of them is tests/test_torch_serve_observe.py.
"""

import json

import pytest

import test_incident as jinc
import test_observe as jobs
import test_serve_observe as jso
import torch_parity
from tensorflow_distributed_tpu.observe import anomaly as janom
from tensorflow_distributed_tpu.observe import registry as jreg
from tensorflow_distributed_tpu.observe import serve_trace as jst
from tensorflow_distributed_tpu.observe import slo as jslo
from tensorflow_distributed_tpu.observe import trace as jtrace
from tensorflow_distributed_tpu.serve import scheduler as jsched
from tensorflow_distributed_tpu_torch.observe import anomaly as tanom
from tensorflow_distributed_tpu_torch.observe import registry as treg
from tensorflow_distributed_tpu_torch.observe import serve_trace as tst
from tensorflow_distributed_tpu_torch.observe import slo as tslo
from tensorflow_distributed_tpu_torch.observe import trace as ttrace
from tensorflow_distributed_tpu_torch.serve import scheduler as tsched
from torch_threads import _one_thread  # noqa: F401


def _serve_observe_targets(slo, st, trace, sched):
    return {(jso, n): getattr(slo, n) for n in (
        "SLOMonitor", "SLOTarget", "parse_slo", "parse_windows",
        "percentile")} | {
        (jso, "ServeTracer"): st.ServeTracer,
        (jso, "ChromeTracer"): trace.ChromeTracer,
        (jso, "load_trace"): trace.load_trace,
        (jso, "unbalanced_async"): trace.unbalanced_async,
        (jso, "Request"): sched.Request, (jso, "Scheduler"): sched.Scheduler}


def _observe_targets(reg, trace):
    return {(jobs, n): getattr(reg, n) for n in (
        "CsvSink", "JsonlSink", "MetricsRegistry", "StdoutSink",
        "config_hash")} | {(jobs, "ChromeTracer"): trace.ChromeTracer,
                           (jobs, "load_trace"): trace.load_trace}


ANOMALY_NAMES = ("AnomalyHub", "MadSpikeDetector", "NonFiniteDetector",
                 "PlateauDetector", "QueueGrowthDetector",
                 "RatioCollapseDetector", "RollingMedianSpike",
                 "SlopeDegradationDetector")


def _incident_targets(anom):
    return {(jinc, n): getattr(anom, n) for n in ANOMALY_NAMES}


CASES = {
    "serve_observe": (jso, (
        "test_parse_slo_grammar", "test_parse_windows",
        "test_burn_rate_alert_fires_and_clears",
        "test_budget_remaining_math",
        "test_monitor_class_filter_and_snapshot",
        "test_chrome_tracer_async_and_balance",
        "test_chrome_tracer_cap_preserves_async_balance",
        "test_chrome_tracer_preload_offsets_clock",
        "test_serve_tracer_request_tree",
        "test_serve_tracer_evict_reopens_queue",
        "test_serve_tracer_resume_closes_dead_spans",
        "test_serve_tracer_close_balances_open_requests"),
        _serve_observe_targets(jslo, jst, jtrace, jsched),
        _serve_observe_targets(tslo, tst, ttrace, tsched)),
    "observe": (jobs, (
        "test_jsonl_sink_round_trip",
        "test_registry_chief_only_and_ring_buffer",
        "test_csv_sink_union_header", "test_stdout_sink_step_format",
        "test_config_hash_stable_and_order_free",
        "test_jsonl_sink_replaces_previous_run",
        "test_chrome_trace_valid_and_complete",
        "test_chrome_trace_caps_events",
        "test_chrome_trace_disabled_writes_nothing"),
        _observe_targets(jreg, jtrace), _observe_targets(treg, ttrace)),
    "incident": (jinc, (
        "test_mad_spike_fires_at_exact_step",
        "test_mad_spike_needs_min_samples",
        "test_mad_spike_outlier_not_absorbed_and_cooldown",
        "test_mad_spike_scale_guards",
        "test_rolling_median_spike_semantics",
        "test_slope_degradation_fires_on_sustained_drop",
        "test_slope_degradation_silent_on_stable_and_improving",
        "test_plateau_detector", "test_nonfinite_detector",
        "test_ratio_collapse_fires_on_frozen_module",
        "test_queue_growth_fires_at_exact_step",
        "test_hub_train_nan_and_step_spike",
        "test_hub_train_throughput_slope",
        "test_hub_health_explosion_and_collapse",
        "test_hub_serve_decode_spike_and_queue_growth",
        "test_hub_serve_ttft_and_slot_nonfinite",
        "test_hub_snapshot_and_active_horizon", "test_hub_validation"),
        _incident_targets(janom), _incident_targets(tanom)),
}
SCENARIOS = [(group, name) for group, (_, names, _, _) in CASES.items()
             for name in names]


@pytest.mark.parametrize("group,name", SCENARIOS,
                         ids=[f"{g}-{n}" for g, n in SCENARIOS])
def test_observe_scenario_equals_jax(group, name, tmp_path):
    module, _, jax_targets, port_targets = CASES[group]
    fn = getattr(module, name)
    jcalls, jfiles = torch_parity.run(fn, jax_targets, tmp_path / "jax")
    tcalls, tfiles = torch_parity.run(fn, port_targets, tmp_path / "port")
    assert len(tcalls) == len(jcalls)
    for i, (j, t) in enumerate(zip(jcalls, tcalls)):
        assert t == j, f"call {i}: {j[0]}.{j[1]}"
    assert tfiles == jfiles


# The rejections of the SLO grammar: the same exception and message.
SLO_SPECS = [
    "", "high:", "high:ttft=100ms", "high:latency_p95=100ms",
    "ttft_p95=100", "ttft_p0=100ms", "ttft_p100=100ms", "ttft_pxx=100ms",
    "ttft_p95=0ms", "ttft_p95=100ms,ttft_p95=200ms", "high:ttft_p95",
    "high:ttft_p95=100ms,tok_p50=30ms;standard:ttft_p95=0.5s;tok_p99=500us",
    "gold:ttft_p95=1s", " high : ttft_p95 = 2ms ; ", "ttft_p95=1e9ms"]


def _outcome(fn, *a):
    try:
        return ("ok", torch_parity.norm(fn(*a), ""))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_parse_slo_equals_jax(spec):
    assert _outcome(tslo.parse_slo, spec) == _outcome(jslo.parse_slo, spec)


@pytest.mark.parametrize("spec", ["60,600", "4,8", "8,4", "0,5", "5",
                                  "a,b", " 3 , 9 ", "1,1"])
def test_parse_windows_equals_jax(spec):
    assert (_outcome(tslo.parse_windows, spec)
            == _outcome(jslo.parse_windows, spec))


def test_burn_rate_trace_on_a_long_stream_equals_jax():
    """A seeded stream of completions under three targets (two classes
    and a classless one) and a step clock: every on_step's events, the
    snapshot, summary and status bits of each step are JAX's."""
    import numpy as np

    def drive(slo_mod):
        events = []
        mon = slo_mod.SLOMonitor(
            slo_mod.parse_slo("high:ttft_p95=50ms,tok_p50=5ms;"
                              "standard:ttft_p99=200ms;tok_p90=8ms"),
            fast_window=6, slow_window=24, burn_threshold=1.5,
            emit=lambda ev, **f: events.append((ev, f)))
        rng = np.random.default_rng(11)
        out = []
        for step in range(1, 200):
            for _ in range(int(rng.integers(0, 3))):
                cls = ["high", "standard", "batch"][int(rng.integers(3))]
                spike = 8.0 if 80 <= step < 110 else 1.0
                mon.observe(cls, float(rng.gamma(2.0, 15.0)) * spike,
                            float(rng.gamma(2.0, 2.0)) * spike, step)
            out.append((mon.on_step(step), mon.snapshot(), mon.summary(),
                        mon.status_bits(), mon.any_alerting()))
        return torch_parity.norm((out, events), "")

    got, want = drive(tslo), drive(jslo)
    assert got == want
    assert any(ev == "slo_alert" for ev, _ in want[1])
    assert any(ev == "slo_ok" for ev, _ in want[1])


def test_registry_host_tags_and_active_registry():
    """host_tags without JAX: rank 0 outside a process group, the mesh
    rendered as JAX renders it, JAX's config hash; the active registry is
    what utils.logging.emit_event forwards to."""
    import dataclasses

    from tensorflow_distributed_tpu_torch.config import TrainConfig
    from tensorflow_distributed_tpu_torch.utils.logging import emit_event

    cfg = {"a": 1, "b": [2, 3]}
    tags = treg.host_tags({"data": 1, "model": 4}, cfg)
    assert tags == {"process_index": 0, "mesh": "model=4",
                    "config_hash": jreg.config_hash(cfg)}
    assert treg.host_tags({"data": 1})["mesh"] == "data=1"
    tc = TrainConfig()
    assert treg.config_hash(tc) == jreg.config_hash(dataclasses.asdict(tc))
    reg = treg.MetricsRegistry()
    treg.set_active(reg)
    try:
        emit_event("recovery", kind="probe", n=1)
    finally:
        treg.set_active(None)
    assert [r["kind"] for r in reg.records] == ["probe"]
    emit_event("recovery", kind="unseen")
    assert len(reg.records) == 1


def test_jsonl_sink_appends_on_resume_as_jax(tmp_path):
    def run(reg_mod, path):
        for append, steps in ((False, (1, 2)), (True, (3,)),
                              (False, (4,)), (True, (5, 6))):
            reg = reg_mod.MetricsRegistry([reg_mod.JsonlSink(
                str(path), append=append)], tags={"process_index": 0})
            for s in steps:
                reg.emit("step", step=s)
            reg.close()
            reg.emit("late", step=-1)        # after close: no reopen

    def rows(path):
        return [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in open(path)]

    run(jreg, tmp_path / "j.jsonl")
    run(treg, tmp_path / "t.jsonl")
    assert rows(tmp_path / "t.jsonl") == rows(tmp_path / "j.jsonl")
    assert [r["step"] for r in rows(tmp_path / "t.jsonl")] == [4, 5, 6]

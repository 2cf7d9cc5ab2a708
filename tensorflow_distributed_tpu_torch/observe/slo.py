"""Live SLO monitor for serving (the port of ``observe/slo.py``):
declared targets, rolling windows, multi-window burn-rate alerting.

An SLO here is a *percentile target* per request class —
``--observe.slo "high:ttft_p95=100ms,tok_p50=30ms"`` declares that 95%
of high-class requests must see first-token latency <= 100 ms and 50%
must see mean inter-token latency <= 30 ms. Each target implies an
**error budget**: ``ttft_p95`` tolerates 5% of requests violating the
threshold; the monitor's job is to say, *while the run is still
serving*, how fast that budget is burning.

Burn rate is the SRE multi-window construction: over a window,
``burn = violating_fraction / budget_fraction`` (1.0 = burning exactly
as fast as the SLO tolerates; 2.0 = the budget gone in half the
period). An alert fires when BOTH a fast and a slow window exceed the
threshold — the fast window gives low detection latency, the slow one
keeps a single straggler from paging — and clears (``slo_ok``) when
either drops back under. Windows are measured on the **decode-step
clock** (the scheduler's own iteration counter), not wall time, so a
test can replay a fixed completion sequence and get the exact same
alert trace every run; the defaults (60 / 600 steps) are the 1m/10m
shape at ~1 step/s.

Pure stdlib. The
scheduler drives it: :meth:`SLOMonitor.observe` per completion,
:meth:`SLOMonitor.on_step` per decode step; events flow out through
the emit callable (the scheduler's registry) as ``slo_alert`` /
``slo_ok`` records carrying burn rates and error-budget remaining.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

#: Metrics a target may constrain: arrival->first-token latency and
#: mean inter-token latency, both in ms (the two numbers serve_request
#: records already carry).
SLO_METRICS = ("ttft", "tok")


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile — THE definition (observe.report
    imports it), so a live snapshot's per-class p95 agrees exactly
    with the post-run report over the same population."""
    idx = min(len(sorted_vals) - 1,
              max(0, round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One declared objective: ``pct``% of ``cls`` requests must see
    ``metric`` <= ``threshold_ms``. ``cls`` == "" applies to every
    request regardless of class."""

    cls: str
    metric: str            # "ttft" | "tok"
    pct: int               # the percentile, e.g. 95
    threshold_ms: float

    @property
    def budget(self) -> float:
        """Tolerated violating fraction (5% for a p95 target)."""
        return 1.0 - self.pct / 100.0

    @property
    def key(self) -> str:
        base = f"{self.metric}_p{self.pct}"
        return f"{self.cls}:{base}" if self.cls else base


def _parse_value_ms(text: str) -> float:
    text = text.strip()
    for suffix, scale in (("ms", 1.0), ("us", 1e-3), ("s", 1e3)):
        if text.endswith(suffix):
            return float(text[: -len(suffix)]) * scale
    raise ValueError(
        f"SLO value {text!r} needs a unit suffix (ms, s, or us)")


def parse_slo(spec: str) -> List[SLOTarget]:
    """``--observe.slo`` grammar: ``;``-separated class groups, each an
    optional ``class:`` prefix followed by ``,``-separated
    ``metric_pNN=value`` entries —
    ``"high:ttft_p95=100ms,tok_p50=30ms;standard:ttft_p95=500ms"``.
    No prefix = the target applies to every request. Values carry a
    unit suffix (ms/s/us). Duplicate (class, metric, percentile)
    triples are rejected."""
    targets: List[SLOTarget] = []
    seen = set()
    for group in spec.split(";"):
        group = group.strip()
        if not group:
            continue
        cls = ""
        body = group
        if ":" in group:
            head, rest = group.split(":", 1)
            # A bare "ttft_p95=100ms" has no class prefix; a prefix is
            # an identifier with no "=" in it.
            if "=" not in head:
                cls, body = head.strip(), rest
        for entry in body.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" not in entry:
                raise ValueError(
                    f"SLO entry {entry!r} is not metric_pNN=value")
            name, value = (x.strip() for x in entry.split("=", 1))
            if "_p" not in name:
                raise ValueError(
                    f"SLO metric {name!r} is not metric_pNN "
                    f"(e.g. ttft_p95)")
            metric, pct_s = name.rsplit("_p", 1)
            if metric not in SLO_METRICS:
                raise ValueError(
                    f"unknown SLO metric {metric!r}; have {SLO_METRICS}")
            try:
                pct = int(pct_s)
            except ValueError:
                raise ValueError(
                    f"SLO percentile {pct_s!r} in {name!r} is not an "
                    f"integer")
            if not 1 <= pct <= 99:
                raise ValueError(
                    f"SLO percentile must be in [1, 99], got {pct}")
            threshold = _parse_value_ms(value)
            if threshold <= 0:
                raise ValueError(
                    f"SLO threshold for {name!r} must be > 0, got "
                    f"{threshold}ms")
            tgt = SLOTarget(cls=cls, metric=metric, pct=pct,
                            threshold_ms=threshold)
            dup = (cls, metric, pct)
            if dup in seen:
                raise ValueError(
                    f"SLO target {tgt.key!r} declared twice")
            seen.add(dup)
            targets.append(tgt)
    if not targets:
        raise ValueError(f"SLO spec {spec!r} names no targets")
    return targets


def parse_windows(spec: str) -> Tuple[int, int]:
    """``--observe.slo-windows "60,600"`` -> (fast, slow) in decode
    steps, fast < slow, both >= 1."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if len(parts) != 2:
        raise ValueError(
            f"slo_windows {spec!r} must be 'fast,slow' decode-step "
            f"counts")
    fast, slow = int(parts[0]), int(parts[1])
    if not 1 <= fast < slow:
        raise ValueError(
            f"slo_windows must satisfy 1 <= fast < slow, got "
            f"({fast}, {slow})")
    return fast, slow


class _TargetState:
    """Rolling accounting for one target: a slow-window deque of
    (step, value_ms) samples with incrementally-maintained violation
    counts for both windows (on_step runs every decode step — a
    recount per step would be O(window) each)."""

    def __init__(self, target: SLOTarget, fast: int, slow: int):
        self.target = target
        self.fast, self.slow = fast, slow
        self.samples: collections.deque = collections.deque()
        self.fast_n = self.fast_v = 0
        self.slow_n = self.slow_v = 0
        self.total = self.violations = 0
        self.alerting = False
        self.alerts = 0

    def observe(self, value_ms: float, step: int) -> None:
        bad = value_ms > self.target.threshold_ms
        self.samples.append((step, value_ms, bad))
        self.slow_n += 1
        self.fast_n += 1
        self.total += 1
        if bad:
            self.slow_v += 1
            self.fast_v += 1
            self.violations += 1

    def prune(self, step: int) -> None:
        while self.samples and self.samples[0][0] <= step - self.slow:
            _, _, bad = self.samples.popleft()
            self.slow_n -= 1
            self.slow_v -= int(bad)
        # Fast-window counts recount over the (short) fast suffix only
        # when the boundary moved past samples; keep it simple and
        # exact: walk from the right, fast windows are small.
        fn = fv = 0
        for s, _, bad in reversed(self.samples):
            if s <= step - self.fast:
                break
            fn += 1
            fv += int(bad)
        self.fast_n, self.fast_v = fn, fv

    def burn(self) -> Tuple[float, float]:
        budget = self.target.budget
        fast = (self.fast_v / self.fast_n / budget) if self.fast_n else 0.0
        slow = (self.slow_v / self.slow_n / budget) if self.slow_n else 0.0
        return fast, slow

    def budget_remaining(self) -> float:
        """Run-lifetime error budget left: 1 - violations / (budget *
        observed). Negative = overspent."""
        if not self.total:
            return 1.0
        allowed = self.target.budget * self.total
        return round(1.0 - self.violations / max(allowed, 1e-12), 4)

    def window_percentile(self) -> Optional[float]:
        """The target metric's observed percentile over the slow
        window (None without samples) — the status line's number."""
        if not self.samples:
            return None
        vals = sorted(v for _, v, _ in self.samples)
        return percentile(vals, self.target.pct)


class SLOMonitor:
    """Drives burn-rate alerting for a set of targets.

    The scheduler calls :meth:`observe` once per completed request and
    :meth:`on_step` once per decode step (the monitor's clock). Alert
    transitions emit ``slo_alert``/``slo_ok`` through ``emit`` and an
    instant marker through ``tracer`` (both optional). Deterministic
    by construction: same completion sequence on the same step clock
    -> same events.
    """

    def __init__(self, targets: List[SLOTarget], fast_window: int = 60,
                 slow_window: int = 600, burn_threshold: float = 1.0,
                 emit: Optional[Callable[..., Any]] = None,
                 tracer: Any = None, event_prefix: str = ""):
        if not targets:
            raise ValueError("SLOMonitor needs at least one target")
        if burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}")
        fast, slow = int(fast_window), int(slow_window)
        if not 1 <= fast < slow:
            raise ValueError(
                f"windows must satisfy 1 <= fast < slow, got "
                f"({fast}, {slow})")
        self.targets = list(targets)
        self.fast_window, self.slow_window = fast, slow
        self.burn_threshold = burn_threshold
        self._emit = emit
        self._tracer = tracer
        # "fleet_" at the router makes the monitor emit
        # fleet_slo_alert / fleet_slo_ok — same machinery, a namespace
        # that keeps fleet-level and per-replica records separable in
        # one merged JSONL (observe/report.py folds them into
        # different sections).
        self.event_prefix = event_prefix
        self._state = [_TargetState(t, fast, slow) for t in targets]

    def observe(self, slo_class: str, ttft_ms: float, tok_ms: float,
                step: int) -> None:
        """Fold one completion into every matching target's windows."""
        for st in self._state:
            t = st.target
            if t.cls and t.cls != slo_class:
                continue
            value = ttft_ms if t.metric == "ttft" else tok_ms
            st.observe(float(value), int(step))

    def on_step(self, step: int) -> List[Dict[str, Any]]:
        """Advance the decode-step clock: prune windows, evaluate burn
        rates, emit alert transitions. Returns the events emitted this
        step (tests read them directly)."""
        events: List[Dict[str, Any]] = []
        for st in self._state:
            st.prune(step)
            fast, slow = st.burn()
            firing = (fast > self.burn_threshold
                      and slow > self.burn_threshold)
            if firing == st.alerting:
                continue
            st.alerting = firing
            kind = self.event_prefix + (
                "slo_alert" if firing else "slo_ok")
            if firing:
                st.alerts += 1
            fields = {
                "target": st.target.key, "slo_class": st.target.cls,
                "metric": st.target.metric, "pct": st.target.pct,
                "threshold_ms": st.target.threshold_ms,
                "burn_fast": round(fast, 4), "burn_slow": round(slow, 4),
                "window_fast": self.fast_window,
                "window_slow": self.slow_window,
                "budget_remaining": st.budget_remaining(),
                "step": int(step),
            }
            events.append({"event": kind, **fields})
            if self._emit is not None:
                self._emit(kind, **fields)
            if self._tracer is not None:
                self._tracer.instant(kind, cat="slo",
                                     target=st.target.key,
                                     burn_fast=fields["burn_fast"],
                                     burn_slow=fields["burn_slow"])
        return events

    # -- read-side --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time SLO state for the scheduler's
        ``metrics_snapshot()`` export: per-target burn rates, observed
        window percentile, budget remaining, alert state."""
        out: Dict[str, Any] = {}
        for st in self._state:
            fast, slow = st.burn()
            entry: Dict[str, Any] = {
                "threshold_ms": st.target.threshold_ms,
                "burn_fast": round(fast, 4),
                "burn_slow": round(slow, 4),
                "budget_remaining": st.budget_remaining(),
                "alerting": st.alerting,
                "alerts": st.alerts,
                "observed": st.total,
            }
            wp = st.window_percentile()
            if wp is not None:
                entry["window_value_ms"] = round(wp, 3)
            out[st.target.key] = entry
        return out

    def summary(self) -> Dict[str, Any]:
        """Run-end rollup merged into the serve_summary record."""
        return {
            "slo_alerts": sum(st.alerts for st in self._state),
            "slo_budget_remaining_min": min(
                st.budget_remaining() for st in self._state),
            "slo_targets": ",".join(t.key for t in self.targets),
        }

    def any_alerting(self) -> bool:
        return any(st.alerting for st in self._state)

    def status_bits(self) -> str:
        """The SLO half of the live status line: per-target observed
        window percentile vs threshold plus the worst burn."""
        bits = []
        for st in self._state:
            _, slow = st.burn()
            wp = st.window_percentile()
            wp_s = "-" if wp is None else f"{wp:.0f}ms"
            mark = "!" if st.alerting else ""
            bits.append(f"{st.target.key}={wp_s}/"
                        f"{st.target.threshold_ms:.0f}ms "
                        f"burn={slow:.2f}{mark}")
        return " ".join(bits)

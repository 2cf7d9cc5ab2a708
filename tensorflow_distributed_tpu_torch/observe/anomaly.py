"""Online anomaly detection over the observe record flow: the port of
``observe/anomaly.py``, pure host math.

Everything else in observe/ tells you what happened; this module says
*something is going wrong, now*. A set of streaming detectors consumes
the values the run ALREADY fetches on its log cadence — no new host
transfers, no device work — and emits ``event="anomaly"`` records
(detector id, severity, the offending value, the rolling baseline, an
evidence window) the moment a signal leaves its envelope:

- **step-time spike** (:class:`MadSpikeDetector`): robust z-score
  against the rolling median/MAD — a stall, a swap-in, a noisy
  neighbor shows as one step far outside the jitter envelope;
- **throughput-slope degradation** (:class:`SlopeDegradationDetector`):
  the newer half of the window sustainedly below the older half — the
  slow-leak failure a single-step spike detector cannot see;
- **loss spike** (:class:`RollingMedianSpike`, the rolling-median
  spike rule) and **loss plateau**
  (:class:`PlateauDetector`) / **non-finite loss**
  (:class:`NonFiniteDetector`);
- **grad-norm explosion / update-ratio collapse** on the per-module
  health records (observe/health.py): a layer diverging or freezing
  flags before the global loss moves;
- serve side, on the **deterministic decode-step clock**: TTFT spike,
  decode-step-time spike, sustained queue growth
  (:class:`QueueGrowthDetector`), and per-slot non-finite logits (the
  engine's own ok-flag, surfaced as an anomaly).

The :class:`AnomalyHub` owns one run's detectors, routes the observed
values (the Observatory feeds it from ``log_step``/health records, the
serve scheduler from its decode loop), emits through the run's
registry, and keeps the live incident state
(:meth:`AnomalyHub.snapshot`) that ``Scheduler.metrics_snapshot()``
and the ``--observe.export-path`` payload carry for a router or fleet
supervisor to poll.

The port wires the serve feeds (``observe_decode_step``,
``observe_completion``, ``note_slot_nonfinite``, ``snapshot``); the
train feeds (``observe_train_step``, ``observe_health``) are here and
tested, and are wired with the training ``Observatory`` (ROADMAP.md A8).

Pure stdlib.
"""

from __future__ import annotations

import collections
import math
import statistics
from typing import Any, Callable, Dict, List, Optional

#: Severity levels, mild first. "warn" = degradation worth a look;
#: "critical" = the run is actively damaged (non-finite values,
#: explosions).
SEVERITIES = ("warn", "critical")


def _finite(value: Any) -> bool:
    return isinstance(value, (int, float)) and math.isfinite(value)


class MadSpikeDetector:
    """Robust single-sample spike detection: rolling median + MAD.

    A sample fires when BOTH hold over a window of at least
    ``min_samples`` prior values:

    - robust z-score ``(value - median) / max(MAD/0.6745,
      0.01*|median|)`` exceeds ``z_threshold`` (the 1%-of-median floor
      keeps a near-constant baseline — MAD ~ 0 — from turning timer
      quantization into infinite z);
    - ``value > ratio_min * median`` AND ``value - median > abs_min``
      (scale guards: relative jitter on a tiny baseline — sub-ms
      decode steps easily double on host scheduling noise — never
      fires; an incident must be large in BOTH senses).

    A firing sample is NOT added to the window (one outlier must not
    drag the baseline toward itself) and starts a ``cooldown`` during
    which further samples are absorbed into the window without firing
    — a sustained regime shift re-baselines instead of paging every
    step.
    """

    def __init__(self, id: str, window: int = 64, min_samples: int = 8,
                 z_threshold: float = 8.0, ratio_min: float = 4.0,
                 abs_min: float = 0.0,
                 severity: str = "warn", evidence: int = 8):
        self.id = id
        self.severity = severity
        self.min_samples = max(2, int(min_samples))
        self.z_threshold = float(z_threshold)
        self.ratio_min = float(ratio_min)
        self.abs_min = float(abs_min)
        self.evidence = int(evidence)
        self._buf: collections.deque = collections.deque(
            maxlen=int(window))
        self._cool = 0
        self._cooldown = self.min_samples

    def observe(self, value: float) -> Optional[Dict[str, Any]]:
        if not _finite(value):
            return None
        value = float(value)
        if self._cool > 0:
            self._cool -= 1
            self._buf.append(value)
            return None
        if len(self._buf) >= self.min_samples:
            med = statistics.median(self._buf)
            mad = statistics.median(abs(x - med) for x in self._buf)
            denom = max(mad / 0.6745, 0.01 * abs(med), 1e-9)
            z = (value - med) / denom
            if (z > self.z_threshold and med > 0
                    and value > self.ratio_min * med
                    and value - med > self.abs_min):
                self._cool = self._cooldown
                return {
                    "value": value, "baseline": med,
                    "zscore": min(z, 1e6),
                    "evidence": list(self._buf)[-self.evidence:],
                }
        self._buf.append(value)
        return None

    def reset(self) -> None:
        self._buf.clear()
        self._cool = 0


class RollingMedianSpike:
    """Rolling-window divergence detector for FINITE values — the ONE
    median-spike implementation (``resilience.policies
    .LossSpikeDetector`` is this class, so the loop's acting policy
    and the anomaly hub's advisory detector cannot drift apart).

    ``observe(value)`` returns the window median when ``value >
    factor * median`` over a full window, else None. The spiking value
    is NOT added to the window (one outlier must not drag the baseline
    toward itself), but training-regime shifts still track because
    every non-spike value is."""

    def __init__(self, window: int, factor: float):
        self.factor = factor
        self._window: collections.deque = collections.deque(
            maxlen=window)

    def observe(self, loss: float) -> Optional[float]:
        full = len(self._window) == self._window.maxlen
        if full:
            med = statistics.median(self._window)
            if loss > self.factor * max(med, 1e-12):
                return med
        self._window.append(loss)
        return None

    def reset(self) -> None:
        """After a rewind the replayed steps re-approach the spike
        region legitimately; a stale window would re-flag them."""
        self._window.clear()


class SlopeDegradationDetector:
    """Sustained degradation of a higher-is-better signal
    (throughput): over a FULL window, the newer half's median below
    ``(1 - drop) x`` the older half's median. One dipped sample never
    fires — half the window must sit down there. On fire the window
    clears (the new regime becomes the baseline; re-arms after a full
    window of fresh samples)."""

    def __init__(self, id: str, window: int = 12, drop: float = 0.4,
                 severity: str = "warn"):
        if window < 4:
            raise ValueError(f"window must be >= 4, got {window}")
        self.id = id
        self.severity = severity
        self.drop = float(drop)
        self._buf: collections.deque = collections.deque(
            maxlen=int(window))

    def observe(self, value: float) -> Optional[Dict[str, Any]]:
        if not _finite(value):
            return None
        self._buf.append(float(value))
        if len(self._buf) < self._buf.maxlen:
            return None
        vals = list(self._buf)
        half = len(vals) // 2
        old = statistics.median(vals[:half])
        new = statistics.median(vals[half:])
        if old > 0 and new < (1.0 - self.drop) * old:
            self._buf.clear()
            return {"value": new, "baseline": old,
                    "evidence": vals[-8:]}
        return None

    def reset(self) -> None:
        self._buf.clear()


class PlateauDetector:
    """A lower-is-better signal (loss) that stopped improving: over a
    FULL window, the relative improvement of the newer half's median
    vs the older half's is below ``min_improve`` in magnitude (a
    worsening signal is the spike detectors' territory — it does not
    read as a plateau). Long default window: a plateau is a
    macro-scale judgment, not a per-step one."""

    def __init__(self, id: str, window: int = 256,
                 min_improve: float = 0.005, severity: str = "warn"):
        if window < 8:
            raise ValueError(f"window must be >= 8, got {window}")
        self.id = id
        self.severity = severity
        self.min_improve = float(min_improve)
        self._buf: collections.deque = collections.deque(
            maxlen=int(window))

    def observe(self, value: float) -> Optional[Dict[str, Any]]:
        if not _finite(value):
            return None
        self._buf.append(float(value))
        if len(self._buf) < self._buf.maxlen:
            return None
        vals = list(self._buf)
        half = len(vals) // 2
        old = statistics.median(vals[:half])
        new = statistics.median(vals[half:])
        improve = (old - new) / max(abs(old), 1e-12)
        if abs(improve) < self.min_improve:
            self._buf.clear()
            return {"value": new, "baseline": old,
                    "improvement": improve}
        return None

    def reset(self) -> None:
        self._buf.clear()


class NonFiniteDetector:
    """A value that should always be finite went NaN/inf — fires
    immediately (no window), critical by default."""

    def __init__(self, id: str, severity: str = "critical"):
        self.id = id
        self.severity = severity

    def observe(self, value: Any) -> Optional[Dict[str, Any]]:
        if isinstance(value, (int, float)) and not math.isfinite(value):
            return {"value": str(value)}
        return None

    def reset(self) -> None:
        pass


class RatioCollapseDetector:
    """A should-stay-positive signal (per-module update ratio)
    collapsing toward zero: over a full window, ``value < median /
    factor``. The frozen-layer signature — the explosion direction is
    :class:`MadSpikeDetector`'s job. Collapsing samples are not added
    (the baseline must keep describing healthy steps); a cooldown
    absorbs a sustained collapse into one event per window."""

    def __init__(self, id: str, window: int = 32, factor: float = 50.0,
                 floor: float = 1e-12, severity: str = "warn"):
        self.id = id
        self.severity = severity
        self.factor = float(factor)
        self.floor = float(floor)
        self._buf: collections.deque = collections.deque(
            maxlen=int(window))
        self._cool = 0

    def observe(self, value: float) -> Optional[Dict[str, Any]]:
        if not _finite(value):
            return None
        value = float(value)
        if self._cool > 0:
            self._cool -= 1
            self._buf.append(value)
            return None
        if len(self._buf) == self._buf.maxlen:
            med = statistics.median(self._buf)
            if med > self.floor and value < med / self.factor:
                self._cool = self._buf.maxlen
                return {"value": value, "baseline": med,
                        "evidence": list(self._buf)[-8:]}
        self._buf.append(value)
        return None

    def reset(self) -> None:
        self._buf.clear()
        self._cool = 0


class QueueGrowthDetector:
    """Sustained backlog growth on a deterministic clock: over a FULL
    window of queue-depth samples, net growth of at least
    ``min_growth`` with the backlog AT its window maximum (still
    growing, not draining). Fires once per window (the buffer clears),
    so a standing backlog pages once per window, not per step."""

    def __init__(self, id: str, window: int = 32, min_growth: int = 8,
                 severity: str = "warn"):
        if window < 4:
            raise ValueError(f"window must be >= 4, got {window}")
        self.id = id
        self.severity = severity
        self.min_growth = int(min_growth)
        self._buf: collections.deque = collections.deque(
            maxlen=int(window))

    def observe(self, depth: float) -> Optional[Dict[str, Any]]:
        if not _finite(depth):
            return None
        depth = float(depth)
        self._buf.append(depth)
        if len(self._buf) < self._buf.maxlen:
            return None
        vals = list(self._buf)
        if (vals[-1] - vals[0] >= self.min_growth
                and vals[-1] >= max(vals)):
            self._buf.clear()
            return {"value": vals[-1], "baseline": vals[0],
                    "evidence": vals[-8:]}
        return None

    def reset(self) -> None:
        self._buf.clear()


class AnomalyHub:
    """One run's incident brain: owns the detector set for its phase
    (``train`` or ``serve``), routes observed values, emits
    ``anomaly`` records through ``emit`` (the run's registry), and
    tracks the live state :meth:`snapshot` exports.

    Every ``observe_*`` method returns the list of anomaly records it
    fired (tests read them directly; callers may ignore the return).
    All feeds consume values the caller already has on host — the hub
    itself never touches a device.
    """

    def __init__(self, emit: Optional[Callable[..., Any]] = None,
                 window: int = 64, phase: str = "train"):
        if phase not in ("train", "serve"):
            raise ValueError(
                f"unknown anomaly phase {phase!r}; have "
                f"('train', 'serve')")
        if window < 8:
            raise ValueError(f"anomaly window must be >= 8, "
                             f"got {window}")
        self.emit = emit
        self.phase = phase
        self.window = int(window)
        self.count = 0
        self.by_detector: Dict[str, int] = {}
        self.last: Optional[Dict[str, Any]] = None
        self._cur_step = 0
        self._fired_step: Dict[str, int] = {}
        if phase == "train":
            self._loss_nonfinite = NonFiniteDetector("loss_nonfinite")
            self._loss_spike = RollingMedianSpike(
                window=max(4, window // 8), factor=4.0)
            self._loss_plateau = PlateauDetector(
                "loss_plateau", window=4 * window)
            # Time-scale detectors carry a 50 ms absolute-excess
            # floor: relative jitter on a small baseline (host
            # scheduling noise on ms-scale steps) is not an incident.
            self._step_time = MadSpikeDetector(
                "step_time_spike", window=window, abs_min=50.0)
            self._throughput = SlopeDegradationDetector(
                "throughput_slope", window=max(8, window // 4))
            self._grad_norm = MadSpikeDetector(
                "grad_norm_spike", window=window,
                severity="critical")
        else:
            self._ttft = MadSpikeDetector("ttft_spike", window=window,
                                          abs_min=50.0)
            self._decode_time = MadSpikeDetector(
                "decode_time_spike", window=window, abs_min=50.0)
            self._queue = QueueGrowthDetector(
                "queue_growth", window=max(8, window // 2))
        # Per-module health detectors, created lazily as modules
        # appear in the health records.
        self._health: Dict[str, Any] = {}

    # -- emission ---------------------------------------------------------

    def _fire(self, detector: str, severity: str, step: int,
              finding: Dict[str, Any], **extra: Any) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"detector": detector,
                               "severity": severity,
                               "step": int(step)}
        for key, val in finding.items():
            if isinstance(val, float):
                rec[key] = round(val, 6)
            elif isinstance(val, list):
                rec[key] = [round(v, 6) if isinstance(v, float) else v
                            for v in val]
            else:
                rec[key] = val
        rec.update(extra)
        self.count += 1
        self.by_detector[detector] = (
            self.by_detector.get(detector, 0) + 1)
        self.last = rec
        self._fired_step[detector] = int(step)
        if self.emit is not None:
            self.emit("anomaly", **rec)
        return rec

    def _note_step(self, step: int) -> None:
        self._cur_step = max(self._cur_step, int(step))

    # -- train feeds (Observatory.log_step / health records) --------------

    def observe_train_step(self, step: int, metrics: Dict[str, Any],
                           step_wall_ms: Optional[float] = None
                           ) -> List[Dict[str, Any]]:
        """One log-cadence sample: the fetched task metrics plus the
        cadence-derived per-step wall (None on the first log, which
        has no previous cadence to difference against)."""
        self._note_step(step)
        fired: List[Dict[str, Any]] = []
        loss = metrics.get("loss")
        if isinstance(loss, (int, float)):
            f = self._loss_nonfinite.observe(loss)
            if f is not None:
                fired.append(self._fire(
                    "loss_nonfinite", self._loss_nonfinite.severity,
                    step, f))
            else:
                med = self._loss_spike.observe(float(loss))
                if med is not None:
                    fired.append(self._fire(
                        "loss_spike", "warn", step,
                        {"value": float(loss), "baseline": med,
                         "factor": self._loss_spike.factor}))
                f = self._loss_plateau.observe(float(loss))
                if f is not None:
                    fired.append(self._fire(
                        "loss_plateau", self._loss_plateau.severity,
                        step, f))
        if step_wall_ms is not None:
            f = self._step_time.observe(step_wall_ms)
            if f is not None:
                fired.append(self._fire(
                    "step_time_spike", self._step_time.severity,
                    step, f))
        for key in ("tokens_per_sec", "images_per_sec",
                    "items_per_sec"):
            if isinstance(metrics.get(key), (int, float)):
                f = self._throughput.observe(float(metrics[key]))
                if f is not None:
                    fired.append(self._fire(
                        "throughput_slope", self._throughput.severity,
                        step, f, signal=key))
                break
        if isinstance(metrics.get("grad_norm"), (int, float)):
            f = self._grad_norm.observe(float(metrics["grad_norm"]))
            if f is not None:
                fired.append(self._fire(
                    "grad_norm_spike", self._grad_norm.severity,
                    step, f))
        return fired

    def observe_health(self, step: int, module: str,
                       fields: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One per-module health record (observe/health.py): grad-norm
        explosion and update-ratio collapse, per module."""
        self._note_step(step)
        fired: List[Dict[str, Any]] = []
        dets = self._health.get(module)
        if dets is None:
            dets = self._health[module] = {
                "grad": MadSpikeDetector(
                    f"grad_norm_spike/{module}", window=self.window,
                    severity="critical"),
                "ratio": RatioCollapseDetector(
                    f"update_ratio_collapse/{module}",
                    window=max(8, self.window // 2)),
            }
        if isinstance(fields.get("grad_norm"), (int, float)):
            f = dets["grad"].observe(float(fields["grad_norm"]))
            if f is not None:
                fired.append(self._fire(
                    dets["grad"].id, dets["grad"].severity, step, f,
                    module=module))
        if isinstance(fields.get("update_ratio"), (int, float)):
            f = dets["ratio"].observe(float(fields["update_ratio"]))
            if f is not None:
                fired.append(self._fire(
                    dets["ratio"].id, dets["ratio"].severity, step, f,
                    module=module))
        return fired

    # -- serve feeds (scheduler, on the decode-step clock) ----------------

    def observe_decode_step(self, step: int,
                            queue_depth: Optional[int] = None,
                            step_wall_ms: Optional[float] = None
                            ) -> List[Dict[str, Any]]:
        """One decode step: the dispatch wall (decode-stall detection)
        and the queue depth (sustained-backlog detection)."""
        self._note_step(step)
        fired: List[Dict[str, Any]] = []
        if step_wall_ms is not None:
            f = self._decode_time.observe(step_wall_ms)
            if f is not None:
                fired.append(self._fire(
                    "decode_time_spike", self._decode_time.severity,
                    step, f))
        if queue_depth is not None:
            f = self._queue.observe(queue_depth)
            if f is not None:
                fired.append(self._fire(
                    "queue_growth", self._queue.severity, step, f))
        return fired

    def observe_completion(self, step: int, ttft_ms: float
                           ) -> List[Dict[str, Any]]:
        """One completed request's TTFT, on the decode-step clock."""
        self._note_step(step)
        f = self._ttft.observe(ttft_ms)
        if f is not None:
            return [self._fire("ttft_spike", self._ttft.severity,
                               step, f)]
        return []

    def note_slot_nonfinite(self, step: int, slot: Optional[int] = None,
                            rid: Optional[int] = None
                            ) -> List[Dict[str, Any]]:
        """The engine's per-slot finiteness flag tripped (the value is
        already on host — the scheduler quarantines on it); surface it
        as a critical anomaly immediately."""
        self._note_step(step)
        extra: Dict[str, Any] = {}
        if slot is not None:
            extra["slot"] = int(slot)
        if rid is not None:
            extra["rid"] = int(rid)
        return [self._fire("slot_nonfinite", "critical", step, {},
                           **extra)]

    # -- read side --------------------------------------------------------

    def active(self) -> List[str]:
        """Detectors that fired within the last ``window`` steps of
        the hub's clock — the "is something wrong RIGHT NOW" set."""
        return sorted(
            det for det, at in self._fired_step.items()
            if self._cur_step - at <= self.window)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able incident state for ``metrics_snapshot()`` / the
        ``--observe.export-path`` payload: total count, per-detector
        counts, currently-active detectors, and the last anomaly."""
        out: Dict[str, Any] = {
            "anomalies": self.count,
            "active": self.active(),
            "by_detector": dict(sorted(self.by_detector.items())),
        }
        if self.last is not None:
            out["last"] = {k: self.last[k] for k in
                           ("detector", "severity", "step")
                           if k in self.last}
            if "value" in self.last:
                out["last"]["value"] = self.last["value"]
        return out

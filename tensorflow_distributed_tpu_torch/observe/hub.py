"""The serve observatory: the port of ``observe/hub.py``'s
``ServeObservatory``, one object wiring the serve-side instruments into
a ``--mode serve`` run.

The training ``Observatory``, the flight recorder, the autopilot and the
compiled-program registry are not ported yet (ROADMAP.md A8):
``config.py`` refuses their flags.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from tensorflow_distributed_tpu_torch.observe import registry as registry_mod
from tensorflow_distributed_tpu_torch.observe.anomaly import AnomalyHub
from tensorflow_distributed_tpu_torch.observe.registry import (
    JsonlSink, MetricsRegistry)
from tensorflow_distributed_tpu_torch.observe.serve_trace import ServeTracer
from tensorflow_distributed_tpu_torch.observe.slo import (
    SLOMonitor, parse_slo, parse_windows)


class ServeObservatory:
    """mode=serve's observability bundle: the metrics registry (JSONL
    sink, appended on a journal resume), the per-request
    :class:`~.serve_trace.ServeTracer` (resumed too: one trace file spans
    a supervised restart), the :class:`~.slo.SLOMonitor` built from
    ``--observe.slo``, the anomaly hub of ``--observe.anomaly`` and the
    rolling-snapshot export knobs: everything serve/run.py hands the
    scheduler. Installs its registry as the process's active one (library
    events such as injected faults land in the run's JSONL) and removes
    it in :meth:`close`."""

    def __init__(self, ocfg, *, chief: bool = True,
                 tags: Optional[Dict[str, Any]] = None,
                 process_index: int = 0, resumed: bool = False):
        sinks = []
        if ocfg.metrics_jsonl:
            # A journal-resumed leg appends: the dead leg's records are
            # part of the same serving story.
            sinks.append(JsonlSink(ocfg.metrics_jsonl, append=resumed))
        self.registry = MetricsRegistry(
            sinks, enabled=chief, tags=tags or {},
            max_records=ocfg.max_records)
        # Online anomaly detection on the decode-step clock: the
        # scheduler feeds the TTFT, decode-wall and queue-depth values it
        # holds on the host; the live incident state rides
        # metrics_snapshot() for the export-path pollers.
        self.anomalies = None
        if ocfg.anomaly:
            self.anomalies = AnomalyHub(emit=self.registry.emit,
                                        window=ocfg.anomaly_window,
                                        phase="serve")
        self.tracer = None
        if ocfg.trace:
            self.tracer = ServeTracer(ocfg.trace, enabled=chief,
                                      pid=process_index, resume=resumed,
                                      durable=ocfg.trace_durable)
        self.slo_monitor = None
        self.status_every = 0
        fast, slow = parse_windows(ocfg.slo_windows)
        if ocfg.slo:
            self.slo_monitor = SLOMonitor(
                parse_slo(ocfg.slo), fast_window=fast, slow_window=slow,
                burn_threshold=ocfg.slo_burn, emit=self.registry.emit,
                tracer=self.tracer)
            # The live status line defaults to the fast window's cadence
            # when the monitor is armed.
            self.status_every = ocfg.slo_status_every or fast
        elif ocfg.slo_status_every:
            self.status_every = ocfg.slo_status_every
        self.export_every = ocfg.export_every
        self.export_path = ocfg.export_path
        registry_mod.set_active(self.registry)

    def scheduler_kwargs(self) -> Dict[str, Any]:
        """The scheduler-facing slice of this bundle (serve/run.py
        splats it into the Scheduler)."""
        return {
            "registry": self.registry, "tracer": self.tracer,
            "slo_monitor": self.slo_monitor,
            "anomaly_hub": self.anomalies,
            "export_every": self.export_every,
            "export_path": self.export_path,
            "status_every": self.status_every,
        }

    def close(self) -> None:
        if registry_mod.get_active() is self.registry:
            registry_mod.set_active(None)
        if self.tracer is not None:
            self.tracer.close()
        self.registry.close()

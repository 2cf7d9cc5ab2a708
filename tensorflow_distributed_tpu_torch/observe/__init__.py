"""The port's observe layer: the serve observatory (ROADMAP.md A8 holds
the rest of the JAX package's ``observe/``).

- :mod:`.registry`: ``MetricsRegistry`` and its sinks (JSONL, stdout,
  CSV), record tags, the process's active registry;
- :mod:`.slo`: the ``--observe.slo`` grammar and the multi-window
  burn-rate ``SLOMonitor``;
- :mod:`.trace` / :mod:`.serve_trace`: the Chrome-trace writer and the
  per-request serve span trees;
- :mod:`.anomaly`: the streaming detectors and their ``AnomalyHub``;
- :mod:`.hub`: ``ServeObservatory``, the bundle ``--mode serve`` builds.

Pure stdlib; nothing here imports torch at module level.
"""

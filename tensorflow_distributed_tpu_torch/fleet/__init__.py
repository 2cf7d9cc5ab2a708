"""Fleet serving, the port of the JAX package's ``fleet/``: a
health-aware router and a lifecycle controller over N replica processes
of the port's ``--mode serve``.

- :mod:`.replica`: the per-replica contract: the append-only JSONL inbox
  a replica tails for requests and control commands (``--serve.inbox``),
  the per-epoch workspace, and the handle the router and controller read
  snapshots and journals through.
- :mod:`.router`: SLO-class-aware dispatch driven by each replica's
  ``--observe.export-path`` snapshot; a replica with an active anomaly or
  a stale snapshot is quarantined and its in-flight requests re-dispatched
  as continuations (token-identical by greedy determinism); timeouts
  with capped backoff, a retry budget, lowest-class shedding.
- :mod:`.controller`: spawn and restart with the supervisor's leg
  semantics and capped backoff (each restart on a fresh epoch),
  drain-before-stop, and rolling weight swaps one replica at a time as
  new checkpoints land, with model staleness tracked.
- :mod:`.run`: the front-end gluing them (``python -m
  tensorflow_distributed_tpu_torch.fleet.run``).

Host-side policy only (stdlib + numpy); nothing here imports torch at
module level.
"""

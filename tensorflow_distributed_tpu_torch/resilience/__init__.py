"""Fault tolerance of the PyTorch port, the JAX package's
``resilience/``: :mod:`faults` (the fault-plan grammar and the injection
points of training and serving), :mod:`policies` (what a non-finite loss
or a loss spike does: halt, skip, rewind) and :mod:`watchdog` (the
next-batch, device-sync and decode deadlines) and :mod:`supervisor`
(restarts with backoff; ``--elastic`` onto the surviving cards' mesh)."""

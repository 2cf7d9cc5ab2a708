"""Fault tolerance of the PyTorch port, the serve phase of the JAX
package's ``resilience/``: :mod:`faults` (the fault-plan grammar and the
serve phase's injection points) and :mod:`watchdog` (the decode
watchdog). The train loop's policies, watchdogs and supervisor are not
ported yet (ROADMAP.md A8)."""

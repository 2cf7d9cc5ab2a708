"""Continuous-batching inference of the PyTorch port (``--mode serve``):
the bucket ladder, the slot engine, the FIFO scheduler and ``run.py``,
which serves a workload end to end."""

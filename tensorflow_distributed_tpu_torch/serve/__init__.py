"""Continuous-batching inference of the PyTorch port (``--mode serve``):
the bucket ladder, the slot engine, the FIFO and SLO scheduler (with the
serve observatory's hooks and the fleet intake) and ``run.py``, which
serves a workload, or a fleet replica's inbox, end to end."""

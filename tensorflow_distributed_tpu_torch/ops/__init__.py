"""Ops of the PyTorch port: losses and the flash-attention kernels."""

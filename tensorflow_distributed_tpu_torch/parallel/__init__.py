"""Attention building blocks of the PyTorch port (single device)."""

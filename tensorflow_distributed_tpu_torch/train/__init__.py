"""Training machinery of the PyTorch port: optimizer, state, steps,
tasks and the loop."""

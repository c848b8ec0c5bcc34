"""Training utilities of the port: the optimizer and checkpoints."""

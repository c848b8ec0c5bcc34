"""Training utilities of the port: the optimizer."""

"""Benchmarks of the port, the counterparts of the repo's ``benchmarks/``."""

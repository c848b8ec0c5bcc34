"""Synthetic token batches for the LM stack."""

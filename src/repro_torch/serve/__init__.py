"""Serving: prefill plus batched greedy decode."""

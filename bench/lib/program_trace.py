"""What the program's own spans and counters (``repro_torch.trace``)
give the per-layer readers: a snapshot taken when the run's metrics are
read, and the numbers of it. Each gives None where the snapshot holds
nothing, as it does for a program without that module."""
from __future__ import annotations

from typing import Optional


def snapshot() -> Optional[dict]:
    """``repro_torch.trace.snapshot()``, or None for a program that has no
    spans of its own."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.snapshot()


def kernel_load_s(snap: Optional[dict]) -> Optional[float]:
    """Seconds of the first ``kernels.load``: the kernel library's build
    (a checkout's first run) or its rebuild check and load."""
    return (snap or {}).get("first", {}).get("kernels.load")


def first_update_s(snap: Optional[dict]) -> Optional[float]:
    """Seconds of the first ``arch.update`` less the first spans timed
    inside it (the kernel library's load, made at the first kernel
    call)."""
    return (snap or {}).get("first_self", {}).get("arch.update")


def forwards_per_update(snap: Optional[dict]) -> Optional[float]:
    """Tower forwards (``model.backbone_forwards``) an arch update
    (``arch.updates``)."""
    counters = (snap or {}).get("counters", {})
    updates = counters.get("arch.updates")
    if not updates:
        return None
    return counters.get("model.backbone_forwards", 0) / updates

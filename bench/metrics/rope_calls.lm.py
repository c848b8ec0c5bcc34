"""Rotary-embedding kernel calls an arch update: the program's launch
counts ``rope`` and ``rope_bwd`` over its counter ``arch.updates``, both
from ``repro_torch.trace.snapshot()``. None where the program launched no
rope kernel (a program without it, or the CPU's plain version) or counted
no update."""
from bench.lib import program_trace


def read(ctx):
    snap = program_trace.snapshot() or {}
    launches = snap.get("launches", {})
    calls = launches.get("rope", 0) + launches.get("rope_bwd", 0)
    updates = snap.get("counters", {}).get("arch.updates")
    if not calls or not updates:
        return None
    return calls / updates

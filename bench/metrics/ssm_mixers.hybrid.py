"""Mamba-2 mixer calls an arch update, recomputes included: the
program's counters ``model.ssm_mixers`` over ``arch.updates``, from
``repro_torch.trace.snapshot()``. None where the program counts no
mixer or no update (a program without the counter)."""
from bench.lib import program_trace


def read(ctx):
    counters = (program_trace.snapshot() or {}).get("counters", {})
    mixers, updates = counters.get("model.ssm_mixers"), \
        counters.get("arch.updates")
    if not mixers or not updates:
        return None
    return mixers / updates

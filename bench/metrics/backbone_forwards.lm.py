"""Tower forwards an arch update: the program's counters
``model.backbone_forwards`` over ``arch.updates``."""
from bench.lib import program_trace


def read(ctx):
    return program_trace.forwards_per_update(program_trace.snapshot())

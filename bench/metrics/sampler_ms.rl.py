"""Device ms a round launched under sampler_chunk (env steps, the actor,
n-step)."""
from bench.lib.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["sampler_chunk"], "rounds")

"""Device ms an update launched under the two Adam steps (opt.update)."""
from bench.lib.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["adam"], "updates")

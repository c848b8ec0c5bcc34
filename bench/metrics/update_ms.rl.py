"""Device ms an update launched under update_round (the gather or PER's
draw, the SAC update, Adam, polyak)."""
from bench.lib.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["update_round"], "updates")

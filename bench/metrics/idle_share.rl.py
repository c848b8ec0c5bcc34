"""The device's idle share of the window, in % (lib/readers.idle_share)."""
from bench.lib.readers import idle_share


def read(ctx):
    return idle_share(ctx)

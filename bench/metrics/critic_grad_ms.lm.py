"""Device ms an update launched under the critic loss and its tower_grads."""
from bench.lib.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["critic_loss", "critic_grad"], "updates")

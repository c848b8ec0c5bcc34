"""Device ms an update launched under the actor loss and its tower_grads."""
from bench.lib.readers import span_ms


def read(ctx):
    return span_ms(ctx, ["actor_loss", "actor_grad"], "updates")

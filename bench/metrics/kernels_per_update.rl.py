"""Device ops an update launched under update_round."""


def read(ctx):
    return (None if ctx.trace is None or ctx.trace.span("update_round") is None
            or not ctx.trace.span("update_round").device_ops
            else ctx.trace.span("update_round").device_ops
            / ctx.traced["updates"])

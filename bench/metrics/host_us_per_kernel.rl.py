"""Host microseconds inside megastep() calls over the device ops they
launched (the traced megasteps)."""


def read(ctx):
    return (None if ctx.trace is None or ctx.trace.span("megastep") is None
            or not ctx.trace.span("megastep").device_ops
            else 1e6 * ctx.trace.span("megastep").host_s
            / ctx.trace.span("megastep").device_ops)

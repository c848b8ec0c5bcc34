"""Seconds from the process's start to the first timed step: building the
program's objects and inputs, loading the kernels from the build cache
(building them in a checkout's first run), warming every shape the
window uses, the checked first steps."""


def read(ctx):
    return ctx.setup_s

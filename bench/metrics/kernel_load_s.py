"""Seconds of set-up in the kernel library's load: the program's set-up
span ``kernels.load`` (its build in a checkout's first run)."""
from bench.lib import program_trace


def read(ctx):
    return program_trace.kernel_load_s(program_trace.snapshot())

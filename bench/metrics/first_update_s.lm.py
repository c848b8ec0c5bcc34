"""Seconds of set-up in the first arch update, less the kernel library's
load inside it: the program's set-up span ``arch.update``'s self time
(lazy module loading, cuBLAS's handles, the allocator growing)."""
from bench.lib import program_trace


def read(ctx):
    return program_trace.first_update_s(program_trace.snapshot())

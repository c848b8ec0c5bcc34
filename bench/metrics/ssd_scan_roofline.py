"""The least time of the traced SSD scan calls (bench/work/kernel_work,
bench/work/peaks) over the device time launched under them, in %."""
from bench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, "ssd_scan")

"""11 backbone forward units an update (5 towers' forwards, the 3
differentiated towers' backwards at 2 each; recompute not counted) in
the window, over its wall and the bf16 peak (989 TFLOP/s), in %."""
from bench.lib.readers import mfu
from bench.work.peaks import PEAK_FLOPS_BF16


def read(ctx):
    return mfu(ctx, PEAK_FLOPS_BF16)

"""The SAC update's and the sampler's matrix-product FLOPs
(bench/work/model_flops) in the window, over its wall and the float32
peak (67 TFLOP/s: the port turns TF32 off), in %."""
from bench.lib.readers import mfu
from bench.work.peaks import PEAK_FLOPS_F32


def read(ctx):
    return mfu(ctx, PEAK_FLOPS_F32)

"""Device ms an update in cuBLAS matrix-product kernels, by kernel name."""
from bench.lib.readers import gemm_ms


def read(ctx):
    return gemm_ms(ctx, "updates")

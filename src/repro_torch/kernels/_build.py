"""Builds the CUDA sources in ``csrc/`` at first use.

Takes the place of ``repro/kernels/_compat.py``: there the question was
whether Pallas compiles to Mosaic or runs in the interpreter; here it is
how the hand-written Hopper kernels get compiled and loaded. Nothing is
built at import, so the CPU tests import every module without ``nvcc``.

``torch.utils.cpp_extension.load`` compiles ``binding.cpp`` (the only
source with PyTorch headers, and only ``torch/library.h``) and the
kernels' ``.cu`` files (which include none) for ``sm_90a``, one ``nvcc``
per source run in parallel by ninja, into
``build/repro_torch_kernels/`` at the repository root, and loads the
library, which registers ``torch.ops.repro_torch.*``. A second call in
the same process reuses the loaded library; a second process reuses the
build if the sources are unchanged.
"""
import functools
import os

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.abspath(os.path.join(CSRC, *[os.pardir] * 4))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "repro_torch_kernels")
SOURCES = ("binding.cpp", "ring_ops.cu", "per_ops.cu", "rmsnorm.cu",
           "flash_attention.cu", "decode_attention.cu", "ssd_scan.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")


@functools.lru_cache(maxsize=None)
def load_kernels() -> str:
    """Compile (if needed) and load the kernel library; returns its path."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)     # load() does not create it
    return load(name="repro_torch_kernels",
                sources=[os.path.join(CSRC, s) for s in SOURCES],
                build_directory=BUILD_DIR,
                extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                is_python_module=False,
                verbose=False)

"""The SSD scan's plain version against the JAX package: ``ssd_scan_ref``
(what the port runs on a CPU tensor, and what ``chip_smoke.py`` holds the
CUDA kernel against on the card) against the JAX Pallas ``ssd_scan`` in
interpret mode and against the O(S^2) oracle ``repro/kernels/ref.py:
ssd_ref``, on the same numpy inputs made from a seed; and the wrapper's
rules (the chunk, mismatched shapes, CPU operands refused; the kernel's
own limits are held on the card, ``tests/test_torch_cuda.py``).

Shapes: ``tests/test_kernels.py``'s four sweep shapes, and one ragged
single chunk (S = L = 100, not a multiple of the kernel's 64-row tiles).

Tolerances: float32, 2e-4 absolute, as ``test_kernels.py`` holds the
Pallas kernel to the oracle (the products are summed in other orders and
the decays exponentiated from cumulative sums taken in other orders).
bfloat16 inputs: both sides compute in float32 from the same rounded
inputs and round y and the state once, so one bf16 rounding step (2**-7
relative) plus the same float32 allowance.
"""
import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import LAUNCH_COUNTS
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as tssd

torch.set_num_threads(2)

ATOL = 2e-4
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}

# (B, S, H, P, N, chunk)
SHAPES = [
    (2, 128, 4, 32, 16, 32),
    (1, 64, 2, 16, 8, 16),
    (2, 96, 3, 8, 32, 32),
    (1, 256, 2, 64, 64, 64),     # mamba2-like dims
    (1, 100, 2, 64, 32, 256),    # one ragged chunk: L = min(256, 100)
]


def scan_inputs(seed, B, S, H, P, N, dtype="float32"):
    """x, B_, C_ ~ 0.5 N(0, 1) in ``dtype``; dtA = -0.3 softplus(N(0, 1))
    in float32 (the decays of test_kernels.py's sweep)."""
    rng = np.random.default_rng(seed)
    np_dt = DTYPES[dtype]
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dtA = (-np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
           * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, H, N)) * 0.5).astype(np.float32)
    return x.astype(np_dt), dtA, Bm.astype(np_dt), Cm.astype(np_dt)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(got, want, dtype):
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=rtol,
                               atol=ATOL)


@functools.lru_cache(maxsize=None)
def _jax_scan(chunk):
    return jax.jit(functools.partial(jax_ssd_scan, chunk=chunk))


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_oracle(B, S, H, P, N, chunk,
                                                  dtype):
    x, dtA, Bm, Cm = scan_inputs(S * H, B, S, H, P, N, dtype)
    y, fin = tssd.ssd_scan_ref(*map(to_torch, (x, dtA, Bm, Cm)),
                               chunk=chunk)
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert y.dtype == fin.dtype == want_dt
    assert y.shape == (B, S, H, P) and fin.shape == (B, H, P, N)
    assert y.is_contiguous() and fin.is_contiguous()
    jy, jfin = _jax_scan(chunk)(x, dtA, Bm, Cm)      # interpret mode
    assert_close(y, jy, dtype)
    assert_close(fin, jfin, dtype)
    oy, ofin = jref.ssd_ref(x, dtA, Bm, Cm)
    assert_close(y, oy, dtype)
    assert_close(fin, ofin, dtype)
    # kernels.ops sends a CPU tensor to the plain version
    oy2, ofin2 = kops.ssd_scan(*map(to_torch, (x, dtA, Bm, Cm)), chunk=chunk)
    assert torch.equal(oy2, y) and torch.equal(ofin2, fin)


def test_ssd_scan_plain_chunks_do_not_change_the_result():
    """One chunk of 96 and three of 32 compute the same scan."""
    x, dtA, Bm, Cm = map(to_torch, scan_inputs(3, 2, 96, 3, 16, 8))
    y1, f1 = tssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=96)
    y3, f3 = tssd.ssd_scan_ref(x, dtA, Bm, Cm, chunk=32)
    torch.testing.assert_close(y1, y3, rtol=0, atol=ATOL)
    torch.testing.assert_close(f1, f3, rtol=0, atol=ATOL)


@pytest.mark.parametrize("S,chunk", [(300, 256), (100, 64), (96, 0)])
def test_ssd_scan_refuses_a_chunk_that_does_not_divide_s(S, chunk):
    """The reference asserts S % min(chunk, S) == 0 on both of its paths;
    the port raises a ValueError naming the rule, on the CPU and before
    any launch on the card."""
    x, dtA, Bm, Cm = map(to_torch, scan_inputs(4, 1, S, 1, 8, 8))
    for fn in (tssd.ssd_scan_ref, tssd.ssd_scan):
        with pytest.raises(ValueError, match="must divide"):
            fn(x, dtA, Bm, Cm, chunk=chunk)


def test_ssd_scan_wrapper_refuses_cpu_tensors_and_mismatched_shapes():
    LAUNCH_COUNTS.clear()
    x, dtA, Bm, Cm = map(to_torch, scan_inputs(5, 1, 64, 2, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(x, dtA, Bm, Cm, chunk=64)
    for fn in (tssd.ssd_scan_ref, tssd.ssd_scan):
        with pytest.raises(ValueError, match="dtA must be"):
            fn(x, dtA[:, :-1], Bm, Cm, chunk=64)
        with pytest.raises(ValueError, match="must be"):
            fn(x, dtA, Bm, Cm[..., :-1], chunk=64)
    assert sum(LAUNCH_COUNTS.values()) == 0

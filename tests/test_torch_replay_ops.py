"""The port's replay-ring ops against the JAX package's: ``ring_write`` /
``ring_gather`` in Pallas interpret mode and their jnp ``*_ref`` oracles.
Both sides only copy rows, so every comparison is bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import n, t

from repro.kernels import replay_ops as jops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import replay_ops as rops

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_counts():
    rops.reset_launch_counts()
    yield
    # the CPU path never reaches a kernel
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def _jax_write(data, batch, ptr, **kw):
    """(interpret-mode Pallas kernel, jnp oracle) on the same inputs."""
    d, b = jnp.asarray(data), jnp.asarray(batch)
    p = jnp.asarray(ptr, jnp.int32)
    return (np.asarray(jops.ring_write(d, b, p, interpret=True, **kw)),
            np.asarray(jops.ring_write_ref(d, b, p, **kw)))


@pytest.mark.parametrize("cap,nrows,ptr,row", [
    (16, 5, 3, (3,)),     # plain append
    (13, 8, 9, (3,)),     # wraps at the ring end mid-batch
    (13, 13, 12, ()),     # full-capacity write, wraps, scalar rows
    (40, 32, 30, (1,)),   # one round of the small trainer, wrapping
])
def test_ring_write_matches_jax(cap, nrows, ptr, row):
    rng = np.random.default_rng(cap * 100 + ptr)
    data = rng.standard_normal((cap,) + row).astype(np.float32)
    batch = rng.standard_normal((nrows,) + row).astype(np.float32)
    want_kernel, want_ref = _jax_write(data, batch, ptr)
    got = n(kops.ring_write(t(data), t(batch), t(np.int32(ptr))))
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)


@pytest.mark.parametrize("lo", [0, 8, 16, 24])
def test_ring_write_partial_window(lo):
    """A 32-slot ring split into windows of 8: each keeps exactly the
    rows of a wrapping write that land in its slots."""
    rng = np.random.default_rng(lo)
    cap, nrows, ptr = 32, 12, 28
    data = rng.standard_normal((8, 3)).astype(np.float32)
    batch = rng.standard_normal((nrows, 3)).astype(np.float32)
    want_kernel, want_ref = _jax_write(data, batch, ptr, capacity=cap,
                                       window_start=lo)
    got = n(kops.ring_write(t(data), t(batch), t(np.int32(ptr)),
                            capacity=cap, window_start=lo))
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)


def test_ring_write_over_capacity_raises():
    data, batch = torch.zeros(4, 2), torch.zeros(5, 2)
    ptr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        kops.ring_write(data, batch, ptr)
    with pytest.raises(ValueError, match="capacity"):
        jops.ring_write(jnp.zeros((4, 2)), jnp.zeros((5, 2)), 0,
                        interpret=True)


def test_ring_write_dtype_mismatch_raises():
    with pytest.raises(TypeError):
        kops.ring_write(torch.zeros(4, 2), torch.zeros(2, 2,
                                                       dtype=torch.float64),
                        torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("lo,rows", [(0, 37), (10, 16)])
@pytest.mark.parametrize("row", [(), (3,)])
def test_ring_gather_matches_jax(lo, rows, row):
    """In-window, out-of-window and -1 padding indices; out-of-window
    rows come back as zeros."""
    rng = np.random.default_rng(rows + lo)
    data = rng.standard_normal((rows,) + row).astype(np.float32)
    idx = np.concatenate([
        rng.integers(lo, lo + rows, 50),          # inside the window
        rng.integers(0, lo + 2 * rows, 20),       # some outside it
        [-1, -1, lo - 1, lo + rows]]).astype(np.int32)
    want_kernel = np.asarray(jops.ring_gather(
        jnp.asarray(data), jnp.asarray(idx), window_start=lo,
        interpret=True))
    want_ref = np.asarray(jops.ring_gather_ref(
        jnp.asarray(data), jnp.asarray(idx), window_start=lo))
    got = n(kops.ring_gather(t(data), t(idx), window_start=lo))
    assert got.shape == (len(idx),) + row
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)
    assert not got[-4:].any()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch CUDA kernels only: a CPU operand is
    refused before anything is built or launched."""
    data = torch.zeros(8, 3)
    ptr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_write(data, torch.zeros(2, 3), ptr)
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_gather(data, torch.zeros(4, dtype=torch.int32))

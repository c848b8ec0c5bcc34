"""The port's PER kernels' plain versions against the JAX package's:
``per_topk`` and ``priority_scatter`` in Pallas interpret mode and their
jnp ``*_ref`` oracles. (On a CUDA tensor the wrappers launch the CUDA
kernels; ``tests/test_torch_cuda.py`` holds those against these plain
versions on the card.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import n, t

from repro.kernels import replay_ops as jops
from repro_torch.kernels import ops as kops
from repro_torch.kernels import replay_ops as rops

torch.set_num_threads(2)

ALPHA = 0.6


@pytest.fixture(autouse=True)
def _fresh_counts():
    rops.reset_launch_counts()
    yield
    # the CPU path never reaches a kernel
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


def _pool(rows, live, seed, zeros=False):
    """Priorities of a pool whose first ``live`` rows are written (some
    zeroed when ``zeros``) and a Gumbel field, as the trainer draws it."""
    rng = np.random.default_rng(seed)
    pri = np.zeros(rows, np.float32)
    pri[:live] = rng.uniform(1e-3, 5.0, live)
    if zeros:
        pri[rng.random(rows) < 0.25] = 0.0
    u = rng.uniform(1e-12, 1.0, rows).astype(np.float32)
    return pri, (-np.log(-np.log(u))).astype(np.float32)


def _jax_topk(pri, g, k, **kw):
    """(interpret-mode Pallas kernel, jnp oracle) on the same inputs."""
    p, gg = jnp.asarray(pri), jnp.asarray(g)
    ks, ki = jops.per_topk(p, gg, ALPHA, k, interpret=True, **kw)
    lo = kw.get("window_start", 0)
    rs, ri = jops.per_topk_ref(p, gg, ALPHA, k, window_start=lo)
    return (np.asarray(ks), np.asarray(ki)), (np.asarray(rs),
                                              np.asarray(ri))


def _assert_scores_close(got, want, pri):
    """Scores ``alpha * log(p) + g`` whose only difference is the log:
    XLA's and PyTorch's CPU ``log`` differ by 1 ulp on about a tenth of
    the inputs, the product with alpha rounds that to at most 2 ulps of
    ``alpha * log(p)``, and the sum rounds once more (half an ulp of the
    score). Where the two terms nearly cancel that is many ulps of the
    score itself, so the bound is taken on the terms."""
    logp = np.abs(ALPHA * np.log(pri.astype(np.float64)))
    bound = 2 * np.spacing(logp.astype(np.float32)) + np.spacing(
        np.abs(want))
    assert (np.abs(got - want) <= bound).all(), np.max(
        np.abs(got - want) / bound)


def _check_topk(got, kernel, ref, pri, lo=0):
    """Indices equal the Pallas kernel's everywhere (both carry the
    sentinel on -inf slots) and the oracle's where the score is finite;
    scores as ``_assert_scores_close`` says."""
    gs, gi = n(got[0]), n(got[1])
    assert gi.dtype == np.int32 and gs.dtype == np.float32
    np.testing.assert_array_equal(gi, kernel[1])
    fin = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isneginf(gs), ~fin)
    np.testing.assert_array_equal(gi[fin], ref[1][fin])
    assert (gi[~fin] == rops.IDX_SENTINEL).all()
    drawn = pri[gi[fin] - lo]
    _assert_scores_close(gs[fin], ref[0][fin], drawn)
    _assert_scores_close(gs[fin], kernel[0][fin], drawn)


@pytest.mark.parametrize("rows", [256, 1000, 4096])
@pytest.mark.parametrize("k", [1, 64, "rows"])
@pytest.mark.parametrize("pool", ["full", "partial", "zeros"])
def test_per_topk_matches_jax(rows, k, pool):
    """A full pool, one with fewer live rows (40) than most k, and one
    with zero-priority rows mixed in."""
    k = rows if k == "rows" else k
    live = 40 if pool == "partial" else rows
    pri, g = _pool(rows, live, seed=rows + k, zeros=pool == "zeros")
    kernel, ref = _jax_topk(pri, g, k)
    got = kops.per_topk(t(pri), t(g), ALPHA, k)
    _check_topk(got, kernel, ref, pri)
    if pool == "partial" and k > live:
        assert np.isneginf(n(got[0])[live:]).all()


@pytest.mark.parametrize("lo", [0, 300, 4096])
def test_per_topk_window(lo):
    """Indices come back offset by the window's first global slot."""
    pri, g = _pool(1000, 700, seed=lo)
    kernel, ref = _jax_topk(pri, g, 800, window_start=lo)
    got = kops.per_topk(t(pri), t(g), ALPHA, 800, window_start=lo)
    _check_topk(got, kernel, ref, pri, lo)
    assert n(got[1])[:700].min() >= lo


def test_per_topk_ties_in_index_order():
    """Equal priority and equal Gumbel value at several rows, across the
    Pallas kernel's 256-row blocks: the lower row comes first."""
    pri, g = _pool(1000, 1000, seed=7)
    tied = [3, 130, 255, 256, 700, 999]
    pri[tied], g[tied] = 4.0, 14.0         # the best scores
    pri[[10, 600]], g[[10, 600]] = 2.0, 12.0   # the next best
    kernel, ref = _jax_topk(pri, g, 64, block=256)
    got = kops.per_topk(t(pri), t(g), ALPHA, 64)
    _check_topk(got, kernel, ref, pri)
    gi = n(got[1])
    np.testing.assert_array_equal(gi[:len(tied)], tied)
    np.testing.assert_array_equal(gi[len(tied):len(tied) + 2], [10, 600])


def test_per_topk_k_above_rows_raises():
    pri, g = _pool(16, 16, seed=0)
    with pytest.raises(ValueError, match="k=17"):
        kops.per_topk(t(pri), t(g), ALPHA, 17)
    with pytest.raises(ValueError, match="k=17"):
        rops.per_topk(t(pri), t(g), ALPHA, 17)
    with pytest.raises(ValueError, match="k=17"):
        jops.per_topk(jnp.asarray(pri), jnp.asarray(g), ALPHA, 17,
                      interpret=True)


def test_per_scores_match_jax():
    pri, g = _pool(512, 400, seed=3, zeros=True)
    want = np.asarray(jops.per_scores_ref(jnp.asarray(pri), jnp.asarray(g),
                                          ALPHA))
    got = n(rops.per_scores_ref(t(pri), t(g), ALPHA))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _assert_scores_close(got[fin], want[fin], pri[fin])


def _sequential_scatter(pri, idx, vals, lo):
    out = pri.copy()
    for i, v in zip(idx, vals):
        if 0 <= i - lo < len(out):
            out[i - lo] = v
    return out


@pytest.mark.parametrize("lo", [0, 16])
def test_priority_scatter_matches_sequential(lo):
    """Repeated indices (the last write wins, as in the Pallas kernel's
    sequential loop) and out-of-window indices (skipped)."""
    rng = np.random.default_rng(lo)
    rows = 48
    pri = rng.uniform(0.1, 2.0, rows).astype(np.float32)
    idx = np.concatenate([
        rng.integers(lo, lo + rows, 40),            # many repeats
        [lo + 5, lo + 5, lo + 5, lo - 1, lo + rows, -1, 2**31 - 1],
        rng.integers(lo, lo + rows, 13)]).astype(np.int32)
    vals = rng.uniform(0.0, 9.0, len(idx)).astype(np.float32)
    want = _sequential_scatter(pri, idx, vals, lo)
    kernel = np.asarray(jops.priority_scatter(
        jnp.asarray(pri), jnp.asarray(idx), jnp.asarray(vals),
        window_start=lo, interpret=True))
    np.testing.assert_array_equal(kernel, want)
    p = t(pri)
    got = kops.priority_scatter(p, t(idx), t(vals), window_start=lo)
    assert got is p                                  # in place
    np.testing.assert_array_equal(n(got), want)


def test_priority_scatter_unique_matches_jax_ref():
    """Without repeats the jnp oracle is defined too."""
    rng = np.random.default_rng(1)
    pri = rng.uniform(0.1, 2.0, 64).astype(np.float32)
    idx = rng.permutation(64)[:30].astype(np.int32)
    vals = rng.uniform(0.0, 9.0, 30).astype(np.float32)
    want = np.asarray(jops.priority_scatter_ref(
        jnp.asarray(pri), jnp.asarray(idx), jnp.asarray(vals)))
    np.testing.assert_array_equal(
        n(kops.priority_scatter(t(pri), t(idx), t(vals))), want)


def test_per_kernel_wrappers_refuse_cpu_tensors():
    pri, g = _pool(32, 32, seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        rops.per_topk(t(pri), t(g), ALPHA, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rops.priority_scatter(t(pri), torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4))

"""The bench-baseline kernels' plain versions against the JAX package's:
``per_scores``, ``ring_write_rowloop`` and ``ring_gather_rowloop`` in
Pallas interpret mode (under ``jax.jit``) and their jnp oracles, plus
``merge_topk_candidates``; and the port's replay-kernel bench on the
CPU. (On a CUDA tensor the wrappers launch the CUDA kernels;
``tests/test_torch_cuda.py`` holds those against these plain versions
on the card.)"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import n, t
from test_torch_per_ops import ALPHA, _assert_scores_close

from repro.kernels import replay_ops as jops
from repro_torch.benchmarks import replay_kernels as bench
from repro_torch.kernels import ops as kops
from repro_torch.kernels import replay_ops as rops

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_counts():
    rops.reset_launch_counts()
    yield
    # the CPU path never reaches a kernel
    assert sum(rops.LAUNCH_COUNTS.values()) == 0


@pytest.mark.parametrize("rows", [1, 100, 1000, 1300])
def test_per_scores_matches_jax(rows):
    """Rows that are not a multiple of the kernel's 128-lane blocks (the
    Pallas side pads its tail), zeros (-inf) and p = 1e-13 (below the
    1e-12 floor)."""
    rng = np.random.default_rng(rows)
    pri = rng.uniform(1e-3, 5.0, rows).astype(np.float32)
    pri[rng.random(rows) < 0.3] = 0.0
    pri[::7] = 1e-13
    g = (-np.log(-np.log(rng.uniform(1e-12, 1.0, rows)))).astype(np.float32)
    kernel = np.asarray(jax.jit(functools.partial(
        jops.per_scores, alpha=ALPHA, interpret=True))(jnp.asarray(pri),
                                                       jnp.asarray(g)))
    ref = np.asarray(jops.per_scores_ref(jnp.asarray(pri), jnp.asarray(g),
                                         ALPHA))
    got = n(kops.per_scores(t(pri), t(g), ALPHA))
    assert got.shape == (rows,) and got.dtype == np.float32
    for want in (kernel, ref):
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        _assert_scores_close(got[fin], want[fin], pri[fin])
    np.testing.assert_array_equal(np.isneginf(got), pri == 0)


def _jax_rowloop_write(data, batch, ptr):
    return np.asarray(jax.jit(functools.partial(
        jops.ring_write_rowloop, interpret=True))(
            jnp.asarray(data), jnp.asarray(batch), jnp.asarray(ptr,
                                                               jnp.int32)))


@pytest.mark.parametrize("cap,nrows,ptr,row", [
    (16, 5, 3, (3,)),       # plain append
    (13, 8, 9, (3,)),       # wraps at the ring end mid-batch
    (13, 13, 12, ()),       # n == capacity, wraps, scalar rows
    (10, 4, 8, (2, 3)),     # trailing dims flattened to one row width
    (10, 3, 25, (1,)),      # ptr past the capacity
])
def test_ring_write_rowloop_matches_jax(cap, nrows, ptr, row):
    rng = np.random.default_rng(cap * 100 + ptr)
    data = rng.standard_normal((cap,) + row).astype(np.float32)
    batch = rng.standard_normal((nrows,) + row).astype(np.float32)
    want = _jax_rowloop_write(data, batch, ptr)
    got = n(kops.ring_write_rowloop(t(data), t(batch), t(np.int32(ptr))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jops.ring_write_ref(
        jnp.asarray(data), jnp.asarray(batch), jnp.int32(ptr))))


def test_ring_write_rowloop_over_capacity_raises():
    ptr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity"):
        kops.ring_write_rowloop(torch.zeros(4, 2), torch.zeros(5, 2), ptr)
    with pytest.raises(ValueError, match="capacity"):
        jops.ring_write_rowloop(jnp.zeros((4, 2)), jnp.zeros((5, 2)), 0,
                                interpret=True)


@pytest.mark.parametrize("rows,row", [(10, (2,)), (37, ()), (16, (2, 3))])
def test_ring_gather_rowloop_matches_jax(rows, row):
    """In-range indices with repeats, 0 and rows - 1, and indices outside
    the pool: the Pallas kernel (no bounds check) takes a negative index
    from the end once and clamps the rest, and the port does the same;
    the jnp oracle ``ring_gather_ref`` gives zeros there instead."""
    rng = np.random.default_rng(rows)
    data = rng.standard_normal((rows,) + row).astype(np.float32)
    inside = rng.integers(0, rows, 40)
    idx = np.concatenate([inside, inside[:8], [0, rows - 1, rows - 1],
                          [rows + 2, -3, -rows - 3, 2**31 - 1, -2**31]]
                         ).astype(np.int32)
    want = np.asarray(jax.jit(functools.partial(
        jops.ring_gather_rowloop, interpret=True))(jnp.asarray(data),
                                                   jnp.asarray(idx)))
    got = n(kops.ring_gather_rowloop(t(data), t(idx)))
    assert got.shape == (len(idx),) + row
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-5:], data[[rows - 1, rows - 3, 0,
                                                  rows - 1, 0]])
    oracle = np.asarray(jops.ring_gather_ref(jnp.asarray(data),
                                             jnp.asarray(idx)))
    np.testing.assert_array_equal(got[:-5], oracle[:-5])
    assert not oracle[-5:].any()


def test_merge_topk_candidates_matches_jax():
    """Candidates of 4 windows with many tied scores (across and inside
    windows) and -inf slots: the stable merge keeps the earlier
    candidate first among equal scores, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(0)
    scores = rng.choice([3.0, 1.5, 1.5, 0.25, -np.inf], 4 * 32).astype(
        np.float32)
    idx = rng.permutation(4 * 32).astype(np.int32)
    for k in (1, 17, 32):
        want_v, want_i = jops.merge_topk_candidates(jnp.asarray(scores),
                                                    jnp.asarray(idx), k)
        got_v, got_i = rops.merge_topk_candidates(t(scores), t(idx), k)
        np.testing.assert_array_equal(n(got_v), np.asarray(want_v))
        np.testing.assert_array_equal(n(got_i), np.asarray(want_i))


def test_two_phase_merge_equals_the_dense_topk():
    """Four window-local top-k's merged in window order equal the dense
    top-k, on the port's plain versions (the bench's two-phase check)."""
    pri, g = bench._pool(torch.device("cpu"), 4096, 3)
    k, rows = 100, 1024
    cand = [kops.per_topk(pri[lo:lo + rows], g[lo:lo + rows], ALPHA, k,
                          window_start=lo) for lo in range(0, 4096, rows)]
    mv, mi = rops.merge_topk_candidates(torch.cat([c[0] for c in cand]),
                                        torch.cat([c[1] for c in cand]), k)
    dv, di = rops.per_topk_ref(pri, g, ALPHA, k)
    assert torch.equal(mv, dv) and torch.equal(mi, di)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch CUDA kernels only: a CPU operand is
    refused before anything is built or launched."""
    data = torch.zeros(8, 3)
    ptr = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        rops.per_scores(torch.ones(8), torch.ones(8), ALPHA)
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_write_rowloop(data, torch.zeros(2, 3), ptr)
    with pytest.raises(ValueError, match="CUDA"):
        rops.ring_gather_rowloop(data, torch.zeros(4, dtype=torch.int32))


def test_bench_tiny_on_the_cpu(tmp_path, capsys):
    """``--tiny --device cpu`` runs every table, every oracle check holds,
    and the report goes to ``--out`` only."""
    out = tmp_path / "replay_kernels.json"
    assert bench.main(["--tiny", "--device", "cpu", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["name"] for x in lines] == ["ring_write", "ring_gather",
                                          "per_scores", "per_topk", "oracle"]
    assert lines[-1]["ok"] is True and lines[-1]["device"] == "device: cpu"
    report = json.loads(out.read_text())
    assert report["oracle_ok"] and report["per_topk"]["two_phase_ok"]
    assert set(report["ring_gather"]) == {"kernel_ms", "rowloop_ms",
                                          "plain_ms"}
    assert set(report["per_topk"]) == {"kernel_ms", "global_topk_ms",
                                       "plain_ms", "two_phase_ok"}
    assert bench.DEFAULT_OUT.startswith(bench.REPO_ROOT + "/build/")


def test_bench_exits_non_zero_on_a_mismatch(tmp_path, monkeypatch):
    """An arm that reads the wrong rows fails its check (and the run)."""
    monkeypatch.setattr(kops, "ring_gather_rowloop",
                        lambda data, idx: rops.ring_gather_ref(data, idx + 1))
    assert bench.main(["--tiny", "--device", "cpu", "--out",
                       str(tmp_path / "r.json")]) == 1

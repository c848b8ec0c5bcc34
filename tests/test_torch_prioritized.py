"""The port's prioritized replay against the JAX package's
(``repro.replay.prioritized``), mirroring ``tests/test_prioritized.py``:
max-priority inserts, Gumbel-top-k sampling given the same Gumbel field
(computed in JAX from the key, exactly as ``per.sample`` draws it), the
importance weights, and re-prioritisation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import assert_tree_equal, n, t, to_np

import repro  # noqa: F401  (jax_threefry_partitionable, as in the trainer)
from repro.kernels import ops as jkops
from repro.replay import buffer as jrb
from repro.replay import prioritized as jper
from repro_torch import interop
from repro_torch.replay import buffer as rb
from repro_torch.replay import prioritized as per

torch.set_num_threads(2)

# importance weights: p^alpha, a sum over the pool and (N P)^-beta, in
# float32 on both sides; XLA and PyTorch round pow and order the sum
# differently, a few ulps of each weight
W_RTOL = 1e-6


def _rows(n_rows, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n_rows,) + s).astype(np.float32)
            for k, (s, _) in jrb.trainer_specs(3, 1).items()}


def _both(capacity, writes, seed=0):
    """The same writes through JAX's and the port's ``add_batch``."""
    jst = jper.init_prioritized(capacity, jrb.trainer_specs(3, 1))
    st = per.init_prioritized(capacity, rb.trainer_specs(3, 1), "cpu")
    for i, w in enumerate(writes):
        rows = _rows(w, seed + i)
        jst = jper.add_batch(jst, {k: jnp.asarray(v)
                                   for k, v in rows.items()})
        st = per.add_batch(st, {k: t(v) for k, v in rows.items()})
    return jst, st


def _assert_state_equal(jst, st):
    """Bitwise, field by field (``jax.tree`` orders dict keys, not
    NamedTuple fields)."""
    want, got = to_np(jst), interop.prioritized_to_numpy(st)
    assert_tree_equal(want.base.data, got["base"]["data"])
    for a, b in ((want.base.ptr, got["base"]["ptr"]),
                 (want.base.size, got["base"]["size"]),
                 (want.priorities, got["priorities"]),
                 (want.max_priority, got["max_priority"])):
        assert_tree_equal(a, b)


def _gumbel(key, capacity):
    """The Gumbel field ``per.sample`` draws from ``key``."""
    return -jnp.log(-jnp.log(jax.random.uniform(
        key, (capacity,), minval=1e-12, maxval=1.0)))


@pytest.mark.parametrize("capacity,writes", [
    (16, [8]),            # mid-ring
    (16, [10, 10]),       # the second write wraps
    (16, [5, 40]),        # oversized: only the newest 16 rows survive
])
def test_add_batch_max_priority_matches_jax(capacity, writes):
    jst, st = _both(capacity, writes)
    _assert_state_equal(jst, st)
    assert n(st.priorities)[:min(sum(writes), capacity)].min() == 1.0


def test_add_after_update_inherits_max_priority():
    jst, st = _both(8, [8])
    idx, td = np.asarray([0, 3], np.int32), np.asarray([50.0, -7.0],
                                                       np.float32)
    jst = jper.update_priorities(jst, jnp.asarray(idx), jnp.asarray(td))
    per.update_priorities(st, t(idx), t(td))
    rows = _rows(2, 9)
    jst = jper.add_batch(jst, {k: jnp.asarray(v)
                               for k, v in rows.items()})
    per.add_batch(st, {k: t(v) for k, v in rows.items()})
    _assert_state_equal(jst, st)
    assert float(st.max_priority) == pytest.approx(50.001)
    assert n(st.priorities)[:2].tolist() == [float(st.max_priority)] * 2


@pytest.mark.parametrize("capacity,writes,batch,pri,alpha,beta", [
    (64, [5], 12, None, 0.6, 0.4),      # fewer live rows: draws cycle
    (16, [6], 4, [0.5, 1.0, 2.0, 4.0, 0.25, 1.5], 0.7, 0.5),  # partial
    (32, [20, 20], 16, "random", 0.6, 0.4),  # full and wrapped
    (16, [8], 6, [1.0, 2.0, 0.0, 3.0, 1.0, 0.0, 5.0, 0.5], 1.0, 1.0),
])
def test_sample_matches_jax(capacity, writes, batch, pri, alpha, beta):
    """Same pool, same Gumbel field: the same drawn rows, bitwise; the
    importance weights within ``W_RTOL``. Priorities set through
    ``update_priorities`` with eps 0 (zeros are never drawn)."""
    jst, st = _both(capacity, writes, seed=capacity)
    if pri is not None:
        live = min(sum(writes), capacity)
        vals = (np.random.default_rng(1).uniform(0.1, 5.0, live)
                if pri == "random" else np.asarray(pri))
        idx = np.arange(live, dtype=np.int32)
        vals = vals.astype(np.float32)
        jst = jper.update_priorities(jst, jnp.asarray(idx),
                                     jnp.asarray(vals), eps=0.0)
        per.update_priorities(st, t(idx), t(vals), eps=0.0)
        _assert_state_equal(jst, st)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jbatch, jidx, jw = jper.sample(jst, key, batch, alpha=alpha,
                                       beta=beta)
        got, idx, w = per.sample(st, t(_gumbel(key, capacity)), batch,
                                 alpha=alpha, beta=beta)
        np.testing.assert_array_equal(n(idx), np.asarray(jidx))
        assert idx.dtype == torch.int32
        assert_tree_equal(to_np(jbatch), interop.to_numpy(got))
        np.testing.assert_allclose(n(w), np.asarray(jw), rtol=W_RTOL)
        live = n(st.priorities) > 0
        assert live[n(idx)].all()
    if sum(writes) < batch:                      # the draws cycled
        arr = n(idx)
        np.testing.assert_array_equal(arr[sum(writes):2 * sum(writes)],
                                      arr[:sum(writes)])


@pytest.mark.parametrize("eps", [1e-3, 0.0])
def test_update_priorities_matches_jax(eps):
    """Distinct rows (the jnp scatter's winner is defined) against the
    jnp path; ``max_priority`` tracks the largest new priority."""
    jst, st = _both(32, [32])
    rng = np.random.default_rng(5)
    idx = rng.permutation(32)[:12].astype(np.int32)
    td = rng.standard_normal(12).astype(np.float32) * 3
    jst = jper.update_priorities(jst, jnp.asarray(idx), jnp.asarray(td),
                                 eps=eps)
    per.update_priorities(st, t(idx), t(td), eps=eps)
    _assert_state_equal(jst, st)


def test_update_priorities_repeated_rows_last_wins():
    """Cycled draws repeat rows, each with its own |TD|: the last draw
    wins, as in the JAX package's sequential Pallas scatter (interpret
    mode, under its ``use_pallas`` switch)."""
    jst, st = _both(16, [5])
    idx = np.asarray([0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1], np.int32)
    td = np.arange(1, 13, dtype=np.float32)
    with jkops.use_pallas(True):
        jst = jper.update_priorities(jst, jnp.asarray(idx),
                                     jnp.asarray(td))
    per.update_priorities(st, t(idx), t(td))
    _assert_state_equal(jst, st)
    np.testing.assert_allclose(n(st.priorities)[:5],
                               [11.001, 12.001, 8.001, 9.001, 10.001],
                               rtol=1e-6)


def test_prioritized_round_trip_is_bitwise():
    jst, _ = _both(16, [10])
    st = interop.prioritized_from_numpy(to_np(jst), "cpu")
    assert st.priorities.dtype == torch.float32
    assert st.base.ptr.dtype == torch.int32
    _assert_state_equal(jst, st)

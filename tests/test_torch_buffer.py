"""The port's replay ring and n-step transform against the JAX
package's: ``nstep_chunk``, ``write_plan``, ``add_batch`` and uniform
``sample`` with injected indices. Rows are copied, so ring contents and
counters compare bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import assert_tree_equal, n, t, to_np

import repro  # noqa: F401
from repro.replay import buffer as jrb
from repro.replay.nstep import nstep_chunk as jnstep
from repro_torch import interop
from repro_torch.replay import buffer as rb
from repro_torch.replay.nstep import nstep_chunk

torch.set_num_threads(2)

T, N = 8, 4          # the small trainer's chunk: 8 steps x 4 envs


def _chunk(seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((T, N, 3)).astype(np.float32),
            "act": rng.uniform(-1, 1, (T, N, 1)).astype(np.float32),
            "rew": rng.standard_normal((T, N)).astype(np.float32),
            "next_obs": rng.standard_normal((T, N, 3)).astype(np.float32),
            "done": (rng.random((T, N)) < 0.2).astype(np.float32)}


@pytest.mark.parametrize("nsteps", [1, 2, 3, T + 1])   # n - 1 <= T
def test_nstep_chunk_matches_jax(nsteps):
    exps = _chunk(nsteps)
    want = jnstep({k: jnp.asarray(v) for k, v in exps.items()}, nsteps,
                  0.99)
    got = nstep_chunk({k: t(v) for k, v in exps.items()}, nsteps, 0.99)
    assert set(got) == set(want)
    # same float32 operations in the same order on both sides
    for k in want:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_nstep_truncates_at_the_chunk_end():
    """Beyond n - 1 = T every look-ahead lies past the chunk: the rows are
    the ones n = T + 1 gives (the JAX version raises there instead)."""
    exps = {k: t(v) for k, v in _chunk(7).items()}
    want = nstep_chunk(exps, T + 1, 0.99)
    for k, v in nstep_chunk(exps, T + 4, 0.99).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


@pytest.mark.parametrize("ptr,nrows,cap", [(0, 5, 10), (7, 5, 10),
                                           (3, 25, 10), (9, 10, 10)])
def test_write_plan_matches_jax(ptr, nrows, cap):
    jp0, jkeep = jrb.write_plan(jnp.asarray(ptr, jnp.int32), nrows, cap)
    p0, keep = rb.write_plan(torch.tensor(ptr, dtype=torch.int32), nrows,
                             cap)
    assert keep == jkeep and int(p0) == int(jp0)


def _rows(rng, nrows, specs):
    return {k: rng.standard_normal((nrows,) + s).astype(np.float32)
            for k, (s, _) in specs.items()}


@pytest.mark.parametrize("writes", [(32, 32, 32, 32),   # wraps mid-batch
                                    (30, 120),          # write > capacity
                                    (5,)])
def test_add_batch_matches_jax(writes):
    cap = 100            # not a multiple of the 32 rows a round writes
    specs = jrb.trainer_specs(3, 1)
    rng = np.random.default_rng(len(writes))
    jstate = jrb.init_replay(cap, specs)
    state = rb.init_replay(cap, rb.trainer_specs(3, 1), device="cpu")
    for w in writes:
        rows = _rows(rng, w, specs)
        jstate = jrb.add_batch(jstate, {k: jnp.asarray(v)
                                        for k, v in rows.items()})
        out = rb.add_batch(state, {k: t(v) for k, v in rows.items()})
        assert out is state                      # in place
    got = interop.replay_to_numpy(state)
    want = to_np(jstate)
    assert_tree_equal(want.data, got["data"])
    assert_tree_equal((want.ptr, want.size), (got["ptr"], got["size"]))


@pytest.mark.parametrize("fill", [60, 100, 130])   # partial, full, wrapped
def test_sample_with_injected_indices_matches_jax(fill):
    cap, batch = 100, 64
    specs = jrb.trainer_specs(3, 1)
    rows = _rows(np.random.default_rng(fill), fill, specs)
    jstate = jrb.add_batch(jrb.init_replay(cap, specs),
                           {k: jnp.asarray(v) for k, v in rows.items()})
    state = interop.replay_from_numpy(to_np(jstate), "cpu")
    key = jax.random.PRNGKey(fill)
    # the indices the JAX sample draws from this key (buffer.py:166)
    idx = jax.random.randint(key, (batch,), 0,
                             jnp.maximum(jstate.size, 1))
    want = jrb.sample(jstate, key, batch)
    got = rb.sample(state, t(idx, torch.int32))
    assert_tree_equal(to_np(want), interop.to_numpy(got))


def test_uniform_indices_stay_in_the_live_rows():
    state = rb.init_replay(100, rb.trainer_specs(3, 1), device="cpu")
    g = torch.Generator().manual_seed(0)
    assert not rb.uniform_indices(state, 64, g).any()      # empty pool
    state.size.fill_(37)
    idx = rb.uniform_indices(state, 4096, g)
    assert idx.dtype == torch.int32
    assert int(idx.min()) == 0 and int(idx.max()) == 36

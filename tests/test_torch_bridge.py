"""numpy <-> tensor helpers shared by the port's parity tests, and the
round trip of ``repro_torch.interop``: a JAX ``AlgoState`` / ``ReplayState``
carried into the port and back out must come back bitwise."""
import jax
import numpy as np
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable first)
from repro.replay import buffer as jrb
from repro.rl import sac as jsac
from repro.rl.base import AlgoHP as JaxHP
from repro_torch import interop

torch.set_num_threads(2)

SMALL_HIDDEN = (32, 32)


def to_np(tree):
    """A JAX pytree (or array) -> the same nesting of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def t(x, dtype=None):
    """numpy -> CPU tensor (a copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    """CPU tensor -> numpy."""
    return x.detach().cpu().numpy()


def assert_tree_equal(a, b):
    """Bitwise equality of two nestings of arrays (dicts compared by key,
    tuples by position)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def assert_tree_close(a, b, rtol, atol):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol)


def jax_sac_state(seed=0, hidden=SMALL_HIDDEN, **hp_kw):
    hp = JaxHP(hidden=hidden, **hp_kw)
    return hp, jsac.init_state(jax.random.PRNGKey(seed), 3, 1, hp)


def test_algo_state_round_trip_is_bitwise():
    _, state = jax_sac_state()
    # step the optimizer counters so the carried values are not all zero
    state = state._replace(
        opt_q=state.opt_q._replace(step=state.opt_q.step + 7),
        step=state.step + 3)
    ref = to_np(state)
    port = interop.algo_state_from_numpy(ref, "cpu")
    assert port.q["l0"]["w"].shape == (2, 4, 32)         # stacked (2,in,out)
    back = interop.algo_state_to_numpy(port)
    for name in ("actor", "q", "q_target", "log_alpha", "step"):
        assert_tree_equal(getattr(ref, name), back[name])
    for name in ("opt_actor", "opt_q", "opt_alpha"):
        want = getattr(ref, name)
        got = back[name]
        assert_tree_equal((want.step, want.mu, want.nu),
                          (got["step"], got["mu"], got["nu"]))


def test_algo_state_accepts_mappings():
    _, state = jax_sac_state(seed=1)
    ref = to_np(state)
    as_dict = {k: (v._asdict() if hasattr(v, "_asdict") else v)
               for k, v in ref._asdict().items()}
    port = interop.algo_state_from_numpy(as_dict, "cpu")
    assert_tree_equal(ref.opt_actor.mu, interop.to_numpy(port.opt_actor.mu))
    assert port.opt_alpha.step.dtype == torch.int32


def test_replay_round_trip_is_bitwise():
    specs = jrb.trainer_specs(3, 1)
    replay = jrb.init_replay(10, specs)
    rows = {k: jax.random.normal(jax.random.PRNGKey(i), (7,) + s)
            for i, (k, (s, _)) in enumerate(specs.items())}
    replay = to_np(jrb.add_batch(replay, rows))
    port = interop.replay_from_numpy(replay, "cpu")
    assert port.ptr.dtype == torch.int32 and int(port.ptr) == 7
    back = interop.replay_to_numpy(port)
    assert_tree_equal(replay.data, back["data"])
    assert_tree_equal((replay.ptr, replay.size), (back["ptr"], back["size"]))

"""One TD3 and one DDPG update in the port against the JAX package's,
from the same carried-across state, batch and noise; the delayed policy
update; the exploration policy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import SMALL_HIDDEN, assert_tree_close, n, t, to_np
from test_torch_sac import ACT, ATOL, B, OBS, RTOL, _batch

from repro.rl import ddpg as jddpg
from repro.rl import td3 as jtd3
from repro.rl.base import AlgoHP as JaxHP
from repro_torch import interop
from repro_torch.rl import ddpg, td3
from repro_torch.rl.base import AlgoHP, get_algo

torch.set_num_threads(2)

JAX_ALGOS = {"td3": jtd3, "ddpg": jddpg}
PORT_ALGOS = {"td3": td3, "ddpg": ddpg}


def _states(algo, seed, **hp_kw):
    """The JAX initial state and the port's copy of it."""
    jhp = JaxHP(algo=algo, hidden=SMALL_HIDDEN, **hp_kw)
    jstate = JAX_ALGOS[algo].init_state(jax.random.PRNGKey(seed), OBS, ACT,
                                        jhp)
    state = interop.algo_state_from_numpy(to_np(jstate), "cpu")
    return jhp, jstate, AlgoHP(algo=algo, hidden=SMALL_HIDDEN, **hp_kw), state


def _noises(algo, key):
    """The draws the JAX update makes from its key: TD3's smoothing noise
    ``normal(key, act.shape)`` (rl/td3.py:46), none for DDPG."""
    if algo == "td3":
        return (t(jax.random.normal(key, (B, ACT))),)
    return ()


def _assert_states_close(want, got):
    want, got = to_np(want), interop.algo_state_to_numpy(got)
    for name in ("actor", "q", "q_target", "log_alpha"):
        assert_tree_close(getattr(want, name), got[name], RTOL, ATOL)
    for name in ("opt_actor", "opt_q"):
        w = getattr(want, name)
        np.testing.assert_array_equal(w.step, got[name]["step"])
        assert_tree_close((w.mu, w.nu), (got[name]["mu"], got[name]["nu"]),
                          RTOL, 1e-7)
    assert want.opt_alpha is None and got["opt_alpha"] is None
    np.testing.assert_array_equal(want.step, got["step"])


def test_registry_holds_the_three_algorithms():
    for name, noises in (("sac", 2), ("td3", 1), ("ddpg", 0)):
        assert get_algo(name).UPDATE_NOISES == noises
    with pytest.raises(KeyError, match="known"):
        get_algo("ppo")


@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_init_state_layout_matches_jax(algo):
    _, _, hp, carried = _states(algo, 0)
    state = PORT_ALGOS[algo].init_state(torch.Generator().manual_seed(0),
                                        OBS, ACT, hp, "cpu")
    want, got = (jax.tree.map(lambda a: (a.shape, a.dtype.name),
                              interop.algo_state_to_numpy(s))
                 for s in (carried, state))
    assert want == got
    assert got["q"]["l0"]["w"][0] == ((2 if algo == "td3" else 1),
                                      OBS + ACT, SMALL_HIDDEN[0])
    for a, b in ((state.q, state.q_target["q"]),
                 (state.actor, state.q_target["actor"])):
        assert_tree_close(interop.to_numpy(a), interop.to_numpy(b), 0, 0)


@pytest.mark.parametrize("weight", [False, True], ids=["uniform", "per"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_update_matches_jax(algo, seed, weight):
    """One update, unweighted and with PER importance weights."""
    jhp, jstate, hp, state = _states(algo, seed)
    batch, key = _batch(seed, weight), jax.random.PRNGKey(100 + seed)
    update = jax.jit(JAX_ALGOS[algo].make_update_step(jhp, OBS, ACT))
    want_state, want_m = update(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    got_state, got_m = PORT_ALGOS[algo].make_update_step(hp, OBS, ACT)(
        state, {k: t(v) for k, v in batch.items()}, *_noises(algo, key))
    assert got_state is state                     # updated in place
    _assert_states_close(want_state, got_state)
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(n(got_m[k]), np.asarray(v), RTOL, ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("weight", [False, True], ids=["uniform", "per"])
def test_td3_delays_the_policy_update(weight):
    """Step 0 moves the actor and its Adam state; step 1 (policy_delay 2)
    leaves both bitwise as they were, while the critic and both targets
    move. Both steps track the JAX update (a large tau makes the target
    actor's polyak step visible above the tolerance)."""
    jhp, jstate, hp, state = _states("td3", 3, tau=0.5)
    update = td3.make_update_step(hp, OBS, ACT)
    jupdate = jax.jit(jtd3.make_update_step(jhp, OBS, ACT))
    def snapshot():     # to_numpy shares the tensors' memory: copy
        return jax.tree.map(np.copy, interop.algo_state_to_numpy(state))

    snaps = [snapshot()]
    for i in range(2):
        batch, key = _batch(10 + i, weight), jax.random.PRNGKey(20 + i)
        jstate, _ = jupdate(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, key)
        state, _ = update(state, {k: t(v) for k, v in batch.items()},
                          *_noises("td3", key))
        _assert_states_close(jstate, state)
        snaps.append(snapshot())
    before, first, second = snaps

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in
                   zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    assert not same(before["actor"], first["actor"])
    assert int(first["opt_actor"]["step"]) == 1
    assert same(first["actor"], second["actor"])
    assert same(first["opt_actor"], second["opt_actor"])
    assert not same(first["q"], second["q"])
    assert not same(first["q_target"]["actor"], second["q_target"]["actor"])
    assert int(second["opt_q"]["step"]) == 2 and int(second["step"]) == 2


@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_make_act_matches_jax(algo):
    """The exploration policy ``clip(tanh(mlp) + explore_noise * eps,
    +-1)`` under the eps ``normal(key, a.shape)`` the JAX act draws, and
    the deterministic one. A large noise makes the clip bite."""
    jhp, jstate, hp, state = _states(algo, 4, explore_noise=0.8)
    obs = np.random.default_rng(4).standard_normal((B, OBS)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    ja = JAX_ALGOS[algo].make_act(jhp)(jstate.actor, jnp.asarray(obs), key)
    a = PORT_ALGOS[algo].make_act(hp)(
        state.actor, t(obs), t(jax.random.normal(key, (B, ACT))))
    np.testing.assert_allclose(n(a), np.asarray(ja), RTOL, ATOL)
    assert (np.abs(n(a)) == 1.0).any()
    jdet = JAX_ALGOS[algo].make_act(jhp, deterministic=True)(
        jstate.actor, jnp.asarray(obs), None)
    det = PORT_ALGOS[algo].make_act(hp, deterministic=True)(
        state.actor, t(obs), None)
    np.testing.assert_allclose(n(det), np.asarray(jdet), RTOL, ATOL)


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")


@pytest.mark.parametrize("algo", ["td3", "ddpg"])
def test_init_state_raises_without_a_gpu(no_gpu, algo):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT_ALGOS[algo].init_state(torch.Generator(), OBS, ACT,
                                    AlgoHP(hidden=(8, 8)))

"""The port's batched envs (Pendulum, CartPole, Reacher, Hopper) against
the JAX package's vmapped ones, on identical states, actions and reset
draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_reset_draws, n, t

import repro  # noqa: F401
from repro.envs import make as jmake
from repro_torch.envs import make

torch.set_num_threads(2)

# float32 transcendentals (sin, cos, remainder) in XLA and in PyTorch may
# differ in the last bit or two; one step moves values of order 1-10
RTOL, ATOL = 1e-6, 1e-5
N = 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    states = {"th": rng.uniform(-7, 7, N).astype(np.float32),
              "thdot": rng.uniform(-8, 8, N).astype(np.float32),
              # half the envs end their episode on this step
              "t": rng.choice([3, 199], N).astype(np.int32)}
    action = rng.uniform(-1.5, 1.5, (N, 1)).astype(np.float32)
    return states, action


@pytest.mark.parametrize("seed", [0, 1])
def test_pendulum_step_and_observe(seed):
    states, action = _inputs(seed)
    jenv, env = jmake("pendulum"), make("pendulum")
    js, jobs, jrew, jdone = jax.vmap(jenv.step)(
        {k: jnp.asarray(v) for k, v in states.items()}, jnp.asarray(action))
    ps, pobs, prew, pdone = env.step({k: t(v) for k, v in states.items()},
                                     t(action))
    for k in ("th", "thdot"):
        np.testing.assert_allclose(n(ps[k]), np.asarray(js[k]), RTOL, ATOL)
    np.testing.assert_array_equal(n(ps["t"]), np.asarray(js["t"]))
    np.testing.assert_allclose(n(pobs), np.asarray(jobs), RTOL, ATOL)
    np.testing.assert_allclose(n(prew), np.asarray(jrew), RTOL, ATOL)
    np.testing.assert_array_equal(n(pdone), np.asarray(jdone))
    np.testing.assert_allclose(
        n(env.observe({k: t(v) for k, v in states.items()})),
        np.asarray(jax.vmap(jenv.observe)(states)), RTOL, ATOL)


def test_pendulum_autoreset_step_uses_injected_draws():
    """Done envs restart from the reset draws (copied bitwise) and report
    the observation of the fresh state."""
    states, action = _inputs(2)
    jenv, env = jmake("pendulum"), make("pendulum")
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    fresh = jax.vmap(jenv.reset)(keys)
    js, jobs, jrew, jdone = jax.vmap(jenv.autoreset_step)(
        {k: jnp.asarray(v) for k, v in states.items()}, jnp.asarray(action),
        keys)
    draws = {"th": t(fresh["th"]), "thdot": t(fresh["thdot"])}
    ps, pobs, prew, pdone = env.autoreset_step(
        {k: t(v) for k, v in states.items()}, t(action), draws)
    done = np.asarray(jdone)
    assert done.any() and not done.all()
    np.testing.assert_array_equal(n(pdone), done)
    for k in ("th", "thdot"):
        np.testing.assert_array_equal(n(ps[k])[done],
                                      np.asarray(js[k])[done])
        np.testing.assert_allclose(n(ps[k]), np.asarray(js[k]), RTOL, ATOL)
    np.testing.assert_array_equal(n(ps["t"]), np.asarray(js["t"]))
    np.testing.assert_allclose(n(pobs), np.asarray(jobs), RTOL, ATOL)
    np.testing.assert_allclose(n(prew), np.asarray(jrew), RTOL, ATOL)


def test_reset_draws_cover_the_reference_ranges():
    env = make("pendulum")
    g = torch.Generator().manual_seed(0)
    s = env.reset_batch(4096, g)
    assert s["t"].dtype == torch.int32 and not s["t"].any()
    assert -np.pi <= float(s["th"].min()) and float(s["th"].max()) < np.pi
    assert -1 <= float(s["thdot"].min()) and float(s["thdot"].max()) < 1
    assert float(s["th"].std()) > 1.5      # spread over the whole circle


NEW_ENVS = ("cartpole", "reacher", "hopper")
# float32 dynamics: one step moves values of order 1-10; ten steps carry
# the last-bit differences of sin/cos/sqrt along
ROLLOUT_RTOL, ROLLOUT_ATOL = 1e-5, 1e-5


def _new_env_inputs(name, seed):
    """Seeded states across each env's regimes, and actions beyond the
    clip. Hopper's: a third of the envs airborne, a third in contact
    (the foot at least 0.1 from the ground either way, so an ulp cannot
    flip the contact branch), a third falling (pitch past 0.75 by at
    least 0.01 after the step), and the rest kept off both fall limits."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, shape=(N,): rng.uniform(lo, hi, shape).astype(
        np.float32)
    if name == "cartpole":
        states = {"x": u(-2, 2), "xdot": u(-3, 3), "th": u(-7, 7),
                  "thdot": u(-8, 8),
                  "t": rng.choice([3, 499], N).astype(np.int32)}
    elif name == "reacher":
        states = {"q": u(-4, 4, (N, 2)), "qd": u(-9, 9, (N, 2)),
                  "target": u(-1, 1, (N, 2)),
                  "t": rng.choice([3, 149], N).astype(np.int32)}
    else:
        group = np.arange(N) % 3
        z = np.where(group == 0, u(1.7, 2.0), u(0.8, 1.0))
        leg = np.where(group == 0, u(-0.4, 0.4), u(0.2, 0.4))
        pitch = np.where(group == 2, rng.choice([-0.79, 0.79], N),
                         u(-0.6, 0.6)).astype(np.float32)
        states = {"x": u(-5, 5), "vx": u(-3, 3), "z": z.astype(np.float32),
                  "vz": u(-2, 2), "leg": leg.astype(np.float32),
                  "pitch": pitch,
                  "t": rng.integers(0, 400, N).astype(np.int32)}
    act_dim = make(name).spec.act_dim
    return states, u(-1.5, 1.5, (N, act_dim))


def _assert_states_close(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        if k == "t":
            np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(n(got[k]), np.asarray(want[k]),
                                       rtol, atol, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NEW_ENVS)
def test_new_env_step_and_observe(name, seed):
    states, action = _new_env_inputs(name, seed)
    jenv, env = jmake(name), make(name)
    js, jobs, jrew, jdone = jax.vmap(jenv.step)(
        {k: jnp.asarray(v) for k, v in states.items()}, jnp.asarray(action))
    ps, pobs, prew, pdone = env.step({k: t(v) for k, v in states.items()},
                                     t(action))
    _assert_states_close(ps, js)
    np.testing.assert_allclose(n(pobs), np.asarray(jobs), RTOL, ATOL)
    np.testing.assert_allclose(n(prew), np.asarray(jrew), RTOL, ATOL)
    np.testing.assert_array_equal(n(pdone), np.asarray(jdone))
    done = np.asarray(jdone)
    assert done.any() and not done.all()
    np.testing.assert_allclose(
        n(env.observe({k: t(v) for k, v in states.items()})),
        np.asarray(jax.vmap(jenv.observe)(states)), RTOL, ATOL)


def test_hopper_inputs_cover_its_branches():
    """The Hopper states above reach contact, flight and a fall."""
    states, action = _new_env_inputs("hopper", 0)
    leg = np.clip(states["leg"] + 2.0 * np.clip(action[:, 0], -1, 1)
                  * 0.02, -0.5, 0.5)
    foot = states["z"] - (1.0 + leg)
    assert (foot < -0.1).any() and (foot > 0.1).any()
    assert (np.abs(foot) > 0.1).all()
    _, _, rew, done = make("hopper").step(
        {k: t(v) for k, v in states.items()}, t(action))
    fallen = np.abs(states["pitch"]) > 0.75
    assert fallen.any() and n(done)[fallen].all()


@pytest.mark.parametrize("name", NEW_ENVS)
def test_new_env_autoreset_rollout(name):
    """Ten autoreset steps from states near the episode's end, with the
    JAX env's reset draws: done envs restart from the draws and report the
    fresh state's observation."""
    states, _ = _new_env_inputs(name, 2)
    jenv, env = jmake(name), make(name)
    rng = np.random.default_rng(3)
    js = {k: jnp.asarray(v) for k, v in states.items()}
    ps = {k: t(v) for k, v in states.items()}
    seen_done = 0
    for i in range(10):
        action = rng.uniform(-1.5, 1.5, (N, env.spec.act_dim)).astype(
            np.float32)
        keys = jax.random.split(jax.random.PRNGKey(i), N)
        js, jobs, jrew, jdone = jax.vmap(jenv.autoreset_step)(
            js, jnp.asarray(action), keys)
        ps, pobs, prew, pdone = env.autoreset_step(
            ps, t(action), jax_reset_draws(name, keys))
        np.testing.assert_array_equal(n(pdone), np.asarray(jdone))
        _assert_states_close(ps, js, ROLLOUT_RTOL, ROLLOUT_ATOL)
        np.testing.assert_allclose(n(pobs), np.asarray(jobs), ROLLOUT_RTOL,
                                   ROLLOUT_ATOL)
        np.testing.assert_allclose(n(prew), np.asarray(jrew), ROLLOUT_RTOL,
                                   ROLLOUT_ATOL)
        seen_done += int(np.asarray(jdone).sum())
    assert seen_done > 0


def test_autoreset_resets_each_env_of_a_two_env_leaf():
    """A (2, 2) leaf with one of 2 envs done: the done env's row comes
    from the fresh state, the other env's row from the step. (Compared
    against ``done`` as a (2,) mask broadcast over the leaf's last axis,
    which would reset column 0 of both envs instead.)"""
    env = make("reacher")
    state = {"q": t([[0.1, 0.2], [0.3, 0.4]]),
             "qd": t([[0.5, -0.5], [1.0, -1.0]]),
             "target": t([[0.5, 0.0], [0.0, 0.5]]),
             "t": t([149, 3], torch.int32)}
    draws = {"q": t([[1.0, 2.0], [3.0, 4.0]]),
             "qd": t([[0.25, 0.125], [-0.25, -0.125]]),
             "r": t([0.5, 0.6]), "ang": t([0.0, 1.0])}
    stepped, _, _, done = env.step(state, torch.zeros(2, 2))
    fresh = env.reset(draws)
    got, obs, _, got_done = env.autoreset_step(state, torch.zeros(2, 2),
                                               draws)
    assert got_done.tolist() == [True, False]
    for k in ("q", "qd", "target", "t"):
        torch.testing.assert_close(got[k][0], fresh[k][0], rtol=0, atol=0)
        torch.testing.assert_close(got[k][1], stepped[k][1], rtol=0, atol=0)
    torch.testing.assert_close(obs, env.observe(got), rtol=0, atol=0)


# the reference's reset ranges (envs/{cartpole,reacher,hopper}.py)
RESET_RANGES = {
    "cartpole": {"x": (-0.1, 0.1), "th": (np.pi - 0.1, np.pi + 0.1),
                 "xdot": (0, 0), "thdot": (0, 0)},
    "reacher": {"q": (-np.pi, np.pi), "qd": (-0.5, 0.5),
                "target": (-0.9, 0.9)},
    "hopper": {"vx": (-0.1, 0.1), "z": (1.0, 1.05), "x": (0, 0),
               "vz": (0, 0), "leg": (0, 0), "pitch": (0, 0)},
}


@pytest.mark.parametrize("name", NEW_ENVS)
def test_new_env_reset_draws_cover_the_reference_ranges(name):
    env = make(name)
    s = env.reset_batch(4096, torch.Generator().manual_seed(0))
    assert s["t"].dtype == torch.int32 and not s["t"].any()
    for k, (lo, hi) in RESET_RANGES[name].items():
        v = n(s[k])
        assert v.dtype == np.float32 and v.shape[0] == 4096, k
        assert lo - 1e-6 <= v.min() and v.max() <= hi + 1e-6, k
        if hi > lo:                  # spread over most of the range
            assert v.max() - v.min() > 0.9 * (hi - lo), k
    if name == "reacher":
        radius = np.linalg.norm(n(s["target"]), axis=-1)
        assert 0.3 - 1e-6 <= radius.min() and radius.max() <= 0.9 + 1e-6


@pytest.mark.parametrize("name", NEW_ENVS)
def test_new_env_reset_matches_jax(name):
    """``reset`` builds the JAX reset's state from the draws the JAX
    reset made (Reacher's target from its radius and angle)."""
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    want = jax.vmap(jmake(name).reset)(keys)
    got = make(name).reset(jax_reset_draws(name, keys))
    _assert_states_close(got, want)

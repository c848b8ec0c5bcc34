"""The port's batched Pendulum against the JAX package's vmapped one, on
identical states, actions and reset draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import n, t

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

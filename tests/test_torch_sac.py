"""One SAC update in the port against the JAX package's, from the same
carried-across state, batch and action noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import (assert_tree_close, jax_sac_state, n, t,
                               to_np)

from repro.rl import networks as jnets
from repro.rl import sac as jsac
from repro_torch import interop
from repro_torch.rl import networks as nets
from repro_torch.rl import sac
from repro_torch.rl.base import AlgoHP

torch.set_num_threads(2)

B, OBS, ACT = 64, 3, 1
# float32 on both sides, but XLA and PyTorch sum the products and
# reductions in different orders: values agree to a few ulps of their
# magnitude. Adam's first steps divide by sqrt(v) ~ |g|, which keeps
# parameter updates at ~lr and the rounding differences at ~1e-6 of it.
RTOL, ATOL = 1e-4, 1e-5


def _batch(seed, weight=False):
    """A replay batch; with ``weight``, PER importance weights too
    (normalised to max 1, as ``prioritized.sample`` gives them)."""
    rng = np.random.default_rng(seed)
    batch = {"obs": rng.standard_normal((B, OBS)).astype(np.float32),
             "act": rng.uniform(-1, 1, (B, ACT)).astype(np.float32),
             "rew": rng.standard_normal(B).astype(np.float32),
             "next_obs": rng.standard_normal((B, OBS)).astype(np.float32),
             "done": (rng.random(B) < 0.1).astype(np.float32),
             "disc": (0.99 * (rng.random(B) > 0.1)).astype(np.float32)}
    if weight:
        w = rng.uniform(0.05, 1.0, B).astype(np.float32)
        batch["weight"] = w / w.max()
    return batch


def _jax_update(hp, state, batch, key):
    update = jax.jit(jsac.make_update_step(hp, OBS, ACT))
    return update(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)


def _eps(key):
    """The two draws the JAX update makes from its key (sac.py:43 and
    networks.sample_action)."""
    k1, k2 = jax.random.split(key)
    return (t(jax.random.normal(k1, (B, ACT))),
            t(jax.random.normal(k2, (B, ACT))))


@pytest.mark.parametrize("seed", [0, 1])
def test_sac_update_matches_jax(seed):
    _check_one_update(seed, weight=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_sac_weighted_update_matches_jax(seed):
    """PER batches: ``weight`` scales each sample's squared TD error in
    the critic loss (the same batch as the unweighted case, plus
    weights)."""
    _check_one_update(seed, weight=True)


def _check_one_update(seed, weight):
    jhp, jstate = jax_sac_state(seed)
    hp = AlgoHP(hidden=jhp.hidden)
    batch, key = _batch(seed, weight), jax.random.PRNGKey(100 + seed)
    state = interop.algo_state_from_numpy(to_np(jstate), "cpu")
    want_state, want_m = _jax_update(jhp, jstate, batch, key)

    got_state, got_m = sac.make_update_step(hp, OBS, ACT)(
        state, {k: t(v) for k, v in batch.items()}, *_eps(key))
    assert got_state is state                     # updated in place
    want, got = to_np(want_state), interop.algo_state_to_numpy(got_state)
    for name in ("actor", "q", "q_target", "log_alpha"):
        assert_tree_close(getattr(want, name), got[name], RTOL, ATOL)
    for name in ("opt_actor", "opt_q", "opt_alpha"):
        w = getattr(want, name)
        np.testing.assert_array_equal(w.step, got[name]["step"])
        assert_tree_close((w.mu, w.nu), (got[name]["mu"], got[name]["nu"]),
                          RTOL, 1e-7)
    np.testing.assert_array_equal(want.step, got["step"])
    for k, v in want_m.items():
        np.testing.assert_allclose(n(got_m[k]), np.asarray(v), RTOL, ATOL,
                                   err_msg=k)


def test_sac_two_updates_track_jax():
    """Two chained updates: the second reads the first's new actor, Q,
    target, alpha and Adam moments, so an ordering slip compounds. A
    large tau makes the polyak step visible above the tolerance (at the
    default 0.005 it moves the target by ~1e-6)."""
    _check_two_updates(weight=False)


def test_sac_two_weighted_updates_track_jax():
    _check_two_updates(weight=True)


def _check_two_updates(weight):
    jhp, jstate = jax_sac_state(3, tau=0.5)
    hp = AlgoHP(hidden=jhp.hidden, tau=0.5)
    state = interop.algo_state_from_numpy(to_np(jstate), "cpu")
    update = sac.make_update_step(hp, OBS, ACT)
    for i in range(2):
        batch, key = _batch(10 + i, weight), jax.random.PRNGKey(20 + i)
        jstate, want_m = _jax_update(jhp, jstate, batch, key)
        state, got_m = update(state, {k: t(v) for k, v in batch.items()},
                              *_eps(key))
    want, got = to_np(jstate), interop.algo_state_to_numpy(state)
    for name in ("actor", "q", "q_target", "log_alpha"):
        assert_tree_close(getattr(want, name), got[name], RTOL, ATOL)
    np.testing.assert_allclose(n(got_m["critic_loss"]),
                               np.asarray(want_m["critic_loss"]), RTOL)


def test_sample_action_matches_jax():
    jhp, jstate = jax_sac_state(4)
    obs = np.random.default_rng(4).standard_normal((B, OBS)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    ja, jlogp = jnets.sample_action(jstate.actor, jnp.asarray(obs), key)
    actor = interop.to_tensors(to_np(jstate.actor), "cpu")
    eps = t(jax.random.normal(key, (B, ACT)))
    a, logp = nets.sample_action(actor, t(obs), eps)
    np.testing.assert_allclose(n(a), np.asarray(ja), RTOL, ATOL)
    np.testing.assert_allclose(n(logp), np.asarray(jlogp), RTOL, ATOL)
    np.testing.assert_allclose(
        n(nets.deterministic_action(actor, t(obs))),
        np.asarray(jnets.deterministic_action(jstate.actor,
                                              jnp.asarray(obs))),
        RTOL, ATOL)
    q = interop.to_tensors(to_np(jstate.q), "cpu")
    np.testing.assert_allclose(
        n(nets.min_q(q, t(obs), a)),
        np.asarray(jnets.min_q(jstate.q, jnp.asarray(obs), ja)), RTOL, ATOL)


def test_weighted_critic_loss_is_not_the_unweighted_one():
    """The weights reach the loss (and only the loss: ``td_abs`` stays
    the unweighted per-sample |TD|)."""
    jhp, jstate = jax_sac_state(5)
    hp = AlgoHP(hidden=jhp.hidden)
    update = sac.make_update_step(hp, OBS, ACT)
    batch, key = _batch(5, weight=True), jax.random.PRNGKey(7)
    out = {}
    for weighted in (False, True):
        state = interop.algo_state_from_numpy(to_np(jstate), "cpu")
        b = {k: t(v) for k, v in batch.items()
             if weighted or k != "weight"}
        _, out[weighted] = update(state, b, *_eps(key))
    assert float(out[True]["critic_loss"]) < float(out[False]["critic_loss"])
    torch.testing.assert_close(out[True]["td_abs"], out[False]["td_abs"],
                               rtol=0, atol=0)

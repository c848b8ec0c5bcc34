"""The slice as a whole: the port's trainer against the JAX package's
single-device fused megastep, from the same carried-across state and
with the same random draws.

JAX threefry and torch Philox never agree, so ``JaxDraws`` replays the
JAX trainer's key schedule and hands the port the very numbers the JAX
trainer draws. The schedule itself is checked first and exactly, so that
a wrong schedule fails loudly rather than as a tolerance miss. Both the
uniform and the prioritized (PER) megastep are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import (SMALL_HIDDEN, assert_tree_close,
                               assert_tree_equal, n, t, to_np)

import repro  # noqa: F401  (jax_threefry_partitionable, as in the trainer)
from repro.core import SpreezeConfig as JaxConfig
from repro.core import SpreezeTrainer as JaxTrainer
from repro.envs import make as jmake
from repro.replay import prioritized as jper
from repro.rl.base import AlgoHP as JaxHP
from repro_torch import interop
from repro_torch.core import SpreezeConfig, SpreezeTrainer
from repro_torch.kernels import replay_ops as rops
from repro_torch.replay import prioritized as per
from repro_torch.rl import AlgoHP

torch.set_num_threads(2)

# capacity 100 is not a multiple of the 32 rows a round writes, so ring
# writes wrap mid-batch; warmup 64 + 2 rounds overfill it
SMALL = dict(env_name="pendulum", algo="sac", num_envs=4, chunk_len=8,
             batch_size=64, replay_capacity=100, warmup_frames=64,
             updates_per_round=2, rounds_per_dispatch=2,
             eval_every_rounds=0, seed=0)
# float32 on both sides with sums taken in different orders (XLA vs
# PyTorch's CPU kernels), carried through 4 Adam steps and the env steps
# the updated actor takes: parameters move by ~lr = 3e-4 a step and agree
# to ~1e-6 of that; rows and rewards agree to a few ulps of their size
RTOL, ATOL = 1e-4, 1e-5


class JaxDraws:
    """Replays the JAX trainer's PRNG schedule as tensors for the port:
    per env step ``key, k_act, k_reset = split(key, 3)``
    (core/pipeline.py:415), the actor noise ``normal(k_act, (N, act))``
    (rl/networks.py:76) and one reset per env from ``split(k_reset, N)``
    (pipeline.py:419, envs/pendulum.py:33-35); per update ``key, k1, k2 =
    split(key, 3)`` (pipeline.py:461), ``randint(k1, (B,), 0,
    max(size, 1))`` (replay/buffer.py:166) and the two action noises of
    ``k1', k2' = split(k2)`` (rl/sac.py:43); per PER update the same
    split (pipeline.py:442), the Gumbel field of ``k1``
    (replay/prioritized.py:126-128) and the same two noises."""

    def __init__(self, key):
        self.key = key
        self.env = jmake("pendulum")

    def sampler_step(self, num_envs, act_dim):
        self.key, k_act, k_reset = jax.random.split(self.key, 3)
        eps = jax.random.normal(k_act, (num_envs, act_dim))
        fresh = jax.vmap(self.env.reset)(jax.random.split(k_reset,
                                                          num_envs))
        return t(eps), {"th": t(fresh["th"]), "thdot": t(fresh["thdot"])}

    def update(self, replay, batch_size, act_dim):
        self.key, k1, k2 = jax.random.split(self.key, 3)
        idx = jax.random.randint(k1, (batch_size,), 0,
                                 jnp.maximum(jnp.int32(int(replay.size)), 1))
        ka, kb = jax.random.split(k2)
        return (t(idx, torch.int32),
                t(jax.random.normal(ka, (batch_size, act_dim))),
                t(jax.random.normal(kb, (batch_size, act_dim))))

    def per_update(self, capacity, batch_size, act_dim):
        self.key, k1, k2 = jax.random.split(self.key, 3)
        gumbel = -jnp.log(-jnp.log(jax.random.uniform(
            k1, (capacity,), minval=1e-12, maxval=1.0)))
        ka, kb = jax.random.split(k2)
        return (t(gumbel),
                t(jax.random.normal(ka, (batch_size, act_dim))),
                t(jax.random.normal(kb, (batch_size, act_dim))))

    def eval_reset(self, n):
        raise AssertionError("eval is not part of the compared path")


def _configs(**kw):
    base = {**SMALL, **kw}
    return (JaxConfig(hp=JaxHP(hidden=SMALL_HIDDEN), **base),
            SpreezeConfig(hp=AlgoHP(hidden=SMALL_HIDDEN), device="cpu",
                          **{k: v for k, v in base.items()}))


def _carried(jtr):
    """The JAX trainer's state as numpy, before any donating call."""
    return (to_np(jtr.state), to_np(jtr.replay), to_np(jtr.env_states),
            jtr.key)


def _port(cfg, carried):
    state, replay, env_states, key = carried
    tr = SpreezeTrainer(cfg, draws=JaxDraws(key))
    tr.state = interop.algo_state_from_numpy(state, "cpu")
    tr.replay = (interop.prioritized_from_numpy(replay, "cpu")
                 if cfg.prioritized else
                 interop.replay_from_numpy(replay, "cpu"))
    tr.env_states = interop.to_tensors(env_states, "cpu")
    return tr


def test_replayed_draws_reproduce_a_jax_sampler_chunk():
    """With an all-zero actor the action is exactly tanh(eps), and half
    the envs end their episode on the first step, so the chunk exposes
    the actor noise and the reset draws directly."""
    jcfg, cfg = _configs()
    jtr = JaxTrainer(jcfg)
    actor = jax.tree.map(jnp.zeros_like, jtr.state.actor)
    env_states = dict(jtr.env_states)
    env_states["t"] = jnp.asarray([199, 3, 199, 3], jnp.int32)
    key = jtr.key
    draws = JaxDraws(key)
    replayed = [draws.sampler_step(4, 1) for _ in range(cfg.chunk_len)]
    states, exps, key_after, _ = jtr._sampler(actor, env_states, key)

    assert_tree_equal(np.asarray(key_after), np.asarray(draws.key))
    eps = np.stack([n(e) for e, _ in replayed])
    np.testing.assert_array_equal(
        np.asarray(exps["act"]).reshape(cfg.chunk_len, 4, 1),
        np.asarray(jnp.tanh(eps)))
    # envs 0 and 2 reset on step 0: their next observation's thdot is the
    # reset draw itself
    nxt = np.asarray(exps["next_obs"]).reshape(cfg.chunk_len, 4, 3)
    first = replayed[0][1]
    np.testing.assert_array_equal(nxt[0, [0, 2], 2],
                                  n(first["thdot"])[[0, 2]])
    assert np.asarray(exps["done"]).reshape(cfg.chunk_len, 4)[0].tolist() \
        == [1.0, 0.0, 1.0, 0.0]


def test_megastep_matches_jax():
    """JAX ``_warmup`` + one fused megastep (R=2 rounds, K=2 updates)
    against the port's, from the same state and draws."""
    jcfg, cfg = _configs()
    jtr = JaxTrainer(jcfg)
    carried = _carried(jtr)
    jtr._warmup()
    (jtr.state, jtr.replay, jtr.env_states, jtr.key,
     jmetrics) = jtr._megastep(jtr.state, jtr.replay, jtr.env_states,
                               jtr.key)

    tr = _port(cfg, carried)
    tr._warmup()
    metrics = tr.megastep()

    assert_tree_equal(np.asarray(jtr.key), np.asarray(tr.draws.key))
    want_r, got_r = to_np(jtr.replay), interop.replay_to_numpy(tr.replay)
    assert_tree_equal((want_r.ptr, want_r.size), (got_r["ptr"],
                                                  got_r["size"]))
    assert_tree_close(want_r.data, got_r["data"], RTOL, ATOL)
    want_s, got_s = to_np(jtr.state), interop.algo_state_to_numpy(tr.state)
    for name in ("actor", "q", "q_target", "log_alpha"):
        assert_tree_close(getattr(want_s, name), got_s[name], RTOL, ATOL)
    for name in ("opt_actor", "opt_q", "opt_alpha"):
        np.testing.assert_array_equal(getattr(want_s, name).step,
                                      got_s[name]["step"])
    np.testing.assert_array_equal(want_s.step, got_s["step"])
    want_e, got_e = to_np(jtr.env_states), interop.to_numpy(tr.env_states)
    np.testing.assert_array_equal(want_e["t"], got_e["t"])
    assert_tree_close({k: want_e[k] for k in ("th", "thdot")},
                      {k: got_e[k] for k in ("th", "thdot")}, RTOL, ATOL)
    for k in ("mean_rew", "critic_loss"):
        assert metrics[k].shape == (cfg.rounds_per_dispatch,)
        np.testing.assert_allclose(n(metrics[k]), np.asarray(jmetrics[k]),
                                   RTOL, ATOL, err_msg=k)



def test_megastep_equals_single_rounds():
    """An R-round megastep is R single-round calls (mirrors
    tests/test_megastep.py): same draws in, the same state out, bitwise."""
    from repro_torch.core.pipeline import Draws
    _, cfg = _configs(rounds_per_dispatch=3)
    trainers = [SpreezeTrainer(cfg) for _ in range(2)]
    for tr in trainers:
        tr.draws = Draws(tr.env, 1, 2, "cpu")
        tr._warmup()
    fused, single = trainers
    fused.megastep()
    rews = [single.megastep(rounds=1)["mean_rew"] for _ in range(3)]
    torch.testing.assert_close(fused.last_metrics["mean_rew"],
                               torch.cat(rews), rtol=0, atol=0)
    assert_tree_equal(interop.algo_state_to_numpy(fused.state),
                      interop.algo_state_to_numpy(single.state))
    assert_tree_equal(interop.replay_to_numpy(fused.replay),
                      interop.replay_to_numpy(single.replay))
    assert_tree_equal(interop.to_numpy(fused.env_states),
                      interop.to_numpy(single.env_states))


def test_train_reports_rates_and_inline_eval():
    _, cfg = _configs(eval_every_rounds=2, eval_episodes=2)
    tr = SpreezeTrainer(cfg)
    per_dispatch = cfg.num_envs * cfg.chunk_len * cfg.rounds_per_dispatch
    hist = tr.train(max_seconds=60.0, max_frames=64 + 3 * per_dispatch)
    assert tr.total_updates == 3 * 2 * 2
    assert hist.warmup_frames == 64
    assert hist.eval_rounds == [0, 2, 4]
    assert all(np.isfinite(hist.eval_returns))
    assert hist.sampling_hz > 0 and hist.update_hz > 0
    assert hist.update_frame_hz == hist.update_hz * cfg.batch_size


def test_replayed_per_draws_reproduce_a_jax_per_sample():
    """``JaxDraws.per_update`` follows the JAX PER update's schedule: the
    port, handed its Gumbel field, draws the rows ``per.sample`` draws
    from ``k1`` (bitwise, in order: batch row i meets noise row i), and
    the two noises are those of ``split(k2)``. Batch 16 of 64 live rows
    (a real selection) and 64 of 64 (the whole pool, ranked)."""
    jcfg, cfg = _configs(prioritized=True)
    jtr = JaxTrainer(jcfg)
    jtr._warmup()
    replay = interop.prioritized_from_numpy(to_np(jtr.replay), "cpu")
    for batch_size in (16, 64):
        draws = JaxDraws(jtr.key)
        gumbel, eps_next, eps_actor = draws.per_update(
            cfg.replay_capacity, batch_size, 1)
        key, k1, k2 = jax.random.split(jtr.key, 3)
        assert_tree_equal(np.asarray(key), np.asarray(draws.key))
        jbatch, jidx, jw = jper.sample(jtr.replay, k1, batch_size,
                                       alpha=cfg.per_alpha,
                                       beta=cfg.per_beta)
        batch, idx, w = per.sample(replay, gumbel, batch_size,
                                   alpha=cfg.per_alpha, beta=cfg.per_beta)
        np.testing.assert_array_equal(n(idx), np.asarray(jidx))
        assert_tree_equal(to_np(jbatch), interop.to_numpy(batch))
        np.testing.assert_allclose(n(w), np.asarray(jw), rtol=1e-6)
        ka, kb = jax.random.split(k2)
        np.testing.assert_array_equal(
            n(eps_next), np.asarray(jax.random.normal(ka, (batch_size, 1))))
        np.testing.assert_array_equal(
            n(eps_actor), np.asarray(jax.random.normal(kb, (batch_size, 1))))


# Smallest gap between neighbouring scores of a PER selection (the k + 1
# best, so the cut and the order both count) that the comparison below
# trusts: the two sides' priorities drift apart by ~1e-6 of their size
# over the megastep (a score by alpha times that), so a gap of 1e-4
# cannot flip. Where a smaller gap shows up, the test names the update
# instead of failing later as a tolerance miss. The PER comparison runs
# seed 1: seed 0's first PER update ranks two rows 7e-5 apart (harmless
# there, as every priority is still the exact max 1.0 on both sides, but
# below the margin), and seed 2 is ill-conditioned on both paths (its
# actor drifts ~7e-5 even under uniform replay). Seed 1's smallest gap
# over its 4 updates is 1.05e-3.
PER_MIN_GAP = 1e-4
PER_SEED = 1


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp", "pallas_interpret"])
def test_per_megastep_matches_jax(monkeypatch, use_pallas):
    """JAX ``_warmup`` + one fused PER megastep (R=2, K=2, batch 64 of a
    100-row pool: the first update draws every live row without cycling)
    against the port's, from the same state and draws; the JAX side on
    its jnp path and on its Pallas kernels in interpret mode. Equal
    priority vectors show that the same rows were drawn and updated."""
    jcfg, cfg = _configs(prioritized=True, seed=PER_SEED)
    jcfg.use_pallas = use_pallas
    jtr = JaxTrainer(jcfg)
    carried = _carried(jtr)
    jtr._warmup()
    (jtr.state, jtr.replay, jtr.env_states, jtr.key,
     jmetrics) = jtr._megastep(jtr.state, jtr.replay, jtr.env_states,
                               jtr.key)

    gaps = []
    sample = per.sample

    def recording(state, gumbel, batch_size, **kw):
        s = rops.per_scores_ref(state.priorities, gumbel, kw["alpha"])
        top = torch.sort(s, descending=True, stable=True)[0]
        top = top[:batch_size + 1][torch.isfinite(top[:batch_size + 1])]
        gaps.append(float((top[:-1] - top[1:]).min()))
        return sample(state, gumbel, batch_size, **kw)

    monkeypatch.setattr(per, "sample", recording)
    tr = _port(cfg, carried)
    tr._warmup()
    metrics = tr.megastep()
    assert len(gaps) == cfg.rounds_per_dispatch * cfg.updates_per_round
    near = [i for i, g in enumerate(gaps) if g < PER_MIN_GAP]
    assert not near, f"near-tie in the PER draw of update(s) {near}: {gaps}"

    assert_tree_equal(np.asarray(jtr.key), np.asarray(tr.draws.key))
    want_r = to_np(jtr.replay)
    got_r = interop.prioritized_to_numpy(tr.replay)
    assert_tree_equal((want_r.base.ptr, want_r.base.size),
                      (got_r["base"]["ptr"], got_r["base"]["size"]))
    assert_tree_close(want_r.base.data, got_r["base"]["data"], RTOL, ATOL)
    np.testing.assert_allclose(got_r["priorities"], want_r.priorities,
                               RTOL, ATOL)
    assert (got_r["priorities"] > 0).all()          # 100 of 100 written
    np.testing.assert_allclose(got_r["max_priority"], want_r.max_priority,
                               RTOL, ATOL)
    want_s, got_s = to_np(jtr.state), interop.algo_state_to_numpy(tr.state)
    for name in ("actor", "q", "q_target", "log_alpha"):
        assert_tree_close(getattr(want_s, name), got_s[name], RTOL, ATOL)
    np.testing.assert_array_equal(want_s.step, got_s["step"])
    for k in ("mean_rew", "critic_loss"):
        np.testing.assert_allclose(n(metrics[k]), np.asarray(jmetrics[k]),
                                   RTOL, ATOL, err_msg=k)

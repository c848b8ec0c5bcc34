"""Preemption-safe resume in the port (``train/resume.py``): the cases of
``tests/test_resume.py`` (bundle round trips, retention, refusal by name,
the bitwise preempt-and-resume contract, the async snapshot worker) on
the CPU, then the port's bundle held against the JAX package's: the same
keys, and a preempted-and-resumed port run against an uninterrupted JAX
run through ``JaxDraws``."""
import os
import tempfile

import numpy as np
import pytest
import torch

from test_torch_pipeline import (ATOL, RTOL, JaxDraws,
                                 _assert_trainers_close, _carried, _port)

import repro  # noqa: F401  (jax_threefry_partitionable, as in the trainer)
from repro.core import SpreezeConfig as JaxConfig
from repro.core import SpreezeTrainer as JaxTrainer
from repro.train import resume as jax_resume
from repro_torch._tree import tree_leaves
from repro_torch.core import SpreezeConfig, SpreezeTrainer, TrainHistory
from repro_torch.core import faults
from repro_torch.replay import prioritized as per
from repro_torch.train import checkpoint
from repro_torch.train import resume as resume_lib

torch.set_num_threads(2)

BASE = dict(env_name="pendulum", algo="sac", num_envs=2, batch_size=32,
            chunk_len=4, updates_per_round=2, warmup_frames=32,
            replay_capacity=256, eval_every_rounds=10**9, seed=3,
            rounds_per_dispatch=2, async_eval=False,
            snapshot_every_rounds=2, snapshot_min_interval_s=0.0)


def _cfg(snap_dir=None, **kw):
    return SpreezeConfig(**{**BASE, "snapshot_dir": snap_dir,
                            "device": "cpu", **kw})


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _train(tr, dispatches, **kw):
    # frames a dispatch: 2 envs x 4 steps x 2 rounds
    return tr.train(max_seconds=600, max_frames=dispatches * 16, **kw)


# --------------------------------------------------------------------------- #
# bundle mechanics
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_snapshot_roundtrip_restores_full_carry(tmp_path, algo):
    """TD3's ``opt_alpha`` is ``None``: the bundle writes no key for it
    and restores it as ``None``."""
    d = str(tmp_path)
    tr = SpreezeTrainer(_cfg(d, algo=algo))
    hist = _train(tr, 3)
    path = resume_lib.snapshot_now(tr, hist, round_i=6)
    tr2 = SpreezeTrainer(_cfg(d, algo=algo))
    meta = resume_lib.restore_trainer(tr2, path)
    assert _trees_equal(tr.state, tr2.state)
    assert _trees_equal(tr.replay, tr2.replay)
    assert _trees_equal(tr.env_states, tr2.env_states)
    assert torch.equal(tr.draws.get_state(), tr2.draws.get_state())
    assert tr2.total_frames == tr.total_frames
    assert tr2.total_updates == tr.total_updates
    assert meta["round_i"] == 6
    assert (tr2.state.opt_alpha is None) == (algo == "td3")


def test_retention_prunes_to_keep_and_latest_wins(tmp_path):
    d = str(tmp_path)
    tr = SpreezeTrainer(_cfg(d, keep_snapshots=2))
    hist = TrainHistory()
    tr._warmup()
    for r in (2, 4, 6, 8):
        resume_lib.snapshot_now(tr, hist, round_i=r)
    assert [r for r, _ in resume_lib.list_snapshots(d)] == [6, 8]
    assert resume_lib.latest(d) == resume_lib.snapshot_path(d, 8)


def test_config_mismatch_fails_by_name(tmp_path):
    d = str(tmp_path)
    tr = SpreezeTrainer(_cfg(d))
    tr._warmup()
    path = resume_lib.snapshot_now(tr, TrainHistory(), round_i=0)
    # same shapes, different math: the seed is in the fingerprint
    with pytest.raises(checkpoint.CheckpointError,
                       match="different trainer config"):
        resume_lib.restore_trainer(SpreezeTrainer(_cfg(d, seed=99)), path)


def test_shape_mismatch_fails_by_key(tmp_path):
    d = str(tmp_path)
    tr = SpreezeTrainer(_cfg(d))
    tr._warmup()
    path = resume_lib.snapshot_now(tr, TrainHistory(), round_i=0)
    with pytest.raises(checkpoint.CheckpointError) as ei:
        resume_lib.restore_trainer(
            SpreezeTrainer(_cfg(d, replay_capacity=512)), path)
    assert any(m.startswith("replay/.data/obs: shape")
               for m in ei.value.mismatched)


def test_restore_rejects_nonfinite_bundle(tmp_path):
    d = str(tmp_path)
    tr = SpreezeTrainer(_cfg(d))
    tr._warmup()
    tr.state = tr.state._replace(actor=faults.poison_actor(tr.state.actor))
    path = resume_lib.snapshot_now(tr, TrainHistory(), round_i=0)
    with pytest.raises(faults.FiniteGuardError, match="non-finite"):
        resume_lib.restore_trainer(SpreezeTrainer(_cfg(d)), path)


def test_hist_meta_roundtrip():
    hist = TrainHistory()
    hist.record_eval(1.0, -2.5, 100, 10, round_i=2)
    hist.record_eval(2.0, -1.5, 200, 20, round_i=4)
    hist.warmup_frames = 32
    hist2 = TrainHistory()
    resume_lib.hist_restore(hist2, resume_lib.hist_to_meta(hist))
    assert hist2.eval_returns == hist.eval_returns
    assert hist2.eval_rounds == hist.eval_rounds
    assert hist2.env_frames == hist.env_frames
    assert hist2.warmup_frames == 32


# --------------------------------------------------------------------------- #
# interrupt -> resume determinism (the contract)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_preempt_resume_bitwise_identical(fused):
    """Interrupt at round 6 of 12 and resume from the preemption
    snapshot: the state, the ring, the draw state, the counters and the
    recorded history equal those of the uninterrupted run, bit for bit."""
    with tempfile.TemporaryDirectory() as d_ref, \
            tempfile.TemporaryDirectory() as d_int:
        kw = dict(eval_every_rounds=4, fused=fused)
        tr_ref = SpreezeTrainer(_cfg(d_ref, **kw))
        hist_ref = _train(tr_ref, 6)

        tr_int = SpreezeTrainer(_cfg(
            d_int, fault_plan=faults.FaultPlan(preempt_round=6), **kw))
        with pytest.raises(faults.Preempted) as ei:
            _train(tr_int, 6)
        snap = ei.value.snapshot_path
        assert snap is not None and os.path.exists(snap)
        assert ei.value.round_i == 6

        tr_res = SpreezeTrainer(_cfg(d_int, **kw))
        hist_res = _train(tr_res, 6, resume_from=snap)

        assert _trees_equal(tr_ref.state, tr_res.state)
        assert _trees_equal(tr_ref.replay, tr_res.replay)
        assert _trees_equal(tr_ref.env_states, tr_res.env_states)
        assert torch.equal(tr_ref.draws.get_state(),
                           tr_res.draws.get_state())
        assert tr_ref.total_frames == tr_res.total_frames
        assert tr_ref.total_updates == tr_res.total_updates
        # the resumed run replays no eval round and loses none
        assert hist_res.eval_rounds == hist_ref.eval_rounds == [0, 4]
        assert hist_res.eval_returns == hist_ref.eval_returns
        assert hist_res.env_frames == hist_ref.env_frames
        assert hist_res.warmup_frames == hist_ref.warmup_frames


def test_preempt_resume_prioritized_draws_identical():
    """The same contract under PER: the priorities are in the bundle, so
    a draw after the resume picks the same rows with the same weights."""
    with tempfile.TemporaryDirectory() as d_ref, \
            tempfile.TemporaryDirectory() as d_int:
        tr_ref = SpreezeTrainer(_cfg(d_ref, prioritized=True))
        _train(tr_ref, 5)
        tr_int = SpreezeTrainer(_cfg(
            d_int, prioritized=True,
            fault_plan=faults.FaultPlan(preempt_round=4)))
        with pytest.raises(faults.Preempted) as ei:
            _train(tr_int, 5)
        tr_res = SpreezeTrainer(_cfg(d_int, prioritized=True))
        _train(tr_res, 5, resume_from=ei.value.snapshot_path)

        assert _trees_equal(tr_ref.state, tr_res.state)
        assert _trees_equal(tr_ref.replay, tr_res.replay)
        u = torch.rand(256, generator=torch.Generator().manual_seed(7))
        gumbel = -torch.log(-torch.log(u.clamp_(min=1e-12)))
        _, idx_ref, w_ref = per.sample(tr_ref.replay, gumbel, 32)
        _, idx_res, w_res = per.sample(tr_res.replay, gumbel, 32)
        assert torch.equal(idx_ref, idx_res)
        assert torch.equal(w_ref, w_res)


def test_async_periodic_snapshots_resumable(tmp_path):
    """The snapshot worker writes restorable bundles at the cadence
    while the loop goes on."""
    d = str(tmp_path)
    kw = dict(eval_every_rounds=2, async_eval=True, worker_heartbeat_s=0)
    cfg = _cfg(d, **kw)
    hist = SpreezeTrainer(cfg).train(max_seconds=60, max_frames=4 * 16)
    assert hist.runtime_stats.get("state_done", 0) >= 1
    snap = resume_lib.latest(d)
    assert snap is not None
    tr2 = SpreezeTrainer(_cfg(d, **kw))
    meta = resume_lib.restore_trainer(tr2, snap)
    assert tr2.total_frames >= cfg.warmup_frames
    assert meta["config_sig"] == resume_lib.config_sig(cfg)


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #

def _jax_cfg(snap_dir, **kw):
    return JaxConfig(**{**BASE, "snapshot_dir": snap_dir, **kw})


def _keys_under(path, prefixes=("state/", "replay/", "env_states/")):
    with np.load(path, allow_pickle=False) as data:
        return {k for k in data.files if k.startswith(prefixes)}


@pytest.mark.parametrize("kw", [dict(), dict(algo="td3"),
                                dict(prioritized=True)],
                         ids=["sac", "td3", "sac-per"])
def test_bundle_keys_equal_the_jax_bundles(tmp_path, kw):
    """A port bundle and a JAX bundle of the same config hold the same
    keys under ``state/``, ``replay/`` and ``env_states/`` (the port's
    draw state replaces the reference's ``key``)."""
    jtr = JaxTrainer(_jax_cfg(str(tmp_path / "jax"), **kw))
    jpath = jax_resume.snapshot_now(jtr, None, round_i=0)
    tr = SpreezeTrainer(_cfg(str(tmp_path / "port"), **kw))
    path = resume_lib.snapshot_now(tr, None, round_i=0)
    assert _keys_under(path) == _keys_under(jpath)
    assert _keys_under(path, ("draws",)) == {"draws"}
    assert _keys_under(jpath, ("key",)) == {"key"}


def test_preempted_and_resumed_port_run_matches_an_uninterrupted_jax_run(
        tmp_path):
    """The JAX trainer runs 6 dispatches without a stop; the port, from
    the same carried-across state and draws (``JaxDraws``), is preempted
    at round 6 and resumed from its snapshot. The parameters and the
    ring agree within the tolerance of ``test_torch_pipeline.py``, the
    key and the counters exactly, and both score the same eval rounds."""
    jtr = JaxTrainer(_jax_cfg(None))
    carried = _carried(jtr)
    jhist = jtr.train(max_seconds=600, max_frames=6 * 16)

    d = str(tmp_path)
    tr_int = _port(_cfg(d, fault_plan=faults.FaultPlan(preempt_round=6)),
                   carried)
    with pytest.raises(faults.Preempted) as ei:
        _train(tr_int, 6)
    fresh = JaxTrainer(_jax_cfg(None))
    tr_res = SpreezeTrainer(_cfg(d), draws=JaxDraws.of(fresh))
    hist = _train(tr_res, 6, resume_from=ei.value.snapshot_path)

    _assert_trainers_close(jtr, tr_res)
    assert (tr_res.total_frames, tr_res.total_updates) == (
        jtr.total_frames, jtr.total_updates)
    assert hist.eval_rounds == jhist.eval_rounds == [0]
    np.testing.assert_allclose(hist.eval_returns, jhist.eval_returns, RTOL,
                               ATOL)

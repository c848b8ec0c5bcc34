"""Fault injection in the port (``core/faults.py``): the cases of
``tests/test_faults.py`` from the finite guard on, on the CPU. Every
injection point recovers (supervised retry, watchdog replacement,
rollback) or fails loudly (a fatal error, a spent budget). The port's
``FaultClock`` fires exactly as the reference's for the same plan and the
same calls, and a NaN rollback in the port retrains as the JAX trainer's
does."""
import tempfile
import warnings

import numpy as np
import pytest
import torch

from test_torch_pipeline import _assert_trainers_close, _carried, _port
from test_torch_pipeline import ATOL, RTOL

import repro  # noqa: F401  (jax_threefry_partitionable, as in the trainer)
from repro.core import SpreezeConfig as JaxConfig
from repro.core import SpreezeTrainer as JaxTrainer
from repro.core import faults as jax_faults
from repro_torch.core import SpreezeConfig, SpreezeTrainer
from repro_torch.core import faults

torch.set_num_threads(2)


BASE = dict(env_name="pendulum", algo="sac", num_envs=2, batch_size=32,
            chunk_len=4, updates_per_round=2, warmup_frames=32,
            replay_capacity=256, eval_every_rounds=10**9, seed=3,
            rounds_per_dispatch=2, snapshot_min_interval_s=0.0)


def _cfg(**kw):
    return SpreezeConfig(**{**BASE, "device": "cpu", **kw})


# --------------------------------------------------------------------------- #
# finite guard units
# --------------------------------------------------------------------------- #

def test_tree_finite_and_poison():
    clean = {"a": torch.ones(3), "n": torch.arange(4)}
    flag = faults.tree_finite(clean)
    assert flag.dtype == torch.bool and flag.shape == () and bool(flag)
    assert faults.finite_guard(clean)
    assert not faults.finite_guard({"a": torch.tensor([1.0, float("nan")])})
    poisoned = faults.poison_actor(clean)
    assert not faults.finite_guard(poisoned)
    # int leaves are untouched (NaN has no integer encoding), and the
    # poisoned leaf is a copy: the original keeps its values
    assert poisoned["n"] is clean["n"]
    assert faults.finite_guard(clean)


def test_tree_finite_walks_namedtuples_and_skips_none():
    tr = SpreezeTrainer(_cfg())
    state = tr.state._replace(opt_alpha=None)
    assert faults.finite_guard((state, tr.replay, None))
    state = state._replace(actor=faults.poison_actor(state.actor))
    assert not faults.finite_guard((state, tr.replay, None))


def test_fault_clock_fires_exactly_repeat_times():
    plan = faults.FaultPlan(ssd_oserror_rounds=(4,), ssd_oserror_repeat=2,
                            nan_round=6)
    clock = faults.FaultClock(plan)
    for _ in range(2):
        with pytest.raises(OSError):
            clock.ssd_oserror(4)
    clock.ssd_oserror(4)             # budget spent: no raise
    clock.ssd_oserror(2)             # unscheduled round: no raise
    assert clock.nan(5) is False     # not reached yet
    assert clock.nan(7) is True      # the first round index >= 6
    assert clock.nan(7) is False     # consumed: a rollback replay is safe


def _fires(clock, calls):
    """What each call does: "raise <class>", True/False, or None."""
    out = []
    for point, round_i in calls:
        try:
            out.append(getattr(clock, point)(round_i))
        except (OSError, ValueError) as e:
            out.append(f"raise {type(e).__name__}")
    return out


@pytest.mark.parametrize("plan_kw", [
    dict(ssd_oserror_rounds=(2, 4), ssd_oserror_repeat=2, preempt_round=6),
    dict(eval_error_rounds=(2,), eval_error_repeat=3, nan_round=4),
    dict(eval_error_rounds=(0, 2), eval_error_transient=False,
         eval_hang_rounds=(4,), hang_seconds=0.0, nan_round=0),
], ids=["ssd-preempt", "eval-nan", "fatal-hang"])
def test_fault_clock_fires_as_the_references(plan_kw):
    calls = [(p, r) for r in range(0, 10, 2)
             for p in ("ssd_oserror", "eval_fault", "preempt", "nan",
                       "ssd_oserror", "eval_fault", "eval_fault")]
    ours = _fires(faults.FaultClock(faults.FaultPlan(**plan_kw)), calls)
    theirs = _fires(jax_faults.FaultClock(jax_faults.FaultPlan(**plan_kw)),
                    calls)
    assert ours == theirs
    assert any(f not in (None, False) for f in ours)


# --------------------------------------------------------------------------- #
# trainer-level injections (each point recovers or fails loudly)
# --------------------------------------------------------------------------- #

def test_ssd_oserror_injection_recovers():
    """One injected SSD write failure: the supervisor retries the same
    snapshot, eval still lands, the restart is recorded."""
    plan = faults.FaultPlan(ssd_oserror_rounds=(2,))
    cfg = _cfg(eval_every_rounds=2, async_eval=True, weight_sync="ssd",
               fault_plan=plan, worker_heartbeat_s=0)
    hist = SpreezeTrainer(cfg).train(max_seconds=60, max_frames=8 * 8)
    s = hist.runtime_stats
    assert s["worker_restarts"] >= 1
    assert s["degraded"] == []
    assert len(hist.eval_returns) >= 1


def test_eval_transient_injection_recovers():
    plan = faults.FaultPlan(eval_error_rounds=(2,))
    cfg = _cfg(eval_every_rounds=2, async_eval=True, fault_plan=plan,
               worker_heartbeat_s=0)
    hist = SpreezeTrainer(cfg).train(max_seconds=60, max_frames=8 * 8)
    s = hist.runtime_stats
    assert s["worker_restarts"] >= 1
    assert s["degraded"] == []
    assert 2 in hist.eval_rounds     # the faulted round was retried


def test_eval_fatal_injection_fails_loudly():
    """A programming error in a worker kills the run, supervised or
    not: retrying a bug would hide it."""
    plan = faults.FaultPlan(eval_error_rounds=(2,),
                            eval_error_transient=False)
    cfg = _cfg(eval_every_rounds=2, async_eval=True, fault_plan=plan,
               worker_heartbeat_s=0)
    with pytest.raises(RuntimeError, match="worker failed") as ei:
        SpreezeTrainer(cfg).train(max_seconds=60, max_frames=8 * 8)
    assert isinstance(ei.value.__cause__, ValueError)


def test_eval_hang_injection_watchdog_recovers():
    """A hung eval worker is found by its heartbeat and replaced; the run
    finishes with the hang recorded."""
    plan = faults.FaultPlan(eval_hang_rounds=(2,), hang_seconds=3.0)
    cfg = _cfg(eval_every_rounds=2, async_eval=True, fault_plan=plan,
               worker_heartbeat_s=0.2)
    hist = SpreezeTrainer(cfg).train(max_seconds=60, max_frames=8 * 8)
    s = hist.runtime_stats
    assert s["worker_hangs"] >= 1
    assert s["worker_restarts"] >= 1


def test_nan_injection_rolls_back_with_lr_backoff():
    with tempfile.TemporaryDirectory() as d:
        plan = faults.FaultPlan(nan_round=6)
        cfg = _cfg(async_eval=False, snapshot_dir=d,
                   snapshot_every_rounds=2, fault_plan=plan)
        tr = SpreezeTrainer(cfg)
        lr0 = tr.hp.lr
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            hist = tr.train(max_seconds=120, max_frames=16 * 8)
        msgs = [str(x.message) for x in w]
        assert hist.runtime_stats["rollbacks"] == 1
        assert tr.hp.lr == pytest.approx(lr0 * cfg.rollback_lr_backoff)
        assert faults.finite_guard(tr.state.actor)
        assert tr.total_frames == 16 * 8      # recovered to the full budget
        assert any("rolled back" in m for m in msgs)
        # the poisoned bundle in flight was vetted out, never written
        assert any("skipping snapshot" in m for m in msgs)


def test_nan_without_snapshot_fails_loudly():
    plan = faults.FaultPlan(nan_round=4)
    cfg = _cfg(async_eval=False, fault_plan=plan)   # no snapshot_dir
    with pytest.raises(faults.FiniteGuardError, match="non-finite"):
        SpreezeTrainer(cfg).train(max_seconds=120, max_frames=16 * 8)


def test_rollback_budget_exhaustion_fails_loudly():
    """max_rollbacks=0: the first non-finite carry raises instead of
    looping rollback forever."""
    with tempfile.TemporaryDirectory() as d:
        plan = faults.FaultPlan(nan_round=4)
        cfg = _cfg(async_eval=False, snapshot_dir=d,
                   snapshot_every_rounds=2, fault_plan=plan,
                   max_rollbacks=0)
        with pytest.raises(faults.FiniteGuardError, match="non-finite"):
            SpreezeTrainer(cfg).train(max_seconds=120, max_frames=16 * 8)


def test_nan_rollback_retrains_as_the_jax_trainer_does(tmp_path):
    """The JAX trainer and the port, from the same carried-across state
    and draws (``JaxDraws``), meet the same NaN at round 6 with snapshots
    every 2 rounds. Each rolls back once to its latest finite bundle,
    halves its learning rate and trains on to the budget: the parameters
    and the ring agree within the tolerance of ``test_torch_pipeline.py``
    (an update still at the old rate would not), the key, the counters,
    the eval rounds and the rollback count exactly."""
    kw = dict(async_eval=False, snapshot_every_rounds=2,
              eval_every_rounds=4)
    jtr = JaxTrainer(JaxConfig(**{**BASE, **kw,
                                  "snapshot_dir": str(tmp_path / "jax"),
                                  "fault_plan": jax_faults.FaultPlan(
                                      nan_round=6)}))
    carried = _carried(jtr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jhist = jtr.train(max_seconds=120, max_frames=12 * 16)
    tr = _port(_cfg(**kw, snapshot_dir=str(tmp_path / "port"),
                    fault_plan=faults.FaultPlan(nan_round=6)), carried)
    lr0 = tr.hp.lr
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        hist = tr.train(max_seconds=120, max_frames=12 * 16)

    assert any("rolled back" in str(x.message) for x in w)
    assert hist.runtime_stats["rollbacks"] == jhist.runtime_stats[
        "rollbacks"] == 1
    assert tr.hp.lr == pytest.approx(jtr.hp.lr)
    assert tr.hp.lr == pytest.approx(lr0 * tr.cfg.rollback_lr_backoff)
    _assert_trainers_close(jtr, tr)
    assert (tr.total_frames, tr.total_updates) == (
        jtr.total_frames, jtr.total_updates)
    assert hist.eval_rounds == jhist.eval_rounds
    np.testing.assert_allclose(hist.eval_returns, jhist.eval_returns, RTOL,
                               ATOL)

"""The port's host async runtime (``core/runtime.py``) and the trainer's
async eval/viz/SSD path: the cases of ``tests/test_runtime.py`` on the
port. Latest-wins mailboxes, round-ordered thread-safe recording, the
solved event, the SSD channel, error propagation, supervision, and async
eval equal to inline eval round by round. Waits are on events with short
timeouts."""
import glob
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import SpreezeConfig, SpreezeTrainer, TrainHistory
from repro_torch.core.runtime import (HostRuntime, Snapshot, SnapshotMailbox,
                                      SupervisorPolicy)
from repro_torch.rl import AlgoHP

torch.set_num_threads(2)

WAIT_S = 5.0


def _snap(round_i, actor, **kw):
    base = dict(round_i=round_i, actor=actor, eval_key=round_i,
                viz_key=round_i, t=float(round_i), frames=round_i * 10,
                steps=round_i, want_eval=True, want_viz=False)
    base.update(kw)
    return Snapshot(**base)


def _wait_until(pred, timeout=WAIT_S):
    """Poll ``pred`` until it holds or ``timeout`` passes."""
    deadline = time.monotonic() + timeout
    tick = threading.Event()
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting"
        tick.wait(0.005)


def test_mailbox_latest_wins():
    cond = threading.Condition()
    box = SnapshotMailbox(cond, "t")
    box.publish(_snap(0, "a"))
    box.publish(_snap(1, "b"))       # replaces the unconsumed round 0
    assert box.published == 2 and box.dropped == 1
    with cond:
        item = box._pop_locked()
    assert item.round_i == 1 and box.empty


def test_runtime_matches_inline_and_orders_rounds():
    hist = TrainHistory()

    def eval_fn(actor, key):
        return float(actor) * 2.0 + float(key)

    r = HostRuntime(eval_fn=eval_fn, hist=hist)
    snaps = [_snap(i, float(i) + 0.5) for i in range(0, 10, 2)]
    for s in snaps:
        r.publish(s)
        r.drain()                    # no latest-wins drops: score each one
    r.close()
    assert hist.eval_returns == [eval_fn(s.actor, s.eval_key) for s in snaps]
    assert hist.eval_rounds == [s.round_i for s in snaps]
    assert hist.env_frames == [s.frames for s in snaps]
    assert r.stats()["eval_done"] == len(snaps)


def test_runtime_two_workers_record_in_round_order():
    """Round 0 finishes after round 2; the history still records round 0
    first."""
    hist = TrainHistory()
    claimed, release = threading.Event(), threading.Event()

    def eval_fn(actor, key):
        if actor == "slow":
            claimed.set()
            release.wait(WAIT_S)
        return float(key)

    r = HostRuntime(eval_fn=eval_fn, hist=hist, eval_workers=2)
    r.publish(_snap(0, "slow"))
    assert claimed.wait(WAIT_S)      # worker A holds round 0
    r.publish(_snap(2, "fast"))
    _wait_until(lambda: len(hist.eval_returns) == 1)   # round 2 first...
    assert hist.eval_rounds == [2]
    release.set()
    r.close()
    assert hist.eval_rounds == [0, 2]                  # ...recorded in order
    assert hist.eval_returns == [0.0, 2.0]


def test_runtime_latest_wins_drops_stale_snapshots():
    hist = TrainHistory()
    claimed, gate = threading.Event(), threading.Event()

    def eval_fn(actor, key):
        claimed.set()
        gate.wait(WAIT_S)
        return float(key)

    r = HostRuntime(eval_fn=eval_fn, hist=hist)
    r.publish(_snap(0, "x"))
    assert claimed.wait(WAIT_S)      # the worker holds round 0
    r.publish(_snap(1, "x"))
    r.publish(_snap(2, "x"))         # replaces round 1 in the mailbox
    gate.set()
    r.close()
    assert hist.eval_rounds == [0, 2]
    assert r.stats()["eval_dropped"] == 1


def test_runtime_solved_event_carries_publish_time():
    r = HostRuntime(eval_fn=lambda a, k: 100.0, hist=TrainHistory(),
                    target_return=50.0)
    r.publish(_snap(4, "x", t=7.25))
    r.drain()
    assert r.solved.is_set()
    assert r.solved_time == 7.25
    r.close()


def test_runtime_worker_error_reraised_in_train_thread():
    def eval_fn(actor, key):
        raise ValueError("boom")

    r = HostRuntime(eval_fn=eval_fn, hist=TrainHistory())
    r.publish(_snap(0, "x"))
    with pytest.raises(RuntimeError) as ei:
        r.close()
    assert isinstance(ei.value.__cause__, ValueError)


def test_runtime_ssd_channel_materializes_once_per_snapshot():
    """One save/restore a snapshot, fanned out to eval and viz alike."""
    calls, seen = [], {}

    def materialize(actor):
        calls.append(actor)
        return ("materialized", actor)

    def eval_fn(actor, key):
        seen["eval"] = actor
        return 0.0

    def viz_fn(actor, key, round_i):
        seen["viz"] = actor

    r = HostRuntime(eval_fn=eval_fn, viz_fn=viz_fn, hist=TrainHistory(),
                    materialize_fn=materialize)
    r.publish(_snap(3, "weights", want_viz=True))
    r.close()
    assert calls == ["weights"]
    assert seen["eval"] is seen["viz"] == ("materialized", "weights")


def _mk_cfg(**kw):
    base = dict(env_name="pendulum", num_envs=2, batch_size=32,
                chunk_len=4, updates_per_round=1, warmup_frames=32,
                replay_capacity=512, eval_every_rounds=2, eval_episodes=2,
                rounds_per_dispatch=2, seed=11, hp=AlgoHP(hidden=(32, 32)),
                device="cpu")
    base.update(kw)
    return SpreezeConfig(**base)


@pytest.mark.parametrize("weight_sync", ["live", "ssd"])
def test_trainer_async_matches_inline_eval_returns(weight_sync):
    """Driven by max_frames (a fixed round count), the async runtime
    scores the same round/draws pairs as the inline path: the same
    return for every round it scores (the draws are keyed by round), and
    the final window is always scored."""
    def run(async_eval):
        tr = SpreezeTrainer(_mk_cfg(async_eval=async_eval,
                                    weight_sync=weight_sync))
        # warmup 32 frames + 3 fused megasteps of 16 frames
        return tr.train(max_seconds=1e9, max_frames=32 + 16 * 3)

    inline, asyn = run(False), run(True)
    assert inline.eval_rounds == [0, 2, 4]
    assert inline.runtime_stats == {} and asyn.runtime_stats["eval_done"]
    assert set(asyn.eval_rounds) <= set(inline.eval_rounds)
    assert asyn.eval_rounds[-1] == inline.eval_rounds[-1]
    for r, ret in zip(asyn.eval_rounds, asyn.eval_returns):
        assert ret == inline.eval_returns[inline.eval_rounds.index(r)]
    assert asyn.eval_rounds == sorted(asyn.eval_rounds)


def test_trainer_async_ssd_weight_sync_off_thread(monkeypatch):
    """weight_sync="ssd" under the async runtime: the saves happen on the
    channel worker, never on the train thread."""
    from repro_torch.train import checkpoint
    train_thread = threading.current_thread()
    save_threads = []
    orig = checkpoint.save

    def spying_save(path, tree, metadata=None):
        save_threads.append(threading.current_thread())
        return orig(path, tree, metadata)

    monkeypatch.setattr(checkpoint, "save", spying_save)
    tr = SpreezeTrainer(_mk_cfg(weight_sync="ssd"))
    hist = tr.train(max_seconds=1e9, max_frames=32 + 16 * 2)
    assert len(hist.eval_returns) >= 1
    assert save_threads, "SSD channel never wrote weights"
    assert all(t is not train_thread for t in save_threads)


def test_trainer_async_rejects_sync_mode():
    with pytest.raises(ValueError):
        SpreezeTrainer(_mk_cfg(async_eval=True, sync_mode=True,
                               fused=False))
    # auto mode resolves to inline under the sync ablation
    tr = SpreezeTrainer(_mk_cfg(sync_mode=True, fused=False))
    assert not tr.use_async_eval


def test_trainer_async_visualization_process(tmp_path):
    """The viz worker writes one ``traj_<round>.npz`` a viz window, each
    a whole episode: obs (200, 3), act (200, 1), rew (200,)."""
    tr = SpreezeTrainer(_mk_cfg(viz_every_rounds=2, viz_dir=str(tmp_path)))
    hist = tr.train(max_seconds=1e9, max_frames=32 + 16 * 2)
    trajs = sorted(glob.glob(str(tmp_path / "traj_*.npz")))
    assert trajs, "async viz worker wrote no trajectories"
    assert hist.runtime_stats["viz_done"] == len(trajs)
    d = np.load(trajs[0])
    assert d["obs"].shape == (200, 3) and d["act"].shape == (200, 1)
    assert d["rew"].shape == (200,) and np.isfinite(d["rew"]).all()


def test_close_timeout_names_stuck_worker():
    """A worker that cannot join within close()'s timeout raises naming
    the thread. Supervision off, so nothing replaces it."""
    claimed, release = threading.Event(), threading.Event()

    def eval_fn(actor, key):
        claimed.set()
        release.wait(30.0)
        return 0.0

    r = HostRuntime(eval_fn=eval_fn, hist=TrainHistory(),
                    policy=SupervisorPolicy(supervise=False,
                                            heartbeat_timeout_s=0))
    r.publish(_snap(0, "x"))
    assert claimed.wait(WAIT_S)      # the worker holds the snapshot
    try:
        with pytest.raises(RuntimeError, match="eval.*failed to join"):
            r.close(timeout=0.3)
    finally:
        release.set()                # unstick for teardown


def test_close_succeeds_after_hang_when_watchdog_retired_thread():
    """With supervision on, a thread the watchdog retired is left out of
    close()'s leak check: the run ends cleanly despite the hang."""
    release = threading.Event()

    def eval_fn(actor, key):
        if actor == "hang":
            release.wait(30.0)
        return 0.0

    r = HostRuntime(eval_fn=eval_fn, hist=TrainHistory(),
                    policy=SupervisorPolicy(max_restarts=3,
                                            backoff_base_s=0.001,
                                            heartbeat_timeout_s=0.15))
    r.publish(_snap(0, "hang"))
    _wait_until(lambda: r.stats()["worker_hangs"] >= 1, timeout=10.0)
    try:
        r.close(timeout=1.0)         # must not raise: the thread is retired
    finally:
        release.set()
    assert r.stats()["worker_hangs"] >= 1


def test_transient_errors_retry_then_degrade():
    """A transient OSError is retried on the same snapshot within the
    budget; once the budget is spent the consumer degrades (training goes
    on, its snapshots are dropped and counted)."""
    fails = {"left": 2}

    def eval_fn(actor, key):
        if actor == "flaky" and fails["left"]:
            fails["left"] -= 1
            raise OSError("busy")
        if actor == "broken":
            raise OSError("gone")
        return 1.0

    hist = TrainHistory()
    r = HostRuntime(eval_fn=eval_fn, hist=hist,
                    policy=SupervisorPolicy(max_restarts=3,
                                            backoff_base_s=0.001,
                                            heartbeat_timeout_s=0))
    r.publish(_snap(0, "flaky"))
    r.drain()
    assert hist.eval_rounds == [0] and r.stats()["worker_restarts"] == 2
    r.publish(_snap(1, "broken"))
    r.drain()
    assert r.stats()["degraded"] == ["eval"]
    r.publish(_snap(2, "fine"))
    r.close()
    assert hist.eval_rounds == [0]
    assert r.stats()["degraded_dropped"] == 1

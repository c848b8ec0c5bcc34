"""``SpreezeConfig.sanitize`` in the port: the cases of
``tests/test_sanitize.py`` on the CPU. On the card the scope runs a
dispatch under ``torch.cuda.set_sync_debug_mode("error")``
(``test_torch_cuda.py`` checks that); on the CPU no such mode exists, so
the scope does its finite check (the reference's ``debug_nans``) and
holds the gate that keeps the workers' host reads out of a sanitized
dispatch."""
import pytest
import torch

from repro_torch.core import SpreezeConfig, SpreezeTrainer, faults
from repro_torch.core import pipeline

torch.set_num_threads(2)


def _cfg(**kw):
    base = dict(env_name="pendulum", algo="sac", num_envs=2, batch_size=32,
                chunk_len=4, updates_per_round=2, warmup_frames=32,
                replay_capacity=256, eval_every_rounds=10**9, seed=3,
                device="cpu")
    base.update(kw)
    return SpreezeConfig(**base)


def _gate_free() -> bool:
    if not pipeline._SYNC_GATE.acquire(blocking=False):
        return False
    pipeline._SYNC_GATE.release()
    return True


def test_sanitize_scope_holds_the_gate_and_checks_the_carry():
    tr = SpreezeTrainer(_cfg(sanitize=True))
    tr._warmup()
    with tr._sanitize_scope():
        assert not _gate_free()
        tr.megastep()
    assert _gate_free()
    with pytest.raises(FloatingPointError, match="non-finite"):
        with tr._sanitize_scope():
            tr.state = tr.state._replace(
                actor=faults.poison_actor(tr.state.actor))
    assert _gate_free()             # scoped: nothing leaks past the with


def test_sanitize_scope_raises_the_dispatchs_own_error_first():
    """A dispatch that raises keeps its error: the finite check runs only
    after a clean exit."""
    tr = SpreezeTrainer(_cfg(sanitize=True))
    tr.state = tr.state._replace(actor=faults.poison_actor(tr.state.actor))
    with pytest.raises(KeyError, match="boom"):
        with tr._sanitize_scope():
            raise KeyError("boom")
    assert _gate_free()


def test_sanitize_scope_failure_unwinds_the_gate(monkeypatch):
    """If entering the scope fails partway (the debug mode cannot be
    set), the gate already taken is released instead of leaking."""
    tr = SpreezeTrainer(_cfg(sanitize=True))

    def boom(device, mode):
        raise RuntimeError("sync debug mode unavailable")

    monkeypatch.setattr(pipeline, "sync_debug_mode", boom)
    with pytest.raises(RuntimeError, match="sync debug mode unavailable"):
        tr._sanitize_scope()
    assert _gate_free()


def test_sanitize_scope_noop_when_off():
    tr = SpreezeTrainer(_cfg())
    tr.state = tr.state._replace(actor=faults.poison_actor(tr.state.actor))
    with tr._sanitize_scope():
        assert _gate_free()
    assert _gate_free()


@pytest.mark.parametrize("kw", [dict(fused=True), dict(fused=False),
                                dict(transfer="queue", queue_size=64)],
                         ids=["fused", "eager", "queue"])
def test_sanitize_train_smoke(kw):
    """A sanitize=True train() completes on the fused, eager and queue
    paths, with eval on the async workers."""
    tr = SpreezeTrainer(_cfg(sanitize=True, rounds_per_dispatch=2,
                             eval_every_rounds=2, eval_episodes=1, **kw))
    hist = tr.train(max_seconds=15.0, max_frames=32 + 6 * 16)
    assert hist.sampling_hz > 0 and hist.update_hz > 0
    assert hist.eval_returns        # eval stayed outside the scope
    assert _gate_free()

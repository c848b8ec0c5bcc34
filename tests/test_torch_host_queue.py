"""The port's host queue (``replay/host_queue.py``) and queue transfer
(``core/transfer.py``) against the JAX package's, over the same sequence
of puts: the same drained batches, drops, loss and ring contents."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import n, t, to_np

import repro  # noqa: F401
from repro.core.transfer import QueueTransfer as JaxQueueTransfer
from repro.core.transfer import make_transfer as jax_make_transfer
from repro.replay import buffer as jrb
from repro.replay.host_queue import HostQueue as JaxHostQueue
from repro_torch import interop
from repro_torch.core.transfer import (QueueTransfer, SharedTransfer,
                                       make_transfer)
from repro_torch.replay import buffer as rb
from repro_torch.replay.host_queue import HostQueue

torch.set_num_threads(2)

# chunk sizes that fill the queue unevenly: some puts fit, some overflow
SIZES = [7, 12, 3, 16, 9, 1, 14, 5, 11, 8, 2, 13]
QUEUE_SIZE = 24


def _chunk(rng, rows):
    return {"obs": rng.standard_normal((rows, 3)).astype(np.float32),
            "act": rng.standard_normal((rows, 1)).astype(np.float32),
            "rew": rng.standard_normal(rows).astype(np.float32)}


@pytest.mark.parametrize("min_frames", [0, 10, 20])
def test_host_queue_matches_jax(min_frames):
    """Puts and drains in turn (a drain after every third put): each put
    is taken or dropped alike, each drain returns the same rows (or
    nothing below ``min_frames``), and the counters agree."""
    rng = np.random.default_rng(min_frames)
    jq, q = JaxHostQueue(QUEUE_SIZE), HostQueue(QUEUE_SIZE, "cpu")
    drains = 0
    for i, rows in enumerate(SIZES):
        chunk = _chunk(rng, rows)
        assert q.put({k: t(v) for k, v in chunk.items()}) == jq.put(
            {k: jnp.asarray(v) for k, v in chunk.items()})
        if i % 3 == 2:
            want, got = jq.drain(min_frames), q.drain(min_frames)
            assert (want is None) == (got is None)
            if want is not None:
                drains += 1
                assert set(got) == set(want)
                for k in want:
                    assert got[k].dtype == torch.float32
                    np.testing.assert_array_equal(n(got[k]),
                                                  np.asarray(want[k]))
    assert drains >= 2
    assert (q.frames_offered, q.frames_dropped) == (jq.frames_offered,
                                                    jq.frames_dropped)
    assert q.frames_dropped > 0
    assert q.transmission_loss == jq.transmission_loss
    assert len(q.cycle_times) == len(jq.cycle_times) == drains - 1
    assert q.put_time > 0 and q.drain_time > 0
    assert q.transfer_cycle > 0


def test_host_queue_drops_before_any_copy(monkeypatch):
    """A put that would overflow the queue is counted and dropped without
    copying the batch to the host."""
    q = HostQueue(10, "cpu")
    copies = []

    class Spy(torch.Tensor):
        def cpu(self, *a, **kw):
            copies.append(self.shape[0])
            return super().cpu(*a, **kw)

    def batch(rows):
        return {"obs": torch.zeros(rows, 3).as_subclass(Spy)}

    assert q.put(batch(6))
    assert not q.put(batch(5))            # 6 + 5 > 10: dropped, no copy
    assert copies == [6]
    assert (q.frames_offered, q.frames_dropped) == (11, 5)
    assert q.drain() is not None and q.drain() is None


def test_queue_transfer_matches_jax():
    """``QueueTransfer`` between sampler and ring: pushes stage rows on the
    host, a flush writes once half the queue is full (a forced one
    whatever is there), and the ring, its counters and the stats agree
    with the reference's after every step."""
    rng = np.random.default_rng(0)
    fields = {"obs": (3,), "act": (1,), "rew": ()}
    jspecs = {k: (s, jnp.float32) for k, s in fields.items()}
    specs = {k: (s, torch.float32) for k, s in fields.items()}
    jtr, tr = JaxQueueTransfer(QUEUE_SIZE), QueueTransfer(QUEUE_SIZE,
                                                          device="cpu")
    assert tr.drain_min == jtr.drain_min == QUEUE_SIZE // 2
    jreplay = jrb.init_replay(24, jspecs)
    replay = rb.init_replay(24, specs, "cpu")
    for i, rows in enumerate(SIZES):
        chunk = _chunk(rng, rows)
        jreplay = jtr.push(jreplay, {k: jnp.asarray(v)
                                     for k, v in chunk.items()})
        replay = tr.push(replay, {k: t(v) for k, v in chunk.items()})
        if i % 3 != 2:
            continue                 # a flush after every third push
        force = i == len(SIZES) - 1
        jreplay = jtr.flush(jreplay, force=force)
        replay = tr.flush(replay, force=force)
        want, got = to_np(jreplay), interop.replay_to_numpy(replay)
        assert (int(got["ptr"]), int(got["size"])) == (int(want.ptr),
                                                       int(want.size))
        for k in fields:
            np.testing.assert_array_equal(got["data"][k], want.data[k])
    assert tr.q._frames_in_queue == jtr.q._frames_in_queue == 0
    stats, jstats = tr.stats(), jtr.stats()
    assert set(stats) == set(jstats)
    assert stats["transmission_loss"] == jstats["transmission_loss"] > 0
    assert stats["blocked_time_s"] > 0


def test_make_transfer_kinds():
    assert isinstance(make_transfer("shared"), SharedTransfer)
    q = make_transfer("queue", 64, device="cpu")
    assert isinstance(q, QueueTransfer) and q.drain_min == 32
    assert q.name == jax_make_transfer("queue", 64).name == "queue"
    with pytest.raises(ValueError, match="unknown transfer"):
        make_transfer("pipe")

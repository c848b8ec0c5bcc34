"""Experience transfer paths: shared memory (Spreeze) against the host
queue (the baseline). Counterpart of ``repro/core/transfer.py``.

The trainer writes sampled experience into the replay pool through a
transfer object. ``SharedTransfer`` is the paper's shared-memory path:
an in-place ring write on the device that costs the updater nothing.
``QueueTransfer`` is the Queue/Pipe baseline: a copy to the host, a
bounded deque, an upload; both ends block (Fig. 4a), experience arrives
late (policy lag) and overflowing frames are dropped (transmission loss,
Table 3 QS rows).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import trace
from repro_torch.replay import buffer as rb
from repro_torch.replay.host_queue import HostQueue


class SharedTransfer:
    """Direct device-side write into the replay ring (no host copies).

    ``add_fn`` defaults to the uniform ring write; the prioritized pool
    passes its own (max-priority-tagging) writer."""

    name = "shared"

    def __init__(self, add_fn=None):
        self.write_time = 0.0    # stays 0: writes are launched async
        self._add = add_fn or rb.add_batch

    @trace.spanned("transfer.push")
    def push(self, replay, exp: Dict[str, torch.Tensor]):
        return self._add(replay, exp)

    def flush(self, replay, force: bool = False):
        return replay

    def stats(self) -> Dict[str, float]:
        return {"transfer_cycle_s": 0.0, "transmission_loss": 0.0,
                "blocked_time_s": self.write_time}


class QueueTransfer:
    """The paper's baseline transfer, through a bounded host queue.

    Fig. 4a's semantics: the handoff happens at a "centrally agreed"
    moment, when the queue has collected a full load, so the updater sees
    experience late and in bursts. It drains at half the queue size, the
    fullest load that can never deadlock against the overflow drop at
    ``queue_size``."""

    name = "queue"

    def __init__(self, queue_size: int, add_fn=None, device="cuda"):
        self.q = HostQueue(queue_size, device)
        self.drain_min = queue_size // 2
        self._add = add_fn or rb.add_batch

    @trace.spanned("transfer.push")
    def push(self, replay, exp: Dict[str, torch.Tensor]):
        self.q.put(exp)          # copy to the host; may drop on overflow
        return replay

    def flush(self, replay, force: bool = False):
        """Consumer side: upload the queued chunks into the device pool
        (one ring write a drain)."""
        batch = self.q.drain(0 if force else self.drain_min)
        if batch is not None:
            replay = self._add(replay, batch)
        return replay

    def stats(self) -> Dict[str, float]:
        return {"transfer_cycle_s": self.q.transfer_cycle,
                "transmission_loss": self.q.transmission_loss,
                "blocked_time_s": self.q.put_time + self.q.drain_time}


def make_transfer(kind: str, queue_size: int = 20_000, add_fn=None,
                  device="cuda"):
    if kind == "shared":
        return SharedTransfer(add_fn)
    if kind == "queue":
        return QueueTransfer(queue_size, add_fn, device)
    raise ValueError(f"unknown transfer kind {kind!r}")

"""Experience transfer: the shared-memory path. Counterpart of
``repro/core/transfer.py``'s ``SharedTransfer`` (the host-queue baseline
is not ported yet)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.replay import buffer as rb


class SharedTransfer:
    """Direct device-side write into the replay ring (no host copies).

    ``add_fn`` defaults to the uniform ring write; the prioritized pool
    passes its own (max-priority-tagging) writer."""

    name = "shared"

    def __init__(self, add_fn=None):
        self.write_time = 0.0    # stays 0: writes are launched async
        self._add = add_fn or rb.add_batch

    def push(self, replay, exp: Dict[str, torch.Tensor]):
        return self._add(replay, exp)

    def flush(self, replay, force: bool = False):
        return replay

    def stats(self) -> Dict[str, float]:
        return {"transfer_cycle_s": 0.0, "transmission_loss": 0.0,
                "blocked_time_s": self.write_time}

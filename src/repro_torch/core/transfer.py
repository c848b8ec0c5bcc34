"""Experience transfer: the shared-memory path. Counterpart of
``repro/core/transfer.py``'s ``SharedTransfer`` (the host-queue baseline
is not ported yet)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.replay import buffer as rb


class SharedTransfer:
    """Direct device-side write into the replay ring (no host copies)."""

    name = "shared"

    def __init__(self):
        self.write_time = 0.0    # stays 0: writes are launched async

    def push(self, replay: rb.ReplayState, exp: Dict[str, torch.Tensor]
             ) -> rb.ReplayState:
        return rb.add_batch(replay, exp)

    def flush(self, replay: rb.ReplayState, force: bool = False
              ) -> rb.ReplayState:
        return replay

    def stats(self) -> Dict[str, float]:
        return {"transfer_cycle_s": 0.0, "transmission_loss": 0.0,
                "blocked_time_s": self.write_time}

"""Host-queue experience transfer: the paper's *baseline* (Fig. 4a).
Counterpart of ``repro/replay/host_queue.py``.

Reproduces the Queue/Pipe pathology the paper ablates against (§3.3.2,
Table 3 QS rows): experience is copied off the card (a blocking
``.cpu()``, the inter-process pickle/dump), staged in a bounded host
deque, and uploaded again in queue-sized chunks. Both ends *block* on
the copy, so transfer time is taken from sampler and updater alike, and
a large queue delays experience (policy lag, "transmission loss").

The queue's cost is the measured result, so it stays as the reference
has it: pageable host arrays, blocking copies, and a device synchronise
after each upload. These are the queue's intended host transfers (the
reference's explicit ``jax.device_get`` / ``device_put``), so they run
with the sync debug mode lifted (``sync_debug_mode(device, 0)``): a
sanitized trainer checks every other operation of the round.
"""
from __future__ import annotations

import collections
import time
from typing import Deque, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device, sync_debug_mode


class HostQueue:
    """Bounded FIFO of host-side experience chunks.

    ``put`` blocks the *producer* for the device-to-host copy; ``drain``
    blocks the *consumer* for the host-to-device upload. The stats are
    the paper's Table 3 columns: transfer cycle (s) and transmission loss
    (the fraction of sampled frames dropped because the queue was full).
    """

    def __init__(self, queue_size: int, device="cuda"):
        self.queue_size = queue_size
        self.device = resolve_device(device)
        self._q: Deque[Dict[str, np.ndarray]] = collections.deque()
        self._frames_in_queue = 0
        # stats
        self.frames_offered = 0
        self.frames_dropped = 0
        self.put_time = 0.0
        self.drain_time = 0.0
        self._last_drain_t: Optional[float] = None
        self.cycle_times = []

    # ---- producer side (sampler process) --------------------------------
    def put(self, batch: Dict[str, torch.Tensor]) -> bool:
        """Copy a device batch to the host and enqueue it. Returns False
        (and counts the frames as dropped, with no copy) if the queue is
        full."""
        n = int(next(iter(batch.values())).shape[0])
        self.frames_offered += n
        if self._frames_in_queue + n > self.queue_size:
            self.frames_dropped += n
            return False
        t0 = time.perf_counter()
        with sync_debug_mode(self.device, 0):
            host = {k: v.cpu().numpy() for k, v in batch.items()}
        self.put_time += time.perf_counter() - t0
        self._q.append(host)
        self._frames_in_queue += n
        return True

    # ---- consumer side (network update process) -------------------------
    def drain(self, min_frames: int = 0
              ) -> Optional[Dict[str, torch.Tensor]]:
        """Upload every queued chunk to the device as one concatenated
        batch.

        ``min_frames`` reproduces the paper's Fig. 4a handoff: the
        transfer happens only once the queue holds a full load, so
        experience reaches the updater in stale, bursty batches. 0 =
        drain whatever is there. Returns None when below the threshold
        or empty."""
        if not self._q or self._frames_in_queue < min_frames:
            return None
        t0 = time.perf_counter()
        chunks: list = []
        while self._q:
            chunks.append(self._q.popleft())
        with sync_debug_mode(self.device, 0):
            out = {k: torch.from_numpy(
                       np.concatenate([c[k] for c in chunks], axis=0)
                   ).to(self.device) for k in chunks[0]}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the consumer stall
        now = time.perf_counter()
        self.drain_time += now - t0
        if self._last_drain_t is not None:
            self.cycle_times.append(now - self._last_drain_t)
        self._last_drain_t = now
        self._frames_in_queue = 0
        return out

    # ---- stats -----------------------------------------------------------
    @property
    def transmission_loss(self) -> float:
        if self.frames_offered == 0:
            return 0.0
        return self.frames_dropped / self.frames_offered

    @property
    def transfer_cycle(self) -> float:
        return float(np.mean(self.cycle_times)) if self.cycle_times else 0.0

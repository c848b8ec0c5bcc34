#!/usr/bin/env python3
"""What the finite guard costs the fused loop on the card.

    python3 tools/guard_cost.py

Builds ``SpreezeTrainer`` at the reference's default config (Pendulum,
SAC, hidden 256x256, 16 envs x 32 steps, batch 8192, capacity 262,144,
K 4, R 4), warms it up, then in turns with the guard on, off, off, on,
on, off, off, on measures on the one trainer:

- the host wall of ``MEGASTEPS`` megasteps, each followed by the
  guard's work in ``train()`` (``carry_finite``'s copy to pinned memory
  and its event, then the poll), the card synchronised before and after;
- ``update_hz`` of ``train(max_seconds=SECONDS)``, the end-to-end
  metric that the guard should not move.

"Off" swaps ``faults.tree_finite`` for a flag made once and
``_guard_entry`` for a host ``True``, so the loop does none of the
guard's device or host work. Prints the card line, one JSON line a turn
and a JSON summary (the mean of each arm). Needs a CUDA device.
"""
import json
import os
import sys
import time

from device_profile import card_line

MEGASTEPS = 10
SECONDS = 3.0
ORDER = ("on", "off", "off", "on", "on", "off", "off", "on")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("guard_cost: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.core import SpreezeConfig, SpreezeTrainer, faults

    card = card_line()
    print(card, flush=True)
    tr = SpreezeTrainer(SpreezeConfig())
    tr._warmup()
    for _ in range(2):
        tr.megastep()
    torch.cuda.synchronize()

    flag = torch.ones((), dtype=torch.bool, device=tr.device)
    arms = {"on": (faults.tree_finite, SpreezeTrainer._guard_entry),
            "off": (lambda tree: flag,
                    lambda self, round_i, carry_finite: (round_i, True,
                                                         None))}

    def megasteps_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(MEGASTEPS):
            tr.megastep()
            tr._guard_q.append(tr._guard_entry(
                i, tr.last_metrics["carry_finite"]))
            tr._poll_guard()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / MEGASTEPS
        tr._poll_guard(blocking=True)
        return ms

    rows = []
    try:
        for arm in ORDER:
            faults.tree_finite, SpreezeTrainer._guard_entry = arms[arm]
            ms = megasteps_ms()
            hist = tr.train(max_seconds=SECONDS)
            rows.append({"guard": arm, "wall_ms_per_megastep": ms,
                         "update_hz": hist.update_hz})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        faults.tree_finite, SpreezeTrainer._guard_entry = arms["on"]

    def mean(arm, key):
        vals = [r[key] for r in rows if r["guard"] == arm]
        return sum(vals) / len(vals)

    print(json.dumps({
        "card": card, "megasteps": MEGASTEPS, "train_seconds": SECONDS,
        "order": list(ORDER),
        **{f"{key}_{arm}": mean(arm, key)
           for key in ("wall_ms_per_megastep", "update_hz")
           for arm in ("on", "off")}}))


if __name__ == "__main__":
    main()

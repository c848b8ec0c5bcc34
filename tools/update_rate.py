#!/usr/bin/env python3
"""The single-device main path's update rate, two source trees in turns.

    python3 tools/update_rate.py OLD_TREE NEW_TREE

Each tree is a checkout of the repository (its ``src/`` is put on the
path). In the turns OLD, NEW, NEW, OLD, OLD, NEW, NEW, OLD one process
a turn builds ``SpreezeTrainer`` at the reference's default config
(Pendulum, SAC, hidden 256x256, 16 envs x 32 steps, batch 8192,
capacity 262,144, K 4, R 4, one device), warms it up, runs two
megasteps, then measures:

- the host wall of ``MEGASTEPS`` megasteps, the card synchronised before
  and after;
- ``update_hz`` of ``train(max_seconds=SECONDS)``, the end-to-end metric.

Prints the card line, one JSON line a turn and a JSON summary (the mean
of each tree). Needs a CUDA device.
"""
import json
import os
import subprocess
import sys
import time

from device_profile import card_line

MEGASTEPS = 10
SECONDS = 5.0
ORDER = (0, 1, 1, 0, 0, 1, 1, 0)


def one_turn():
    """One turn in this process, on the tree whose ``src/`` is on the
    path: prints one JSON line."""
    import torch
    from repro_torch.core import SpreezeConfig, SpreezeTrainer

    tr = SpreezeTrainer(SpreezeConfig())
    tr._warmup()
    for _ in range(2):
        tr.megastep()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(MEGASTEPS):
        tr.megastep()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / MEGASTEPS
    hist = tr.train(max_seconds=SECONDS)
    print(json.dumps({"wall_ms_per_megastep": ms,
                      "update_hz": hist.update_hz}), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("update_rate: no CUDA device is available")
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    card = card_line()
    print(card, flush=True)
    rows = []
    for i in ORDER:
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[i], "src"))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn"], env=env,
            capture_output=True, text=True, timeout=600)
        if out.returncode:
            sys.exit(f"update_rate: the turn on {trees[i]} failed:\n"
                     f"{out.stderr[-4000:]}")
        rows.append({"tree": trees[i],
                     **json.loads(out.stdout.strip().splitlines()[-1])})
        print(json.dumps(rows[-1]), flush=True)

    def mean(tree, key):
        vals = [r[key] for r in rows if r["tree"] == tree]
        return sum(vals) / len(vals)

    print(json.dumps({
        "card": card, "megasteps": MEGASTEPS, "train_seconds": SECONDS,
        "order": [trees[i] for i in ORDER],
        **{f"{key}_{name}": mean(tree, key)
           for key in ("wall_ms_per_megastep", "update_hz")
           for name, tree in zip(("old", "new"), trees)}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--turn"]:
        one_turn()
    else:
        main()

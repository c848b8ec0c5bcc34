#!/usr/bin/env python3
"""Where the port's megastep spends its time on the card.

    python3 tools/profile_megastep.py [--prioritized] [--algo sac|td3|ddpg]

Builds ``SpreezeTrainer`` at the reference's full widths (the
configuration ``chip_smoke.py`` trains), with SAC (or ``--algo``) and
uniform replay or, given ``--prioritized``, prioritized replay, warms it
up, then runs two
megasteps under ``torch.profiler`` and prints one JSON
line: host wall time per megastep, device busy time (the summed
duration of every device op; one stream, so they do not overlap), the
device's idle share of the wall, device ops (kernels, copies, fills) per
megastep, the device time of the port's own kernels, and the ops that
take the most device time. Needs a CUDA device.
"""
import argparse
import json
import os
import sys

from device_profile import card_line, profiled

MEGASTEPS = 2
# the device functions of src/repro_torch/kernels/csrc/*.cu
PORT_KERNELS = ("ring_write_kernel", "ring_gather_kernel",
                "topk_count_kernel", "topk_place_kernel", "topk_sort_kernel",
                "priority_scatter_kernel")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_megastep: no CUDA device is available")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.core import SpreezeConfig, SpreezeTrainer
    from repro_torch.rl import AlgoHP

    ap = argparse.ArgumentParser()
    ap.add_argument("--prioritized", action="store_true")
    ap.add_argument("--algo", default="sac", choices=("sac", "td3", "ddpg"))
    args = ap.parse_args()
    card = card_line()
    prioritized = args.prioritized
    tr = SpreezeTrainer(SpreezeConfig(algo=args.algo,
                                      hp=AlgoHP(hidden=(256, 256)),
                                      prioritized=prioritized))
    tr._warmup()
    for _ in range(2):
        tr.megastep()
    torch.cuda.synchronize()

    wall_ms, busy_ms, ops, per_op = profiled(tr.megastep, MEGASTEPS)
    port = {k: sum(v for name, v in per_op.items() if k in name) / 1e3
            for k in PORT_KERNELS}
    print(json.dumps({
        "card": card, "megasteps": MEGASTEPS, "algo": args.algo,
        "replay": "PER" if prioritized else "uniform",
        "wall_ms_per_megastep": wall_ms,
        "device_busy_ms_per_megastep": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "device_ops_per_megastep": ops,
        "port_kernels_ms_per_megastep": port,
        "top_device_ops_ms_per_megastep": {
            k: v / 1e3 for k, v in per_op.most_common(12)}}))

if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process: for each
seed the program's checked steps against the reference (the lower
reading), the control against the reference, and each fault asked for.
No window is run: a training cell's readings need none.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control] [--faults half_batch unchanged] [--out FILE]

The control is the reference put in the program's place and computed in
the nearest precision below the configuration's (TF32 products for a
float32 configuration, float8 operands for a bf16 one). Prints one JSON
line a seed (and appends it to ``--out``).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(name, seeds, control, faults, device="cuda", overrides=None,
             out=None, bm=None):
    import torch

    from bench.lib import compare, harness
    from bench.lib.faults import FAULTS
    _, _, cfg, traffic = harness.cell_parts(name, overrides=overrides, bm=bm)
    rows = []
    for seed in seeds:
        row = {"workload": name, "seed": seed}
        t = time.perf_counter()
        cell = harness.make_cell(cfg, traffic, seed, device)
        cell.setup()
        row["setup_s"] = time.perf_counter() - t
        prog = cell.program_numbers()
        if device != "cpu":
            row["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        cell.release()
        t = time.perf_counter()
        ref = cell.reference_numbers()
        row["reference_s"] = time.perf_counter() - t
        always = [k for k in ref["change"] if k.startswith("q_target.")]
        row["sound"] = compare.numbers(prog, ref, always)
        row["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
        row["leaves"] = {
            "grad": compare.leaf_gaps(prog["grad"], ref["grad"]),
            "change": compare.leaf_gaps(prog["change"], ref["change"])}
        if control:
            low = cell.control_numbers()
            row["control"] = compare.numbers(low, ref, always)
            row["losses"]["control"] = low["losses"]
            row["control_leaves"] = {
                "grad": compare.leaf_gaps(low["grad"], ref["grad"]),
                "change": compare.leaf_gaps(low["change"], ref["change"])}
        del cell
        for f in faults:
            with FAULTS[f]():
                bad = harness.make_cell(cfg, traffic, seed, device)
                bad.setup()
                nums = bad.program_numbers()
                bad.release()
                del bad
            row[f] = compare.numbers(nums, ref, always)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        rows.append(row)
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    readings(args.workload, args.seeds, args.control, args.faults,
             out=args.out)


if __name__ == "__main__":
    main()

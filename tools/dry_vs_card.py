#!/usr/bin/env python3
"""The dry run's census on the meta device against the same steps on the
card: ``chip_smoke.py``'s phase 14 on its own.

    python3 tools/dry_vs_card.py [--repeats N]

For each of ``chip_smoke.DRY_STEPS`` (qwen2-0.5b's train step at 8 x
1024 tokens, its prefill and a decode step at the serving shape,
mamba2-130m's train step, one arch RL update of full-width smollm-360m
towers at 32 x 1024) it runs ``chip_smoke.check_dry_vs_card``: the
census's kernel calls against ``LAUNCH_COUNTS``, its aten FLOPs against
``FlopCounterMode`` on the card, its peak of temporaries against
``torch.cuda.max_memory_allocated()`` above what was allocated before the
step (within ``chip_smoke.DRY_MEM_TOL``), and its roofline bound beside
the step's measured wall. One JSON line a step and repeat, with the
card's name and power limit; exits non-zero when a check fails. Needs a
CUDA device.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("dry_vs_card: no CUDA device is available")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    _build.load_kernels()
    for i in range(args.repeats):
        for arch, kind in chip_smoke.DRY_STEPS:
            got = chip_smoke.check_dry_vs_card(torch.device("cuda"), arch,
                                               kind)
            print(json.dumps({"run": i, "card": card, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

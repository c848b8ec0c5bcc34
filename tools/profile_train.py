#!/usr/bin/env python3
"""Where the port's LM training step spends its time on the card.

    python3 tools/profile_train.py [--arch qwen2-0.5b] [--steps 2]
                                   [--src DIR] [--kernel-repeats N]

Builds the full-width model (random weights from seed 0, float32
parameters, bf16 compute, adamw, clip 1.0, remat), takes two warm-up
steps on batches of 8 x 1024 tokens from ``batch_iterator``, then runs
``--steps`` steps under ``torch.profiler`` and prints one JSON line:
host wall time a step, device busy time (the summed duration of every
device op; one stream, so they do not overlap), the device's idle share
of the wall, device ops a step, the device time of the port's own
kernels (forward and backward), and the ops that take the most device
time. ``--src`` names the ``src`` directory whose ``repro_torch`` runs
(default: this checkout's), so two versions are profiled from one
checkout. ``--kernel-repeats N`` first times the three backward kernels
N times over (``chip_smoke.time_backward_kernels``: kernel, plain
version, the library's backward and the bound at qwen2-0.5b's training
shape; ``chip_smoke.time_ssd_scan_bwd``: the scan's at mamba2-130m's;
CUDA events), one JSON line a kernel a run, so each time's spread is
seen within one call. ``--arch mamba2-130m`` or ``zamba2-1.2b`` profiles
SSM and hybrid training. ``--arch-rl smollm-360m`` profiles instead one
update of the RL towers on that backbone at full width
(``chip_smoke.arch_rl_update_fn``: an actor, two critics and their
targets, batch 32 x 1024 tokens, 16 action dimensions; the critic loss's
gradient over the critics, the actor loss's over the actor, Adam on
each), after one warm-up update. Needs a CUDA device.
"""
import argparse
import json
import os
import sys

from device_profile import card_line, profiled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SEQ = 8, 1024
# the device functions of src/repro_torch/kernels/csrc/{rmsnorm,
# flash_attention,ssd_scan,ssd_scan_bwd}.cu on the training path: the
# forward kernels and the backward's (rmsnorm_bwd: rows + dw sum; flash:
# delta, key tiles, query tiles, on the tensor cores (_tc_) or the CUDA
# cores; the scan: chunk states, state pass, y; its backward: the
# chunks' own adjoint terms, the reverse state pass, key tiles, query
# tiles (on the tensor cores or the CUDA cores), ddtA)
PORT_KERNELS = ("rmsnorm_kernel", "rmsnorm_bwd_rows_kernel",
                "rmsnorm_bwd_dw_kernel", "flash_tc_kernel", "flash_kernel",
                "flash_bwd_delta_kernel", "flash_bwd_kv_tc_kernel",
                "flash_bwd_q_tc_kernel", "flash_bwd_kv_kernel",
                "flash_bwd_q_kernel", "ssd_chunk_state_tc_kernel",
                "ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                "ssd_y_tc_kernel", "ssd_y_kernel", "ssd_bwd_local_kernel",
                "ssd_bwd_state_pass_kernel", "ssd_bwd_key_tc_kernel",
                "ssd_bwd_query_tc_kernel", "ssd_bwd_key_kernel",
                "ssd_bwd_query_kernel", "ssd_bwd_dtA_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--kernel-repeats", type=int, default=0)
    ap.add_argument("--arch-rl", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_train: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import batch_iterator
    from repro_torch.train.trainer import init_train_state, make_train_step

    card = card_line()
    dev = torch.device("cuda")
    if args.kernel_repeats:
        sys.path.insert(0, ROOT)
        import chip_smoke
        for i in range(args.kernel_repeats):
            timed = {**chip_smoke.time_backward_kernels(dev),
                     "ssd_scan_bwd": chip_smoke.time_ssd_scan_bwd(dev)}
            for name, t in timed.items():
                print(json.dumps({
                    "run": i, "kernel": name, "card": card,
                    **{k: t[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms")}}), flush=True)
            torch.cuda.empty_cache()
    if args.arch_rl:
        sys.path.insert(0, ROOT)
        import chip_smoke
        fn, _ = chip_smoke.arch_rl_update_fn(dev, args.arch_rl)
        fn()                                 # warm-up
        label = {"arch_rl": args.arch_rl, "batch": chip_smoke.ARCH_RL_B,
                 "seq": chip_smoke.ARCH_RL_S,
                 "act_dim": chip_smoke.ARCH_RL_ACT}
    else:
        cfg = get_config(args.arch)
        rc = RunConfig(model=cfg, shape=InputShape("train", SEQ, B,
                                                   "train"))
        params, state, opt = init_train_state(
            rc, torch.Generator(device=dev).manual_seed(0))
        step = make_train_step(rc, opt)
        batch = next(batch_iterator(cfg, rc.shape, device=dev))

        def fn():
            step(params, state, batch)

        for _ in range(2):                   # warm-up
            fn()
        label = {"arch": args.arch, "batch": B, "seq": SEQ}
    torch.cuda.synchronize()
    wall, busy, ops, per_op = profiled(fn, args.steps)
    port = {k: sum(v for n, v in per_op.items() if k in n) / 1e3
            for k in PORT_KERNELS}
    print(json.dumps({
        "card": card, **label,
        "steps": args.steps, "src": os.path.abspath(args.src),
        "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / wall, "device_ops": ops,
        "port_kernels_ms": port,
        "top_device_ops_ms": {k: v / 1e3
                              for k, v in per_op.most_common(12)}}),
          flush=True)


if __name__ == "__main__":
    main()

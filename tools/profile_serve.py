#!/usr/bin/env python3
"""Where the port's serving path spends its time on the card.

    python3 tools/profile_serve.py [--arch qwen2-0.5b|mamba2-130m|zamba2-1.2b]
                                   [--src DIR]

Builds the full-width model (qwen2-0.5b unless ``--arch`` names another
served one; random weights from seed 0, bf16 compute),
prefills 8 prompts of 1024 tokens, warms up, then runs one prefill and
16 decode steps under ``torch.profiler`` and prints one JSON line per
phase: host wall time per call, device busy time (the summed duration
of every device op; one stream, so they do not overlap), the device's
idle share of the wall, device ops per call, the device time of the
port's own kernels (``ssd_scan`` also as the sum of all its passes), and
the ops that take the most device time. ``--src`` names the ``src``
directory whose ``repro_torch`` runs (default: this checkout's), so two
versions are profiled from one checkout. Needs a CUDA device.
"""
import argparse
import json
import os
import sys

from device_profile import card_line, profiled

STEPS = 16
B, PROMPT, GEN = 8, 1024, 64
# the device functions of src/repro_torch/kernels/csrc/{rmsnorm,
# flash_attention,decode_attention,ssd_scan}.cu
# flash_attention.cu has two: flash_tc_kernel (bf16) and flash_kernel (f32).
# ssd_scan.cu runs three passes: the chunk states (bf16 on the tensor
# cores, f32 SIMT), the state recurrence, and y (again two kernels);
# ssd_scan_kernel is the one-pass kernel of older trees, which
# --src may name.
PORT_KERNELS = ("rmsnorm_kernel", "flash_tc_kernel", "flash_kernel",
                "decode_split_kernel", "decode_combine_kernel",
                "ssd_chunk_state_tc_kernel", "ssd_chunk_state_kernel",
                "ssd_state_pass_kernel", "ssd_y_tc_kernel", "ssd_y_kernel",
                "ssd_scan_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--src", default=os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_serve: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, RunConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import factory
    from repro_torch.serve import engine

    card = card_line()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    shape = InputShape("serve", seq_len=PROMPT, global_batch=B,
                       kind="prefill")
    rc = RunConfig(model=cfg, shape=shape)
    params = factory.cast_params(factory.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)), torch.bfloat16)
    batch = make_batch(cfg, shape, torch.Generator(device=dev).manual_seed(1))
    prefill = engine.make_prefill_step(rc, PROMPT + GEN)
    step = engine.make_decode_step(rc)
    cache, logits = prefill(params, batch)
    cache = engine._grow_cache(cfg, cache, PROMPT + GEN)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    pos = torch.tensor(PROMPT, dtype=torch.int32, device=dev)
    for _ in range(4):                       # warm-up
        step(params, tok, cache, pos)
    torch.cuda.synchronize()

    phases = {"prefill": (lambda: prefill(params, batch), 2),
              "decode_step": (lambda: step(params, tok, cache, pos), STEPS)}
    for name, (fn, reps) in phases.items():
        wall, busy, ops, per_op = profiled(fn, reps)
        port = {k: sum(v for n, v in per_op.items() if k in n) / 1e3
                for k in PORT_KERNELS}
        port["ssd_scan (all passes)"] = sum(
            v for n, v in per_op.items() if "ssd_" in n) / 1e3
        print(json.dumps({
            "card": card, "arch": args.arch, "phase": name, "calls": reps,
            "src": os.path.abspath(args.src),
            "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall,
            "device_ops": ops, "port_kernels_ms": port,
            "top_device_ops_ms": {k: v / 1e3
                                  for k, v in per_op.most_common(10)}}),
              flush=True)


if __name__ == "__main__":
    main()

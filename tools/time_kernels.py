#!/usr/bin/env python3
"""decode_attention and priority_scatter on the card: time against bound,
plain version and library call, and where priority_scatter's time goes.

    python3 tools/time_kernels.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's); its kernels build into that checkout's
``build/``. So two versions of the kernels are timed in turns by running
this script once for each, from one checkout, in one call. The shapes and
timing are ``chip_smoke.py``'s (``time_decode_attention``,
``time_priority_scatter``): decode attention, bf16, over qwen2-0.5b's
decode_32k cache (B 8, 32,768 slots, 14 / 2 heads of 64) and serving
cache (1,088 slots), and over zamba2-1.2b's serving cache (32 / 32
heads); one update's re-prioritisation (k 8,192 distinct rows of a
262,144-row pool) with ``index_put_`` beside it. For the scatter and
``index_put_`` also, over 200 back-to-back calls: the device time a call
(the summed device ops under ``torch.profiler``), and the host's time to
enqueue a call (no synchronisation until the last); the CUDA-event time
of the same loop is the larger of the two. One JSON line a kernel, with
the card's name and power limit. Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 200


def enqueue_ms(fn, calls=CALLS):
    """Host milliseconds a call of ``fn`` over ``calls`` calls, with no
    synchronisation between them."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def decode_device_us(cs, dev, S, H, KV, calls=50):
    """Device microseconds a call of decode attention, by kernel (its
    split pass and its combine), under torch.profiler."""
    import torch
    from device_profile import profiled
    from repro_torch.kernels import decode_attention as dec
    q, k, v = cs.model_inputs(dev, 14, torch.bfloat16,
                              (cs.SERVE_B, H, cs.HEAD_DIM),
                              (cs.SERVE_B, S, KV, cs.HEAD_DIM),
                              (cs.SERVE_B, S, KV, cs.HEAD_DIM))
    vl = torch.tensor(S, dtype=torch.int32, device=dev)
    per_op = profiled(lambda: dec.decode_attention(q, k, v, vl), calls)[3]
    return {("split" if "decode_split" in n else "combine"): us
            for n, us in per_op.items() if "decode_" in n}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_kernels: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from device_profile import card_line, profiled
    from repro_torch.kernels import _build
    from repro_torch.kernels import replay_ops as rops

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load_kernels()
    head = {"label": args.label, "src": os.path.dirname(rops.__file__),
            "card": card}
    serving = cs.SERVE_PROMPT + cs.SERVE_GEN
    for name, S, H, KV in (
            ("decode_attention", cs.DECODE_LONG, cs.HEADS, cs.KV_HEADS),
            ("decode_attention_serving", serving, cs.HEADS, cs.KV_HEADS),
            ("decode_attention_zamba2", serving, cs.ZAMBA_HEADS,
             cs.ZAMBA_HEADS)):
        t = cs.time_decode_attention(dev, cs.SERVE_B, S, H, KV)
        print(json.dumps({**head, "kernel": name, **t,
                          "device_us": decode_device_us(cs, dev, S, H, KV)}),
              flush=True)
        torch.cuda.empty_cache()

    t = cs.time_priority_scatter(rops, dev)
    pri, idx, vals = cs.scatter_inputs(dev)
    idx_long = idx.long()
    split = {}
    for name, fn in (
            ("kernel", lambda: rops.priority_scatter(pri, idx, vals)),
            ("library", lambda: pri.index_put_((idx_long,), vals))):
        host = enqueue_ms(fn)
        _, busy, ops, _ = profiled(fn, CALLS)
        split[name] = {"device_ms": busy, "device_ops": ops,
                       "enqueue_ms": host}
    print(json.dumps({**head, "kernel": "priority_scatter", **t,
                      "per_call": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""decode_attention, priority_scatter, the ring write, the ring gather and
the SSD scan on the card: time against bound, plain version and library
call, and where the host-bound calls' time goes.

    python3 tools/time_kernels.py [--src DIR] [--label NAME]
                                  [--only decode_attention priority_scatter
                                          ring_write ring_gather ssd_scan]

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
of the same loop is the larger of the two. The ring write's block
(``chip_smoke.time_ring_write``'s round: the six Pendulum fields, n 512
rows, at slot 100,000 of 262,144) splits the same three numbers a round
for each arm: the round as the port's trainer writes it (one
``ring_write_fields`` call where the timed ``repro_torch`` has it, else
six ``ring_write`` calls), ``ring_write_rowloop`` x6, ``index_copy_`` x6,
and the registered ``torch.ops.repro_torch.*`` ops called with no Python
wrapper, so that the wrapper's share (wrapper arm less raw op), the
dispatcher's and launch's (raw op) and the device's each get a number.
The ring gather's block does the same for an update's gather
(``chip_smoke.time_ring_gather``'s: the six Pendulum fields, B 8,192
uniform rows of 262,144): the trainer's gather (one
``ring_gather_fields`` call where the timed ``repro_torch`` has it, else
six ``ring_gather`` calls), ``ring_gather_rowloop`` x6, ``index_select``
x6 and the raw ops.
The scan's block (``--only ssd_scan``) runs ``ssd_scan`` at both of
``chip_smoke.SCAN_SHAPES`` (mamba2-130m's and zamba2-1.2b's prefill scan),
in bf16 and in float32, and splits a call the same three ways over 20
calls after 3, with the device time of each kernel the call launches.
One JSON line a kernel, with the card's name and power limit. Needs a
CUDA device.
"""
import argparse
import json
import os
import sys
import time

from device_profile import profiled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 200
KERNELS = ("decode_attention", "priority_scatter", "ring_write",
           "ring_gather", "ssd_scan")
SCAN_CALLS = 20


def enqueue_ms(fn, calls=CALLS, warmup=20):
    """Host milliseconds a call of ``fn`` over ``calls`` calls, with no
    synchronisation between them."""
    import torch
    for _ in range(warmup):
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


def split(cs, fn, calls=CALLS):
    """A loop of ``fn`` three ways: CUDA-event ms a call, host enqueue ms
    a call, and the profiler's device ms and device ops a call."""
    _, busy, ops, _ = profiled(fn, calls)
    return {"event_ms": cs.event_ms(fn, calls), "enqueue_ms": enqueue_ms(fn),
            "device_ms": busy, "device_ops": ops}


def kernel_name(name):
    """A device function's name without its namespace and arguments:
    ``ssd_y_tc_kernel<4, 8>`` for the profiler's full C++ name."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ")


def ssd_scan_split(cs, dev, arch, dtype):
    """One scan call at ``arch``'s prefill shape in ``dtype``: CUDA-event
    ms, host enqueue ms and profiler device ms a call (``split``'s three,
    over SCAN_CALLS calls after 3), and the device ms a call of each
    kernel it launches."""
    from repro_torch.kernels import ssd_scan as ssd
    B, S, H, P, N, L = cs.SCAN_SHAPES[arch]
    args = cs.scan_inputs(dev, 15, dtype, B, S, H, P, N)

    def fn():
        return ssd.ssd_scan(*args, chunk=L)

    fn()
    _, busy, ops, per_op = profiled(fn, SCAN_CALLS)
    return {"event_ms": cs.event_ms(fn, SCAN_CALLS, warmup=3),
            "enqueue_ms": enqueue_ms(fn, SCAN_CALLS, warmup=3),
            "device_ms": busy, "device_ops": ops,
            "device_ms_by_kernel": {kernel_name(n): us / 1e3
                                    for n, us in per_op.items()},
            "shape": [B, S, H, P, N, L]}


def ring_write_split(cs, rops, dev):
    """The ring write's round, each arm split (``split``): the trainer's
    call (``ring_write_fields`` where it exists, else six ``ring_write``
    calls), the row-at-a-time baseline x6, ``index_copy_`` x6, and the
    registered ops with no wrapper."""
    import torch
    g = torch.Generator(device=dev).manual_seed(3)
    widths = cs.FIELD_WIDTHS.values()
    datas = [torch.randn((cs.CAPACITY, w), generator=g, device=dev)
             for w in widths]
    batches = [torch.randn((cs.ROUND_ROWS, w), generator=g, device=dev)
               for w in widths]
    pairs = list(zip(datas, batches))
    ptr = torch.tensor(100_000, dtype=torch.int32, device=dev)
    dest = (100_000 + torch.arange(cs.ROUND_ROWS, device=dev)) % cs.CAPACITY
    op = torch.ops.repro_torch
    if hasattr(rops, "ring_write_fields"):
        arms = {"ring_write_fields": lambda: rops.ring_write_fields(
                    datas, batches, ptr),
                "raw_ring_write_op": lambda: op.ring_write(
                    datas, batches, ptr, None, cs.CAPACITY)}
    else:
        arms = {"ring_write_x6": lambda: [rops.ring_write(d, b, ptr)
                                          for d, b in pairs],
                "raw_ring_write_op_x6": lambda: [
                    op.ring_write(d, b, ptr, None, cs.CAPACITY)
                    for d, b in pairs]}
    arms.update({
        "ring_write_rowloop_x6": lambda: [rops.ring_write_rowloop(d, b, ptr)
                                          for d, b in pairs],
        "raw_ring_write_rowloop_op_x6": lambda: [
            op.ring_write_rowloop(d, b, ptr) for d, b in pairs],
        "index_copy_x6": lambda: [d.index_copy_(0, dest, b)
                                  for d, b in pairs]})
    return {name: split(cs, fn) for name, fn in arms.items()}


def ring_gather_split(cs, rops, dev):
    """An update's gather, each arm split (``split``): the trainer's call
    (``ring_gather_fields`` where it exists, else six ``ring_gather``
    calls), the row-at-a-time baseline x6, ``index_select`` x6, and the
    registered ops with no wrapper (which make their outputs where the
    timed tree has ``ring_gather_fields``, else write into outputs made
    once)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)
    datas = [torch.randn((cs.CAPACITY, w), generator=g, device=dev)
             for w in cs.FIELD_WIDTHS.values()]
    idx = torch.randint(0, cs.CAPACITY, (cs.BATCH,), generator=g,
                        device=dev, dtype=torch.int32)
    idx_long = idx.long()
    op = torch.ops.repro_torch
    if hasattr(rops, "ring_gather_fields"):
        arms = {"ring_gather_fields": lambda: rops.ring_gather_fields(
                    datas, idx),
                "raw_ring_gather_op": lambda: op.ring_gather(
                    datas, idx, None),
                "raw_ring_gather_rowloop_op_x6": lambda: [
                    op.ring_gather_rowloop(d, idx) for d in datas]}
    else:
        pairs = [(d, torch.empty((cs.BATCH, d.shape[1]), device=dev))
                 for d in datas]
        arms = {"ring_gather_x6": lambda: [rops.ring_gather(d, idx)
                                           for d in datas],
                "raw_ring_gather_op_x6": lambda: [
                    op.ring_gather(d, idx, None, o) for d, o in pairs],
                "raw_ring_gather_rowloop_op_x6": lambda: [
                    op.ring_gather_rowloop(d, idx, o) for d, o in pairs]}
    arms.update({
        "ring_gather_rowloop_x6": lambda: [rops.ring_gather_rowloop(d, idx)
                                           for d in datas],
        "index_select_x6": lambda: [torch.index_select(d, 0, idx_long)
                                    for d in datas]})
    return {name: split(cs, fn) for name, fn in arms.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--only", nargs="+", default=KERNELS, choices=KERNELS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_kernels: no CUDA device is available")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from device_profile import card_line
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
        if "decode_attention" not in args.only:
            break
        t = cs.time_decode_attention(dev, cs.SERVE_B, S, H, KV)
        print(json.dumps({**head, "kernel": name, **t,
                          "device_us": decode_device_us(cs, dev, S, H, KV)}),
              flush=True)
        torch.cuda.empty_cache()

    if "priority_scatter" in args.only:
        t = cs.time_priority_scatter(rops, dev)
        pri, idx, vals = cs.scatter_inputs(dev)
        idx_long = idx.long()
        per_call = {
            "kernel": split(cs, lambda: rops.priority_scatter(pri, idx,
                                                              vals)),
            "library": split(cs, lambda: pri.index_put_((idx_long,), vals))}
        print(json.dumps({**head, "kernel": "priority_scatter", **t,
                          "per_call": per_call}), flush=True)

    if "ring_write" in args.only:
        print(json.dumps({**head, "kernel": "ring_write_round",
                          "per_round": ring_write_split(cs, rops, dev)}),
              flush=True)

    if "ring_gather" in args.only:
        print(json.dumps({**head, "kernel": "ring_gather_update",
                          "per_update": ring_gather_split(cs, rops, dev)}),
              flush=True)

    for arch in cs.SSM_ARCHS if "ssd_scan" in args.only else ():
        for dtype in (torch.bfloat16, torch.float32):
            print(json.dumps({**head, "kernel": "ssd_scan", "arch": arch,
                              "dtype": str(dtype).replace("torch.", ""),
                              **ssd_scan_split(cs, dev, arch, dtype)}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""decode_attention, priority_scatter, the ring write, the ring gather,
the SSD scan, the PER selection and score pass, and the rotary embedding
on the card: time against bound, plain version and library call, and
where the host-bound calls' time goes.

    python3 tools/time_kernels.py [--src DIR] [--label NAME]
                                  [--only decode_attention priority_scatter
                                          ring_write ring_gather ssd_scan
                                          per_topk per_scores rope]

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
The PER blocks (``--only per_topk per_scores``) take
``chip_smoke.time_per_topk``'s and ``time_per_scores``'s inputs (a full
262,144-row pool; ``per_topk`` draws k 8,192) and split a call the same
three ways for the wrapper, the raw ``torch.ops.repro_torch.*`` op (with
outputs and scratch made once where the timed tree's op takes them) and
the library call, and list each launch of one call in order with its
device microseconds. The rotary block (``--only rope``) times ``rope``
and ``rope_bwd`` at smollm-360m's training shape (q (32, 1024, 15, 64)
and k (32, 1024, 5, 64) at positions 0-1023), bf16 and float32, beside
their byte bound and their plain versions on the card, each split the
same three ways over 200 calls after 20.
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
           "ring_gather", "ssd_scan", "per_topk", "per_scores", "rope")
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


def launch_trace(fn, calls=50, tries=3):
    """Each device op of one call of ``fn`` in launch order, with its
    device microseconds averaged over ``calls`` calls under
    torch.profiler (after a warm-up call). A trace whose op count is not
    a multiple of ``calls`` (the profiler dropped events) is taken
    again, up to ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        per_call = len(ev) // calls
        if per_call * calls == len(ev):
            return [{"name": kernel_name(ev[i].name),
                     "us": sum(ev[c * per_call + i].time_range.elapsed_us()
                               for c in range(calls)) / calls}
                    for i in range(per_call)]
    return {"error": f"{len(ev)} device ops over {calls} calls"}


def takes(op, arg):
    """Whether the registered op ``op`` has an argument named ``arg``
    (the parent's PER ops take their outputs and scratch)."""
    return any(a.name == arg for a in op.default._schema.arguments)


def per_topk_split(cs, rops, dev):
    """One PER selection at the training path's shapes, each arm split
    (``split``): the wrapper, the raw op (outputs and scratch made once
    where the timed tree's op takes them) and the library call (score
    ops + ``torch.topk``); then each launch of a wrapper call."""
    import torch
    g = torch.Generator(device=dev).manual_seed(7)
    pri, gumbel = cs._per_pool(dev, g, cs.CAPACITY, cs.CAPACITY)
    a, k = cs.ALPHA, cs.BATCH
    op = torch.ops.repro_torch.per_topk
    if takes(op, "scratch"):
        scratch = torch.empty((rops.per_topk_scratch_keys(cs.CAPACITY, k),),
                              dtype=torch.int64, device=dev)
        scores = torch.empty(k, device=dev)
        idx = torch.empty(k, dtype=torch.int32, device=dev)

        def raw():
            op(pri, gumbel, None, scratch, scores, idx, a, k)
    else:
        def raw():
            op(pri, gumbel, None, a, k)

    def library():
        s = torch.where(pri > 0.0, a * torch.log(torch.clamp(pri, min=1e-12)),
                        float("-inf")) + gumbel
        torch.topk(s, k, sorted=True)

    def wrapper():
        rops.per_topk(pri, gumbel, a, k)

    arms = {"per_topk": wrapper, "raw_per_topk_op": raw, "library": library}
    return {"per_call": {name: split(cs, fn) for name, fn in arms.items()},
            "launches": launch_trace(wrapper)}


def per_scores_split(cs, rops, dev):
    """The score pass over a full pool, split as ``per_topk_split``: the
    wrapper, the raw op (its output made once where the timed tree's op
    takes one) and each launch of a wrapper call."""
    import torch
    g = torch.Generator(device=dev).manual_seed(12)
    pri, gumbel = cs._per_pool(dev, g, cs.CAPACITY, cs.CAPACITY)
    op = torch.ops.repro_torch.per_scores
    if takes(op, "out"):
        out = torch.empty_like(pri)

        def raw():
            op(pri, gumbel, out, cs.ALPHA)
    else:
        def raw():
            op(pri, gumbel, cs.ALPHA)

    def wrapper():
        rops.per_scores(pri, gumbel, cs.ALPHA)

    arms = {"per_scores": wrapper, "raw_per_scores_op": raw}
    return {"per_call": {name: split(cs, fn) for name, fn in arms.items()},
            "launches": launch_trace(wrapper)}


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


def rope_split(cs, dev, dtype):
    """``rope`` and ``rope_bwd`` at smollm-360m's training shape in
    ``dtype`` beside their plain versions: ``split``'s three numbers an
    arm, the byte bound, and the kernels' event ms as a share of it."""
    import torch
    from repro_torch.kernels import rope as R
    from repro_torch.kernels import work
    from repro_torch.launch.analysis import bound_ms
    B, S, H, KV, d, theta = 32, 1024, 15, 5, 64, 1e4
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, H, d), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, KV, d), generator=g, device=dev).to(dtype)
    pos = torch.arange(S, device=dev)
    arms = {"rope": lambda: R.rope(q, k, pos, pos, theta),
            "rope_bwd": lambda: R.rope_bwd(q, k, pos, pos, theta),
            "plain": lambda: R.rope_ref(q, k, pos, pos, theta),
            "plain_bwd": lambda: R.rope_bwd_ref(q, k, pos, pos, theta)}
    out = {name: split(cs, fn) for name, fn in arms.items()}
    bound, by = bound_ms(work.rope(B, S, S, H, KV, d, dtype))
    return {"shape": [B, S, H, KV, d], "bound_ms": bound, "bound_by": by,
            "share_of_bound": {n: bound / out[n]["event_ms"]
                               for n in ("rope", "rope_bwd")},
            **out}


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

    if "per_topk" in args.only:
        print(json.dumps({**head, "kernel": "per_topk",
                          **cs.time_per_topk(rops, dev),
                          **per_topk_split(cs, rops, dev)}), flush=True)

    if "per_scores" in args.only:
        print(json.dumps({**head, "kernel": "per_scores",
                          **cs.time_per_scores(rops, dev),
                          **per_scores_split(cs, rops, dev)}), flush=True)

    for arch in cs.SSM_ARCHS if "ssd_scan" in args.only else ():
        for dtype in (torch.bfloat16, torch.float32):
            print(json.dumps({**head, "kernel": "ssd_scan", "arch": arch,
                              "dtype": str(dtype).replace("torch.", ""),
                              **ssd_scan_split(cs, dev, arch, dtype)}),
                  flush=True)
            torch.cuda.empty_cache()

    for dtype in (torch.bfloat16, torch.float32) if "rope" in args.only \
            else ():
        print(json.dumps({**head, "kernel": "rope",
                          "dtype": str(dtype).replace("torch.", ""),
                          **rope_split(cs, dev, dtype)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

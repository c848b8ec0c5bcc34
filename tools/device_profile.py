"""The device-time profile that ``profile_megastep.py`` and
``profile_serve.py`` read: ``torch.profiler`` around repeated calls,
summed per device op. Needs a CUDA device."""
import collections
import subprocess
import time


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def profiled(fn, reps):
    """(wall ms per call, device busy ms per call, device ops per call,
    device us by op name per call) of ``reps`` calls of ``fn``. The busy
    time is the summed duration of every device op: one stream, so they
    do not overlap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    per_op = collections.Counter()
    ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_op[e.name] += e.time_range.elapsed_us() / reps
            ops += 1
    return wall_ms, sum(per_op.values()) / 1e3, ops / reps, per_op

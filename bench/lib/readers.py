"""Arithmetic the per-layer readers in ``bench/metrics/`` share. Each
returns None where the trace holds nothing to read, never 0 for a share
of a roofline or a peak."""
from __future__ import annotations

from typing import Optional, Sequence

from bench.work.peaks import bound_s

# cuBLAS's matrix-product kernels on Hopper, by name
GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma")


def idle_share(ctx) -> Optional[float]:
    """The device's idle share of the window, in %: 1 - (device busy time
    an update in the traced sub-window, the union of its device-op
    intervals) / (wall time an update in the untraced window). The traced
    sub-window's own wall is longer by the profiler's host overhead, so it
    is not the denominator."""
    t, w = ctx.trace, ctx.window
    if (t is None or not t.device_ops or not ctx.traced.get("updates")
            or not w.get("updates") or w.get("wall_s", 0) <= 0):
        return None
    busy = t.busy_s / ctx.traced["updates"]
    return 100.0 * (1.0 - busy / (w["wall_s"] / w["updates"]))


def mfu(ctx, peak: float) -> Optional[float]:
    """The window's model FLOPs over its wall and ``peak``, in %."""
    w = ctx.window
    if not w.get("model_flops") or w.get("wall_s", 0) <= 0:
        return None
    return 100.0 * w["model_flops"] / w["wall_s"] / peak


def span_ms(ctx, names: Sequence[str], per: str) -> Optional[float]:
    """Device ms launched under the spans ``names``, a ``per`` (a count
    of the traced block: rounds, updates)."""
    t = ctx.trace
    if t is None or not ctx.traced.get(per):
        return None
    spans = [t.span(n) for n in names]
    if any(s is None for s in spans):
        return None
    total = sum(s.device_s for s in spans)
    return 1e3 * total / ctx.traced[per] if total > 0 else None


def roofline(ctx, kernel: str) -> Optional[float]:
    """The least time of every traced call of ``kernel`` (its bytes over
    the HBM rate or its FLOPs over the peak, the larger; ``work``) over
    the device time launched under those calls, in %."""
    t = ctx.trace
    if t is None:
        return None
    calls, span = t.calls.get(kernel), t.span("op." + kernel)
    if not calls or span is None or span.device_s <= 0:
        return None
    return 100.0 * sum(bound_s(w)[0] for w in calls) / span.device_s


def gemm_ms(ctx, per: str) -> Optional[float]:
    """Device ms in cuBLAS's matrix-product kernels, a ``per``."""
    t = ctx.trace
    if t is None or not ctx.traced.get(per):
        return None
    s = sum(v for k, v in t.op_seconds.items()
            if any(m in k.lower() for m in GEMM_MARKS))
    return 1e3 * s / ctx.traced[per] if s > 0 else None

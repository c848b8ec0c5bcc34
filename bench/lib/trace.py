"""The traced sub-window: spans that the benchmark places around the
program's entry points, wrappers that log each kernel call's shapes, and
the reduction of ``torch.profiler``'s events to what the per-layer
readers take.

Nothing here edits the program: a span is a ``record_function`` opened by
a wrapper that the benchmark puts in place of a method or a module
attribute for the traced sub-window only, and takes out again. Device
work is given to a span by time: every device op whose launching host op
started inside the span's host interval belongs to it, whichever thread
launched it (autograd runs a CUDA backward on a thread of its own, while
the caller waits inside its span).
"""
from __future__ import annotations

import bisect
import collections
import functools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench."
NAME_CHARS = 120        # a device op's name as the breakdown gives it


@dataclass
class SpanStats:
    """Every span of one name: how many, their host seconds, and the
    device seconds and device ops launched inside them."""
    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    device_ops: int = 0


@dataclass
class Trace:
    """What the readers see of one traced sub-window."""
    window_s: float                       # host wall, ends in a synchronise
    busy_s: float                         # union of device-op intervals
    device_ops: int
    op_seconds: Dict[str, float]          # device seconds by op name
    spans: Dict[str, SpanStats]
    calls: Dict[str, List[object]]        # kernel name -> Work of each call
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def span(self, name: str) -> Optional[SpanStats]:
        s = self.spans.get(name)
        return s if s is not None and s.count else None


class Tracer:
    """Installs spans and kernel-call loggers, runs a profiled block and
    reduces its events (``run``). Every patch is undone on leaving."""

    def __init__(self):
        self._patches: List[Tuple[object, str, object]] = []
        self.calls: Dict[str, List[Callable[[], object]]] = \
            collections.defaultdict(list)

    # -- placing --------------------------------------------------------- #
    def _patch(self, owner, attr: str, new) -> None:
        self._patches.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def span_around(self, owner, attr: str, name: str) -> None:
        """``owner.attr`` (a function or a bound method) runs inside the
        span ``bench.<name>``."""
        inner = getattr(owner, attr)

        @functools.wraps(inner)
        def spanned(*a, **kw):
            with torch.profiler.record_function(PREFIX + name):
                return inner(*a, **kw)
        self._patch(owner, attr, spanned)

    def kernel_calls(self, owner, attr: str, name: str,
                     work: Callable[..., Callable[[], object]]) -> None:
        """``owner.attr``, a kernel's entry point, runs inside the span
        ``bench.op.<name>``, and ``work(*args, **kw)`` is logged for each
        call: a thunk that gives the call's ``Work`` once the window has
        closed (so a count that needs the data reads it then)."""
        inner = getattr(owner, attr)
        log = self.calls[name]

        @functools.wraps(inner)
        def logged(*a, **kw):
            log.append(work(*a, **kw))
            with torch.profiler.record_function(PREFIX + "op." + name):
                return inner(*a, **kw)
        self._patch(owner, attr, logged)

    def undo(self) -> None:
        while self._patches:
            owner, attr, old = self._patches.pop()
            setattr(owner, attr, old)

    # -- running --------------------------------------------------------- #
    def run(self, block: Callable[[], object], sync: Callable[[], None]
            ) -> Tuple[Trace, object]:
        """Profile ``block`` (host and device activity), synchronising
        before and after, and reduce its events. -> (Trace, block's
        result)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        sync()
        try:
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = block()
                sync()
                window_s = time.perf_counter() - t0
        finally:
            self.undo()
        calls = {k: [thunk() for thunk in v] for k, v in self.calls.items()}
        return reduce_events(prof.events(), window_s, calls), out


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy / 1e6


def _name_gaps(gaps: List[Tuple[float, float]],
               spans: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds of each idle gap (start, end) by the innermost span open on
    the host at its middle, swept in time order."""
    spans = sorted(spans)
    out: Dict[str, float] = collections.Counter()
    active: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        t = (g0 + g1) / 2
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        name = (min(active, key=lambda s: s[1] - s[0])[2] if active
                else "host outside the spans")
        out[name] += (g1 - g0) / 1e6
    return out


def reduce_events(events, window_s: float,
                  calls: Dict[str, List[object]]) -> Trace:
    """The profiler's events -> a ``Trace``. Device ops are the device
    activities (kernels, copies, fills) but the device copies of the
    benchmark's own annotations."""
    dev = [e for e in events if _is_device(e)
           and not e.name.startswith(PREFIX)
           and not getattr(e, "is_user_annotation", False)]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    op_seconds: Dict[str, float] = collections.Counter()
    for e in dev:
        op_seconds[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    # launching host ops, sorted by start, with prefix sums of their device
    # seconds and device ops
    launch = sorted((e.time_range.start, sum(k.duration for k in e.kernels),
                     len(e.kernels)) for e in events
                    if not _is_device(e) and e.kernels)
    starts = [x[0] for x in launch]
    cum_s, cum_n = [0.0], [0]
    for _, d, n in launch:
        cum_s.append(cum_s[-1] + d)
        cum_n.append(cum_n[-1] + n)
    spans: Dict[str, SpanStats] = collections.defaultdict(SpanStats)
    host_spans: List[Tuple[float, float, str]] = []
    for e in events:
        if _is_device(e) or not e.name.startswith(PREFIX):
            continue
        name = e.name[len(PREFIX):]
        s, t = e.time_range.start, e.time_range.end
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, t)
        st = spans[name]
        st.count += 1
        st.host_s += (t - s) / 1e6
        st.device_s += (cum_s[hi] - cum_s[lo]) / 1e6
        st.device_ops += cum_n[hi] - cum_n[lo]
        host_spans.append((s, t, name))
    idle, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            idle.append((end, s))
        end = e if end is None else max(end, e)
    gaps = _name_gaps(idle, host_spans)
    top = sorted(op_seconds.items(), key=lambda kv: -kv[1])[:10]
    return Trace(
        window_s=window_s, busy_s=_union_s(intervals), device_ops=len(dev),
        op_seconds=dict(op_seconds), spans=dict(spans), calls=calls,
        top_ops=[(n[:NAME_CHARS], v) for n, v in top],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])

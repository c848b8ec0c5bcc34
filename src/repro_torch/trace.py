"""Spans, first-call spans and counters of the port.

A *span* names a phase of the program: ``with trace.span("arch.adam"):``
or the decorator ``@trace.spanned("op.rmsnorm")``. A span is *active*
after ``enable()`` (undone by ``disable()``) and while a
``torch.profiler`` session records. Inactive, ``span`` reads two module
globals and hands back one shared no-op context: no allocation, no
clock, no dispatcher call. Active, it opens
``torch.profiler.record_function("repro." + name)``, so the span stands
in the profiler's trace with the device ops it launched under it, and it
keeps a record ``(name, parent, step, start_ns, end_ns)`` in a bounded
buffer (``records()``; ``CAPACITY`` of them, the overflow counted in
``dropped``). ``step`` is the index of the enclosing step span
(``STEP_SPANS``: one ``arch.update`` or ``megastep``), so every span of
one update shares it; ``parent`` is the name of the span open around
it. The times are unix nanoseconds (``time.time_ns()``: the system clock
that the profiler anchors its events' times to, read after the span's
``record_function`` opens and after it closes), so a record and the
profiler's host and device events lie on one time line.

``first(name)`` is a set-up span: its first entry in a process is timed
whether tracing is on or off (``snapshot()["first"]``), and after that it
is a plain ``span``. ``count(name, n)`` adds to an always-on counter, at
places the event happens a few times an update or less often.
``LAUNCH_COUNTS`` (``repro_torch.kernels``) stays the one launch counter;
``snapshot()`` hands it over as it stands.

Nothing here synchronises with the device or records a CUDA event.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

from repro_torch.kernels import LAUNCH_COUNTS

PREFIX = "repro."
CAPACITY = 65_536
#: spans that open a step: every span inside one shares its index
STEP_SPANS = ("arch.update", "megastep")

Record = Tuple[str, Optional[str], Optional[int], int, int]

_enabled = False
_NULL = contextlib.nullcontext()
_open: List["_Span"] = []         # spans open now, innermost last
_records: List[Record] = []
_dropped = 0
_steps = 0
_stats: Dict[str, List[int]] = {}  # name -> [count, host ns, child ns]
_counters: collections.Counter = collections.Counter()
_first: Dict[str, float] = {}      # name -> seconds of the first entry
_first_self: Dict[str, float] = {}  # the same, less first spans inside
_first_seen: set = set()


def enable() -> None:
    """Turn the spans on without a profiler (records and ``snapshot``)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class _Span:
    __slots__ = ("name", "active", "first", "rf", "parent", "step", "t0",
                 "child_ns", "first_child_ns")

    def __init__(self, name: str, active: bool, first: bool):
        self.name, self.active, self.first = name, active, first

    def __enter__(self):
        global _steps
        parent = _open[-1] if _open else None
        self.parent = parent
        self.child_ns = self.first_child_ns = 0
        if parent is not None:
            self.step = parent.step
        elif self.name in STEP_SPANS:
            self.step, _steps = _steps, _steps + 1
        else:
            self.step = None
        _open.append(self)
        if self.active:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.active:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        dur = t1 - self.t0
        if _open and _open[-1] is self:
            _open.pop()
        else:                       # closed out of order (another thread)
            _open.remove(self)
        parent = self.parent
        if self.active:
            st = _stats.get(self.name)
            if st is None:
                st = _stats[self.name] = [0, 0, 0]
            st[0] += 1
            st[1] += dur
            st[2] += self.child_ns
            if parent is not None:
                parent.child_ns += dur
            if len(_records) < CAPACITY:
                _records.append((self.name, parent and parent.name,
                                 self.step, self.t0, t1))
            else:
                _dropped += 1
        if self.first:
            _first[self.name] = dur / 1e9
            _first_self[self.name] = (dur - self.first_child_ns) / 1e9
            outer = next((s for s in reversed(_open) if s.first), None)
            if outer is not None:
                outer.first_child_ns += dur
        return False


def span(name: str):
    """A context that is the span ``name`` while tracing is active, and a
    shared no-op otherwise."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, True, False)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (_enabled or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name, True, False):
                return fn(*args, **kwargs)
        return inner
    return wrap


def first(name: str):
    """The set-up span ``name``: its first entry in the process is timed
    (``snapshot()["first"]``) whether tracing is on or off; later entries
    are ``span(name)``."""
    if name in _first_seen:
        return span(name)
    _first_seen.add(name)
    return _Span(name, _enabled or _profiler._is_profiler_enabled, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the always-on counter ``name``."""
    _counters[name] += n


def records() -> List[Record]:
    """The buffered records, in the order the spans closed."""
    return list(_records)


def snapshot() -> dict:
    """``spans``: {name: {count, host_s, self_s}} (self: less the spans
    that ran inside); ``first``: {name: seconds of the first entry};
    ``first_self``: those seconds less the first spans timed inside
    (``kernels.load`` in the first ``arch.update``); ``counters``;
    ``launches``: ``LAUNCH_COUNTS`` itself; ``dropped``: records that the
    full buffer turned away."""
    return {"spans": {k: {"count": c, "host_s": h / 1e9,
                          "self_s": (h - ch) / 1e9}
                      for k, (c, h, ch) in _stats.items()},
            "first": dict(_first), "first_self": dict(_first_self),
            "counters": dict(_counters), "launches": LAUNCH_COUNTS,
            "dropped": _dropped}


def reset() -> None:
    """Clear the spans, records and counters (not ``first``)."""
    global _dropped, _steps
    _stats.clear()
    _records.clear()
    _counters.clear()
    _dropped = _steps = 0

"""Spans and counters of the port's host work.

A span times one stage of the program: `with tracing.span("sort.parse"):`.
Spans are on while `enable()` holds or while a torch profiler is recording,
so a profiled run gets them with no change to its caller.  Off, `span`
costs one flag check and a call into the profiler's state, and returns a
shared no-op context.  On, each span keeps its name, its parent (the span
open around it on the same thread), and its start and end on
`time.perf_counter_ns()`, in memory: at most MAX_RECORDS raw spans, with a
count of those dropped past that, while `totals()` stays exact and gives
each name's calls, total time and self time (total less the time of its
child spans).

While a profiler records, a span also opens `record_function("impg." +
name)`, so it sits on the profiler's clock beside the kernels and copies
and a trace shows what the host did in each gap of the device.  The
profiler also draws a CUDA-side annotation over the device work launched
inside the innermost open range, typed as a CUDA event like a kernel.  So
a span that launches device work, or whose children that do are kept off
the profiler, is marked `launches=True` and stays in memory only: no trace
reads a span as device time.

Counters (`count`) are always on: an integer add under a lock at a layer
boundary, never per element.  The kernels' launch counts are counters
named "launch.<kernel>" (kernels.launch_counts is their view).
"""

from __future__ import annotations

import contextlib
import threading
from time import perf_counter_ns
from typing import NamedTuple

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

# Raw spans kept in memory; later ones are counted in `dropped()` only.
MAX_RECORDS = 1 << 16
PREFIX = "impg."


class Record(NamedTuple):
    name: str
    parent: str | None
    start_ns: int
    end_ns: int


_enabled = False
_lock = threading.Lock()
_local = threading.local()
_records: list = []
_dropped = 0
_totals: dict = {}        # name -> [calls, total_ns, self_ns]
_counters: dict = {}
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "launches", "parent", "child_ns", "start", "rf")

    def __init__(self, name: str, launches: bool):
        self.name = name
        self.launches = launches
        self.child_ns = 0

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.rf = None
        if not self.launches and _profiler_enabled():
            self.rf = record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        end = perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child_ns
            if len(_records) < MAX_RECORDS:
                _records.append(Record(
                    self.name, None if parent is None else parent.name,
                    self.start, end))
            else:
                _dropped += 1
        return False


def span(name: str, launches: bool = False):
    """A context that times `name` while spans are on, else a no-op.
    `launches`: the span launches device work, so it never opens a profiler
    range (module docstring)."""
    if _enabled or _profiler_enabled():
        return _Span(name, launches)
    return _OFF


def enable(on: bool = True) -> bool:
    """Turn spans on (or off) outside a profiler; returns the previous
    setting."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset_counters(prefix: str = "") -> None:
    """Zero the counters whose names start with `prefix` (all by default)."""
    with _lock:
        for name in [k for k in _counters if k.startswith(prefix)]:
            del _counters[name]


def totals() -> dict:
    """{name: {"calls", "total_ns", "self_ns"}} of every span ended so far."""
    with _lock:
        return {name: {"calls": c, "total_ns": t, "self_ns": s}
                for name, (c, t, s) in _totals.items()}


def records() -> list:
    """The raw spans kept, in the order they ended."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans ended past MAX_RECORDS (in `totals()`, not in `records()`)."""
    return _dropped


def reset() -> None:
    """Clear the spans, their totals and every counter."""
    global _dropped
    with _lock:
        _records.clear()
        _totals.clear()
        _dropped = 0
    reset_counters()


def report() -> list:
    """One line per span name (calls, total and self ms) and per counter,
    in name order, for a log."""
    lines = [f"span {name}: {t['calls']} calls, {t['total_ns'] / 1e6:.3f} "
             f"ms total, {t['self_ns'] / 1e6:.3f} ms self"
             for name, t in sorted(totals().items())]
    if _dropped:
        lines.append(f"spans dropped past {MAX_RECORDS}: {_dropped}")
    lines += [f"counter {name}: {v}"
              for name, v in sorted(counters().items())]
    return lines

"""One torch.profiler pass over the measured window, reduced to what the
per-layer readers need.

The device is busy where any kernel, copy or memset ran: the union of their
intervals, not the sum of their times (two streams, or a copy beside a
kernel, would count twice).  A trace with no device event fails the run: an
empty trace must never read as a card 100% idle or a kernel at 0% of its
roofline.

The benchmark's own spans (`span`, named "portbench.<layer>") land in the
same trace as CPU events, so each idle gap between device intervals is named
by the innermost span the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

SPAN_PREFIX = "portbench."


class EmptyTrace(RuntimeError):
    pass


@contextlib.contextmanager
def span(name: str, on: bool):
    """A named CPU range in the profiler's trace when `on`."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def merge_intervals(iv: list) -> list:
    """Sorted union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """Device intervals (microseconds) and the benchmark's spans of one
    profiled window, `window_s` long by the host's clock."""

    def __init__(self, device_events: list, spans: list, window_s: float):
        if not device_events:
            raise EmptyTrace("the profiler recorded no device event in the "
                             "traced window")
        self.window_s = float(window_s)
        self.events = device_events          # [(start_us, end_us, name)]
        self.spans = spans                   # [(start_us, end_us, name)]
        self.busy = merge_intervals([[s, e] for s, e, _ in device_events])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        if self.busy_s <= 0:
            raise EmptyTrace("the traced device events span no time")

    @classmethod
    def from_profile(cls, prof, window_s: float) -> "DeviceTrace":
        dev, spans = [], []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.name.startswith(SPAN_PREFIX):
                # A span shows on the device too, as an annotation over the
                # work it launched: the host's record, not device work.
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    spans.append((start, end, e.name[len(SPAN_PREFIX):]))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((start, end, e.name))
        return cls(dev, spans, window_s)

    def kernel_seconds(self, name_part: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds
        `name_part`."""
        ts = [e - s for s, e, n in self.events if name_part in n]
        return sum(ts) / 1e6, len(ts)

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def _span_at(self, t: float) -> str:
        best = None
        for s, e, n in self.spans:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        return best[2] if best else "outside_spans"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps between device intervals by the host span they fell in."""
        by_name: dict = defaultdict(float)
        for s, e, n in self.events:
            by_name[n] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
                for a, b in zip(self.busy, self.busy[1:])]
        gaps.sort(key=lambda g: -g[0])
        idle = [[self._span_at(mid), g / 1e6] for g, mid in gaps[:top]]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}

"""Reading a ``torch.profiler`` Chrome trace: device intervals and host ranges.

``interval_union``, ``busy_share`` and ``read_trace`` are frozen copies of
the port's ``chip_smoke.py`` functions of those names (``read_trace`` also
keeps the ranges the harness itself records); the rest reduces a traced
window to the numbers a run reports.  Times are the trace's microseconds.
"""

from __future__ import annotations

import json
import pathlib
from bisect import bisect_left, bisect_right

DEVICE_EVENT_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's own range around the measured window
WINDOW = "gabench.window"


def interval_union(spans):
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def busy_share(spans, lo, hi):
    """The share of [lo, hi] that the union of the spans covers."""
    return interval_union([(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]) / (
        hi - lo)


def read_trace(trace_dir):
    """(device events by kind as (name, start, end) in us, host ranges
    (name, start, end), file bytes) of the one Chrome trace in trace_dir."""
    (path,) = pathlib.Path(trace_dir).glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    device = {kind: [] for kind in DEVICE_EVENT_KINDS}
    ranges = []
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if e.get("cat") in device:
            device[e["cat"]].append(span)
        elif e.get("cat") == "user_annotation":
            ranges.append(span)
    return device, ranges, path.stat().st_size


class Trace:
    """The device events and host ranges of one traced window."""

    def __init__(self, device_events, ranges):
        self.device_events = device_events
        self.ranges = ranges
        (self.lo, self.hi), = [(a, b) for name, a, b in ranges if name == WINDOW]
        self._device_spans = None

    def device_spans(self):
        """(start, end) of every kernel, copy and set inside the window,
        clipped to it; made once a trace (callers do not change it)."""
        if self._device_spans is None:
            self._device_spans = [
                (max(a, self.lo), min(b, self.hi))
                for kind in DEVICE_EVENT_KINDS for _, a, b in self.device_events[kind]
                if b > self.lo and a < self.hi]
        return self._device_spans

    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return interval_union(self.device_spans()) / 1e6

    def kernel_seconds(self, fragment: str):
        """(launches, summed seconds) of the kernels inside the window whose
        name holds ``fragment``."""
        spans = [(a, b) for name, a, b in self.device_events["kernel"]
                 if fragment in name and a >= self.lo and b <= self.hi]
        return len(spans), sum(b - a for a, b in spans) / 1e6

    def top_device_ops(self, n: int = 10):
        """[name, seconds] of the n device operations that took most time in
        the window, their events summed by name."""
        totals = {}
        for kind in DEVICE_EVENT_KINDS:
            for name, a, b in self.device_events[kind]:
                if b > self.lo and a < self.hi:
                    totals[name] = totals.get(name, 0.0) + (min(b, self.hi) - max(a, self.lo))
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10):
        """[name, seconds] of the n longest stretches of the window in which
        nothing ran on the device, cut where a host range (the program's
        phase, or ``load``) begins or ends, so that each is named by the
        innermost range it lies in.  One pass over the stretches, each taking
        the cuts strictly inside it from the sorted cuts by bisection."""
        merged = []
        for a, b in sorted(self.device_spans()):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [self.lo] + [x for span in merged for x in span] + [self.hi]
        cuts = sorted({t for name, a, b in self.ranges if name != WINDOW for t in (a, b)
                       if self.lo < t < self.hi})
        gaps = []
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            inside = cuts[bisect_right(cuts, a):bisect_left(cuts, b)]
            gaps += [(x, y) for x, y in zip([a] + inside, inside + [b]) if y > x]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.enclosing((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:n]]

    def enclosing(self, t: float) -> str:
        """Name of the shortest host range around time t, other than the
        window itself."""
        inside = [(b - a, name) for name, a, b in self.ranges
                  if a <= t <= b and name != WINDOW]
        return min(inside)[1] if inside else WINDOW

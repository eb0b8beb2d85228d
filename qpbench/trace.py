"""Reduction of a profiler trace to device intervals, idle time and the
breakdown that the result line carries.

``Trace`` holds the device activities (kernels, copies, sets) and the host
operations of one traced window, read from the Chrome trace that
``torch.profiler`` exports.  Times are in seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import List, Optional, Tuple

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation"})


@dataclasses.dataclass
class Activity:
    name: str
    start: float
    dur: float
    grid: Tuple[int, int, int] = (0, 0, 0)
    kernel: bool = False

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class Trace:
    device: List[Activity]
    host: List[Activity]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, patterns) -> List[Activity]:
        """Kernels whose name contains one of ``patterns``."""
        return [a for a in self.device
                if a.kernel and any(p in a.name for p in patterns)]


def load_chrome(path, window_name: str) -> Trace:
    """Read an exported Chrome trace; the window is the span of the host
    annotation ``window_name``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        act = Activity(e["name"], e["ts"] * 1e-6, e.get("dur", 0) * 1e-6)
        if cat in DEVICE_CATS:
            act.kernel = cat == "kernel"
            act.grid = tuple(e.get("args", {}).get("grid", (0, 0, 0)))
            device.append(act)
        elif cat in HOST_CATS:
            if e["name"] == window_name:
                window = (act.start, act.end)
            else:
                host.append(act)
    if window is None:
        raise ValueError(f"trace {path} has no span {window_name!r}")
    return Trace(device, host, window)


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    lo, hi = trace.window
    return sum(e - s for s, e in union(((a.start, a.end)
                                        for a in trace.device), lo, hi))


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The idle intervals of the window: where no device operation ran."""
    lo, hi = trace.window
    out, t = [], lo
    for s, e in union(((a.start, a.end) for a in trace.device), lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out


def top_device_ops(trace: Trace, k: int = 10):
    """``[[name, seconds], ...]``: the device operations that took most
    time in the window, summed by name."""
    tot = defaultdict(float)
    for a in trace.device:
        tot[a.name[:120]] += a.dur
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_by_host_op(trace: Trace, k: int = 10):
    """``[[host operation, seconds], ...]``: the idle time of the window
    summed by the innermost host operation running at each gap's midpoint
    ("host idle" where none ran), longest first."""
    host = sorted(trace.host, key=lambda a: a.start)
    starts = [a.start for a in host]
    tot = defaultdict(float)
    for s, e in gaps(trace):
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        best = None
        # Host spans nest; scan back over those that started before mid.
        for a in reversed(host[max(0, i - 256):i]):
            if a.end > mid and (best is None or a.dur < best.dur):
                best = a
        tot["host idle" if best is None else best.name[:120]] += e - s
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

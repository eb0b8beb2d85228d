"""Idle time and counts charged to the program's spans.

The port enters named host spans through ``utils/profiling.span``:
``lqp.scale``, ``lqp.factorize``, ``lqp.loop`` and ``lqp.check``.  Under
``torch.profiler`` they are ``user_annotation`` events on the kernels'
clock, so ``Trace.host`` holds them.  An idle gap of the window
(``trace.gaps``) is charged whole to the innermost ``lqp.*`` span the host
was in when the gap began: a gap that opens while the host waits in
``lqp.check`` is the check's round trip, one that opens in ``lqp.loop``
outside a check is the loop's issue rate, one that opens outside every
span goes to no span.

Readers (``metrics/*.py``) divide by the traced units and return None
where the trace has no device work or no span of the name they read.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from qpbench import trace as tr

PREFIX = "lqp."


def program_spans(trace: tr.Trace, name: str = None) -> List[tr.Activity]:
    """The ``lqp.*`` spans (of ``name`` alone, if given) that meet the
    window, by start."""
    lo, hi = trace.window
    return sorted((a for a in trace.host
                   if a.name.startswith(PREFIX)
                   and (name is None or a.name == name)
                   and a.end > lo and a.start < hi),
                  key=lambda a: a.start)


def innermost(spans, times) -> List[Optional[tr.Activity]]:
    """For each of ``times``, the innermost of ``spans`` whose half-open
    interval [start, end) holds it (the latest started of those open), or
    None."""
    bounds = []
    for s in spans:
        if s.dur > 0:
            # At one instant ends come before starts, and an outer (longer)
            # span opens before an inner one.
            bounds.append((s.start, 1, -s.dur, s))
            bounds.append((s.end, 0, s.dur, s))
    bounds.sort(key=lambda b: b[:3])
    out: List[Optional[tr.Activity]] = [None] * len(times)
    open_: List[tr.Activity] = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        while j < len(bounds) and bounds[j][0] <= times[i]:
            s = bounds[j][3]
            if bounds[j][1]:
                open_.append(s)
            else:
                # Spans of two host threads need not close in order.
                k = max(k for k, o in enumerate(open_) if o is s)
                del open_[k]
            j += 1
        out[i] = open_[-1] if open_ else None
    return out


def idle_s(trace: tr.Trace) -> Dict[str, float]:
    """Seconds of the window's idle gaps by the span the host was in when
    each gap began."""
    gaps = tr.gaps(trace)
    owner = innermost(program_spans(trace), [g[0] for g in gaps])
    tot: Dict[str, float] = defaultdict(float)
    for (s, e), sp in zip(gaps, owner):
        if sp is not None:
            tot[sp.name] += e - s
    return dict(tot)


def nested(trace: tr.Trace, inner: str, outer: str) -> int:
    """How many ``inner`` spans lie inside an ``outer`` span (``outer``
    spans do not nest in one another)."""
    outs = program_spans(trace, outer)
    starts = [o.start for o in outs]
    n = 0
    for s in program_spans(trace, inner):
        i = bisect.bisect_right(starts, s.start) - 1
        if i >= 0 and outs[i].end >= s.end:
            n += 1
    return n


def _readable(run, name: str) -> bool:
    return (run.trace is not None and bool(run.trace.device)
            and bool(run.records) and bool(program_spans(run.trace, name)))


def idle_ms(run, name: str) -> Optional[float]:
    """Mean idle time per traced unit charged to ``name``."""
    if not _readable(run, name):
        return None
    return 1e3 * idle_s(run.trace).get(name, 0.0) / len(run.records)


def nested_per_unit(run, inner: str, outer: str) -> Optional[float]:
    """Mean count per traced unit of ``inner`` spans inside ``outer``
    ones; 0 is a reading where ``outer`` spans exist."""
    if not _readable(run, outer):
        return None
    return nested(run.trace, inner, outer) / len(run.records)

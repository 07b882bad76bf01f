"""The program's own host spans (``rajepy.*``) in a traced window: how
long the host was inside a span, and how long the card sat idle
meanwhile.  Spans and device operations share the profiler's clock."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .trace import Trace, union

Interval = Tuple[float, float]            # (start_us, end_us)


def _complement(intervals: Sequence[Interval], lo: float, hi: float
                ) -> List[Interval]:
    """The stretches of [lo, hi] that disjoint, sorted ``intervals``
    leave uncovered."""
    out, t = [], lo
    for s, e in intervals:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _intersect(a: Sequence[Interval], b: Sequence[Interval]
               ) -> List[Interval]:
    """The points in both of two disjoint, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _seconds(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals) / 1e6


def intervals(trace: Trace, name: str) -> List[Interval]:
    """The window's stretches inside any host span named ``name``."""
    lo, hi = trace.window
    return union([(max(s, lo), min(e, hi)) for n, s, e in trace.host
                  if n == name and e > lo and s < hi])


def idle(trace: Trace) -> List[Interval]:
    """The window's stretches with nothing (no kernel, copy or set) on
    the card."""
    return _complement(union([(s, e) for _, s, e in trace.device]),
                       *trace.window)


def split(trace: Trace, name: str, exclude: Sequence[str] = ()
          ) -> Optional[Tuple[float, float]]:
    """(host seconds, device-idle seconds) inside the spans named
    ``name`` and outside those named in ``exclude``, over the window; None
    where the window holds no span ``name``."""
    inside = intervals(trace, name)
    if not inside:
        return None
    lo, hi = trace.window
    for other in exclude:
        inside = _intersect(inside, _complement(intervals(trace, other),
                                                lo, hi))
    return _seconds(inside), _seconds(_intersect(inside, idle(trace)))

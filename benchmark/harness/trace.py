"""What the traced run reads from ``torch.profiler``: the device's
operations (kernels, copies, sets) and the host's spans over the traced
window, which runs from the start of the first request span to the end of
the last."""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

REQUEST_SPAN = 'bench.request'

Event = Tuple[str, float, float]          # (name, start_us, end_us)
NAME_CHARS = 160                          # of a name in the breakdown


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Disjoint, sorted intervals covering the same points."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    """Device operations and host spans of one traced window.

    ``device``: every operation that ran on the card; ``host``: the
    host's spans (the profiler's operator, runtime-call and benchmark
    spans); ``window``: (start_us, end_us)."""

    def __init__(self, device: Sequence[Event], host: Sequence[Event],
                 window: Tuple[float, float]):
        self.window = window
        lo, hi = window
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi]
        self.host = list(host)

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        """From a finished ``torch.profiler.profile``'s raw events (the
        profiler's own event tree is far slower to build)."""
        from torch.autograd import DeviceType
        device, host = [], []
        for ev in prof.profiler.kineto_results.events():
            item = (ev.name(), ev.start_ns() / 1e3, ev.end_ns() / 1e3)
            if ev.device_type() != DeviceType.CUDA:
                if not item[0].startswith('ProfilerStep'):
                    host.append(item)
            elif not (ev.is_user_annotation() or
                      item[0].startswith(('bench.', 'ProfilerStep'))):
                # (the device timeline mirrors host spans as annotations)
                device.append(item)
        spans = [h for h in host if h[0] == REQUEST_SPAN]
        if not spans:
            raise RuntimeError("the trace holds no request span")
        return cls(device, host, (min(s for _, s, _ in spans),
                                  max(e for _, _, e in spans)))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self, keep: Callable[[str], bool] = lambda n: True) -> float:
        """Seconds in which at least one kept operation ran."""
        return sum(e - s for s, e in union(
            [(s, e) for n, s, e in self.device if keep(n)])) / 1e6

    def op_seconds(self, keep: Callable[[str], bool]) -> float:
        """Summed durations of the kept operations [s]."""
        return sum(e - s for n, s, e in self.device if keep(n)) / 1e6

    def op_count(self, keep: Callable[[str], bool] = lambda n: True) -> int:
        return sum(1 for n, _, _ in self.device if keep(n))

    def top_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took the most time, by name:
        [[name, seconds], ...]."""
        total = {}
        for name, s, e in self.device:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[k[:NAME_CHARS], v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches of the window with nothing on the
        device, each named by the two innermost host spans open at its
        middle ('outer > inner'): [[name, seconds], ...]."""
        lo, hi = self.window
        busy = union([(s, e) for _, s, e in self.device])
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            open_ = sorted((h for h in self.host if h[1] <= mid <= h[2]),
                           key=lambda h: h[2] - h[1])[:2]
            name = ' > '.join(h[0][:NAME_CHARS] for h in reversed(open_)) \
                or 'no span'
            out.append([name, (e - s) / 1e6])
        return out

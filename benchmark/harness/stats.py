"""Arithmetic of the end-to-end metrics and of the spread of repeated
runs.  Every statistic is taken over all requests and all the time of the
measured window."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(n_done: int, window_s: float) -> float:
    """Requests completed per second over the whole window."""
    if window_s <= 0:
        raise ValueError(f"window of {window_s} s")
    return n_done / window_s


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of ``values`` do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[math.ceil(0.95 * len(ordered)) - 1]


def per_step_ms(window_s: float, steps: int) -> float:
    """Milliseconds of window per optimiser step."""
    if steps <= 0:
        raise ValueError("no completed step")
    return window_s / steps * 1e3


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile (``statistics.
    quantiles``, n=4) as a share of the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

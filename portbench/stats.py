"""Rate, percentile and spread arithmetic on host-clock timestamps."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear between the two nearest
    ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def latencies_ms(read_t: Sequence[float], yield_t: Sequence[float]):
    """Each frame's time from its hand-over by the capture to its
    disparity on the host, in ms, over the frames that came back."""
    return [(y - r) * 1e3 for r, y in zip(read_t, yield_t)]


def rate(read_t: Sequence[float], yield_t: Sequence[float]) -> float:
    """Frames that came back over the window's time: from the first
    hand-over to the last disparity."""
    if not yield_t:
        return 0.0
    return len(yield_t) / (yield_t[-1] - read_t[0])


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles`` with n=4)."""
    q1, median, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / median

"""Arithmetic of the metrics: percentiles, intervals on a timeline."""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def tail_percentile(n: int) -> Optional[int]:
    """The highest integer percentile P with at least 10 of ``n`` samples
    beyond it, n (100 - P) / 100 >= 10; None where that P is below 50."""
    p = 100 - math.ceil(1000 / n) if n else 0
    return p if p >= 50 else None


def percentile(xs: Sequence[float], p: float) -> float:
    """The ``p``-th percentile of ``xs``, linear between the order
    statistics (numpy's default)."""
    s = sorted(xs)
    if not s:
        raise ValueError("percentile of no samples")
    pos = (len(s) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def merged(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    """The union of ``intervals`` clipped to ``window``, as disjoint sorted
    intervals."""
    lo, hi = window
    out: List[Interval] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def covered(intervals: Iterable[Interval], window: Interval) -> float:
    """Length of the union of ``intervals`` inside ``window``."""
    return sum(e - s for s, e in merged(intervals, window))


def gaps(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    """The parts of ``window`` that no interval covers."""
    out, at = [], window[0]
    for s, e in merged(intervals, window):
        if s > at:
            out.append((at, s))
        at = e
    if window[1] > at:
        out.append((at, window[1]))
    return out

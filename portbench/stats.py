"""The statistics the metrics take: over every frame of the window, and
over the union of device intervals."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def rate(count: float, frames: Sequence[Interval], start: float) -> float:
    """``count`` units of work over the window's whole time: from its
    start to the end of its last frame."""
    return count / (frames[-1][1] - start)


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile of all values (linear between the order
    statistics, ``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(p) - 1]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged intervals, sorted: overlapping work counted once."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(merged: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The parts of ``[lo, hi]`` that ``merged`` (from ``union``) leaves
    uncovered, in time order."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]

"""Order statistics of the benchmark."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between order
    statistics (numpy's default): rank q/100 * (n - 1)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    r = q / 100.0 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def busy_union(intervals) -> float:
    """Total length covered by a set of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers, in order."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]

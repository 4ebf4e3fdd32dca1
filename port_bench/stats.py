"""The benchmark's own statistics (the program's rolling percentiles are not used)."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile over every value: the smallest value with at
    least ``q`` percent of the values at or below it; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total

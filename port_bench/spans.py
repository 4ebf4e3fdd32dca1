"""Reductions of the program's spans: (name, pid, tid, ts_us, dur_us) tuples."""
from __future__ import annotations

from collections import defaultdict

from port_bench.stats import union_seconds


def span_ms(spans, match) -> float:
    """Milliseconds covered by the matching spans, lane by lane (pid, tid),
    a matching span inside another counted once."""
    lanes = defaultdict(list)
    for name, pid, tid, ts, dur in spans:
        if match(name):
            lanes[(pid, tid)].append((ts, ts + dur))
    return sum(union_seconds(iv) for iv in lanes.values()) / 1e3

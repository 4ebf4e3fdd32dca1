"""Collating worker spans onto the host timeline.

Process replicas (serve/sched) run their own ``Tracer`` on their own
``perf_counter_ns`` clock — the two clocks share a rate (CLOCK_MONOTONIC)
but not an origin, and the origin gap is different for every spawned
process.  This module owns the two halves of stitching them together:

  * ``estimate_clock_offset`` — the ping half.  N round trips to the worker
    keep the minimum-RTT sample; under the symmetric-delay assumption the
    worker clock read happened at the midpoint of that round trip, so
    ``offset = t_worker - (t0 + t1) / 2`` with error bounded by RTT/2 (a few
    microseconds over a local pipe).  ``ProcessReplica`` runs this after
    every ready handshake, so a respawned replica re-syncs automatically.

  * ``span_from_wire`` / ``ingest_worker_spans`` — the merge half.  Worker
    spans travel as wire dicts with absolute worker-clock nanoseconds
    (Tracer.drain_wire); subtracting the offset and the host tracer's epoch
    lands them on the host timeline in host microseconds.  Each span keeps
    the worker's os pid, so the Chrome trace renders every replica as its
    own named process lane next to the host's lane 0.

``nesting_violations`` is the invariant checker the tests (and anyone
debugging a skewed trace) lean on: within one (pid, tid) lane, complete
spans must either nest or be disjoint — a partial overlap means the clock
mapping or the span bookkeeping is wrong.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable

from repro_torch.obs.trace import Span, Tracer

CLOCK_SYNC_PINGS = 7  # round trips per sync; min-RTT sample wins


def estimate_clock_offset(
    roundtrip: Callable[[], int], n: int = CLOCK_SYNC_PINGS
) -> tuple[int, int]:
    """Estimate a remote monotonic clock's offset from this process's.

    ``roundtrip()`` performs one request/response exchange and returns the
    remote ``perf_counter_ns`` reading.  Returns ``(offset_ns, rtt_ns)`` of
    the minimum-RTT sample; ``remote - offset_ns`` maps a remote timestamp
    into this process's clock, with error bounded by ``rtt_ns / 2``.
    """
    if n < 1:
        raise ValueError(f"clock sync needs >= 1 ping, got {n}")
    best: tuple[int, int] | None = None
    for _ in range(n):
        t0 = time.perf_counter_ns()
        t_remote = int(roundtrip())
        t1 = time.perf_counter_ns()
        rtt = t1 - t0
        if best is None or rtt < best[1]:
            best = (t_remote - (t0 + t1) // 2, rtt)
    return best


def span_from_wire(d: dict, *, offset_ns: int, epoch_ns: int, pid: int) -> Span:
    """One wire dict (Tracer.drain_wire) -> a Span on the host timeline."""
    return Span(
        name=d["name"],
        ts_us=(d["ts_ns"] - offset_ns - epoch_ns) / 1e3,
        dur_us=d["dur_us"],
        tid=d["tid"],
        depth=d["depth"],
        attrs=dict(d.get("attrs") or {}),
        pid=pid,
    )


def ingest_worker_spans(
    tracer: Tracer,
    wire_spans: Iterable[dict],
    *,
    offset_ns: int,
    pid: int,
    label: str | None = None,
) -> int:
    """Merge a replica's shipped span buffer into the host tracer.

    ``offset_ns`` comes from ``estimate_clock_offset`` against that replica;
    ``pid`` keys the replica's Chrome-trace lane and ``label`` names it.
    Returns the number of spans ingested.
    """
    if label is not None:
        tracer.set_process_name(pid, label)
    n = 0
    for d in wire_spans:
        tracer.add_span(
            span_from_wire(d, offset_ns=offset_ns, epoch_ns=tracer.epoch_ns, pid=pid)
        )
        n += 1
    return n


def nesting_violations(spans: Iterable[Span], slack_us: float = 0.0) -> list[str]:
    """Check the per-lane nesting invariant over complete spans.

    Within one (pid, tid) lane, any two spans must either nest (one interval
    contains the other) or be disjoint; a partial overlap beyond
    ``slack_us`` is reported.  Returns human-readable violation strings
    (empty = the collated timeline is consistent).
    """
    lanes: dict[tuple[int, int], list[Span]] = {}
    for s in spans:
        lanes.setdefault((s.pid, s.tid), []).append(s)
    bad: list[str] = []
    for (pid, tid), lane in lanes.items():
        # sort by start, longest first, so containment shows up as a stack
        lane.sort(key=lambda s: (s.ts_us, -s.dur_us))
        stack: list[Span] = []
        for s in lane:
            while stack and s.ts_us >= stack[-1].ts_us + stack[-1].dur_us - slack_us:
                stack.pop()
            if stack:
                parent = stack[-1]
                if s.ts_us + s.dur_us > parent.ts_us + parent.dur_us + slack_us:
                    bad.append(
                        f"lane (pid={pid}, tid={tid}): {s.name!r} "
                        f"[{s.ts_us:.1f}, {s.ts_us + s.dur_us:.1f}]us partially "
                        f"overlaps {parent.name!r} "
                        f"[{parent.ts_us:.1f}, {parent.ts_us + parent.dur_us:.1f}]us"
                    )
            stack.append(s)
    return bad

"""Metrics registry: counters, gauges, fixed-bucket histograms, collectors.

One ``Registry`` per engine (the facade aggregates its shards' registries
through collectors) replaces the hand-rolled stats dicts that used to live
in serve/boolean.py, serve/shard.py, serve/cache.py, postings/search.py and
rank/topk.py.  ``Registry.snapshot()`` is the single read path: primitives
report their values under their dotted names and registered collectors are
invoked lazily (a collector returning None is omitted, which is how
"no ranked queries yet → no 'ranked' section" is expressed).

``Histogram`` is fixed-bucket: observations land in log-spaced buckets and
percentiles interpolate linearly inside the bracketing bucket, clamped to
the observed min/max — so p50/p90/p99 are exact to within one bucket width
(tested against numpy quantiles).  Fixed buckets keep ``observe`` O(log B)
with zero allocation, which is what lets the serving hot path record
per-phase latencies unconditionally.

``Registry.reset()`` is the single reset path: primitives zero and every
registered reset hook runs — the facade resets shards, shards reset their
guided/ranked/cache accounting — so no caller ever reaches into another
component's private state to start a fresh measurement window.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Callable


class Counter:
    """Monotonic event count (resettable for measurement windows)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self) -> int:
        return int(self.value)


class Gauge:
    """Last-set value (queue depth, resident bytes, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0.0

    def snapshot(self) -> float:
        return float(self.value)


def default_latency_buckets() -> list[float]:
    """Log-spaced microsecond buckets, 1us .. 10s (4 per decade)."""
    return [10 ** (k / 4) for k in range(29)]


class Histogram:
    """Fixed-bucket histogram with interpolated percentile summaries.

    Thread-safe: the sched loop's runner threads observe while the session
    (or an SLO scrape) snapshots.  One lock covers observe/snapshot/reset so
    a snapshot is a *consistent* view — count always equals the bucket sum,
    and min/max always bracket the percentiles — instead of a torn read
    mid-observe.  The lock is uncontended in the common case and cheaper
    than the bisect it guards.
    """

    def __init__(self, buckets: list[float] | None = None):
        edges = sorted(float(b) for b in (buckets or default_latency_buckets()))
        if not edges:
            raise ValueError("histogram needs at least one bucket edge")
        self.edges = edges  # counts[i] holds edges[i-1] <= v < edges[i]
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect_right(self.edges, v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (0..100), exact within one bucket."""
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile wants 0..100, got {q}")
        target = q / 100.0 * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            # bucket i spans [edges[i-1], edges[i]); the open tails clamp to
            # the observed extremes, as does the interpolation inside
            lo = self.edges[i - 1] if i > 0 else self.min
            hi = self.edges[i] if i < len(self.edges) else self.max
            lo, hi = max(lo, self.min), min(hi, self.max)
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return self.max

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self.edges) + 1)
            self.count = 0
            self.sum = 0.0
            self.min = float("inf")
            self.max = float("-inf")

    def snapshot(self) -> dict[str, float] | None:
        with self._lock:
            if self.count == 0:
                return None
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min,
                "max": self.max,
                "p50": self._percentile_locked(50),
                "p90": self._percentile_locked(90),
                "p99": self._percentile_locked(99),
            }


class Registry:
    """Named metrics + lazy collectors behind one snapshot()/reset() pair.

    Dotted names nest in the snapshot ("latency.plan_us" lands under
    snapshot()["latency"]["plan_us"]); collectors own a whole top-level key
    and may carry a reset hook so ``reset()`` reaches every accounting
    window exactly once, with no caller touching private state.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._collectors: dict[str, Callable[[], object]] = {}
        self._reset_hooks: list[Callable[[], None]] = []

    # ------------------------------------------------------------- create
    def _get_or_create(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, Gauge)

    def histogram(self, name: str, buckets: list[float] | None = None) -> Histogram:
        return self._get_or_create(name, Histogram, lambda: Histogram(buckets))

    def register(
        self,
        name: str,
        collector: Callable[[], object],
        *,
        reset: Callable[[], None] | None = None,
    ) -> None:
        """Attach a zero-arg collector under a top-level snapshot key; a
        None return omits the key.  ``reset`` joins the registry's hooks."""
        with self._lock:
            self._collectors[name] = collector
            if reset is not None:
                self._reset_hooks.append(reset)

    # ------------------------------------------------------------- read
    def snapshot(self) -> dict:
        out: dict = {}
        with self._lock:
            metrics = list(self._metrics.items())
            collectors = list(self._collectors.items())
        for name, m in metrics:
            v = m.snapshot()
            if v is None:
                continue
            node = out
            parts = name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        for name, fn in collectors:
            v = fn()
            if v is not None:
                out[name] = v
        return out

    def reset(self) -> None:
        with self._lock:
            metrics = list(self._metrics.values())
            hooks = list(self._reset_hooks)
        for m in metrics:
            m.reset()
        for hook in hooks:
            hook()

"""Decode cache for the serving engine: LRU with a decode-cost budget.

The FIFO term-count cache this replaces treated a 3-posting list and a
3-million-posting list as equally expensive to evict; re-decoding the long
list costs ~10^6x more.  CostLRU charges each entry its actual decode cost
(bytes of decoded output — decode work is linear in it) against a total
budget, evicts least-recently-used entries until the budget holds, and keeps
hit/miss/eviction counters for the serving memory report.

The counters are repro_torch.obs.metrics.Counter primitives — the shard's
metrics registry exposes them through its 'decode_cache' collector and
resets them through ``reset_counters`` (the int-valued ``hits``/``misses``/
``evictions`` properties keep the original accessor shape).

The newest entry is always retained even if it alone exceeds the budget
(a verification round needs the list it just decoded).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Hashable, TypeVar

from repro_torch.obs.metrics import Counter

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class CostLRU(Generic[K, V]):
    def __init__(self, budget: int):
        if budget <= 0:
            raise ValueError(f"budget must be positive, got {budget}")
        self.budget = int(budget)
        self.total_cost = 0
        self._hits = Counter()
        self._misses = Counter()
        self._evictions = Counter()
        self._entries: OrderedDict[K, tuple[V, int]] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: K) -> bool:
        return key in self._entries

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    def get(self, key: K) -> V | None:
        entry = self._entries.get(key)
        if entry is None:
            self._misses.inc()
            return None
        self._entries.move_to_end(key)
        self._hits.inc()
        return entry[0]

    def peek(self, key: K) -> V | None:
        """The cached value, or None, leaving counters and recency as they are."""
        entry = self._entries.get(key)
        return None if entry is None else entry[0]

    def put(self, key: K, value: V, cost: int) -> None:
        cost = max(int(cost), 1)
        old = self._entries.pop(key, None)
        if old is not None:
            self.total_cost -= old[1]
        self._entries[key] = (value, cost)
        self.total_cost += cost
        while self.total_cost > self.budget and len(self._entries) > 1:
            _, (_, c) = self._entries.popitem(last=False)
            self.total_cost -= c
            self._evictions.inc()

    def reset_counters(self) -> None:
        """Zero the hit/miss/eviction window; cached entries stay resident."""
        self._hits.reset()
        self._misses.reset()
        self._evictions.reset()

    def stats(self) -> dict[str, int]:
        return {
            "entries": len(self._entries),
            "cost_bytes": self.total_cost,
            "budget_bytes": self.budget,
            "hits": self._hits.value,
            "misses": self._misses.value,
            "evictions": self._evictions.value,
        }

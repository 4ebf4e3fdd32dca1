"""Decode cache for the serving engine: LRU with a decode-cost budget.

The FIFO term-count cache this replaces treated a 3-posting list and a
3-million-posting list as equally expensive to evict; re-decoding the long
list costs ~10^6x more.  CostLRU charges each entry its actual decode cost
(bytes of decoded output — decode work is linear in it) against a total
budget, evicts least-recently-used entries until the budget holds, and keeps
hit/miss/eviction counters for the serving memory report.

The hit/miss/eviction counters are plain integer attributes, zeroed by
``reset_counters``.

The newest entry is always retained even if it alone exceeds the budget
(a verification round needs the list it just decoded).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class CostLRU(Generic[K, V]):
    def __init__(self, budget: int):
        if budget <= 0:
            raise ValueError(f"budget must be positive, got {budget}")
        self.budget = int(budget)
        self.total_cost = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: OrderedDict[K, tuple[V, int]] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: K) -> bool:
        return key in self._entries

    def get(self, key: K) -> V | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry[0]

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
            self.evictions += 1

    def reset_counters(self) -> None:
        """Zero the hit/miss/eviction window; cached entries stay resident."""
        self.hits = self.misses = self.evictions = 0

    def stats(self) -> dict[str, int]:
        return {
            "entries": len(self._entries),
            "cost_bytes": self.total_cost,
            "budget_bytes": self.budget,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

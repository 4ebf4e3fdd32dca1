"""Batched Boolean-query serving engine — doc-partitioned planner/executor.

The paper's system in deployable form, in three layers:

  1. **plan** (serve/planner.py) — a query batch becomes per-shard probe
     plans: smallest-global-df term ordering, per-shard run masks (a shard
     skips conjunctions provably empty on its partition), and cost-model
     routes pinning each learned-codec term to guided ε-window probes or
     full decode;
  2. **execute** (serve/shard.py) — K document-partitioned ShardEngines each
     compute the batch's learned-Bloom candidates on the device (Algorithm
     3 on the bitset and membership kernels) and verify them exactly
     against their tier-2 store, returning packed result bitmaps over local
     doc ids;
  3. **merge** — shard bitmaps word-copy into the global bitmap at their
     doc-id offset (shard boundaries are 32-aligned), then materialize to
     per-query sorted doc-id arrays.

``BooleanEngine`` is the thin facade over all three.  K=1 reproduces the
unsharded engine bit-for-bit.  The reference's ranked path, store
persistence and metrics registry belong to later slices of the port.
"""
from __future__ import annotations

import numpy as np

from repro_torch.common.config import LearnedIndexConfig
from repro_torch.core.learned_bloom import LearnedBloom
from repro_torch.index.build import InvertedIndex
from repro_torch.postings.search import ProbeStats
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.planner import plan_batch
from repro_torch.serve.shard import WORD_BITS, ShardEngine, shard_ranges, unpack_row

__all__ = ["BooleanEngine", "ServeConfig"]


class BooleanEngine:
    """Facade: plans a batch, fans it out across shards, merges bitmaps."""

    def __init__(
        self,
        lb: LearnedBloom,
        inv: InvertedIndex,
        li_cfg: LearnedIndexConfig,
        cfg: ServeConfig | None = None,
    ):
        self.cfg = cfg or ServeConfig()
        self.lb = lb
        self.inv = inv
        self.li_cfg = li_cfg
        self.n_docs = lb.n_docs
        self._ranges = shard_ranges(inv.n_docs, self.cfg.n_shards)
        self._shards = [
            ShardEngine.from_range(lb, inv, li_cfg, self.cfg, lo, hi) if hi > lo else None
            for lo, hi in self._ranges
        ]
        for sid, sh in enumerate(self.shards):
            sh.shard_id = sid
        self._global_dfs = inv.dfs

    # ------------------------------------------------------------- shards
    @property
    def shards(self) -> list[ShardEngine]:
        """Non-empty shard executors, ascending doc range."""
        return [s for s in self._shards if s is not None]

    @property
    def n_shards(self) -> int:
        return len(self._ranges)

    @property
    def tier2(self):
        """K=1 convenience: the single shard's compressed tier-2 store."""
        active = self.shards
        return active[0].tier2 if len(active) == 1 else None

    # ------------------------------------------------------------- query
    def query_batch(self, queries: np.ndarray) -> list[np.ndarray]:
        """(Q, T) padded term ids -> list of result doc-id arrays."""
        q = self._padded(queries)
        if q.shape[0] == 0:
            return []
        if (q < 0).all():  # all-padding batch: empty without touching a probe
            return [np.zeros(0, np.int32) for _ in range(q.shape[0])]
        bitmap = self._execute(q)
        return [unpack_row(bitmap[i], self.n_docs) for i in range(q.shape[0])]

    def query_batch_bitmap(self, queries: np.ndarray) -> np.ndarray:
        """(Q, T) padded term ids -> (Q, ceil(n_docs/32)) packed uint32 bitmap."""
        q = self._padded(queries)
        words = (self.n_docs + WORD_BITS - 1) // WORD_BITS
        if q.shape[0] == 0 or (q < 0).all():
            return np.zeros((q.shape[0], words), dtype=np.uint32)
        return self._execute(q)

    def _padded(self, queries: np.ndarray) -> np.ndarray:
        q = np.asarray(queries, dtype=np.int32)
        if q.ndim != 2:
            raise ValueError(f"queries must be (Q, T), got shape {q.shape}")
        if q.shape[1] < self.cfg.max_query_terms:
            q = np.pad(q, ((0, 0), (0, self.cfg.max_query_terms - q.shape[1])),
                       constant_values=-1)
        return q

    def _execute(self, q: np.ndarray) -> np.ndarray:
        """Plan, run every shard (candidate masks on the device, then exact
        verification), merge packed bitmaps by doc offset."""
        active = self.shards
        plan = plan_batch(q, self._global_dfs, active, verified=self.cfg.verified)
        parts = []
        for sh, sp in zip(active, plan.shard_plans):
            parts.append(sh.execute(q, sp, plan.qplans))
        return self._merge(parts, active)

    def _merge(self, parts: list[np.ndarray], active: list[ShardEngine]) -> np.ndarray:
        """Word-copy each shard's packed bitmap at its doc-id offset (shard
        boundaries are 32-aligned, so no cross-shard bit arithmetic)."""
        n_queries = parts[0].shape[0] if parts else 0
        out = np.zeros((n_queries, (self.n_docs + WORD_BITS - 1) // WORD_BITS), np.uint32)
        for sh, bm in zip(active, parts):
            off = sh.lo // WORD_BITS
            out[:, off : off + bm.shape[1]] = bm
        return out

    # ------------------------------------------------------------- stats
    def memory_report(self) -> dict[str, int]:
        """Bits used by each component (feeds the Eq.(2) comparison);
        block-bitmap and tier-2 bits summed over shards."""
        report = {
            "model_bits": self.lb.size_bits(),
            "block_bitmap_bits": 0,
            "backup_bits": int(self.lb.backup_keys.size * 64),
        }
        tier2_bits = None
        for sh in self.shards:
            bits = sh.memory_bits()
            report["block_bitmap_bits"] += bits["block_bitmap_bits"]
            if "tier2_bits" in bits:
                tier2_bits = (tier2_bits or 0) + bits["tier2_bits"]
        if tier2_bits is not None:
            report["tier2_bits"] = tier2_bits
        return report

    def serving_stats(self) -> dict:
        """Per-shard stats plus the cache and guided-probe counters summed
        across shards."""
        per = [sh.serving_stats() for sh in self.shards]
        keys = ("entries", "cost_bytes", "budget_bytes", "hits", "misses", "evictions")
        cache = {k: sum(s["decode_cache"][k] for s in per) for k in keys}
        guided = [sh._guided.stats for sh in self.shards if sh._guided is not None]
        fields = ("probes", "guided_terms", "fallback_terms", "routed_terms",
                  "window_bytes", "metadata_bytes", "fallback_bytes", "full_equiv_bytes")
        return {
            "decode_cache": cache,
            "guided": ProbeStats(**{f: sum(int(getattr(g, f)) for g in guided) for f in fields}).as_dict()
            if guided else None,
            "shards": per,
        }

    def reset_stats(self) -> None:
        for sh in self.shards:
            sh.reset_stats()

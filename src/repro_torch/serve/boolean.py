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
unsharded engine bit-for-bit; engines can also start from the persistent
shard-store (index/store.py) via ``from_store`` — no re-encoding, stream
bytes page in lazily via mmap — and ``save`` writes one, in the layout the
reference reads.

``query_topk`` is the ranked path over the same shards: the planner dedupes
terms and computes per-shard run masks, each ShardEngine returns its local
top-k (MaxScore over the tier-2 payload streams, the bm25_score kernel for
exhaustive queries, or fused_topk launches and the dense arena loop), and
the facade folds shard heaps in ascending doc-range order, forwarding the
running k-th best score as the next shard's pruning floor.  Scores are
integer quantized-impact sums with ties broken by ascending doc id, so the
merged top-k is bit-identical for K=1 and any K>1 — and to the brute-force
BM25 oracle (rank.score.brute_force_topk).

Observability is the reference's (repro_torch.obs): one ``metrics``
registry per facade — query counters, per-phase latency histograms
(``latency.plan_us``, ``mask_us``, ``probe_us``, ``merge_us``,
``query_us``, ``topk_query_us``) and collectors aggregating the shards
(``decode_cache``, ``shards``, ``guided``, ``ranked``, ``summary``, and the
port's ``prefetch``) — and ``serve.*`` spans on the engine's tracer.
``serving_stats()`` is the reference's deprecated alias of
``metrics.snapshot()``.  The ranked section keeps the port's count:
``queries`` tallies (query, shard) pairs, as each shard counts the items
it served.  Parallel shard execution lives one level up, in the
continuous-batching scheduler (serve/sched).
"""
from __future__ import annotations

import time
import warnings

import numpy as np

from repro_torch.common.config import LearnedIndexConfig
from repro_torch.core.learned_bloom import LearnedBloom
from repro_torch.index import store
from repro_torch.index.build import InvertedIndex
from repro_torch.obs import trace
from repro_torch.obs.metrics import Registry
from repro_torch.postings.search import ProbeStats
from repro_torch.rank.score import BM25Params, ImpactModel, TopKResult, select_topk
from repro_torch.rank.topk import RankedStats
from repro_torch.serve.config import ObsConfig, RankedConfig, SchedConfig, ServeConfig
from repro_torch.serve.planner import plan_batch, plan_ranked, ranked_run_mask
from repro_torch.serve.shard import WORD_BITS, ShardEngine, shard_ranges, slice_bloom, unpack_row

__all__ = ["BooleanEngine", "ObsConfig", "RankedConfig", "SchedConfig", "ServeConfig"]


class BooleanEngine:
    """Facade: plans a batch, fans it out across shards, merges bitmaps."""

    def __init__(
        self,
        lb: LearnedBloom,
        inv: InvertedIndex | None,
        li_cfg: LearnedIndexConfig,
        cfg: ServeConfig | None = None,
        *,
        shards: list[tuple[tuple[int, int], ShardEngine | None]] | None = None,
    ):
        self.cfg = cfg or ServeConfig()
        self.lb = lb
        self.inv = inv
        self.li_cfg = li_cfg
        self.n_docs = lb.n_docs
        self._impact_model = None
        can_rank = (
            self.cfg.ranked.enabled
            and inv is not None
            and inv.tfs is not None
            and self.cfg.postings_store == "hybrid"
        )
        # shards get the *provider*, not the model: quantizer fitting is an
        # O(n_postings) float64 pass that Boolean-only serving never needs,
        # so it runs at first ranked use (ensure_payloads), not construction
        provider = self._build_impact_model if can_rank else None
        if shards is None:
            if inv is None:
                raise ValueError("need an InvertedIndex (or prebuilt shards)")
            shards = [
                ((lo, hi),
                 ShardEngine.from_range(lb, inv, li_cfg, self.cfg, lo, hi, impact_model=provider)
                 if hi > lo else None)
                for lo, hi in shard_ranges(inv.n_docs, self.cfg.n_shards)
            ]
        self._ranges = [r for r, _ in shards]
        self._shards = [s for _, s in shards]
        active = self.shards
        for sid, sh in enumerate(active):
            sh.shard_id = sid
        if inv is not None:
            self._global_dfs = inv.dfs
        else:
            self._global_dfs = sum((s.local_dfs for s in active), start=0)
        # one registry per facade: primitives (query counters, per-phase
        # latency histograms) plus collectors aggregating the shards
        obs = self.cfg.obs
        self.metrics = obs.metrics if obs.metrics is not None else Registry()
        self._ranked_queries = self.metrics.counter("queries.ranked")
        self._boolean_queries = self.metrics.counter("queries.boolean")
        self._register_collectors()

    def _build_impact_model(self) -> ImpactModel:
        """Fit (once) the collection-global quantizer: every shard's payload
        stream is then a bit-exact slice of the global one (rank/score.py)."""
        if self._impact_model is None:
            self._impact_model = ImpactModel.build(
                self.inv, BM25Params(bits=self.cfg.ranked.payload_bits)
            )
        return self._impact_model

    @property
    def impact_model(self) -> ImpactModel | None:
        """The fitted global quantizer, or None before the first ranked use
        (and for engines that cannot rank from live arrays: no tfs, a raw
        store, or a loaded store, whose payloads carry their own scale)."""
        return self._impact_model

    @classmethod
    def from_store(
        cls,
        lb: LearnedBloom,
        li_cfg: LearnedIndexConfig,
        cfg: ServeConfig | None,
        index_dir: str,
        *,
        mmap: bool = True,
    ) -> "BooleanEngine":
        """Start from a persistent shard-store: no re-encoding, lazy streams.
        Ranked serving reads the store's payloads, scale and width."""
        cfg = cfg or ServeConfig()
        n_docs, entries = store.load_sharded(index_dir, mmap=mmap)
        if n_docs != lb.n_docs:
            raise ValueError(f"store has {n_docs} docs, model {lb.n_docs}")
        shards = [
            ((lo, hi),
             ShardEngine(slice_bloom(lb, lo, hi), inv, li_cfg, cfg, lo=lo, hi=hi, tier2=tier2)
             if inv is not None else None)
            for (lo, hi), inv, tier2 in entries
        ]
        return cls(lb, None, li_cfg, cfg, shards=shards)

    def save(self, index_dir: str) -> None:
        """Persist every shard's index + compressed store (build-then-serve).

        Forces the tier-2 builds and the payloads first, so the saved layout
        is complete and carries the ranked tier; a reloaded engine never
        re-encodes."""
        if self.cfg.postings_store != "hybrid":
            raise ValueError("only the hybrid postings store is persistable")
        for sh in self.shards:
            sh.ensure_payloads()
        entries = [
            ((lo, hi), sh.inv if sh else None, sh.tier2 if sh else None)
            for (lo, hi), sh in zip(self._ranges, self._shards)
        ]
        store.save_sharded(index_dir, self.n_docs, entries)

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

    def _observe_us(self, name: str, t0_ns: int) -> None:
        self.metrics.histogram("latency." + name).observe(
            (time.perf_counter_ns() - t0_ns) / 1e3
        )

    def query_batch_bitmap(self, queries: np.ndarray) -> np.ndarray:
        """(Q, T) padded term ids -> (Q, ceil(n_docs/32)) packed uint32 bitmap."""
        q = self._padded(queries)
        words = (self.n_docs + WORD_BITS - 1) // WORD_BITS
        if q.shape[0] == 0 or (q < 0).all():
            return np.zeros((q.shape[0], words), dtype=np.uint32)
        return self._execute(q)

    def query_topk(
        self,
        queries: np.ndarray,
        k: int = 10,
        *,
        mode: str = "or",
        required: np.ndarray | None = None,
    ) -> list[TopKResult]:
        """(Q, T) padded term ids -> exact ranked top-k per query.

        ``mode`` "or" scores any matching term (disjunctive), "and" requires
        every term; a boolean ``required`` mask of queries' shape marks a
        per-position required subset for mixed AND/OR.  Results order by
        (score desc, doc id asc) and are bit-identical across shard counts
        and to brute-force quantized-BM25 over decoded postings.
        """
        q = np.asarray(queries, dtype=np.int32)
        if q.ndim != 2:
            raise ValueError(f"queries must be (Q, T), got shape {q.shape}")
        empty = TopKResult(ids=np.zeros(0, np.int32), scores=np.zeros(0, np.int64))
        if k <= 0:
            return [empty for _ in range(q.shape[0])]
        self._ranked_queries.inc(int(q.shape[0]))
        active = self.shards
        t_batch = time.perf_counter_ns()
        with trace.activate(self.cfg.obs.trace), \
                trace.span("serve.topk_batch", queries=int(q.shape[0]), k=int(k)):
            with trace.span("serve.plan"):
                qplans = plan_ranked(q, self._global_dfs, mode=mode, required=required)
                runs = [ranked_run_mask(qplans, sh.local_dfs) for sh in active]
            # a shard whose run mask is all-empty contributes nothing to any heap
            live = [(sh, run) for sh, run in zip(active, runs) if run.any()]
            # shards outer, one batch per shard, heap floors forwarded between
            # shards exactly as a per-query loop does: shard doc ranges ascend,
            # so each shard sees the floors the previous shards established
            heaps = [empty] * len(qplans)
            for sh, run in live:
                idx = [i for i, qp in enumerate(qplans) if not qp.dead and run[i]]
                if not idx:
                    continue
                items = []
                for i in idx:
                    floor = int(heaps[i].scores[k - 1]) if len(heaps[i].scores) == k else 0
                    items.append((qplans[i].terms, k, qplans[i].required, floor))
                for i, part in zip(idx, sh.query_topk_batch(items, queries=idx)):
                    if len(part.ids):
                        with trace.span("serve.heap_merge", query=i, shard=sh.shard_id):
                            heaps[i] = _merge_heap(heaps[i], part, k)
        # per-query latency at batch granularity: each live query is charged
        # the batch mean (the shards serve a batch, not one query at a time)
        n_live = sum(1 for qp in qplans if not qp.dead)
        if n_live:
            us = (time.perf_counter_ns() - t_batch) / 1e3 / n_live
            hist = self.metrics.histogram("latency.topk_query_us")
            for _ in range(n_live):
                hist.observe(us)
        return heaps

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
        verification), merge packed bitmaps by doc offset.  Each phase is a
        ``serve.*`` span and a ``latency.*_us`` histogram; the candidate
        masks of all shards are computed first, then verified shard by
        shard on the calling thread."""
        active = self.shards
        t_batch = time.perf_counter_ns()
        self._boolean_queries.inc(int(q.shape[0]))
        with trace.activate(self.cfg.obs.trace), \
                trace.span("serve.batch", queries=int(q.shape[0]), shards=len(active)):
            t0 = time.perf_counter_ns()
            with trace.span("serve.plan"):
                plan = plan_batch(q, self._global_dfs, active, verified=self.cfg.verified)
            self._observe_us("plan_us", t0)
            t0 = time.perf_counter_ns()
            masks = []
            for sh, sp in zip(active, plan.shard_plans):
                if sh.n_docs > 0 and sp.run.any():
                    with trace.span("serve.candidate_mask", shard=sh.shard_id):
                        masks.append(sh.candidate_mask(q))
                else:
                    masks.append(None)
            self._observe_us("mask_us", t0)
            t0 = time.perf_counter_ns()
            parts = []
            for sh, sp, m in zip(active, plan.shard_plans, masks):
                with trace.span("serve.probe_phase", shard=sh.shard_id):
                    parts.append(sh.execute(q, sp, plan.qplans, mask=m))
            self._observe_us("probe_us", t0)
            t0 = time.perf_counter_ns()
            with trace.span("serve.merge"):
                out = self._merge(parts, active)
            self._observe_us("merge_us", t0)
        # per-query latency at batch granularity: each query is charged the
        # batch mean, so histogram counts tally queries
        n_q = max(int(q.shape[0]), 1)
        us = (time.perf_counter_ns() - t_batch) / 1e3 / n_q
        hist = self.metrics.histogram("latency.query_us")
        for _ in range(n_q):
            hist.observe(us)
        return out

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
        dense-state and tier-2 bits summed over shards."""
        report = {
            "model_bits": self.lb.size_bits(),
            "tier1_bits": 0,
            "block_bitmap_bits": 0,
            "backup_bits": int(self.lb.backup_keys.size * 64),
        }
        tier2_bits = payload_bits = None
        for sh in self.shards:
            bits = sh.memory_bits()
            report["tier1_bits"] += bits["tier1_bits"]
            report["block_bitmap_bits"] += bits["block_bitmap_bits"]
            if "tier2_bits" in bits:
                tier2_bits = (tier2_bits or 0) + bits["tier2_bits"]
            if "payload_bits" in bits:
                payload_bits = (payload_bits or 0) + bits["payload_bits"]
        if tier2_bits is not None:
            report["tier2_bits"] = tier2_bits
        if payload_bits is not None:
            report["payload_bits"] = payload_bits
        return report

    def _register_collectors(self) -> None:
        """Aggregating collectors over the shards, all read through one
        ``Registry.snapshot()``."""
        reg = self.metrics
        reg.register("decode_cache", self._collect_cache)
        reg.register("prefetch", self._collect_prefetch)
        reg.register(
            "shards",
            lambda: [sh.serving_stats() for sh in self.shards],
            reset=lambda: [sh.reset_stats() for sh in self.shards],
        )
        reg.register("guided", self._collect_guided)
        reg.register("ranked", self._collect_ranked)
        reg.register("summary", self._collect_summary)

    def _collect_cache(self) -> dict[str, int]:
        keys = ("entries", "cost_bytes", "budget_bytes", "hits", "misses", "evictions")
        per = [sh._decode_cache.stats() for sh in self.shards]
        return {k: sum(s[k] for s in per) for k in keys}

    def _collect_prefetch(self) -> dict[str, int] | None:
        """The shards' batched full decodes (the port's section)."""
        per = [sh.prefetch_stats.as_dict() for sh in self.shards]
        return {k: sum(s[k] for s in per) for k in per[0]} if per else None

    def _collect_guided(self) -> dict | None:
        """'guided' keeps the single-engine shape: counters summed across
        shards, ratios recomputed by ProbeStats.as_dict."""
        per = [sh._guided.stats for sh in self.shards if sh._guided is not None]
        if not per:
            return None
        fields = ProbeStats.__dataclass_fields__
        return ProbeStats(**{f: sum(int(getattr(g, f)) for g in per) for f in fields}).as_dict()

    def _collect_ranked(self) -> dict | None:
        """RankedStats summed over shards; ``queries`` counts (query, shard)
        pairs, as each shard tallies the queries it served."""
        per = [sh.ranked_stats for sh in self.shards if sh.ranked_stats.queries]
        if not per:
            return None
        fields = RankedStats.__dataclass_fields__
        return RankedStats(**{f: sum(int(getattr(r, f)) for r in per) for f in fields}).as_dict()

    def _collect_summary(self) -> dict:
        """The one-number view benchmarks report (the reference's keys)."""
        cache = self._collect_cache()
        guided = self._collect_guided()
        ranked = self._collect_ranked()
        return {
            "n_shards": len(self.shards),
            "cache_hits": cache["hits"],
            "cache_misses": cache["misses"],
            "cache_evictions": cache["evictions"],
            "probe_bytes": guided["guided_bytes"] if guided else 0,
            "bytes_ratio": guided["bytes_ratio"] if guided else 0.0,
            "scored_fraction": ranked["scored_fraction"] if ranked else 0.0,
        }

    def serving_stats(self) -> dict[str, dict]:
        """Deprecated: one snapshot of the facade metrics registry; read
        ``engine.metrics.snapshot()`` instead."""
        warnings.warn(
            "serving_stats() is deprecated; read engine.metrics.snapshot()",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.metrics.snapshot()

    def reset_stats(self) -> None:
        """Zero every accounting window through the metrics registry: facade
        counters/histograms reset, and each shard's ``reset_stats`` zeroes
        its own guided/ranked/cache/prefetch state (cached decodes stay
        resident, so the next pass measures warm serving)."""
        self.metrics.reset()


def _merge_heap(heap: TopKResult, part: TopKResult, k: int) -> TopKResult:
    """Fold one shard's top-k into the running heap (score desc, id asc)."""
    return select_topk(
        np.concatenate([heap.ids, part.ids]), np.concatenate([heap.scores, part.scores]), k
    )

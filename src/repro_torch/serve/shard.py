"""Doc-partitioned shard executor: one shard of the Boolean serving engine.

``ShardEngine`` owns everything one document partition needs to serve its
slice of a query batch end to end:

  * a learned-Bloom slice (doc-embedding rows [lo, hi) of the global model +
    the global per-term zero-FN thresholds — a min over a superset of each
    shard's positives, so the zero-false-negative guarantee survives
    partitioning) and the dense EngineState built from it, on the device;
  * a local compressed tier-2 store (HybridPostings over local doc ids,
    built lazily on the host);
  * its own guided-probe ``TermModel``s (GuidedPostings) and decode-cost
    budgeted ``CostLRU``.

``candidate_mask`` returns the learned-Bloom candidates as packed words (32
docs per word), which is what leaves the device: 32x fewer bytes than a bool
mask.  ``execute`` verifies each query's candidates exactly — guided
ε-window probes for learned-codec terms, galloping search over full decodes
otherwise; full decodes of learned-codec lists go through the ``plm_decode``
kernel — and returns a *packed bitmap* over local doc ids, word-copyable into
the global bitmap because shard boundaries are aligned to 32-doc words
(``shard_ranges``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.common.config import LearnedIndexConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import algorithms as alg
from repro_torch.core.learned_bloom import LearnedBloom
from repro_torch.index.build import InvertedIndex, slice_index
from repro_torch.index.intersect import gallop_membership
from repro_torch.postings.search import full_decode
from repro_torch.serve.cache import CostLRU
from repro_torch.serve.planner import QueryPlan, ShardPlan

WORD_BITS = 32  # packed-bitmap word width; shard boundaries align to this


def shard_ranges(n_docs: int, k: int, *, align: int = WORD_BITS) -> list[tuple[int, int]]:
    """K contiguous doc-id ranges covering [0, n_docs), boundaries aligned.

    Alignment to 32-doc words lets per-shard packed result bitmaps merge into
    the global bitmap by pure word copy (no cross-shard bit shifting).  Small
    collections can yield empty ranges (lo == hi) — the facade skips them.
    """
    if k <= 0:
        raise ValueError(f"need k >= 1 shards, got {k}")
    cuts = [0]
    for i in range(1, k):
        c = int(round(i * n_docs / k / align)) * align
        cuts.append(min(max(c, cuts[-1]), n_docs))
    cuts.append(n_docs)
    return [(cuts[i], cuts[i + 1]) for i in range(k)]


def slice_bloom(lb: LearnedBloom, lo: int, hi: int) -> LearnedBloom:
    """Learned-Bloom restriction to docs [lo, hi), rebased to local ids: the
    doc-embedding rows are sliced, the term table and τ are shared (τ_t
    fitted over *all* positives lower-bounds the shard's, so zero-FN holds
    locally)."""
    return LearnedBloom(model=lb.model.slice_docs(lo, hi), tau=lb.tau, n_docs=hi - lo)


def pack_ids(ids: np.ndarray, n_docs: int) -> np.ndarray:
    """Sorted unique doc ids -> packed uint32 bitmap (bit d%32 of word d//32)."""
    out = np.zeros((n_docs + WORD_BITS - 1) // WORD_BITS, dtype=np.uint32)
    if len(ids):
        ids = np.asarray(ids, np.int64)
        np.bitwise_or.at(out, ids // WORD_BITS, np.uint32(1) << (ids % WORD_BITS).astype(np.uint32))
    return out


def unpack_row(words: np.ndarray, n_docs: int) -> np.ndarray:
    """Packed uint32 bitmap row -> sorted int32 doc ids (inverse of pack_ids)."""
    bits = np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), bitorder="little"
    )[:n_docs]
    return np.nonzero(bits)[0].astype(np.int32)


class ShardEngine:
    """Executor for one document partition."""

    def __init__(
        self,
        lb: LearnedBloom,
        inv: InvertedIndex,
        li_cfg: LearnedIndexConfig,
        cfg,  # ServeConfig
        *,
        lo: int = 0,
        hi: int | None = None,
        tier2=None,  # prebuilt HybridPostings over this shard's local ids
    ):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if lb.device != self.device:
            raise ValueError(f"learned Bloom lives on {lb.device}, engine on {self.device}")
        self.inv = inv
        self.lb = lb
        self.lo = lo
        self.hi = inv.n_docs if hi is None else hi
        self.shard_id = 0  # position in the facade's shard list (it sets this)
        self._tier2 = tier2 if cfg.postings_store == "hybrid" else None
        self._guided = None  # lazy GuidedPostings over tier-2
        self._dfs = inv.dfs  # local document frequencies, materialized once
        self._decode_cache: CostLRU[int, np.ndarray] = CostLRU(cfg.cache_budget_bytes)
        self.state = alg.build_engine(lb.model, lb.tau, inv, block_size=li_cfg.block_size)

    @classmethod
    def from_range(cls, lb, inv, li_cfg, cfg, lo: int, hi: int, tier2=None) -> "ShardEngine":
        """Build the shard by slicing a global model + index to [lo, hi)."""
        return cls(
            slice_bloom(lb, lo, hi), slice_index(inv, lo, hi), li_cfg, cfg,
            lo=lo, hi=hi, tier2=tier2,
        )

    # ------------------------------------------------------------- stores
    @property
    def n_docs(self) -> int:
        return self.inv.n_docs

    @property
    def local_dfs(self) -> np.ndarray:
        """Per-term local document frequencies (the planner's run/est input)."""
        return self._dfs

    @property
    def tier2(self):
        """Compressed tier-2 postings store (hybrid per-term codec choice)."""
        if self._tier2 is None and self.cfg.postings_store == "hybrid":
            from repro_torch.postings import HybridPostings

            self._tier2 = HybridPostings.from_index(self.inv)
        return self._tier2

    @property
    def guided(self):
        """Model-guided prober over tier-2 (None when serving raw postings)."""
        if self._guided is None:
            store = self.tier2
            if store is not None and self.cfg.use_guided:
                from repro_torch.postings import GuidedPostings

                self._guided = GuidedPostings(store, fallback=self._postings, device=self.device)
        return self._guided

    def _postings(self, t: int) -> np.ndarray:
        """Fully-decoded postings of term t, via the cost-budgeted LRU."""
        store = self.tier2
        if store is None:
            return self.inv.postings(t)
        hit = self._decode_cache.get(t)
        if hit is None:
            hit = full_decode(store, t, self.device)
            self._decode_cache.put(t, hit, hit.nbytes)
        return hit

    # ------------------------------------------------------------- planning
    def route_term(self, t: int, est_cands: int) -> str | None:
        """Cost-model route for term t at the planner's candidate estimate:
        'guided' | 'decode' for learned-codec terms, None when no model
        applies (classical codec, raw store, or guided probing disabled)."""
        g = self.guided
        if g is None:
            return None
        tm = g.term_model(t)
        if tm is None:
            return None
        return "guided" if est_cands * tm.avg_window < tm.n else "decode"

    # ------------------------------------------------------------- execute
    def candidate_mask(self, q: np.ndarray) -> np.ndarray:
        """(Q, T) padded terms -> (Q, words) packed uint32 learned-Bloom
        candidates over local doc ids."""
        words = alg.run_queries(self.state, q, self.cfg.algorithm)
        return words.cpu().numpy().view(np.uint32)

    def execute(
        self,
        q: np.ndarray,
        plan: ShardPlan | None = None,
        qplans: list[QueryPlan] | None = None,
        mask: np.ndarray | None = None,
    ) -> np.ndarray:
        """Serve the batch's slice on this shard -> (Q, words) packed bitmap
        over local doc ids.  Honors the planner's run mask and probe routes
        when given; without a plan every query runs with local term order.
        ``mask`` takes candidates the caller already computed."""
        n_queries = q.shape[0]
        words = (self.n_docs + WORD_BITS - 1) // WORD_BITS
        out = np.zeros((n_queries, words), dtype=np.uint32)
        run = plan.run if plan is not None else None
        if self.n_docs == 0 or (run is not None and not run.any()):
            return out
        if mask is None:
            mask = self.candidate_mask(q)
        for i in range(n_queries):
            if run is not None and not run[i]:
                continue
            if not self.cfg.verified:
                out[i] = mask[i]
                continue
            ids = unpack_row(mask[i], self.n_docs)
            if qplans is not None:
                routes = plan.routes[i] if plan is not None else None
                ids = self._verify_terms(qplans[i].terms, ids, routes)
            else:
                ids = self._verify(q[i], ids)
            out[i] = pack_ids(ids, self.n_docs)
        return out

    # ------------------------------------------------------------- verify
    def _verify(self, query: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Exact candidate re-check, smallest *local* list first (the
        plan-less path: direct shard use and unit tests)."""
        terms = sorted({int(t) for t in query if t >= 0})  # dedupe repeats
        if not terms or len(ids) == 0:
            return ids
        terms.sort(key=lambda t: int(self._dfs[t]))
        return self._verify_terms(tuple(terms), ids)

    def _verify_terms(
        self,
        terms: tuple[int, ...],
        ids: np.ndarray,
        routes: dict[int, str] | None = None,
    ) -> np.ndarray:
        """Exact re-check of candidates against tier-2 in the given term
        order.  Each term filters the (sorted) survivors either by guided
        ε-window probes (learned-codec terms, honoring the planner's route
        hint) or by galloping search over the fully-decoded list."""
        out = ids
        if not terms or len(out) == 0:
            return out
        if int(self._dfs[np.asarray(terms)].min()) == 0:
            return out[:0]  # some term occurs nowhere locally: empty AND
        guided = self.guided
        for t in terms:
            if len(out) == 0:
                break
            if guided is not None:
                hint = routes.get(t) if routes else None
                out = out[guided.contains(t, out, route=hint)]
            else:
                out = out[gallop_membership(self._postings(t), out)]
        return out

    # ------------------------------------------------------------- stats
    def memory_bits(self) -> dict[str, int]:
        """This shard's block-bitmap + tier-2 bits (facade sums across shards)."""
        bits = {"block_bitmap_bits": int(self.state.block_bitmaps.numel() * 32)}
        if self._tier2 is not None:
            bits["tier2_bits"] = int(self._tier2.size_bits())
        return bits

    def serving_stats(self) -> dict[str, dict | None]:
        """Decode-cache behaviour + guided-probe byte accounting."""
        return {
            "range": {"lo": int(self.lo), "hi": int(self.hi)},
            "decode_cache": self._decode_cache.stats(),
            "guided": self._guided.stats.as_dict() if self._guided is not None else None,
        }

    def reset_stats(self) -> None:
        """Zero the probe/cache accounting window; cached decodes stay
        resident so the next pass measures warm serving."""
        self._decode_cache.reset_counters()
        if self._guided is not None:
            self._guided.reset_stats()

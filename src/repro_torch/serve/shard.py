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
kernel, of optpfd lists through the ``pfor`` kernel.  The batch verifies
term-major, so the lists each round reads are decoded together, one launch
per kernel (``batch_decodes``), and no list goes unread — and returns a
*packed bitmap* over local doc ids, word-copyable into the global bitmap
because shard boundaries are aligned to 32-doc words (``shard_ranges``).

Observability follows the reference's names (repro_torch.obs): a
per-shard ``metrics`` registry (``serving_stats`` is its snapshot, plus the
port's ``prefetch`` section), ``shard.*`` and ``decode.*`` spans, and one
probe record per routed (query, term) probe with the query and the shard
attributed.  The batch verifies term-major, so ``shard.verify`` is one span
per verification round (``queries``, ``candidates``, ``results`` summed over
the round) and each probe record names its query itself; the records are
logged query by query when the batch is done (``GuidedPostings.batch_log``).

``query_topk_local`` is the ranked path: the shard runs MaxScore dynamic
pruning (repro_torch.rank.topk) against its tier-2 payload streams — full
decodes through the CostLRU, candidate probes through the guided ε-window
rank models landing directly on rank-aligned payloads, segment-granularity
score bounds from the store — and returns its local top-k in *global* doc
ids so the facade can merge shard heaps and forward score floors.  With
``ranked.score_kernel`` exhaustive queries score on the ``bm25_score``
kernel, one launch per batch (``query_topk_batch``); with
``ranked.fused_kernel`` it answers the batch's probe tails with
``fused_topk`` launches, or with the dense loop over a resident impact
arena where the shard fits one.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from itertools import chain

import numpy as np

from repro_torch.common.config import LearnedIndexConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import algorithms as alg
from repro_torch.core.learned_bloom import LearnedBloom
from repro_torch.index.build import InvertedIndex, slice_index
from repro_torch.index.intersect import gallop_membership
from repro_torch.obs import trace
from repro_torch.obs.metrics import Registry
from repro_torch.postings.search import decode_kernel, decode_terms, full_decode
from repro_torch.rank.score import TopKResult
from repro_torch.rank.topk import RankedStats, topk_batch
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


@dataclass
class PrefetchStats:
    """Batched full decodes (``ShardEngine.batch_decodes``): the prefetches
    that decoded anything, the lists they decoded, the lists verification
    took from the batch map instead of decoding them, and the decoded lists
    the batch never read — decodes the per-term path would not have made."""

    calls: int = 0
    decoded: int = 0
    taken: int = 0
    unused: int = 0

    def as_dict(self) -> dict[str, int]:
        return {k: int(getattr(self, k)) for k in ("calls", "decoded", "taken", "unused")}


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
        # global rank.score.ImpactModel, or a zero-arg provider of one (the
        # facade defers the O(n_postings) quantizer fit to first ranked use)
        impact_model=None,
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
        self._impact_model = impact_model
        self._ranked = None  # lazy _RankedSource over tier-2 payloads
        self.ranked_stats = RankedStats()
        self._dfs = inv.dfs  # local document frequencies, materialized once
        self._decode_cache: CostLRU[int, np.ndarray] = CostLRU(cfg.cache_budget_bytes)
        # the open batch's fetched lists (batch_decodes), those of them it
        # decoded that nothing has read yet, those decoded one at a time, and
        # while a Boolean batch verifies, the log of the current query's reads
        self._batch_lists: dict[int, np.ndarray] = {}
        self._unread: set[int] = set()
        self._solo: set[int] = set()
        self._reads: list[int] | None = None
        self._batch_depth = 0
        self.prefetch_stats = PrefetchStats()
        self.state = alg.build_engine(
            lb.model, lb.tau, inv,
            truncation_k=li_cfg.truncation_k, block_size=li_cfg.block_size,
        )

    @classmethod
    def from_range(
        cls, lb, inv, li_cfg, cfg, lo: int, hi: int, tier2=None, impact_model=None
    ) -> "ShardEngine":
        """Build the shard by slicing a global model + index to [lo, hi)."""
        return cls(
            slice_bloom(lb, lo, hi), slice_index(inv, lo, hi), li_cfg, cfg,
            lo=lo, hi=hi, tier2=tier2, impact_model=impact_model,
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

    def ensure_payloads(self) -> None:
        """Quantize + attach this shard's payload stream if it can and hasn't.

        Deferred off the Boolean-only path (packing every term costs real
        startup time).  The values are bit-identical to the global stream's
        slice because the ImpactModel's statistics are collection-global.
        """
        store = self.tier2
        if (
            store is None
            or store.has_payloads
            or self._impact_model is None
            or self.inv.tfs is None
        ):
            return
        if callable(self._impact_model):
            self._impact_model = self._impact_model()
        im = self._impact_model
        store.attach_payloads(
            im.quantize_index(self.inv, lo=self.lo),
            bits=im.params.bits,
            scale=im.scale,
        )

    @property
    def guided(self):
        """Model-guided prober over tier-2 (None when serving raw postings)."""
        if self._guided is None:
            store = self.tier2
            if store is not None and self.cfg.use_guided:
                from repro_torch.postings import GuidedPostings

                self._guided = GuidedPostings(
                    store, fallback=self._postings, device=self.device,
                    probe_log=getattr(self.cfg, "probe_log", None),
                )
        return self._guided

    def _postings(self, t: int) -> np.ndarray:
        """Fully-decoded postings of term t, via the cost-budgeted LRU; on a
        miss from the open batch's prefetched lists when they hold it.

        While a Boolean batch verifies (``_verify_batch``) the read is logged
        and the LRU only peeked: the batch replays its reads in query order
        when it is done (``_replay``)."""
        store = self.tier2
        if store is None:
            return self.inv.postings(t)
        if self._reads is not None:
            self._reads.append(t)
            hit = self._batch_lists.get(t)
            if hit is None:
                hit = self._decode_cache.peek(t)
                if hit is None:  # a host codec, or a list no round fetched
                    with trace.span("decode.postings", term=int(t)) as sp:
                        hit = full_decode(store, t, self.device)
                        sp.set(bytes=int(hit.nbytes))
                    self._solo.add(t)
                self._batch_lists[t] = hit
            self._unread.discard(t)
            return hit
        hit = self._decode_cache.get(t)
        if hit is None:
            hit = self._batch_lists.get(t)
            if hit is None:
                with trace.span("decode.postings", term=int(t)) as sp:
                    hit = full_decode(store, t, self.device)
                    sp.set(bytes=int(hit.nbytes))
            else:
                self.prefetch_stats.taken += 1
                self._unread.discard(t)
            self._decode_cache.put(t, hit, hit.nbytes)
        return hit

    @contextmanager
    def batch_decodes(self, terms=()):
        """Scope of one batch's full decodes: ``terms`` are fetched together
        up front (``_postings_many``) and kept until the outermost scope
        ends, so a list the LRU evicts mid-batch is never decoded twice."""
        self._batch_depth += 1
        try:
            self._postings_many(terms)
            yield
        finally:
            self._batch_depth -= 1
            if self._batch_depth == 0:
                self.prefetch_stats.unused += len(self._unread)
                self._unread.clear()
                self._solo.clear()
                self._batch_lists.clear()

    def _replay(self, reads) -> None:
        """The decode LRU's gets and puts for logged reads, in order; a miss
        puts the batch's copy of the list, ``taken`` where a prefetch
        fetched it (each such miss is a decode the per-term path makes)."""
        for t in chain.from_iterable(reads):
            if self._decode_cache.get(t) is None:
                hit = self._batch_lists[t]
                self.prefetch_stats.taken += t not in self._solo
                self._decode_cache.put(t, hit, hit.nbytes)

    def _postings_many(self, terms) -> None:
        """Fetch the full lists of ``terms`` into the open batch's map: a
        reference to the array the decode LRU holds (peeked, so its counters
        and recency stay as they are), else one ``decode_terms`` call for all
        the rest.  Only terms whose decode runs on a kernel (optpfd, plm,
        rmi) are fetched: a host codec gains nothing from a batch."""
        store = self.tier2
        if store is None:
            return
        if not self._batch_depth:
            raise RuntimeError("_postings_many outside batch_decodes")
        todo = []
        for t in dict.fromkeys(int(t) for t in terms):
            if t in self._batch_lists or decode_kernel(store, t) is None:
                continue
            hit = self._decode_cache.peek(t)
            if hit is not None:
                self._batch_lists[t] = hit
            else:
                todo.append(t)
        if todo:
            self.prefetch_stats.calls += 1
            self.prefetch_stats.decoded += len(todo)
            with trace.span("decode.batch", terms=len(todo)) as sp:
                got = decode_terms(store, todo, self.device)
                sp.set(bytes=int(sum(ids.nbytes for ids in got)))
            self._batch_lists.update(zip(todo, got))
            self._unread.update(todo)

    # ------------------------------------------------------------- ranked
    @property
    def ranked(self) -> "_RankedSource":
        """RankedSource over this shard's payload streams (built on demand)."""
        if self._ranked is None:
            self.ensure_payloads()
            store = self.tier2
            if store is None or not store.has_payloads:
                raise ValueError(
                    "ranked serving needs tier-2 payload streams: build the "
                    "engine from an index with term frequencies (ImpactModel)"
                )
            self._ranked = _RankedSource(self)
        return self._ranked

    def query_topk_local(
        self,
        terms,
        k: int,
        *,
        required=(),
        floor: int = 0,
    ) -> TopKResult:
        """This shard's exact top-k in *global* doc ids — descending score
        with ties ascending id.  ``floor`` is the facade's running k-th best
        score: only strictly better docs can matter here (later shards hold
        larger ids, so floor ties lose).  The one-item ``query_topk_batch``."""
        return self.query_topk_batch([(tuple(terms), k, tuple(required), floor)])[0]

    def query_topk_batch(self, items, queries=None) -> list[TopKResult]:
        """Batched ranked entry point: [(terms, k, required, floor), ...] ->
        one TopKResult per item, global doc ids.

        With ``ranked.fused_kernel`` the batch's probe tails go to
        ``fused_topk`` launches (and the dense loop where an arena fits);
        otherwise multi-phase MaxScore (``rank.topk.topk_batch``), whose
        exhaustive items are decoded together and, with
        ``ranked.score_kernel``, scored in one ``bm25_score`` launch.  Both
        paths are bit-identical.  ``queries`` names each item's query in its
        probe records on the multi-phase path, where items are served one
        after another (the fused path's records keep the ambient query).
        """
        cutoff = self.cfg.ranked.topk_exhaustive_cutoff
        log = getattr(self.cfg, "probe_log", None)
        ctx = log.context(query=None, shard=self.shard_id) if log is not None else nullcontext()
        if self.cfg.ranked.fused_kernel:
            from repro_torch.kernels.fused_query.ops import fused_topk_batch

            with ctx, trace.span("shard.topk_batch", shard=self.shard_id, items=len(items)):
                answers = fused_topk_batch(
                    self.ranked, items, exhaustive_cutoff=cutoff, stats=self.ranked_stats)
        else:
            per_item = None
            if log is not None and queries is not None:
                def per_item(i):
                    return log.context(query=int(queries[i]), shard=None)
            with ctx, trace.span("shard.topk", shard=self.shard_id, items=len(items)):
                answers = topk_batch(
                    self.ranked, items, exhaustive_cutoff=cutoff, stats=self.ranked_stats,
                    batch_scorer=self._batch_scorer() if self.cfg.ranked.score_kernel else None,
                    item_context=per_item)
        return [self._globalize(a) for a in answers]

    def _globalize(self, ans: TopKResult) -> TopKResult:
        return TopKResult(
            ids=(ans.ids.astype(np.int64) + self.lo).astype(np.int32), scores=ans.scores
        )

    def _batch_scorer(self):
        from repro_torch.kernels.bm25_score.ops import score_candidates

        scale = self.tier2.payload_scale / max((1 << self.tier2.payload_bits) - 1, 1)
        return lambda imp: score_candidates(imp, scale, device=self.device)[0]

    # ------------------------------------------------------------- planning
    def route_term(self, t: int, est_cands: int) -> str | None:
        """Cost-model route for term t at the planner's candidate estimate:
        'guided' | 'decode' for learned-codec terms, None when no model
        applies (classical codec, raw store, or guided probing disabled)."""
        g = self.guided
        if g is None or g.term_model(t) is None:  # charges the model's bytes, as a probe would
            return None
        return g.route(t, est_cands)

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
            # worker path (no facade precompute): span the candidate step so
            # a replica's shipped trace shows it apart from verification
            with trace.span("shard.candidate_mask", shard=self.shard_id, queries=n_queries):
                mask = self.candidate_mask(q)
        if not self.cfg.verified:
            for i in range(n_queries):
                if run is None or run[i]:
                    out[i] = mask[i]
            return out
        rows, jobs = [], []
        for i in range(n_queries):
            if run is not None and not run[i]:
                continue
            if qplans is not None:
                terms = qplans[i].terms
                routes = plan.routes[i] if plan is not None else None
            else:
                terms, routes = self._local_order(q[i]), None
            rows.append(i)
            jobs.append((terms, unpack_row(mask[i], self.n_docs), routes))
        for i, ids in zip(rows, self._verify_batch(jobs, queries=rows)):
            out[i] = pack_ids(ids, self.n_docs)
        return out

    # ------------------------------------------------------------- verify
    def _local_order(self, query: np.ndarray) -> tuple[int, ...]:
        """A query's distinct terms, smallest *local* list first (the
        plan-less order: direct shard use and unit tests)."""
        terms = sorted({int(t) for t in query if t >= 0})
        terms.sort(key=lambda t: int(self._dfs[t]))
        return tuple(terms)

    def _verify(self, query: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Exact candidate re-check of one query in local term order."""
        return self._verify_batch([(self._local_order(query), ids, None)])[0]

    def _verify_batch(self, jobs, queries=None) -> list[np.ndarray]:
        """Exact re-check of a batch's candidates against tier-2; ``jobs``
        holds one (terms in order, sorted candidate ids, planner routes or
        None) per query, ``queries`` each job's query index in the batch
        (its probe records' ``query``; by default the job's position).

        Each term filters a query's survivors either by guided ε-window
        probes (learned-codec terms, honoring the planner's route hint) or
        by galloping search over the fully-decoded list.  The batch goes
        term-major: round r applies the r-th term of every query that still
        has survivors.  The guided router (``GuidedPostings.route``, the
        rule the probe itself runs) splits the round: its guided items go to
        one ``contains_many`` call, one ``guided_search`` launch, and the
        full lists the others read are fetched by one ``_postings_many``
        call first, so a list is decoded only if it is read.  The decode
        LRU is only peeked meanwhile; the reads are then replayed query by
        query, so its gets, puts and counters are those of verifying one
        query after another.
        """
        qids = list(range(len(jobs))) if queries is None else [int(i) for i in queries]
        out = [ids for _, ids, _ in jobs]
        live = []
        for j, (terms, ids, _) in enumerate(jobs):
            if not terms or len(ids) == 0:
                continue
            if int(self._dfs[np.asarray(terms)].min()) == 0:
                out[j] = ids[:0]  # some term occurs nowhere locally: empty AND
                continue
            live.append(j)
        guided = self.guided
        log = getattr(self.cfg, "probe_log", None)
        traced = trace.current() is not None
        reads: list[list[int]] = [[] for _ in jobs]
        with self.batch_decodes(), \
                (log.context(query=None, shard=self.shard_id) if log is not None
                 else nullcontext()), \
                (guided.batch_log() if guided is not None else nullcontext()):
            try:
                r = 0
                while live:
                    with trace.span("shard.verify", shard=self.shard_id, round=r,
                                    queries=len(live)) as sp:
                        if traced:
                            sp.set(candidates=int(sum(len(out[j]) for j in live)))
                        self._verify_round(jobs, out, live, r, qids, reads)
                        if traced:
                            sp.set(results=int(sum(len(out[j]) for j in live)))
                    r += 1
                    live = [j for j in live if r < len(jobs[j][0]) and len(out[j])]
            finally:
                self._reads = None
            self._replay(reads)
        return out

    def _verify_round(self, jobs, out, live, r: int, qids, reads) -> None:
        """Round r of ``_verify_batch``: the r-th term of every live job,
        the guided items in one ``contains_many`` call, the rest one by
        one over the lists one ``_postings_many`` call fetched."""
        guided = self.guided
        items = {}
        for j in live:
            terms, _, routes = jobs[j]
            hint = routes.get(terms[r]) if routes else None
            route = None if guided is None else guided.route(terms[r], len(out[j]), hint)
            items[j] = (terms[r], hint, route)
        self._postings_many(t for t, _, route in items.values() if route != "guided")
        probed = [j for j in live if items[j][2] == "guided"]
        if probed:
            masks = guided.contains_many(
                [(items[j][0], out[j], items[j][1]) for j in probed],
                queries=[qids[j] for j in probed])
            for j, mask in zip(probed, masks):
                out[j] = out[j][mask]
        for j in live:
            t, hint, route = items[j]
            if route == "guided":
                continue
            self._reads = reads[j]
            ids = out[j]
            if guided is not None:
                out[j] = ids[guided.contains(t, ids, route=hint, query=qids[j])]
            else:
                out[j] = ids[gallop_membership(self._postings(t), ids)]

    # ------------------------------------------------------------- stats
    def memory_bits(self) -> dict[str, int]:
        """This shard's dense-state + tier-2 bits (facade sums across shards);
        the tier-1 table counts whether or not it is resident yet."""
        bits = {
            "tier1_bits": self.state.tier1_bits,
            "block_bitmap_bits": int(self.state.block_bitmaps.numel() * 32),
        }
        if self._tier2 is not None:
            bits["tier2_bits"] = int(self._tier2.size_bits())
            if self._tier2.has_payloads:
                bits["payload_bits"] = int(self._tier2.payload_size_bits())
        return bits

    @property
    def metrics(self) -> Registry:
        """This shard's metrics registry (built lazily; collectors close over
        self, so the registry tracks later cache/guided/ranked replacements):
        range, decode-cache behaviour, batched full decodes (the port's
        ``prefetch``), guided-probe byte accounting, ranked pruning counters
        and the arena's residence counters."""
        reg = getattr(self, "_metrics", None)
        if reg is None:
            reg = Registry()
            reg.register("range", lambda: {"lo": int(self.lo), "hi": int(self.hi)})
            reg.register("decode_cache", self._decode_cache.stats,
                         reset=self._decode_cache.reset_counters)
            reg.register("prefetch", lambda: self.prefetch_stats.as_dict(),
                         reset=lambda: setattr(self, "prefetch_stats", PrefetchStats()))
            reg.register(
                "guided",
                lambda: self._guided.stats.as_dict() if self._guided is not None else None,
                reset=lambda: self._guided.reset_stats() if self._guided is not None else None,
            )
            reg.register(
                "ranked",
                lambda: self.ranked_stats.as_dict() if self.ranked_stats.queries else None,
                reset=lambda: setattr(self, "ranked_stats", RankedStats()),
            )
            reg.register("arena", self._arena_counters)
            self._metrics = reg
        return reg

    def _arena_counters(self) -> dict | None:
        arena = self._ranked._arena if self._ranked is not None else None
        return arena.counters.as_dict() if arena else None

    def serving_stats(self) -> dict[str, dict | None]:
        """One snapshot of this shard's metrics registry."""
        return self.metrics.snapshot()

    def reset_stats(self) -> None:
        """Zero the probe/cache/ranked accounting window through the
        registry; cached decodes stay resident so the next pass measures
        warm serving."""
        self.metrics.reset()


class _RankedSource:
    """rank.topk.RankedSource over one shard's tier-2 payload streams.

    Full decodes go through the shard's decode-cost-budgeted CostLRU (ids
    under the term key the Boolean path shares, payload vectors under a
    ("pay", t) key); probes ride the guided ε-window rank models where the
    term's codec is learned and fall back to binary search in the cached
    decode otherwise.  Either way the payload read is rank-aligned —
    ``payload_at`` touches only the probe's packed words.
    """

    def __init__(self, shard: ShardEngine):
        self._sh = shard
        self._store = shard.tier2
        self._arena = None  # lazy DeviceArena (False = checked, ineligible)

    def n(self, t: int) -> int:
        return int(self._sh._dfs[t])

    def ub(self, t: int) -> int:
        return self._store.term_ub(t)

    def _payloads(self, t: int) -> np.ndarray:
        key = ("pay", t)
        hit = self._sh._decode_cache.get(key)
        if hit is None:
            with trace.span("decode.payloads", term=int(t)) as sp:
                hit = self._store.payloads(t).astype(np.int64)
                sp.set(bytes=int(hit.nbytes))
            self._sh._decode_cache.put(key, hit, hit.nbytes)
        return hit

    def full(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        return self._sh._postings(t), self._payloads(t)

    def prefetch(self, terms):
        """Context in which the full lists of ``terms`` are fetched together
        (``ShardEngine.batch_decodes``)."""
        return self._sh.batch_decodes(terms)

    def probe(self, t: int, cands: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        g = self._sh.guided
        if g is not None:
            # one probe path for every codec: GuidedPostings routes learned
            # terms through ε-windows and classical terms through the cached
            # decode, and its ProbeStats accounting covers both uniformly
            found, rank = g.probe(t, cands)
        else:  # use_guided=False: binary search in the cached decode
            p = self._sh._postings(t)
            rank = np.searchsorted(p, cands).astype(np.int64)
            found = (rank < len(p)) & (p[np.minimum(rank, len(p) - 1)] == cands)
        q = np.zeros(len(cands), np.int64)
        if found.any():
            q[found] = self._store.payload_at(t, rank[found]).astype(np.int64)
        return found, q

    # ---- fused-kernel extensions (kernels.fused_query.ops) ----
    @property
    def device(self):
        """Where the fused launches and the dense loop run."""
        return self._sh.device

    @property
    def arena(self):
        """This shard's device-resident impact arena, or None.

        Built lazily on the first fused batch that could use it (decode +
        upload is startup cost, not serving) and cached for the shard's
        lifetime.  ``False`` caches a failed eligibility check so it runs
        once.
        """
        if self._arena is None:
            from repro_torch.kernels.arena import DeviceArena

            if self._sh.cfg.ranked.device_arena and DeviceArena.eligible(
                self._store.n_terms, self._sh.n_docs
            ):
                self._arena = DeviceArena.build(
                    self, self._store.n_terms, self._sh.n_docs, self._sh.device
                )
            else:
                self._arena = False
        return self._arena or None

    @property
    def payload_bits(self) -> int:
        """Quantized-impact width — static per store, so per kernel launch."""
        return int(self._store.payload_bits)

    def payload_words(self, t: int) -> np.ndarray:
        """Term t's packed payload stream (uint32 words, rank-aligned)."""
        return self._store.payload_streams[t]

    def postings(self, t: int) -> np.ndarray:
        """Fully-decoded ids only (host rank fallback for classical codecs)."""
        return self._sh._postings(t)

    def decode_kernel(self, t: int) -> str | None:
        """The kernel a full decode of term t runs on ('pfor', 'plm'), or None."""
        return decode_kernel(self._store, t)

    def term_model(self, t: int):
        """Guided ε-window rank model, or None (classical codec/no guiding)."""
        g = self._sh.guided
        return g.term_model(t) if g is not None else None

    def seg_ub(self, t: int, cands: np.ndarray) -> np.ndarray:
        """Block-max bound per candidate: its bracketing segment's max impact
        (learned codecs), the whole-list bound otherwise."""
        g = self._sh.guided
        tm = g.term_model(t) if g is not None else None
        if tm is None:
            return np.full(len(cands), self._store.term_ub(t), np.int64)
        seg = np.searchsorted(tm.seg_first, np.asarray(cands, np.int64), side="right") - 1
        ubs = self._store.term_seg_ubs(t).astype(np.int64)
        out = ubs[np.maximum(seg, 0)]
        out[seg < 0] = 0  # candidate precedes the whole list: cannot match
        return out

"""MaxScore-style dynamic pruning over a learned postings source.

One query's top-k is computed against a ``RankedSource`` — the per-shard
accessor that can fully decode a term (postings + quantized impacts), probe
a sorted candidate set through the guided ε-window rank models, and report
score upper bounds at term and *segment* granularity (the learned segment
models double as block-max tables: each PLA segment's max quantized impact
is a bound on any candidate whose rank bracket falls inside it).

The algorithm is the batch form of MaxScore [Turtle & Flood '95], exact to
the brute-force oracle by construction:

  1. terms sort by descending upper bound; a running threshold θ is the kth
     largest *partial* score (a lower bound on the kth best final score —
     impacts are nonnegative, partial sums only grow);
  2. while a new document could still reach θ (suffix-of-bounds > θ), terms
     are fully decoded and merged into the candidate set (essential terms);
  3. once no unseen document can qualify, the remaining terms only *probe*
     surviving candidates: a candidate stays alive while
     partial + remaining-bound clears θ, with the remaining bound sharpened
     per candidate by its segment's block-max before paying for a probe;
  4. final selection keeps score > floor, ordered (score desc, id asc).

Tie discipline makes sharding exact: candidates merge in ascending doc id,
doc ranges ascend across shards, and every tie breaks toward the smaller id
— so a shard may prune anything that cannot *strictly* beat the floor
forwarded from earlier shards, while intra-shard pruning keeps ties (>= θ).
Scores are integer impact sums, so θ/floor comparisons never round.

Queries whose total postings are below ``exhaustive_cutoff`` skip pruning:
every term is decoded and scored in one batch — at that size the
bookkeeping costs more than it saves.  ``topk_batch`` serves a batch of
items; its exhaustive items share one prefetch and, optionally, one
bm25_score launch over their stacked impact windows.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, ContextManager, Protocol, Sequence

import numpy as np

from repro_torch.obs import trace
from repro_torch.rank.score import TopKResult, select_topk


class RankedSource(Protocol):
    """What topk_query needs from a (shard-local) postings store."""

    def n(self, t: int) -> int: ...

    def ub(self, t: int) -> int: ...

    def full(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (sorted doc ids int32, quantized impacts int64), full decode."""
        ...

    def probe(self, t: int, cands: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """-> (found bool, impacts int64 — 0 where absent) per sorted candidate."""
        ...

    def prefetch(self, terms: Sequence[int]) -> ContextManager:
        """Context in which the full lists of ``terms`` are decoded together
        (one launch per decode kernel) and ``full`` reads them."""
        ...

    def seg_ub(self, t: int, cands: np.ndarray) -> np.ndarray:
        """Per-candidate score bound at segment granularity (<= ub(t))."""
        ...


@dataclass
class RankedStats:
    """Postings accounting for the pruned-vs-exhaustive comparison."""

    queries: int = 0
    exhaustive_queries: int = 0  # served by the no-pruning batch path
    scored_postings: int = 0  # postings decoded + scored in full
    probed_postings: int = 0  # candidate probes into non-essential terms
    exhaustive_postings: int = 0  # what exhaustive scoring would have touched
    # fused-kernel accounting (kernels.fused_query): queries whose probe tail
    # went through the one-launch path, its probe lanes, the packed stream
    # bytes those lanes touched, and the launches' device array traffic
    fused_queries: int = 0
    fused_lanes: int = 0
    fused_stream_bytes: int = 0
    fused_device_bytes: int = 0
    # lanes of learned-codec terms the host bridge resolved itself (brackets
    # wider than W_CAP, or a correction width outside 1..31) and handed to
    # the kernel as one known rank: the part of the probe work done on the CPU
    fused_wide_lanes: int = 0
    # wall split of the fused bridge: ns spent blocked on device execution
    # (copying launch outputs back) vs ns of host plan/pack/merge
    fused_kernel_ns: int = 0
    fused_bridge_ns: int = 0

    def touched(self) -> int:
        return self.scored_postings + self.probed_postings

    def as_dict(self) -> dict[str, int | float]:
        d = {k: int(getattr(self, k)) for k in (
            "queries", "exhaustive_queries", "scored_postings",
            "probed_postings", "exhaustive_postings", "fused_queries",
            "fused_lanes", "fused_stream_bytes", "fused_device_bytes",
            "fused_wide_lanes", "fused_kernel_ns", "fused_bridge_ns",
        )}
        d["touched_postings"] = self.touched()
        d["scored_fraction"] = (
            self.touched() / self.exhaustive_postings if self.exhaustive_postings else 0.0
        )
        return d


_EMPTY = TopKResult(ids=np.zeros(0, np.int32), scores=np.zeros(0, np.int64))


def _merge_add(
    ids: np.ndarray, scores: np.ndarray, new_ids: np.ndarray, new_q: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Union of two sorted (id, score) sets, scores added where ids collide."""
    if len(ids) == 0:
        return new_ids.astype(np.int32), new_q.astype(np.int64)
    cat = np.concatenate([ids, new_ids])
    uids, inv_idx = np.unique(cat, return_inverse=True)
    out = np.zeros(len(uids), np.int64)
    np.add.at(out, inv_idx, np.concatenate([scores, new_q]))
    return uids.astype(np.int32), out


def _kth_partial(scores: np.ndarray, k: int) -> int:
    """kth largest partial score — a valid θ (impacts only ever add)."""
    if len(scores) < k:
        return 0
    return int(np.partition(scores, len(scores) - k)[len(scores) - k])


def _peel_terms(src, terms, required, cutoff):
    """The order in which MaxScore takes an item's terms -> (live terms
    ascending, required terms shortest first, optional terms by descending
    bound, whether the item is scored exhaustively), or None when the item
    is empty on this shard.  The one predicate of the multi-phase batch
    (``topk_batch``) and of the fused peel (kernels.fused_query.ops)."""
    live = sorted({int(t) for t in terms if src.n(int(t)) > 0})
    req_all = {int(r) for r in required}
    req = [t for t in sorted(req_all) if src.n(t) > 0]
    if len(req) < len(req_all) or not live:
        return None  # a required term absent on this shard: empty AND
    exhaustive = not req and sum(src.n(t) for t in live) <= cutoff
    optional = sorted((t for t in live if t not in set(req)), key=lambda t: (-src.ub(t), t))
    return live, sorted(req, key=src.n), optional, exhaustive


def topk_query(
    src: RankedSource,
    terms: Sequence[int],
    k: int,
    *,
    required: Sequence[int] = (),
    floor: int = 0,
    exhaustive_cutoff: int = 2048,
    stats: RankedStats | None = None,
    batch_scorer: Callable[[np.ndarray], np.ndarray] | None = None,
) -> TopKResult:
    """Exact top-k of one query against a shard-local RankedSource.

    ``terms`` are the deduped query terms; ``required`` the conjunctive
    subset (empty = disjunctive, all = conjunctive, in between = mixed).
    ``floor`` is the score a result must strictly beat (the k-th best score
    of earlier shards); results are (score desc, id asc) like the oracle.
    The one-item case of ``topk_batch``.
    """
    return topk_batch(src, [(terms, k, required, floor)], exhaustive_cutoff=exhaustive_cutoff,
                      stats=stats, batch_scorer=batch_scorer)[0]


def topk_batch(
    src: RankedSource,
    items: Sequence[tuple],
    *,
    exhaustive_cutoff: int = 2048,
    stats: RankedStats | None = None,
    batch_scorer: Callable[[np.ndarray], np.ndarray] | None = None,
    item_context: Callable[[int], ContextManager] | None = None,
) -> list[TopKResult]:
    """Exact top-k of each (terms, k, required, floor) item, each equal to
    ``topk_query``'s.  ``item_context(i)``, when given, is entered around
    item i's reads and probes (a probe log's per-query attribution).

    The exhaustive items' lists are fetched in one ``src.prefetch``; with a
    ``batch_scorer`` their (candidate, term) windows are stacked, zero-padded
    to the widest (a zero impact adds nothing), and scored in one call.
    Every list is still read through ``src`` in item order, so a decode cache
    behind it sees the reads of serving one item after another.
    """
    stats = stats if stats is not None else RankedStats()
    orders = [_peel_terms(src, terms, required, exhaustive_cutoff) if k > 0 else None
              for terms, k, required, _ in items]
    out = [_EMPTY] * len(items)
    windows: list[tuple[int, np.ndarray, np.ndarray]] = []
    with src.prefetch([t for o in orders if o is not None and o[3] for t in o[0]]):
        for i, ((_, k, _, floor), order) in enumerate(zip(items, orders)):
            if k <= 0:
                continue
            stats.queries += 1
            if order is None:
                continue
            live, req, optional, exhaustive = order
            stats.exhaustive_postings += sum(src.n(t) for t in live)
            with item_context(i) if item_context is not None else nullcontext():
                if not exhaustive:
                    out[i] = _maxscore(src, req, optional, k, floor, stats)
                    continue
                stats.exhaustive_queries += 1
                with trace.span("score.exhaustive", terms=len(live), k=int(k)) as sp:
                    uids, decoded = _read_all(src, live, stats)
                    sp.set(candidates=int(len(uids)))
            if len(uids) == 0:
                continue
            if batch_scorer is None:
                out[i] = select_topk(uids.astype(np.int32), _host_scores(uids, decoded), k, floor)
            else:
                windows.append((i, uids, _window(uids, decoded)))
    if windows:
        ends = np.cumsum([len(u) for _, u, _ in windows])
        stacked = np.zeros((int(ends[-1]), max(w.shape[1] for _, _, w in windows)), np.int32)
        for (_, _, w), end in zip(windows, ends):
            stacked[end - len(w):end, : w.shape[1]] = w
        scores = np.asarray(batch_scorer(stacked), np.int64)
        for (i, uids, _), end in zip(windows, ends):
            _, k, _, floor = items[i]
            out[i] = select_topk(uids.astype(np.int32), scores[end - len(uids):end], k, floor)
    return out


def _maxscore(src, req, optional, k: int, floor: int, stats: RankedStats) -> TopKResult:
    """MaxScore over one item's ``_peel_terms`` order: the conjunctive seed
    of its required terms, then the optional terms' peel."""
    # ---- conjunctive seed: required terms filter candidates by probe
    if req:
        cands, partial = src.full(req[0])
        partial = partial.astype(np.int64)
        stats.scored_postings += len(cands)
        for t in req[1:]:
            if len(cands) == 0:
                return _EMPTY
            found, q = src.probe(t, cands)
            stats.probed_postings += len(cands)
            cands, partial = cands[found], partial[found] + q[found]
        if len(cands) == 0:
            return _EMPTY
        accepting_new = False
    else:
        cands = np.zeros(0, np.int32)
        partial = np.zeros(0, np.int64)
        accepting_new = True

    # ---- MaxScore peel: optional terms by descending upper bound
    ubs = np.array([src.ub(t) for t in optional], np.int64)
    suffix = np.concatenate([np.cumsum(ubs[::-1])[::-1], [0]])
    theta = _kth_partial(partial, k)
    with trace.span("score.maxscore", terms=len(optional), k=int(k)) as sp:
        cands, partial = _peel_optional(src, optional, suffix, cands, partial, accepting_new, theta,
                               k, floor, stats)
        sp.set(candidates=int(len(cands)))
    return select_topk(cands, partial, k, floor)


def _peel_optional(src, optional, suffix, cands, partial, accepting_new: bool, theta: int, k: int,
          floor: int, stats: RankedStats):
    """MaxScore's peel of the optional terms -> the surviving (candidates,
    partial scores)."""
    for j, t in enumerate(optional):
        alive_min = max(floor + 1, theta)
        if accepting_new and suffix[j] >= alive_min:
            ids, q = src.full(t)
            stats.scored_postings += len(ids)
            cands, partial = _merge_add(cands, partial, ids, q)
        else:
            accepting_new = False
            potential = partial + suffix[j]
            alive = potential >= alive_min
            cands, partial = cands[alive], partial[alive]
            if len(cands) == 0:
                break
            # block-max refinement: this term's contribution is bounded by
            # the candidate's *segment* max, not the whole-list max
            bound = partial + suffix[j + 1] + src.seg_ub(t, cands)
            maybe = bound >= alive_min
            if maybe.any():
                sel = np.nonzero(maybe)[0]
                found, q = src.probe(t, cands[sel])
                stats.probed_postings += len(sel)
                partial[sel[found]] += q[found]
        theta = max(theta, _kth_partial(partial, k))
    return cands, partial


def _read_all(src, terms, stats: RankedStats) -> tuple[np.ndarray, list]:
    """Every term's full list -> (the candidate union, [(ids, impacts)])."""
    decoded = [src.full(t) for t in terms]
    stats.scored_postings += sum(len(ids) for ids, _ in decoded)
    return np.unique(np.concatenate([ids for ids, _ in decoded])), decoded


def _host_scores(uids: np.ndarray, decoded) -> np.ndarray:
    scores = np.zeros(len(uids), np.int64)
    for ids, q in decoded:
        scores[np.searchsorted(uids, ids)] += q
    return scores


def _window(uids: np.ndarray, decoded) -> np.ndarray:
    """The (candidate, term) int32 impact window of a candidate union."""
    imp = np.zeros((len(uids), len(decoded)), np.int32)
    for j, (ids, q) in enumerate(decoded):
        imp[np.searchsorted(uids, ids), j] = q
    return imp


def _exhaustive(src: RankedSource, terms: Sequence[int], k: int, floor: int,
                stats: RankedStats) -> TopKResult:
    """Decode every term, score the candidate union on the host."""
    with src.prefetch(terms):
        uids, decoded = _read_all(src, terms, stats)
    if len(uids) == 0:
        return _EMPTY
    return select_topk(uids.astype(np.int32), _host_scores(uids, decoded), k, floor)

"""BM25 -> quantized-impact scoring for the ranked tier.

The serving stack scores documents with *quantized impacts*: BM25's per-
posting contribution

  impact(t, d) = idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl_d / avgdl))

is computed once over the global collection in float64 and linearly quantized
to ``bits``-bit integers (1 .. 2^bits - 1; a present posting never scores 0).
A document's score is then the *integer* sum of its matched impacts, which
buys exactness everywhere floats would wobble: integer addition is
associative, so MaxScore partial sums, shard-forwarded floors, the
scoring kernel, and the brute-force oracle all agree bit-for-bit, and ties
are broken deterministically by ascending doc id.

``ImpactModel`` is the global quantizer.  It must be built from the *global*
index (idf, avgdl, the quantization scale are collection statistics); shards
then quantize their local postings through the same model, which makes
per-shard payloads bit-identical to slices of the global payload stream —
the property the K=1 vs K>1 equality assertions rest on.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BM25Params:
    k1: float = 0.9
    b: float = 0.4
    bits: int = 8  # payload quantization width (impacts in 1 .. 2^bits - 1)


@dataclass
class ImpactModel:
    """Global BM25 statistics + the impact quantizer derived from them."""

    params: BM25Params
    n_docs: int
    doc_lens: np.ndarray  # (n_docs,) float64 — global token counts per doc
    avg_len: float
    idf: np.ndarray  # (n_terms,) float64
    scale: float  # max float impact over the collection (the quant scale)

    @classmethod
    def build(cls, inv, params: BM25Params | None = None) -> "ImpactModel":
        """Fit the quantizer to a *global* InvertedIndex carrying tfs."""
        if inv.tfs is None:
            raise ValueError("ranked scoring needs an index with term frequencies")
        params = params or BM25Params()
        tfs = inv.tfs.astype(np.float64)
        doc_lens = np.bincount(inv.doc_ids, weights=tfs, minlength=inv.n_docs)
        avg_len = float(doc_lens.mean()) if inv.n_docs else 1.0
        dfs = inv.dfs.astype(np.float64)
        idf = np.log1p((inv.n_docs - dfs + 0.5) / (dfs + 0.5))
        model = cls(
            params=params,
            n_docs=inv.n_docs,
            doc_lens=doc_lens,
            avg_len=max(avg_len, 1e-9),
            idf=idf,
            scale=1.0,
        )
        term_of = np.repeat(np.arange(inv.n_terms, dtype=np.int64), inv.dfs)
        impacts = model.float_impacts(term_of, inv.tfs, doc_lens[inv.doc_ids])
        model.scale = float(impacts.max()) if impacts.size else 1.0
        # the fitting pass already computed every global impact — quantize in
        # place and memo so quantize_index(global) needn't repeat the
        # O(n_postings) float64 pass (keyed on the tfs array itself: shard
        # slices allocate new arrays and correctly miss, and holding the
        # reference keeps `is` comparisons safe from id() reuse)
        model._quant_memo = (inv.tfs, model._quantize_impacts(impacts))
        return model

    # --------------------------------------------------------------- mapping
    def float_impacts(
        self, term_of: np.ndarray, tfs: np.ndarray, dls: np.ndarray
    ) -> np.ndarray:
        """Exact float64 BM25 impact per posting (pre-quantization)."""
        k1, b = self.params.k1, self.params.b
        tf = np.asarray(tfs, np.float64)
        norm = tf + k1 * (1.0 - b + b * np.asarray(dls, np.float64) / self.avg_len)
        return self.idf[np.asarray(term_of, np.int64)] * tf * (k1 + 1.0) / norm

    @property
    def max_quant(self) -> int:
        return (1 << self.params.bits) - 1

    def _quantize_impacts(self, imp: np.ndarray) -> np.ndarray:
        q = np.ceil(imp / self.scale * self.max_quant)
        return np.clip(q, 1, self.max_quant).astype(np.uint32)

    def quantize(
        self, term_of: np.ndarray, tfs: np.ndarray, dls: np.ndarray
    ) -> np.ndarray:
        """Per-posting quantized impacts (uint32 in 1 .. max_quant).

        ceil keeps every present posting's impact >= 1; the computation is
        pure float64 elementwise, so slicing the posting set (doc-partitioned
        shards) cannot change any value.
        """
        return self._quantize_impacts(self.float_impacts(term_of, tfs, dls))

    def quantize_index(self, inv, lo: int = 0) -> np.ndarray:
        """Flat quantized impacts aligned with ``inv.doc_ids``.

        ``lo`` rebases a doc-partitioned shard's local ids into the global
        doc-length table, so a shard's payloads equal the global slice.
        The index this model was fitted on answers from the build-time memo
        without repeating the impact pass.
        """
        if inv.tfs is None:
            raise ValueError("index carries no term frequencies")
        memo = getattr(self, "_quant_memo", None)
        if lo == 0 and memo is not None and memo[0] is inv.tfs:
            return memo[1]
        term_of = np.repeat(np.arange(inv.n_terms, dtype=np.int64), inv.dfs)
        dls = self.doc_lens[inv.doc_ids.astype(np.int64) + lo]
        return self.quantize(term_of, inv.tfs, dls)

    def weight_f32(self) -> np.float32:
        """Dequantization scale: float_score ≈ int_score * weight_f32()."""
        return np.float32(self.scale / self.max_quant)


def dequantize_scores(scores: np.ndarray, im: ImpactModel) -> np.ndarray:
    """Integer impact sums -> approximate float BM25 scores (reporting only;
    ranking happens on the exact integer scores)."""
    return np.asarray(scores, np.float64) * (im.scale / im.max_quant)


# ------------------------------------------------------------------- oracle
@dataclass
class TopKResult:
    """One query's ranked answer — the single result type every path shares
    (executor, shard merge, brute-force oracle), so bit-equality checks
    compare like with like."""

    ids: np.ndarray  # (<=k,) int32, descending score then ascending id
    scores: np.ndarray  # (<=k,) int64 integer impact sums


def select_topk(ids: np.ndarray, scores: np.ndarray, k: int, floor: int = 0) -> TopKResult:
    """Exact (score desc, id asc) top-k of candidates scoring above ``floor``."""
    ids = np.asarray(ids, np.int32)
    scores = np.asarray(scores, np.int64)
    keep = scores > floor
    ids, scores = ids[keep], scores[keep]
    order = np.lexsort((ids, -scores))[:k]
    return TopKResult(ids=ids[order], scores=scores[order])


def brute_force_topk(
    inv,
    im: ImpactModel,
    queries: np.ndarray,
    k: int,
    *,
    mode: str = "or",
    required: np.ndarray | None = None,
) -> list[TopKResult]:
    """Exhaustive quantized-BM25 oracle over decoded postings.

    Scores every posting of every query term into a dense accumulator and
    takes the exact top-k; the serving path (MaxScore pruning, guided probes,
    sharded floors) must reproduce it bit-for-bit.  ``mode`` is "or"
    (disjunctive) or "and" (all terms required); ``required`` marks a
    per-position required subset for mixed queries (overrides mode).
    """
    queries = np.asarray(queries)
    if required is not None and np.asarray(required).shape != queries.shape:
        raise ValueError(
            f"required mask shape {np.asarray(required).shape} != queries {queries.shape}"
        )
    quants = im.quantize_index(inv).astype(np.int64)
    answers = []
    for qi, row in enumerate(queries):
        if required is not None:
            req = {int(t) for t, r in zip(row, required[qi]) if t >= 0 and r}
        else:
            req = {int(t) for t in row if t >= 0} if mode == "and" else set()
        terms = sorted({int(t) for t in row if t >= 0})
        score = np.zeros(inv.n_docs, np.int64)
        hit = np.zeros(inv.n_docs, np.int64)
        for t in terms:
            lo, hi = int(inv.term_offsets[t]), int(inv.term_offsets[t + 1])
            ids = inv.doc_ids[lo:hi]
            score[ids] += quants[lo:hi]
            if t in req:
                hit[ids] += 1
        if req:
            score[hit < len(req)] = 0
        docs = np.nonzero(score)[0].astype(np.int32)
        answers.append(select_topk(docs, score[docs], k))
    return answers

"""Ranked top-k retrieval over the learned postings store.

score  — BM25 -> quantized-impact mapping (ImpactModel), computed once over
         the global collection so every shard quantizes identically, plus the
         brute-force oracle used by tests and ``chip_smoke.py``
topk   — MaxScore-style dynamic pruning for disjunctive / conjunctive /
         mixed queries over a RankedSource (full decodes + guided payload
         probes + segment-granularity score upper bounds)

Scores are integer sums of quantized impacts, so every path — host numpy,
the bm25_score and fused_topk kernels, the dense arena loop, sharded serving
with forwarded floors, and the brute-force oracle — agrees bit-for-bit, ties
broken by ascending doc id.
"""
from repro_torch.rank.score import (
    BM25Params,
    ImpactModel,
    TopKResult,
    brute_force_topk,
    dequantize_scores,
    select_topk,
)
from repro_torch.rank.topk import RankedStats, topk_batch, topk_query

__all__ = [
    "BM25Params",
    "ImpactModel",
    "RankedStats",
    "TopKResult",
    "brute_force_topk",
    "dequantize_scores",
    "select_topk",
    "topk_batch",
    "topk_query",
]

"""Query planner for doc-partitioned serving: batch -> per-shard probe plans.

The planner/executor split: before any shard touches a posting stream, the
planner turns a padded query batch into

  * per-query term orders — deduped terms sorted by ascending *global*
    document frequency (smallest list first shrinks candidate sets fastest;
    global df keeps every shard filtering in the same order, so K=1 plans
    reproduce the unsharded engine's verification order exactly);
  * per-shard run masks — a shard skips a query outright when one of its
    terms has zero *local* df (the conjunction is provably empty on that
    shard) and skips all-padding queries everywhere;
  * per-shard probe routes — for each (query, term) the planner runs the
    guided-search cost model (expected ε-window ranks vs list length,
    repro_torch.postings.search) against its candidate-cardinality estimate, the
    smallest local df in the query, and pins the term to 'guided' ε-window
    probes or 'decode' (full decompression through the shard's CostLRU).

Executors (serve/shard.ShardEngine) honor the plan verbatim; routing hints
never affect result exactness — both probe paths are exact — only which
stream bytes the shard touches.  Unverified serving keeps only the padding
skip: candidate supersets are returned as-is, so df-based pruning would
change results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence

import numpy as np


class ShardLike(Protocol):
    """What the planner needs from an executor shard."""

    @property
    def local_dfs(self) -> np.ndarray: ...

    def route_term(self, t: int, est_cands: int) -> str | None: ...


@dataclass(frozen=True)
class QueryPlan:
    """One query's shard-independent plan."""

    terms: tuple[int, ...]  # deduped, ascending global df (stable on ties)
    allpad: bool  # no real terms: empty result everywhere, both modes
    dead: bool  # some term has zero global df: empty AND (verified mode)


@dataclass
class ShardPlan:
    """One shard's slice of the batch plan."""

    shard_id: int
    run: np.ndarray  # (Q,) bool — execute this query on this shard
    routes: list[dict[int, str] | None]  # per query: term -> 'guided'|'decode'


@dataclass
class BatchPlan:
    queries: np.ndarray  # (Q, T) padded int32, as handed to executors
    qplans: list[QueryPlan]
    shard_plans: list[ShardPlan]

    @property
    def n_queries(self) -> int:
        return len(self.qplans)


def plan_queries(queries: np.ndarray, global_dfs: np.ndarray) -> list[QueryPlan]:
    """Shard-independent half of the plan: term orders + liveness."""
    dfs = np.asarray(global_dfs)
    out = []
    for row in np.asarray(queries):
        terms = sorted({int(t) for t in row if t >= 0})  # dedupe repeats
        terms.sort(key=lambda t: int(dfs[t]))  # stable: ties stay id-ascending
        out.append(
            QueryPlan(
                terms=tuple(terms),
                allpad=not terms,
                dead=bool(terms) and int(dfs[terms[0]]) == 0,
            )
        )
    return out


def plan_batch(
    queries: np.ndarray,
    global_dfs: np.ndarray,
    shards: Sequence[ShardLike],
    *,
    verified: bool = True,
) -> BatchPlan:
    """Full batch plan over the given executor shards (see module docstring)."""
    q = np.asarray(queries, dtype=np.int32)
    qplans = plan_queries(q, global_dfs)
    shard_plans = []
    for sid, sh in enumerate(shards):
        local_dfs = sh.local_dfs
        run = np.zeros(len(qplans), dtype=bool)
        routes: list[dict[int, str] | None] = [None] * len(qplans)
        for i, qp in enumerate(qplans):
            if qp.allpad:
                continue
            if not verified:
                run[i] = True  # supersets served as-is: no df pruning
                continue
            if qp.dead:
                continue
            ldfs = [int(local_dfs[t]) for t in qp.terms]
            est = min(ldfs)
            if est == 0:  # some term absent on this shard: empty AND here
                continue
            run[i] = True
            hints = {t: r for t in qp.terms if (r := sh.route_term(t, est))}
            if hints:
                routes[i] = hints
        shard_plans.append(ShardPlan(shard_id=sid, run=run, routes=routes))
    return BatchPlan(queries=q, qplans=qplans, shard_plans=shard_plans)

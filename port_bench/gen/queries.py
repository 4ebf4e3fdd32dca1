"""Query mixes, drawn from a seed.

Two kinds, the port's ``data/queries.py`` workloads:

* ``df_biased`` (``sample_queries``): Million-Query-Track-like keyword
  queries of ``min_terms``..``max_terms`` terms, each term drawn with
  probability proportional to df^temperature among the terms that occur
  (drawn with replacement, as the original does);
* ``zipf`` (``zipf_conjunctions`` and the web-scale step's batches):
  ``min_terms``..``max_terms`` distinct terms whose ranks follow a
  truncated Zipf(a) over a ranked vocabulary (most frequent first).  A
  duplicate within a query is drawn again until every term differs.

Every query is a row of ``width`` int32 term ids, -1 padded, its length
drawn uniformly (the originals' rule).  The draws are vectorised numpy on
the host.

A pool is shuffled, or with ``strata`` laid out so that every run of
``strata`` consecutive queries holds one query of each of ``strata`` equal
bands of the pool ranked by (terms, smallest df): the mix is the same, and
whatever prefix of the pool a window serves asks for the same shares of
short and long, rare and frequent conjunctions on every seed.
"""
from __future__ import annotations

import numpy as np


def _rows(lengths: np.ndarray, width: int) -> np.ndarray:
    """(n, width) bool: position j of row i is inside its query."""
    return np.arange(width)[None, :] < lengths[:, None]


def df_biased(rng: np.random.Generator, dfs: np.ndarray, n: int, *, min_terms: int,
              max_terms: int, df_temperature: float, width: int) -> np.ndarray:
    w = np.power(np.maximum(dfs.astype(np.float64), 1.0), df_temperature)
    w[dfs == 0] = 0.0
    p = w / w.sum()
    lengths = rng.integers(min_terms, max_terms + 1, size=n)
    inside = _rows(lengths, width)
    out = np.full((n, width), -1, dtype=np.int32)
    out[inside] = rng.choice(len(dfs), size=int(lengths.sum()), p=p).astype(np.int32)
    return out


def zipf_cdf(n_vocab: int, a: float) -> np.ndarray:
    """CDF of a truncated Zipf(a) over ranks 0..n_vocab-1 (rank r weighs (r+1)^-a)."""
    cdf = np.cumsum(np.arange(1, n_vocab + 1, dtype=np.float64) ** -a)
    return cdf / cdf[-1]


def zipf_ranks(rng: np.random.Generator, cdf: np.ndarray, shape) -> np.ndarray:
    return np.minimum(np.searchsorted(cdf, rng.random(shape), side="right"), len(cdf) - 1)


def zipf_distinct(rng: np.random.Generator, vocab: np.ndarray, n: int, *, min_terms: int,
                  max_terms: int, zipf_a: float, width: int) -> np.ndarray:
    """``vocab`` lists term ids most frequent first."""
    if len(vocab) < max_terms:
        raise ValueError(f"only {len(vocab)} terms for queries of {max_terms}")
    lengths = rng.integers(min_terms, max_terms + 1, size=n)
    inside = _rows(lengths, max_terms)
    cdf = zipf_cdf(len(vocab), zipf_a)
    ranks = zipf_ranks(rng, cdf, (n, max_terms))
    while True:
        dup = np.zeros_like(inside)
        for j in range(1, max_terms):
            dup[:, j] = (ranks[:, :j] == ranks[:, j:j + 1]).any(1)
        dup &= inside
        if not dup.any():
            break
        ranks[dup] = zipf_ranks(rng, cdf, int(dup.sum()))
    out = np.full((n, width), -1, dtype=np.int32)
    out[:, :max_terms] = np.where(inside, vocab[ranks], -1)
    return out


def ranked_vocab(dfs: np.ndarray) -> np.ndarray:
    """Term ids that occur, most frequent first (ties by id)."""
    by_df = np.argsort(-dfs, kind="stable")
    return by_df[dfs[by_df] > 0]


def stratified(rng: np.random.Generator, pool: np.ndarray, dfs: np.ndarray,
               strata: int) -> np.ndarray:
    """``pool``'s rows in blocks of ``strata``, each block one row of every
    band of the rows ranked by (valid terms, smallest df), in seeded order."""
    n = len(pool)
    if n % strata:
        raise ValueError(f"a pool of {n} does not split into {strata} bands")
    valid = pool >= 0
    smallest = np.where(valid, dfs[np.maximum(pool, 0)], np.iinfo(np.int64).max).min(1)
    ranked = np.lexsort((rng.random(n), smallest, valid.sum(1)))
    bands = rng.permuted(ranked.reshape(strata, n // strata), axis=1)
    return pool[rng.permuted(bands.T, axis=1).reshape(-1)]


def mix(rng: np.random.Generator, n: int, parts: list[dict], *, dfs: np.ndarray,
        width: int, vocab: np.ndarray | None = None, strata: int | None = None) -> np.ndarray:
    """A pool of ``n`` queries: each part's ``share`` of them, drawn by its
    ``kind``, rows shuffled together or ``stratified`` (``vocab``:
    ``ranked_vocab(dfs)``)."""
    counts = [int(round(n * p["share"])) for p in parts]
    counts[-1] = n - sum(counts[:-1])
    if vocab is None:
        vocab = ranked_vocab(dfs)
    rows = []
    for p, c in zip(parts, counts):
        if p["kind"] == "df_biased":
            rows.append(df_biased(rng, dfs, c, min_terms=p["min_terms"],
                                  max_terms=p["max_terms"],
                                  df_temperature=p["df_temperature"], width=width))
        elif p["kind"] == "zipf":
            rows.append(zipf_distinct(rng, vocab, c, min_terms=p["min_terms"],
                                      max_terms=p["max_terms"], zipf_a=p["zipf_a"],
                                      width=width))
        else:
            raise ValueError(f"unknown query kind {p['kind']!r}")
    pool = np.concatenate(rows)
    if strata:
        return stratified(rng, pool, dfs, strata)
    return pool[rng.permutation(n)]

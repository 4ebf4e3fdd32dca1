"""TREC Million-Query-Track-style query sampler.

MQT queries are short (1-5 terms) keyword queries whose terms are biased
toward *frequent* vocabulary (people search with common words). We sample
term ids df-biased with a temperature, matching the paper's Fig-3 setup of
40k queries evaluated for tier-1 correctness guarantees.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.corpus import Corpus, document_frequencies


def sample_queries(
    corpus: Corpus,
    n_queries: int,
    *,
    max_terms: int = 5,
    df_temperature: float = 0.55,
    seed: int = 13,
) -> np.ndarray:
    """Returns (n_queries, max_terms) int32; -1 pads short queries."""
    rng = np.random.default_rng(seed)
    df = document_frequencies(corpus).astype(np.float64)
    w = np.power(np.maximum(df, 1.0), df_temperature)
    w[df == 0] = 0.0
    p = w / w.sum()

    lengths = rng.integers(1, max_terms + 1, size=n_queries)
    out = np.full((n_queries, max_terms), -1, dtype=np.int32)
    flat = rng.choice(corpus.n_terms, size=int(lengths.sum()), p=p).astype(np.int32)
    pos = 0
    for i, L in enumerate(lengths):
        out[i, :L] = flat[pos : pos + L]
        pos += L
    return out


def _zipf_term_queries(
    dfs: np.ndarray,
    n_queries: int,
    min_terms: int,
    max_terms: int,
    zipf_a: float,
    seed: int,
) -> np.ndarray:
    """Shared Zipf workload core: df-ranked vocabulary, truncated-Zipf term
    ranks, distinct nonzero-df terms per query, -1 padded rows."""
    if not 1 <= min_terms <= max_terms:
        raise ValueError(f"need 1 <= min_terms <= max_terms, got {min_terms}..{max_terms}")
    rng = np.random.default_rng(seed)
    dfs = np.asarray(dfs)
    by_df = np.argsort(-dfs, kind="stable")  # rank 0 = most frequent term
    vocab = by_df[dfs[by_df] > 0]
    if len(vocab) < max_terms:
        raise ValueError(f"only {len(vocab)} nonempty terms < max_terms={max_terms}")
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    p = ranks ** -zipf_a
    p /= p.sum()
    out = np.full((n_queries, max_terms), -1, dtype=np.int32)
    lengths = rng.integers(min_terms, max_terms + 1, size=n_queries)
    for i, L in enumerate(lengths):
        picks = rng.choice(len(vocab), size=int(L), replace=False, p=p)
        out[i, :L] = vocab[picks]
    return out


def zipf_conjunctions(
    dfs: np.ndarray,
    n_queries: int,
    *,
    min_terms: int = 2,
    max_terms: int = 5,
    zipf_a: float = 1.2,
    seed: int = 29,
) -> np.ndarray:
    """Conjunctive query workload: Zipf term draws, 2-5 term AND queries.

    Term *ranks* are drawn from a truncated Zipf(a) and mapped onto the
    vocabulary ordered by descending document frequency, so frequent terms
    dominate queries (the conjunctive-serving stress case: long posting
    lists, small intersections).  Terms are distinct within a query and only
    terms with nonzero df are drawn.  Returns (n_queries, max_terms) int32,
    -1 padded.
    """
    return _zipf_term_queries(dfs, n_queries, min_terms, max_terms, zipf_a, seed)


def zipf_disjunctions(
    dfs: np.ndarray,
    n_queries: int,
    *,
    min_terms: int = 2,
    max_terms: int = 6,
    zipf_a: float = 1.0,
    n_required: int = 0,
    seed: int = 41,
) -> tuple[np.ndarray, np.ndarray]:
    """Graded (ranked) query workload: Zipf term draws, 2-6 term OR queries.

    The ranked-serving stress case: frequent low-idf terms contribute long
    posting lists with small score upper bounds — exactly what MaxScore
    prunes — while the flatter zipf_a mixes in mid-frequency terms whose
    bounds keep them essential.  ``n_required`` marks the first
    min(n_required, length) drawn terms of each query as required (mixed
    AND/OR grading); 0 is the pure disjunctive workload.

    Returns (queries, required): (n_queries, max_terms) int32 -1-padded term
    ids and a same-shape bool mask of the required positions.
    """
    q = _zipf_term_queries(dfs, n_queries, min_terms, max_terms, zipf_a, seed)
    required = np.zeros(q.shape, dtype=bool)
    if n_required > 0:
        required[:, :n_required] = q[:, :n_required] >= 0
    return q, required


def brute_force_answers(corpus: Corpus, queries: np.ndarray) -> list[np.ndarray]:
    """Exact conjunctive Boolean answers (oracle for tests/benchmarks)."""
    from repro_torch.index.build import build_inverted_index

    inv = build_inverted_index(corpus)
    answers = []
    for q in queries:
        terms = [int(t) for t in q if t >= 0]
        if not terms:
            answers.append(np.empty(0, dtype=np.int32))
            continue
        cur = inv.postings(terms[0])
        for t in terms[1:]:
            cur = np.intersect1d(cur, inv.postings(t), assume_unique=True)
            if cur.size == 0:
                break
        answers.append(cur.astype(np.int32))
    return answers

"""The generators are deterministic from the seed and draw what they say."""
from __future__ import annotations

import numpy as np
import torch

from port_bench.gen import corpus, embeddings, queries

BIG = 2 ** 31 + 12345


def test_corpus_is_a_function_of_the_seed():
    a = corpus.synthesize(500, 300, 40, 1.2, 2.7, BIG, "cpu")
    b = corpus.synthesize(500, 300, 40, 1.2, 2.7, BIG, "cpu")
    c = corpus.synthesize(500, 300, 40, 1.2, 2.7, BIG + 1, "cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["term_ids"], c["term_ids"])
    off, terms, tf = a["doc_offsets"], a["term_ids"], a["term_freqs"]
    assert off[0] == 0 and off[-1] == len(terms) == len(tf) and np.all(tf >= 1)
    for d in range(500):
        row = terms[off[d]:off[d + 1]]
        assert np.all(np.diff(row) > 0)  # sorted and deduplicated
        assert tf[off[d]:off[d + 1]].sum() >= 8  # at least 8 draws a document
    assert terms.max() < 300


def test_query_mix_is_a_function_of_the_seed():
    dfs = np.array([0, 50, 10, 30, 0, 5, 7, 9, 11, 40], dtype=np.int64)
    parts = [{"kind": "df_biased", "share": 0.5, "min_terms": 1, "max_terms": 5,
              "df_temperature": 0.55},
             {"kind": "zipf", "share": 0.5, "min_terms": 2, "max_terms": 5, "zipf_a": 1.2}]
    a = queries.mix(np.random.default_rng([BIG, 1]), 400, parts, dfs=dfs, width=8)
    b = queries.mix(np.random.default_rng([BIG, 1]), 400, parts, dfs=dfs, width=8)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (400, 8) and np.all(a[:, 5:] == -1)
    valid = a >= 0
    n = valid.sum(1)
    assert n.min() >= 1 and n.max() <= 5
    assert np.all(dfs[a[valid]] > 0)  # only terms that occur
    # rows are prefixes: terms first, then padding
    assert np.all(valid[:, :-1] >= valid[:, 1:])


def test_zipf_terms_are_distinct_and_skewed():
    vocab = np.arange(100, 0, -1)
    q = queries.zipf_distinct(np.random.default_rng(3), vocab, 2000, min_terms=2, max_terms=5,
                              zipf_a=1.2, width=8)
    for row in q:
        terms = row[row >= 0]
        assert 2 <= len(terms) <= 5 and len(set(terms)) == len(terms)
    counts = np.bincount(q[q >= 0], minlength=101)
    assert counts[100] > counts[50] > counts[1]  # rank 0 (term 100) the most drawn


def test_tables_are_a_function_of_the_seed():
    a = embeddings.learned_index_tables(64, 16, 8, BIG, "cpu")
    b = embeddings.learned_index_tables(64, 16, 8, BIG, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["doc_embed"].dtype == torch.bfloat16 and a["tau"].dtype == torch.float32
    assert float(a["tau"].min()) >= 0.3 and float(a["tau"].max()) < 0.8


def test_a_stratified_pool_keeps_the_mix_and_spreads_each_band_over_every_block():
    rng = np.random.default_rng(5)
    dfs = rng.integers(0, 1000, size=300)
    parts = [{"kind": "df_biased", "share": 0.5, "min_terms": 1, "max_terms": 5,
              "df_temperature": 0.55},
             {"kind": "zipf", "share": 0.5, "min_terms": 2, "max_terms": 5, "zipf_a": 1.2}]
    shuffled = queries.mix(np.random.default_rng([BIG, 1]), 640, parts, dfs=dfs, width=8)
    a = queries.mix(np.random.default_rng([BIG, 1]), 640, parts, dfs=dfs, width=8, strata=16)
    b = queries.mix(np.random.default_rng([BIG, 1]), 640, parts, dfs=dfs, width=8, strata=16)
    np.testing.assert_array_equal(a, b)
    # the same queries as the shuffled pool, in another order
    np.testing.assert_array_equal(np.unique(a, axis=0, return_counts=True)[1],
                                  np.unique(shuffled, axis=0, return_counts=True)[1])
    valid = a >= 0
    key = valid.sum(1) * 10 ** 6 + np.where(valid, dfs[np.maximum(a, 0)], 10 ** 6 - 1).min(1)
    edges = np.sort(key)[::40]  # the smallest key of each of the 16 bands
    for block in key.reshape(40, 16):
        # one query of each band: the block's sorted keys interleave the bands' edges
        s = np.sort(block)
        assert np.all(s >= edges) and np.all(s[:-1] <= edges[1:])

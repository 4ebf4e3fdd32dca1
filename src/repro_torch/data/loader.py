"""Training batches for the membership model f(t, d): (term, doc, label)
triples, positives streamed from the corpus, negatives drawn uniformly and
labelled exactly (they may collide with positives)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.corpus import Corpus


def membership_batches(
    corpus: Corpus,
    *,
    batch_size: int,
    negatives_per_positive: int = 4,
    replaced_terms: np.ndarray | None = None,
    seed: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield {'terms','docs','labels'} batches for training f(t,d).

    If replaced_terms is given (two-tier mode), only those terms are sampled —
    the paper notes f "only has to consider terms for which not all documents
    are stored" (§4).
    """
    rng = np.random.default_rng(seed)
    n_pos = max(1, batch_size // (1 + negatives_per_positive))
    n_neg = batch_size - n_pos

    doc_of = np.repeat(
        np.arange(corpus.n_docs, dtype=np.int64),
        np.diff(corpus.doc_offsets),
    )
    if replaced_terms is not None and len(replaced_terms) > 0:
        replaced = np.zeros(corpus.n_terms, dtype=bool)
        replaced[replaced_terms] = True
        keep = replaced[corpus.term_ids]
        pos_terms_all = corpus.term_ids[keep]
        pos_docs_all = doc_of[keep]
        term_pool = np.asarray(replaced_terms, dtype=np.int32)
    else:
        pos_terms_all = corpus.term_ids
        pos_docs_all = doc_of
        term_pool = None

    n_pairs = len(pos_terms_all)
    while True:
        idx = rng.integers(0, n_pairs, size=n_pos)
        pt, pd = pos_terms_all[idx], pos_docs_all[idx].astype(np.int32)
        if term_pool is not None:
            nt = term_pool[rng.integers(0, len(term_pool), size=n_neg)]
        else:
            nt = rng.integers(0, corpus.n_terms, size=n_neg).astype(np.int32)
        nd = rng.integers(0, corpus.n_docs, size=n_neg).astype(np.int32)
        # negatives may collide with positives; label them correctly
        neg_labels = np.fromiter(
            (corpus.contains(int(t), int(d)) for t, d in zip(nt, nd)),
            dtype=np.float32,
            count=n_neg,
        )
        yield {
            "terms": np.concatenate([pt, nt]).astype(np.int32),
            "docs": np.concatenate([pd, nd]).astype(np.int32),
            "labels": np.concatenate([np.ones(n_pos, np.float32), neg_labels]),
        }

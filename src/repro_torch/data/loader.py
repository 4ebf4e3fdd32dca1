"""Batched data loading with background prefetch.

Two producers:
  * membership_batches — (term, doc, label) triples for training f(t, d):
    positives streamed from the corpus, negatives drawn uniformly and
    labelled exactly (they may collide with positives).
  * lm_token_batches — synthetic token streams for LM training.

PrefetchLoader runs a producer in a daemon thread with a bounded queue; the
straggler watchdog in launch/train.py replaces it with a deeper one.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np

from repro_torch.data.corpus import Corpus


class PrefetchLoader:
    """Wrap an iterator with a daemon-thread prefetch queue.

    ``close()`` stops the thread (it stops between items) and joins it; an
    error in the producer is raised by the next ``next()``."""

    _POLL_S = 0.05

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on next()
            self._err = e
        self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)  # every later next() ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


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


def lm_token_batches(
    *, vocab_size: int, batch: int, seq_len: int, seed: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    """Zipfian synthetic token stream for LM training (the reference's
    stream, token for token, for the same seed)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / ranks**1.1
    p /= p.sum()
    while True:
        toks = rng.choice(vocab_size, size=(batch, seq_len + 1), p=p).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

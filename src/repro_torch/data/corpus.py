"""Synthetic document collections with TREC-matched statistics.

The paper's collections (Robust05, GOV2, ClueWeb09B) are license-gated; its
analysis depends only on the document-frequency distribution, which is closely
Zipf-Mandelbrot in all three (Fig 1 of the paper). We synthesize collections
whose df-curves match that family, calibrated to each target's scale.

Representation: a corpus is stored as a CSR-like pair (doc_offsets, term_ids)
of the *deduplicated* doc->terms incidence, plus the transposed postings
(term_offsets, doc_ids) built by index/build.py.  Deduplication keeps the
within-doc occurrence counts as ``term_freqs`` (aligned with ``term_ids``):
Boolean retrieval ignores them, but the ranked tier scores BM25 from exactly
these tf payloads, so the synthesizer's i.i.d. Zipf draws double as a
realistic tf distribution for free.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.common.config import CorpusConfig


@dataclass
class Corpus:
    cfg: CorpusConfig
    doc_offsets: np.ndarray  # (n_docs+1,) int64 into term_ids
    term_ids: np.ndarray  # (total_postings,) int32, sorted within each doc
    term_freqs: np.ndarray | None = None  # (total_postings,) int32 tf >= 1

    @property
    def n_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def n_terms(self) -> int:
        return int(self.cfg.n_terms)

    @property
    def n_postings(self) -> int:
        return int(self.term_ids.shape[0])

    def doc_terms(self, d: int) -> np.ndarray:
        return self.term_ids[self.doc_offsets[d] : self.doc_offsets[d + 1]]

    def contains(self, t: int, d: int) -> bool:
        terms = self.doc_terms(d)
        i = np.searchsorted(terms, t)
        return bool(i < len(terms) and terms[i] == t)


def zipf_mandelbrot_probs(n_terms: int, a: float, b: float) -> np.ndarray:
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks + b, a)
    return w / w.sum()


def synthesize_corpus(cfg: CorpusConfig) -> Corpus:
    """Draw each document's terms i.i.d. from a Zipf-Mandelbrot unigram model.

    Vectorized: one big multinomial draw for all documents at once. Doc lengths
    are log-normal around avg_doc_len (web-like skew).
    """
    rng = np.random.default_rng(cfg.seed)
    probs = zipf_mandelbrot_probs(cfg.n_terms, cfg.zipf_a, cfg.zipf_b)

    # log-normal doc lengths, mean ≈ avg_doc_len
    sigma = 0.6
    mu = np.log(cfg.avg_doc_len) - 0.5 * sigma**2
    lengths = np.maximum(8, rng.lognormal(mu, sigma, size=cfg.n_docs).astype(np.int64))
    total = int(lengths.sum())

    draws = rng.choice(cfg.n_terms, size=total, p=probs).astype(np.int32)

    # dedupe + sort within each doc (vectorized via per-doc keying); the
    # multiplicity of each (doc, term) pair is its term frequency
    doc_of = np.repeat(np.arange(cfg.n_docs, dtype=np.int64), lengths)
    key = doc_of * np.int64(cfg.n_terms) + draws
    key, tf = np.unique(key, return_counts=True)  # sorts + dedupes jointly
    doc_of_u = (key // cfg.n_terms).astype(np.int64)
    term_u = (key % cfg.n_terms).astype(np.int32)
    counts = np.bincount(doc_of_u, minlength=cfg.n_docs)
    offsets = np.zeros(cfg.n_docs + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return Corpus(cfg=cfg, doc_offsets=offsets, term_ids=term_u,
                  term_freqs=tf.astype(np.int32))


def document_frequencies(corpus: Corpus) -> np.ndarray:
    """df(t) for every term (0 for terms never drawn)."""
    return np.bincount(corpus.term_ids, minlength=corpus.n_terms).astype(np.int64)

"""Inverted-index builder: doc->terms incidence transposed to term->docs CSR."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.corpus import Corpus


@dataclass
class InvertedIndex:
    n_docs: int
    n_terms: int
    term_offsets: np.ndarray  # (n_terms+1,) int64 into doc_ids
    doc_ids: np.ndarray  # (total_postings,) int32, sorted per term
    tfs: np.ndarray | None = None  # (total_postings,) int32 term frequencies

    def postings(self, t: int) -> np.ndarray:
        return self.doc_ids[self.term_offsets[t] : self.term_offsets[t + 1]]

    def term_tfs(self, t: int) -> np.ndarray:
        """Term frequencies aligned with postings(t)."""
        if self.tfs is None:
            raise ValueError("index carries no term frequencies")
        return self.tfs[self.term_offsets[t] : self.term_offsets[t + 1]]

    def df(self, t: int | np.ndarray) -> np.ndarray:
        return self.term_offsets[np.asarray(t) + 1] - self.term_offsets[np.asarray(t)]

    @property
    def dfs(self) -> np.ndarray:
        return np.diff(self.term_offsets)

    @property
    def n_postings(self) -> int:
        return int(self.doc_ids.shape[0])


def build_inverted_index(corpus: Corpus) -> InvertedIndex:
    """Counting-sort transpose of the (doc, term) incidence; O(P)."""
    doc_of = np.repeat(
        np.arange(corpus.n_docs, dtype=np.int64), np.diff(corpus.doc_offsets)
    )
    term = corpus.term_ids.astype(np.int64)
    # stable sort by term keeps doc_ids ascending within each posting list
    # (doc_of is already ascending for equal terms because corpus is doc-major)
    order = np.argsort(term, kind="stable")
    sorted_docs = doc_of[order].astype(np.int32)
    counts = np.bincount(term, minlength=corpus.n_terms)
    offsets = np.zeros(corpus.n_terms + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    tfs = corpus.term_freqs
    return InvertedIndex(
        n_docs=corpus.n_docs,
        n_terms=corpus.n_terms,
        term_offsets=offsets,
        doc_ids=sorted_docs,
        tfs=None if tfs is None else tfs[order].astype(np.int32),
    )


def slice_index(inv: InvertedIndex, lo: int, hi: int) -> InvertedIndex:
    """Doc-range restriction of the index: postings in [lo, hi), ids rebased.

    The document-partitioned serving layer's builder: shard s owns global doc
    ids [lo, hi) and serves them as local ids 0..hi-lo-1.  Per-term order is
    preserved (postings are sorted by doc id, so a contiguous range selects a
    contiguous run of each list).  O(P) vectorized; lo=0, hi=n_docs is the
    identity (modulo array copies).
    """
    if not 0 <= lo <= hi <= inv.n_docs:
        raise ValueError(f"bad doc range [{lo}, {hi}) for {inv.n_docs} docs")
    sel = (inv.doc_ids >= lo) & (inv.doc_ids < hi)
    term_of = np.repeat(np.arange(inv.n_terms, dtype=np.int64), inv.dfs)
    counts = np.bincount(term_of[sel], minlength=inv.n_terms)
    offsets = np.zeros(inv.n_terms + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return InvertedIndex(
        n_docs=hi - lo,
        n_terms=inv.n_terms,
        term_offsets=offsets,
        doc_ids=(inv.doc_ids[sel] - lo).astype(np.int32),
        tfs=None if inv.tfs is None else inv.tfs[sel],
    )


def block_lists(inv: InvertedIndex, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-term block bitmaps for Algorithm 3, packed into uint32 words.

    Returns (bitmaps, n_blocks): bitmaps is (n_terms, ceil(n_blocks/32)) u32;
    bit b of term t set iff some doc in block b contains t.
    """
    n_blocks = -(-inv.n_docs // block_size)
    words = -(-n_blocks // 32)
    bitmaps = np.zeros((inv.n_terms, words), dtype=np.uint32)
    term_of = np.repeat(
        np.arange(inv.n_terms, dtype=np.int64), np.diff(inv.term_offsets)
    )
    blk = (inv.doc_ids // block_size).astype(np.int64)
    word, bit = blk // 32, (blk % 32).astype(np.uint32)
    np.bitwise_or.at(bitmaps, (term_of, word), np.uint32(1) << bit)
    return bitmaps, n_blocks

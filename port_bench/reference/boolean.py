"""Exact conjunctive Boolean answers, brute force from the documents.

The postings of every term come from one stable sort of the documents'
term ids (doc-major, so each list is ascending); a query's answer is the
AND of its terms' document sets as bool vectors over all documents.  An
answer is right when it holds exactly those documents, each once, in
ascending order.
"""
from __future__ import annotations

import numpy as np
import torch


class Conjunctions:
    def __init__(self, doc_offsets: np.ndarray, term_ids: np.ndarray, n_terms: int, device):
        self.device = torch.device(device)
        offsets = torch.from_numpy(np.asarray(doc_offsets, np.int64)).to(self.device)
        terms = torch.from_numpy(np.asarray(term_ids, np.int32)).to(self.device).long()
        self.n_docs = int(offsets.numel() - 1)
        doc_of = torch.repeat_interleave(torch.arange(self.n_docs, device=self.device),
                                         offsets.diff())
        order = torch.sort(terms, stable=True).indices
        self.docs = doc_of[order]
        del doc_of, order
        counts = torch.bincount(terms, minlength=n_terms)
        self.offsets = np.concatenate([[0], np.cumsum(counts.cpu().numpy())]).astype(np.int64)

    def answer(self, terms) -> torch.Tensor:
        """(n_docs,) bool: the documents holding every valid (>= 0) term;
        none for a query without one."""
        valid = sorted({int(t) for t in terms if t >= 0})
        if not valid:
            return torch.zeros(self.n_docs, dtype=torch.bool, device=self.device)
        hit = torch.ones(self.n_docs, dtype=torch.bool, device=self.device)
        for t in valid:
            m = torch.zeros(self.n_docs, dtype=torch.bool, device=self.device)
            m[self.docs[self.offsets[t]:self.offsets[t + 1]]] = True
            hit &= m
        return hit

    def is_right(self, terms, ids: np.ndarray) -> bool:
        ids = np.asarray(ids)
        if ids.size and (np.any(np.diff(ids.astype(np.int64)) <= 0) or ids[0] < 0
                         or ids[-1] >= self.n_docs):
            return False
        got = torch.zeros(self.n_docs, dtype=torch.bool, device=self.device)
        got[torch.from_numpy(ids.astype(np.int64)).to(self.device)] = True
        return bool(torch.equal(got, self.answer(terms)))

"""Zipf-Mandelbrot document collections, drawn on the device from a seed.

The distribution is the port's ``data/corpus.py:synthesize_corpus``: each
document's length is log-normal around ``avg_doc_len`` (sigma 0.6, at least
8 draws), its terms are i.i.d. draws from a Zipf-Mandelbrot unigram model
over ``n_terms`` term ids, and repeated (doc, term) draws collapse into one
posting whose multiplicity is its term frequency.  The draws run in a few
large torch calls on ``device`` (inverse-CDF sampling, one sort of the
(doc, term) keys), so a collection of 528,000 documents takes about a second
on a card instead of half a minute of numpy; the random stream is torch's,
so a seed gives other documents than the numpy original, from the same
distribution.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def zipf_mandelbrot_probs(n_terms: int, a: float, b: float, device) -> torch.Tensor:
    ranks = torch.arange(1, n_terms + 1, dtype=torch.float64, device=device)
    w = 1.0 / torch.pow(ranks + b, a)
    return w / w.sum()


def synthesize(n_docs: int, n_terms: int, avg_doc_len: float, zipf_a: float, zipf_b: float,
               seed: int, device) -> dict[str, np.ndarray]:
    """-> {"doc_offsets" (n_docs + 1,) int64, "term_ids" (P,) int32 sorted
    within each document, "term_freqs" (P,) int32 >= 1}, host arrays."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    cdf = torch.cumsum(zipf_mandelbrot_probs(n_terms, zipf_a, zipf_b, device), 0)
    cdf /= cdf[-1].clone()
    sigma = 0.6
    mu = math.log(avg_doc_len) - 0.5 * sigma ** 2
    lengths = torch.empty(n_docs, dtype=torch.float64, device=device)
    lengths = lengths.log_normal_(mu, sigma, generator=gen).to(torch.int64).clamp_(min=8)
    total = int(lengths.sum())
    u = torch.rand(total, dtype=torch.float64, device=device, generator=gen)
    draws = torch.searchsorted(cdf, u, right=True).clamp_(max=n_terms - 1)
    del u
    doc_of = torch.repeat_interleave(torch.arange(n_docs, device=device), lengths)
    key = doc_of * n_terms + draws
    del doc_of, draws
    key, tf = torch.unique_consecutive(torch.sort(key).values, return_counts=True)
    doc_u = key // n_terms
    counts = torch.bincount(doc_u, minlength=n_docs)
    offsets = torch.zeros(n_docs + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    out = {
        "doc_offsets": offsets.cpu().numpy(),
        "term_ids": (key % n_terms).to(torch.int32).cpu().numpy(),
        "term_freqs": tf.to(torch.int32).cpu().numpy(),
    }
    del key, tf, doc_u, counts, offsets
    return out


def document_frequencies(term_ids: np.ndarray, n_terms: int) -> np.ndarray:
    """df(t) for every term id (0 for terms never drawn)."""
    return np.bincount(term_ids, minlength=n_terms).astype(np.int64)

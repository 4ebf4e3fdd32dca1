"""Exact membership search on the host (numpy): the galloping search the
verifier runs over fully-decoded postings."""
from __future__ import annotations

import numpy as np


def membership_mask(p: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """mask over cands: cands[i] ∈ p (sorted p, vectorized binary search).

    Candidates past the last posting get sel == len(p); the clamp makes them
    compare against p[-1], which can only match when equal (searchsorted
    returns len(p) only for cands strictly greater than p[-1]).
    """
    if len(p) == 0:
        return np.zeros(len(cands), dtype=bool)
    sel = np.searchsorted(p, cands)
    sel = np.clip(sel, 0, len(p) - 1)
    return p[sel] == cands


def gallop_membership(p: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """mask over sorted cands: cands[i] ∈ p, by exponential (galloping) search.

    One forward-moving cursor per list: each candidate gallops ahead from the
    previous match position, then binary-searches the overshoot bracket —
    O(Σ log gap), which beats per-candidate binary search when the candidate
    set is small and clustered relative to p (the verification hot path:
    Bloom-filtered candidates vs a long posting list).  Falls back to the
    vectorized binary search when cands is within ~1/8 of |p|.
    """
    n = len(p)
    if n == 0:
        return np.zeros(len(cands), dtype=bool)
    if len(cands) * 8 >= n:
        return membership_mask(p, cands)
    out = np.zeros(len(cands), dtype=bool)
    pos = 0
    for i, d in enumerate(np.asarray(cands).tolist()):
        if pos >= n:
            break
        step = 1
        hi = pos
        while hi < n and p[hi] < d:
            hi += step
            step <<= 1
        lo = max(pos, hi - (step >> 1))
        hi = min(hi, n)
        j = lo + int(np.searchsorted(p[lo:hi], d))
        out[i] = j < n and p[j] == d
        pos = j
    return out

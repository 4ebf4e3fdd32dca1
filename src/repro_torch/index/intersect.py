"""List intersection primitives.

Exact intersection on the host (numpy) for index building, oracles and the
verifier's galloping search, plus batched intersection and union over padded
posting matrices as tensors: the reference's jax-native forms of Algorithm
2's tier-1 pass.  The port's two-tier candidate step runs on the
``two_tier`` kernel, which needs no union (its output is a bitmap);
``padded_union`` is the plain form of the same union.
"""
from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1  # the union's padding


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact sorted-list intersection (numpy oracle)."""
    return np.intersect1d(a, b, assume_unique=True)


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


def intersect_many(lists: list[np.ndarray]) -> np.ndarray:
    """AND of sorted lists, the first list first, then the rest shortest
    first (the reference's order)."""
    if not lists:
        return np.empty(0, dtype=np.int32)
    cur = lists[0]
    for nxt in sorted(lists[1:], key=len):
        if cur.size == 0:
            break
        cur = intersect_sorted(cur, nxt)
    return cur.astype(np.int32)


def _live(lists: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(n, m) mask of each row's first ``lengths[i]`` entries."""
    return torch.arange(lists.shape[1], device=lists.device)[None, :] < lengths[:, None]


def padded_intersect(lists: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Conjunctive intersection of padded sorted lists.

    ``lists`` is (n_lists, max_len) int32, each row sorted in its first
    ``lengths[i]`` entries (what lies past them is ignored).  Returns a bool
    mask over lists[0]: entry j survives iff j < lengths[0] and it occurs
    in every other list.  One binary search per entry and list.
    """
    live = _live(lists, lengths)
    mask = live[0].clone()
    base = lists[0].contiguous()
    m = lists.shape[1]
    for i in range(1, lists.shape[0]):
        row = torch.where(live[i], lists[i], INT32_MAX).contiguous()  # sorted
        idx = torch.searchsorted(row, base).clamp(max=max(m - 1, 0))
        mask &= (row[idx] == base) & (idx < lengths[i])
    return mask


def padded_union(lists: torch.Tensor, lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Union of padded sorted lists -> (sorted unique ids padded with
    INT32_MAX to n_lists * max_len, count).  Negative entries are padding.

    Algorithm 2's L = ∪ truncated lists, in plain tensor operations."""
    n, m = lists.shape
    flat = torch.where(_live(lists, lengths) & (lists >= 0), lists, INT32_MAX).reshape(-1)
    ids = torch.unique(flat)  # sorted
    ids = ids[ids != INT32_MAX]
    out = torch.full((n * m,), INT32_MAX, dtype=lists.dtype, device=lists.device)
    out[: ids.numel()] = ids
    return out, torch.tensor(ids.numel(), dtype=torch.int32, device=lists.device)

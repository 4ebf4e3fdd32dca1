"""Plain PyTorch version of the batched epsilon-window probe kernel.

One row = one (term, candidate) probe: the candidate's rank bracket
[r_lo, r_lo + n_valid) inside one model segment, with the window's
corrections already unpacked.  Decode is the canonical single float32
multiply + round-half-to-even (``torch.round``) of postings/plm.py, so the
verdicts are bit-identical to the host decode and to the CUDA kernel.
"""
from __future__ import annotations

import torch


def probe_ref(
    seg_starts: torch.Tensor,  # (P,) int32 rank of the segment's first posting
    bases: torch.Tensor,  # (P,) int32 integer intercept
    slopes: torch.Tensor,  # (P,) float32
    r_lo: torch.Tensor,  # (P,) int32 first rank of the probe window
    n_valid: torch.Tensor,  # (P,) int32 window length (may be 0)
    cands: torch.Tensor,  # (P,) int32 candidate doc ids
    corr: torch.Tensor,  # (P, W) int32 window corrections
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (found (P,) int32, lt (P,) int32: window ids below the candidate)."""
    W = corr.shape[1]
    j = torch.arange(W, dtype=torch.int32, device=corr.device)[None, :]
    di = (r_lo[:, None] + j - seg_starts[:, None]).to(torch.float32)
    pred = bases[:, None] + torch.round(slopes[:, None] * di).to(torch.int32)
    ids = pred + corr
    valid = j < n_valid[:, None]
    found = (valid & (ids == cands[:, None])).any(dim=1).to(torch.int32)
    lt = (valid & (ids < cands[:, None])).sum(dim=1).to(torch.int32)
    return found, lt

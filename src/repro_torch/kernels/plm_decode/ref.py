"""Plain PyTorch version of the batched PLM/RMI decode kernel.

The batch's lists lie end to end in one flat rank axis.  Segment g starts at
flat position seg_pos[g] (ascending; each list's first segment at its rank
0), so each posting takes the last segment whose position is <= its own and
i - seg_pos[s] is its rank within that segment: the reference's one-hot
select over a padded batch, written as a search over a ragged one.  The
single float32 multiply + round-half-to-even matches postings/plm.py's
eval_segments.
"""
from __future__ import annotations

import torch


def decode_ref(
    seg_pos: torch.Tensor,  # (S,) int32 flat segment positions, ascending
    bases: torch.Tensor,  # (S,) int32 integer intercepts
    slopes: torch.Tensor,  # (S,) float32
    corr: torch.Tensor,  # (N,) int32 corrections
) -> torch.Tensor:
    """-> (N,) int32 decoded ids (a posting no segment covers decodes to corr)."""
    if seg_pos.shape[0] == 0:
        return corr.clone()
    pos = torch.arange(corr.shape[0], dtype=torch.int32, device=corr.device)
    seg = torch.searchsorted(seg_pos.contiguous(), pos, right=True) - 1
    covered = seg >= 0
    s = seg.clamp(min=0)
    di = (pos - seg_pos[s]).to(torch.float32)
    val = bases[s] + torch.round(slopes[s] * di).to(torch.int32)
    return corr + torch.where(covered, val, torch.zeros_like(val))

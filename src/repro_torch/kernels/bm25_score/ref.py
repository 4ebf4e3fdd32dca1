"""Plain PyTorch version of the bm25_score kernel.

Integer impact sums are order-independent, so an int64 row sum reproduces
the kernel's reduction exactly; the float score is one float32 multiply of
the exact sum (the reference's ``score_ref``).
"""
from __future__ import annotations

import torch


def score_ref(impacts: torch.Tensor, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, T) int32 impacts -> (int32 scores (P,), float32 scores (P,))."""
    ints = impacts.to(torch.int64).sum(dim=1).to(torch.int32)
    floats = ints.to(torch.float32) * torch.tensor(scale, dtype=torch.float32)
    return ints, floats

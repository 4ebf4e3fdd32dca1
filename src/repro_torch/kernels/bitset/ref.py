"""Plain PyTorch version of the packed-bitset AND + popcount kernel.

Words are int32 tensors holding uint32 bit patterns; bitwise AND is the same
on both, and the popcount reads them through int64 so the sign bit counts.
"""
from __future__ import annotations

import torch


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (...,) int64 total set bits per row."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=words.device)
    return ((w[..., None] >> shifts) & 1).sum(dim=(-1, -2))


def bitset_and_popcount_ref(
    bitmaps: torch.Tensor,  # (Q, T, W) int32
    valid: torch.Tensor,  # (Q, T) int32 or bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ((Q, W) int32 AND over valid rows (invalid rows act as all-ones),
    (Q,) int32 popcount of the AND)."""
    ok = valid.to(torch.bool)[:, :, None]
    rows = torch.where(ok, bitmaps, torch.full_like(bitmaps, -1))
    acc = torch.full_like(bitmaps[:, 0], -1)
    for t in range(bitmaps.shape[1]):
        acc = acc & rows[:, t]
    return acc, popcount_words(acc).to(torch.int32)

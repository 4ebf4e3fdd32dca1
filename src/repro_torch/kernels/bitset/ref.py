"""Plain PyTorch versions of the packed-bitset kernels.

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


def block_candidates_ref(
    table: torch.Tensor,  # (n_terms, Wb) int32
    terms: torch.Tensor,  # (Q, T) int32, -1 = pad
    slots: torch.Tensor,  # (Q, T) int32 row of ``rows``, -1 = pad
    rows: torch.Tensor,  # (R, words) int32
    n_docs: int,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> ((Q, words) candidate words, (Q, Wb) block AND, (Q,) count), as
    the fused kernel: the block AND of the query's table rows, the rows
    ANDed over its valid slots (pad slots read an all-ones row), kept in
    surviving blocks, zero past n_docs and for an all-pad query."""
    valid = terms >= 0
    anded, count = bitset_and_popcount_ref(
        table[terms.clamp(min=0).long()], valid.to(torch.int32))
    words = rows.shape[1]
    ones = torch.full((1, words), -1, dtype=torch.int32, device=rows.device)
    padded = torch.cat([rows, ones])
    picked = padded[torch.where(valid, slots, rows.shape[0]).long()]  # (Q, T, words)
    acc = torch.full_like(picked[:, 0], -1)
    for t in range(picked.shape[1]):
        acc = acc & picked[:, t]
    blk = torch.arange(words, device=rows.device) * 32 // block_size
    alive = ((anded[:, blk // 32] >> (blk % 32).to(torch.int32)) & 1).bool()
    keep = alive & valid.any(dim=1, keepdim=True)
    doc = torch.arange(words * 32, device=rows.device).view(words, 32)
    tail = ((doc < n_docs).to(torch.int64) << torch.arange(32, device=rows.device)).sum(1)
    tail = tail.to(torch.int32)  # uint32 bit pattern of each word's real docs
    return torch.where(keep, acc & tail, torch.zeros_like(acc)), anded, count

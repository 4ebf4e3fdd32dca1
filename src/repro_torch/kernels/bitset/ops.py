"""Public wrapper of the bitset kernel: a query batch's block AND and its
surviving-block counts, the reference's ``query_block_intersect``.

It is one ``block_candidates`` launch (kernel.py; its plain version on a
CPU tensor) over the terms' block bitmaps, whose block AND and count are
exactly this function's; the launch's candidate words, scored against one
all-ones membership row, are not read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset.kernel import block_candidates

W_BLK = 1024  # the reference kernel's tile of words; it pads W to a multiple of it
LANE = 32


def query_block_intersect(
    bitmaps: torch.Tensor,  # (n_terms, W) int32 per-term block bitmaps (uint32 patterns)
    queries: torch.Tensor,  # (Q, T) int32 padded with -1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ((Q, W) AND bitmap, (Q,) popcount of surviving blocks).

    Pad slots act as all-ones.  As in the reference, a query with no valid
    slot counts every word of its padded tile (W rounded up to 1,024 words)
    as surviving."""
    dev = bitmaps.device
    Q, W = queries.shape[0], bitmaps.shape[1]
    # one block per doc word: W block words span W * 32 candidate words
    words = W * LANE
    slots = torch.where(queries >= 0, 0, -1).to(torch.int32)
    ones = torch.full((1, words), -1, dtype=torch.int32, device=dev)
    _, anded, count = block_candidates(bitmaps.contiguous(), queries.to(torch.int32).contiguous(),
                                       slots, ones, words * LANE, LANE)
    empty = (queries < 0).all(dim=1)
    pad = (-W) % W_BLK
    return anded, torch.where(empty, count + pad * LANE, count)

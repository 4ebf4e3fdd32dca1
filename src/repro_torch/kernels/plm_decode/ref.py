"""Plain PyTorch version of the batched PLM/RMI decode kernel.

The batch's lists lie end to end in one flat rank axis.  List row l is
[first flat position, first correction word, width, corr_min]: a posting's
list is the last row whose position is <= its own, its rank within the list
the difference, and its correction ``corr_min`` plus bits [r*w, (r+1)*w) of
the list's packed words (``index/compress.py:pack_bits``, little-endian).
Segment g starts at flat position seg_pos[g] (ascending; each list's first
segment at its rank 0), so each posting takes the last segment whose
position is <= its own and i - seg_pos[s] is its rank within that segment:
the reference's one-hot select over a padded batch, written as a search over
a ragged one.  The single float32 multiply + round-half-to-even matches
postings/plm.py's eval_segments; the sum wraps in 32 bits, as the kernel's
does, which is exact for every id below 2^31.
"""
from __future__ import annotations

import torch

LIST_COLS = 4
_U32 = 0xFFFFFFFF


def unpack_corrections(
    lists: torch.Tensor, words: torch.Tensor, n: int
) -> torch.Tensor:
    """(L, 4) int32 list rows + packed words -> (n,) int64 corrections."""
    dev = words.device
    rows = lists.to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    l = torch.searchsorted(rows[:, 0].contiguous(), pos, right=True) - 1
    w = rows[l, 2]
    bitpos = (pos - rows[l, 0]) * w
    word = rows[l, 1] + bitpos // 32
    off = bitpos % 32
    val = torch.zeros(n, dtype=torch.int64, device=dev)
    if words.numel():
        w64 = words.to(torch.int64) & _U32
        last = w64.numel() - 1
        lo = w64[word.clamp(0, last)] >> off
        nxt = w64[(word + 1).clamp(0, last)]
        hi = torch.where(off + w > 32, (nxt << (32 - off)) & _U32, torch.zeros_like(nxt))
        val = torch.where(w > 0, (lo | hi) & ((1 << w) - 1), val)
    return val + rows[l, 3]


def decode_ref(
    seg_pos: torch.Tensor,  # (S,) int32 flat segment positions, ascending
    bases: torch.Tensor,  # (S,) int32 integer intercepts
    slopes: torch.Tensor,  # (S,) float32
    lists: torch.Tensor,  # (L, 4) int32 list rows
    words: torch.Tensor,  # (n_words,) int32 packed corrections
    n: int,
) -> torch.Tensor:
    """-> (n,) int32 decoded ids (a posting no segment covers decodes to its
    correction)."""
    corr = unpack_corrections(lists, words, n)
    if seg_pos.shape[0] == 0:
        val = torch.zeros_like(corr)
    else:
        pos = torch.arange(n, dtype=torch.int32, device=words.device)
        seg = torch.searchsorted(seg_pos.contiguous(), pos, right=True) - 1
        s = seg.clamp(min=0)
        di = (pos - seg_pos[s]).to(torch.float32)
        line = bases[s].to(torch.int64) + torch.round(slopes[s] * di).to(torch.int32)
        val = torch.where(seg >= 0, line, torch.zeros_like(line))
    ids = (corr + val) & _U32
    return torch.where(ids >= 1 << 31, ids - (1 << 32), ids).to(torch.int32)

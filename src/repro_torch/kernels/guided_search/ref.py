"""Plain PyTorch version of the batched epsilon-window probe kernel.

A probe row is [term row, global segment, r_lo, n_valid, cand, out]: the
ranks r_lo .. r_lo + n_valid - 1 of one model segment of one learned term,
checked against one candidate doc id, answered into output slot ``out``
(several rows may share a slot: the host cuts a long window into chunks).
Term row l is [first word, width, corr_min] of the term's packed corrections
in the arena's ``words``; segment g is [start, base, slope bits].  Rank r
decodes to

  base + rint(slope * f32(r - start)) + bits [r*w, (r+1)*w) of the term's words + corr_min

the canonical single float32 multiply + round-half-to-even (``torch.round``)
of postings/plm.py, summed with 32-bit wraparound like the CUDA kernel, so
the verdicts are bit-identical to the host decode and to the kernel.
"""
from __future__ import annotations

import torch

ROW_COLS = 6  # term row, global segment, r_lo, n_valid, cand, out slot
TERM_COLS = 3  # first word, width, corr_min
SEG_COLS = 3  # start, base, slope (float32 bits)
_U32 = 0xFFFFFFFF


def probe_ref(
    rows: torch.Tensor,  # (R, 6) int32 probe rows
    terms: torch.Tensor,  # (L, 3) int32 term rows
    segs: torch.Tensor,  # (S, 3) int32 segment rows
    words: torch.Tensor,  # (n_words,) int32 packed corrections, terms end to end
    n_out: int,
) -> torch.Tensor:
    """-> (2, n_out) int32: found (any window id == cand) and lt (window ids
    below cand), summed over the rows of each slot; 0 for a slot no row names."""
    dev = words.device
    out = torch.zeros(2, n_out, dtype=torch.int64, device=dev)
    r64 = rows.to(torch.int64)
    n = r64[:, 3].clamp(min=0)
    total = int(n.sum())
    if total == 0:
        return out.to(torch.int32)
    row = torch.repeat_interleave(torch.arange(rows.shape[0], device=dev), n, output_size=total)
    first = torch.cumsum(n, 0) - n
    rank = r64[row, 2] + torch.arange(total, device=dev) - first[row]
    term = terms.to(torch.int64)[r64[row, 0]]
    seg = segs[r64[row, 1]]
    w = term[:, 1]
    bitpos = rank * w
    word = term[:, 0] + bitpos // 32
    off = bitpos % 32
    val = torch.zeros(total, dtype=torch.int64, device=dev)
    if words.numel():
        w64 = words.to(torch.int64) & _U32
        last = w64.numel() - 1
        lo = w64[word.clamp(0, last)] >> off
        nxt = w64[(word + 1).clamp(0, last)]
        hi = torch.where(off + w > 32, (nxt << (32 - off)) & _U32, torch.zeros_like(nxt))
        val = torch.where(w > 0, (lo | hi) & ((1 << w) - 1), val)
    di = (rank - seg[:, 0].to(torch.int64)).to(torch.float32)
    line = torch.round(seg[:, 2].view(torch.float32) * di).to(torch.int32)
    ids = (seg[:, 1].to(torch.int64) + line.to(torch.int64) + val + term[:, 2]) & _U32
    ids = torch.where(ids >= 1 << 31, ids - (1 << 32), ids)
    cand = r64[row, 4]
    slot = r64[row, 5]
    out[0].index_add_(0, slot, (ids == cand).to(torch.int64))
    out[1].index_add_(0, slot, (ids < cand).to(torch.int64))
    out[0].clamp_(max=1)
    return out.to(torch.int32)

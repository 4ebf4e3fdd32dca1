"""Plain PyTorch version of the fused ranked-query kernel.

Lane for lane the reference's ``fused_topk_ref`` on the same tiles: the
segment line as one float32 multiply rounded half to even (``torch.round``),
the word-pair shift/or/mask unpack of corrections and payloads, ids compared
in int64 on the valid lanes only, the floor mask, then k argmax peels
(``torch.argmax`` returns the first maximum, so ties go to the smaller
candidate index).  Packed words are int32 bit patterns, widened to int64
for the shifts.
"""
from __future__ import annotations

import torch

NEVER = 1 << 30  # candidate-pad sentinel: above any doc id a stream can hold
_U32 = 0xFFFFFFFF


def _unpack(lo, hi, shift, width):
    """Word-pair unpack at bit offset ``shift`` (int64 tensors), ``width`` bits."""
    lo, hi = lo.to(torch.int64) & _U32, hi.to(torch.int64) & _U32
    up = torch.where(shift > 0, (hi << (32 - shift)) & _U32, torch.zeros_like(hi))
    return ((lo >> shift) | up) & ((1 << width) - 1)


def fused_topk_ref(width, cmin, rlo, wlen, start, base, slope, clo, chi, plo, phi,
                   cand, part, floor, *, k: int, pbits: int):
    """(Q, T, C, W) probe tiles -> ((Q, k) int32 ids, (Q, k) int32 scores)."""
    Q, T, C, W = clo.shape
    dev = clo.device
    j = torch.arange(W, dtype=torch.int64, device=dev)
    ranks = rlo.to(torch.int64)[..., None] + j
    di = (ranks - start.to(torch.int64)[..., None]).to(torch.int32).to(torch.float32)
    pred = base.to(torch.int64)[..., None] + torch.round(slope[..., None] * di).to(torch.int64)
    w = (width.to(torch.int64) & _U32)[:, :, None, None]
    corr = _unpack(clo, chi, (ranks * w) % 32, w)
    corr = torch.where(corr >= 1 << 31, corr - (1 << 32), corr)
    ids = pred + corr + cmin.to(torch.int64)[:, :, None, None]
    valid = j < wlen.to(torch.int64)[..., None]
    eq = valid & (ids == cand.to(torch.int64)[:, None, :, None])
    imp = _unpack(plo, phi, (ranks * pbits) % 32, pbits)
    score = part.to(torch.int64) + torch.where(eq, imp, 0).sum(dim=3).sum(dim=1)
    alive = torch.where(score > floor.to(torch.int64), score, 0)
    rows = torch.arange(Q, device=dev)
    out_ids = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    out_scores = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    cand64 = cand.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)  # a device value: capturable
    for i in range(k):
        best = torch.argmax(alive, dim=1)
        val = alive[rows, best]
        hit = val > 0
        out_ids[:, i] = torch.where(hit, cand64[rows, best], -1).to(torch.int32)
        out_scores[:, i] = torch.where(hit, val, 0).to(torch.int32)
        alive[rows, best] = zero
    return out_ids, out_scores

"""Plain PyTorch versions of the two ranked-query kernels.

``fused_topk_ref`` (csrc/fused_topk.cu): lane for lane the reference's ``fused_topk_ref`` on the same tiles: the
segment line as one float32 multiply rounded half to even (``torch.round``),
the word-pair shift/or/mask unpack of corrections and payloads, ids compared
in int64 on the valid lanes only, the floor mask, then k argmax peels
(``torch.argmax`` returns the first maximum, so ties go to the smaller
candidate index).  Packed words are int32 bit patterns, widened to int64
for the shifts.

``dense_ref`` (csrc/dense_topk.cu): the reference's XLA dense arena loop as
PyTorch operations on the table's device:

  1. gather — each query row gathers its T term rows from the resident
     (n_terms + 1, n_docs) impact table (padded slots hit the all-zero pad
     row) and sums over the term axis into a (Q, n_docs) int32 accumulator;
  2. θ-peel — k rounds, each one masked argmax per row (``torch.argmax``
     returns the first maximum, so ties go to the smaller doc id, the
     oracle's order), the peeled cell zeroed in place.  ``rounds`` is the
     round count of the reference's loop, which stops once no row can still
     beat its floor.
"""
from __future__ import annotations

import torch

NEVER = 1 << 30  # candidate-pad sentinel (above any doc id) and dense_ref's empty slot
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


def dense_ref(table: torch.Tensor, qt: torch.Tensor, floors: torch.Tensor, *, k: int):
    """(n_terms+1, n_docs) table, (Q, T) int term ids (-1 = pad), (Q,) floors
    -> ((Q, k) int32 ids (NEVER where empty), (Q, k) int32 scores, rounds),
    all three tensors on the table's device.

    Every one of the k rounds runs, with no host sync in between, so the
    pass queues on the device and returns at once.  The reference's loop
    stops after the first round in which no row hits; every later round
    would find nothing either (only cells at or below the floor are left,
    and zeroing one changes nothing), so the outputs are the same and
    ``rounds`` is that round's number, computed on the device.
    """
    Q = qt.shape[0]
    dev = table.device
    n_pad = table.shape[0] - 1  # all-zero pad row
    t = torch.where(qt >= 0, qt, n_pad).to(torch.int64)
    scores = table[t].to(torch.int32).sum(dim=1, dtype=torch.int32)  # (Q, n_docs)
    fl = floors.clamp(min=0)[:, None]  # select_topk's > floor rule
    rows = torch.arange(Q, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out_i = torch.full((Q, k), NEVER, dtype=torch.int32, device=dev)
    out_s = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    any_hit = []
    for j in range(k):
        elig = torch.where(scores > fl, scores, 0)
        best = torch.argmax(elig, dim=1)  # first max: the smaller doc id
        val = elig[rows, best]
        hit = val > 0
        out_i[:, j] = torch.where(hit, best.to(torch.int32), NEVER)
        out_s[:, j] = torch.where(hit, val, 0)
        # zero the peeled cell in place; a missed row zeroes an ineligible
        # cell (best = 0 with every score <= floor), which changes nothing
        scores[rows, best] = zero
        any_hit.append(hit.any())
    if k == 0:
        return out_i, out_s, torch.zeros((), dtype=torch.int64, device=dev)
    miss = ~torch.stack(any_hit)
    rounds = torch.where(miss.any(), torch.argmax(miss.to(torch.int32)) + 1, k)
    return out_i, out_s, rounds

"""Dense ranked scoring over a shard's resident impact table.

The reference runs this loop as one jitted XLA program (a gather-sum plus a
``lax.while_loop`` of argmax peels), not as a Pallas kernel; the port runs
the same steps as PyTorch operations on the table's device:

  1. gather — each query row gathers its T term rows from the resident
     (n_terms + 1, n_docs) impact table (padded slots hit the all-zero pad
     row) and sums over the term axis into a (Q, n_docs) int32 accumulator;
  2. θ-peel — k rounds, each one masked argmax per row (``torch.argmax``
     returns the first maximum, so ties go to the smaller doc id, the
     oracle's order), the peeled cell zeroed in place.  ``rounds`` is the
     round count of the reference's loop, which stops once no row can still
     beat its floor.

Exactness: the dense sum over term rows equals the host merge's posting
sums (integer adds, order-free), per-row floors mask exactly
``score > max(floor, 0)`` (the ``select_topk`` rule), and the argmax tie
discipline matches the oracle's (score desc, id asc).

Rows and term slots are padded to the reference's default quanta (8 rows,
4 slots, each times 2^j), so both packages hand the same shapes to the loop.
"""
from __future__ import annotations

import numpy as np
import torch

NEVER = 1 << 30  # empty heap-slot sentinel

# the peel loop costs one (Q, n_docs) scan per round: past this k the
# bucketed kernel path wins, so the bridge routes large-k items there
DENSE_MAX_K = 32

ROW_QUANTUM = 8
TERM_QUANTUM = 4

launches = 0  # dense passes issued (one per dense_topk call)


def dense_impl(table: torch.Tensor, qt: torch.Tensor, floors: torch.Tensor, *, k: int):
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


def dense_topk(arena, qt: np.ndarray, floors: np.ndarray, *, k: int):
    """One dense pass: (Q, T) padded term rows -> (ids, scores, rounds) as
    tensors on the arena's device, still being computed when it returns."""
    global launches
    dev = arena.table.device
    launches += 1
    arena.counters.hits += 1
    return dense_impl(
        arena.table, torch.from_numpy(np.ascontiguousarray(qt, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(floors, np.int32)).to(dev), k=int(k),
    )

"""Host bridge: rank brackets of many terms -> one probe table -> probe_batch.

The caller computes each candidate's exact rank bracket on the host
(repro_torch.postings.search.rank_windows); the segment tables and packed
corrections of every learned term already lie on ``device`` in a
``StreamArena``.  This module turns a batch of brackets, of any number of
terms, into one int32 table of probe rows, cutting windows longer than
CHUNK_RANKS into rows of CHUNK_RANKS, and answers it with one
``probe_batch`` launch: one pinned upload of the table, one download of
found and lt.  A table larger than TABLE_CHUNK_BYTES is cut, at probe
boundaries, into launches of that size.  Empty windows make no row: their
slots stay 0 (absent, rank r_lo).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.cuda import fetch, staging
from repro_torch.kernels.guided_search.kernel import probe_batch
from repro_torch.kernels.guided_search.ref import ROW_COLS
from repro_torch.obs import trace

# ranks one warp scans; a longer window is cut into rows of this many, and
# counts as a wide probe (ProbeStats.wide_probes)
CHUNK_RANKS = 1024
# probe-table bytes one launch takes at most (64 MiB, about 2.8M rows)
TABLE_CHUNK_BYTES = 64 << 20


def probe_rows(
    term: np.ndarray, seg: np.ndarray, r_lo: np.ndarray, lens: np.ndarray, cands: np.ndarray
) -> np.ndarray:
    """Per-probe brackets (term row, global segment, first rank, window
    length, candidate) -> (R, 6) int32 probe rows, slot = probe index; a
    window of n > 0 ranks gives ceil(n / CHUNK_RANKS) rows, an empty one none."""
    lens = np.asarray(lens, np.int64)
    pieces = -(-lens // CHUNK_RANKS)
    slot = np.repeat(np.arange(len(lens)), pieces)
    first = np.cumsum(pieces) - pieces
    at = (np.arange(len(slot)) - first[slot]) * CHUNK_RANKS
    out = np.empty((len(slot), ROW_COLS), np.int32)
    out[:, 0] = np.asarray(term)[slot]
    out[:, 1] = np.asarray(seg)[slot]
    out[:, 2] = np.asarray(r_lo)[slot] + at
    out[:, 3] = np.minimum(lens[slot] - at, CHUNK_RANKS)
    out[:, 4] = np.asarray(cands)[slot]
    out[:, 5] = slot
    return out


def probe_table(arena, rows: np.ndarray, n_out: int, device: torch.device) -> np.ndarray:
    """One launch over probe rows whose slots lie in [0, n_out) -> (2,
    n_out) int32 [found, lt], through one pinned upload and one download."""
    with trace.span("kernel.guided_search", probes=int(n_out), rows=len(rows),
                    window=CHUNK_RANKS):
        host = staging(rows.size, device)
        host.numpy()[:] = rows.reshape(-1)
        table = host.to(device, non_blocking=True).view(-1, ROW_COLS)
        return fetch(probe_batch(table, arena.terms, arena.segs, arena.words, n_out))


def probe_windows(
    arena, term: np.ndarray, seg: np.ndarray, r_lo: np.ndarray, lens: np.ndarray,
    cands: np.ndarray, *, device: torch.device | str,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched guided probes, one per candidate, of any terms of ``arena``
    -> (found bool, lt int64: window ids below the candidate).  ``term`` is
    each probe's term row and ``seg`` its global segment (arena.first_seg
    of the term row + the term's own segment index)."""
    dev = torch.device(device)
    rows = probe_rows(term, seg, r_lo, lens, cands)
    P = len(lens)
    found, lt = np.zeros(P, bool), np.zeros(P, np.int64)
    slot = rows[:, 5]
    per = max(1, TABLE_CHUNK_BYTES // (4 * ROW_COLS))
    i = 0
    while i < len(rows):
        # the rows of whole probes: at most ``per``, or one probe's if it has more
        j = min(i + per, len(rows))
        if j < len(rows):
            j = max(int(np.searchsorted(slot, slot[j])),
                    int(np.searchsorted(slot, slot[i], side="right")))
        lo, hi = int(slot[i]), int(slot[j - 1]) + 1
        part = rows[i:j].copy()
        part[:, 5] -= lo
        res = probe_table(arena, part, hi - lo, dev)
        found[lo:hi] = res[0] != 0
        lt[lo:hi] = res[1]
        i = j
    return found, lt

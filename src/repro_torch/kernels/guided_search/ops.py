"""Host bridge: TermModel + candidates -> padded probe windows -> probe_batch.

Computes the exact rank brackets on the host (repro_torch.postings.search),
gathers each window's packed corrections with a scattered unpack (only the
touched stream words are read; their count is returned for byte
accounting), pads the window axis to a multiple of 128 and answers the
candidate set with ``probe_batch`` calls on ``device``.

Probes whose bracket exceeds MAX_W ranks (degenerate or low-slope segments
scan whole segments) go to launches of their own, padded to their own width
and cut into batches of at most WIDE_CELLS corrections, instead of widening
every row's padding to the outlier's width.  The reference bridge answers
them in host numpy; here every probe runs on the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.guided_search.kernel import probe_batch

_LANES = 128
MAX_W = 1024  # widest window the main launch pads to
WIDE_CELLS = 1 << 24  # corrections per launch of wide windows (64 MiB of int32)


def _bucket(n: int, quantum: int) -> int:
    """Round n up to quantum * 2^k."""
    b = quantum
    while b < n:
        b *= 2
    return b


def _launch(tm, d, seg, r_lo, lens, rows, probe_of, col, flat_ranks, dev):
    """One probe_batch over the probes ``rows`` -> (found, lt) numpy, per row."""
    from repro_torch.index.compress import unpack_bits_at

    pos = np.full(len(d), -1, np.int64)
    pos[rows] = np.arange(len(rows))
    sel = pos[probe_of] >= 0
    W = _bucket(int(lens[rows].max()), _LANES)
    corr = np.zeros((len(rows), W), np.int32)
    vals = unpack_bits_at(tm.corr_words, tm.width, flat_ranks[sel]).astype(np.int64)
    corr[pos[probe_of[sel]], col[sel]] = (vals + tm.corr_min).astype(np.int32)

    def col_t(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    kf, lt = probe_batch(
        col_t(tm.starts[seg[rows]], np.int32),
        col_t(tm.bases[seg[rows]], np.int32),
        col_t(tm.slopes[seg[rows]], np.float32),
        col_t(r_lo[rows], np.int32),
        col_t(lens[rows], np.int32),
        col_t(d[rows], np.int32),
        col_t(corr, np.int32),
    )
    return kf.cpu().numpy().astype(bool), lt.cpu().numpy().astype(np.int64)


def probe_windows(
    tm, cands: np.ndarray, *, device: torch.device | str
) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Batched guided probes of one term -> (found bool, rank int64, bytes,
    wide): ``bytes`` counts the packed correction stream bytes the windows
    touched (metadata is accounted by the caller at model-load time);
    ``wide`` holds the window lengths of the probes wider than MAX_W.
    """
    from repro_torch.postings.search import _touched_words, flatten_windows

    d = np.asarray(cands, np.int64)
    seg, r_lo, lens, probe_of, col, flat_ranks = flatten_windows(tm, d)
    found = np.zeros(len(d), bool)
    rank = r_lo.copy()
    wide = lens > MAX_W
    if len(flat_ranks) == 0:
        return found, rank, 0, lens[wide]
    touched = 4 * _touched_words(flat_ranks, tm.width)
    groups = [np.nonzero(~wide & (lens > 0))[0]]
    if wide.any():
        rows = np.nonzero(wide)[0]
        per = max(1, WIDE_CELLS // _bucket(int(lens[rows].max()), _LANES))
        groups += [rows[i : i + per] for i in range(0, len(rows), per)]
    dev = torch.device(device)
    for rows in groups:
        if len(rows):
            kf, lt = _launch(tm, d, seg, r_lo, lens, rows, probe_of, col, flat_ranks, dev)
            found[rows] = kf
            rank[rows] += lt
    return found, rank, touched, lens[wide]

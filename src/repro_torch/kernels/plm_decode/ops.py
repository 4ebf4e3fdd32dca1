"""Host bridge: plm/rmi word streams -> one ragged batch -> batched decode.

Parses each stream's header and segment table (postings/plm.py layout) and
leaves its corrections packed: the kernel unpacks them on the device.  The
lists lie end to end with each segment start shifted to its flat position;
the segment table, the list rows and the packed correction words go up
through one pinned staging buffer in one copy, one ``decode_batch`` launch
decodes the whole batch on ``device`` and the ids come back in one copy.  No
list is padded.  The uint32 stream fields are reinterpreted as int32 (doc
ids < 2^31 by the index contract, enforced in the host decoder)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.cuda import fetch, staging
from repro_torch.kernels.plm_decode.kernel import decode_batch
from repro_torch.kernels.plm_decode.ref import LIST_COLS
from repro_torch.obs import trace
from repro_torch.postings.plm import parse_segments


def stage_batch(
    streams: list[np.ndarray], lens: list[int], *, device: torch.device | str
) -> tuple[tuple, list[int], np.ndarray]:
    """The non-empty lists of a batch on ``device`` as ``decode_batch`` takes
    them -> ((seg_pos, bases, slopes, list rows, packed words, n), which
    lists, each one's first flat position), through one pinned staging
    buffer in one copy."""
    nonempty = [i for i, n in enumerate(lens) if n > 0]
    n_vals = np.array([lens[i] for i in nonempty], np.int64)
    offsets = np.cumsum(n_vals) - n_vals
    N = int(n_vals.sum())
    parsed = [parse_segments(streams[i]) for i in nonempty]
    for i, (st, _, _, width, _, corr) in zip(nonempty, parsed):
        if len(st) == 0 or st[0] != 0:
            raise ValueError(f"stream {i}: its first segment does not start at rank 0")
        if width > 32 or len(corr) * 32 < lens[i] * width:
            raise ValueError(f"stream {i}: corrupt correction width {width}")
    n_seg = np.array([len(p[0]) for p in parsed], np.int64)
    n_words = np.array([len(p[5]) for p in parsed], np.int64)
    S, L, W = int(n_seg.sum()), len(nonempty), int(n_words.sum())
    if N >= 2**31 or 3 * S + LIST_COLS * L + W >= 2**31:
        raise ValueError(f"{N} postings / {W} words exceed the kernel's int32 positions")
    dev = torch.device(device)
    host = staging(3 * S + LIST_COLS * L + W, dev)
    h = host.numpy()
    rows = h[3 * S : 3 * S + LIST_COLS * L].reshape(L, LIST_COLS)
    if nonempty:
        seg_pos, bases, slopes = h[:S], h[S : 2 * S], h[2 * S : 3 * S].view(np.float32)
        np.concatenate([p[0] for p in parsed], out=seg_pos, casting="unsafe")
        seg_pos += np.repeat(offsets, n_seg).astype(np.int32)
        np.concatenate([p[1] for p in parsed], out=bases, casting="unsafe")
        np.concatenate([p[2] for p in parsed], out=slopes)
        rows[:, 0] = offsets
        rows[:, 1] = np.cumsum(n_words) - n_words
        rows[:, 2] = [p[3] for p in parsed]
        rows[:, 3] = [p[4] for p in parsed]
        np.concatenate([p[5] for p in parsed], out=h[3 * S + LIST_COLS * L :].view(np.uint32),
                       casting="unsafe")
    buf = host.to(dev, non_blocking=True)
    args = (buf[:S], buf[S : 2 * S], buf[2 * S : 3 * S].view(torch.float32),
            buf[3 * S : 3 * S + LIST_COLS * L].view(L, LIST_COLS),
            buf[3 * S + LIST_COLS * L :], N)
    return args, nonempty, offsets


def decode_lists(
    streams: list[np.ndarray], lens: list[int], *, device: torch.device | str
) -> list[np.ndarray]:
    """Batched exact decode of many plm/rmi streams in one launch -> list of
    int32 id arrays."""
    out: list[np.ndarray] = [np.zeros(0, np.int32)] * len(lens)
    if not any(n > 0 for n in lens):
        return out
    with trace.span("kernel.plm_decode", lists=sum(1 for n in lens if n > 0),
                    ranks=int(sum(n for n in lens if n > 0))):
        args, nonempty, offsets = stage_batch(streams, lens, device=device)
        ids = fetch(decode_batch(*args))
    for row, i in enumerate(nonempty):
        out[i] = ids[offsets[row] : offsets[row] + lens[i]].copy()
    return out

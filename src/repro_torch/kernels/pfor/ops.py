"""Host bridge: optpfd word streams -> one batch of PFor blocks -> pfor_decode.

The block headers of a stream are walked on the host once (each block's
position depends on the one before it, as in the reference bridge's
``parse_stream``); callers that decode a term again pass the parsed table
back in (``postings/search.py:decode_terms`` keeps one per term in the
store).  A batch's streams and its block table go to the device through one
pinned staging buffer in one copy, one ``pfor_decode`` launch unpacks,
patches and prefix-sums every list, whatever its widths, and the ids come
back with the overflow flag in one copy; the flag raises ``OverflowError``
as ``index/compress.py:undgaps`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.cuda import fetch, staging
from repro_torch.kernels.pfor.kernel import MAX_VALUES, pfor_decode
from repro_torch.kernels.pfor.ref import META
from repro_torch.obs import trace

BLOCK = 128  # values per PFor block (index/compress.py)


def parse_stream(words: np.ndarray, n: int) -> np.ndarray:
    """Walk an optpfd stream's block headers -> (n_blocks, 6) int32 rows
    [width, first packed word, length, first output, first exception word,
    exception count], word and output positions relative to the stream."""
    rows = []
    pos = done = 0
    while done < n:
        h = int(words[pos])
        b, n_exc, blen = h & 0xFF, (h >> 8) & 0xFFFF, h >> 24
        if b > 32 or not 0 < blen <= BLOCK or n_exc > blen:
            raise ValueError(f"corrupt optpfd header {h:#x} at word {pos}")
        n_words = (blen * b + 31) // 32
        rows.append((b, pos + 1, blen, done, pos + 1 + n_words, n_exc))
        pos += 1 + n_words + 2 * n_exc
        done += blen
    if pos > len(words):
        raise ValueError(f"optpfd stream of {len(words)} words ends inside block data")
    return np.array(rows, np.int32).reshape(-1, 6)


def stage_batch(
    streams: list[np.ndarray],
    lens: list[int],
    *,
    device: torch.device | str,
    tables: list[np.ndarray | None] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, list[int], np.ndarray]:
    """The non-empty lists of a batch on ``device`` as ``pfor_decode`` takes
    them -> (words, meta, which lists, each one's first output position),
    through one pinned staging buffer in one copy.  ``tables[i]``, when
    given, is ``parse_stream(streams[i], lens[i])``."""
    nonempty = [i for i, n in enumerate(lens) if n > 0]
    tabs = [tables[i] if tables is not None and tables[i] is not None
            else parse_stream(streams[i], lens[i]) for i in nonempty]
    n_words = np.array([len(streams[i]) for i in nonempty], np.int64)
    n_vals = np.array([lens[i] for i in nonempty], np.int64)
    n_blk = np.array([len(t) for t in tabs], np.int64)
    word_base = np.cumsum(n_words) - n_words
    out_base = np.cumsum(n_vals) - n_vals
    W, n_out, B = int(n_words.sum()), int(n_vals.sum()), int(n_blk.sum())
    if W + META * B >= 2**31 or n_out >= MAX_VALUES:
        raise ValueError(f"{W} words / {n_out} postings exceed one launch")
    dev = torch.device(device)
    host = staging(W + META * B, dev)
    h = host.numpy()
    if nonempty:
        np.concatenate([streams[i] for i in nonempty], out=h[:W].view(np.uint32),
                       casting="unsafe")
    meta = h[W:].reshape(B, META)
    if B:
        meta[:, :6] = np.concatenate(tabs)
        meta[:, 6:] = 0
        w_rep = np.repeat(word_base, n_blk)
        meta[:, 1] += w_rep
        meta[:, 4] += w_rep
        meta[:, 3] += np.repeat(out_base, n_blk)
        meta[np.cumsum(n_blk) - n_blk, 6] = 1  # each list's first block
    buf = host.to(dev, non_blocking=True)
    return buf[:W], buf[W:].view(B, META), nonempty, out_base


def decode_lists(
    streams: list[np.ndarray],
    lens: list[int],
    *,
    device: torch.device | str,
    tables: list[np.ndarray | None] | None = None,
) -> list[np.ndarray]:
    """Exact decode of many optpfd streams (d-gapped ids) in one launch ->
    int32 id arrays, bit-identical to ``undgaps(optpfd_decode(words, n))``.
    ``tables[i]``, when given, is ``parse_stream(streams[i], lens[i])``."""
    out: list[np.ndarray] = [np.zeros(0, np.int32)] * len(lens)
    if not any(n > 0 for n in lens):
        return out
    n_out = sum(n for n in lens if n > 0)
    with trace.span("kernel.pfor", lists=sum(1 for n in lens if n > 0), values=int(n_out)):
        words, meta, nonempty, out_base = stage_batch(streams, lens, device=device,
                                                      tables=tables)
        flat = fetch(pfor_decode(words, meta, n_out))
    if flat[n_out]:
        raise OverflowError("doc id exceeds int32 range")
    for row, i in enumerate(nonempty):
        out[i] = flat[out_base[row] : out_base[row] + lens[i]].copy()
    return out


def decode_stream(words: np.ndarray, n: int, *, device: torch.device | str = "cuda"
                  ) -> np.ndarray:
    """Full decode of one optpfd stream -> its ``n`` int32 doc ids (gaps
    summed), the reference's ``decode_stream``: ``decode_lists`` of one
    list."""
    return decode_lists([words], [n], device=device)[0]

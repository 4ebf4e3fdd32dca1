"""Host bridge: optpfd word streams -> one batch of PFor blocks -> pfor_unpack.

The block headers are walked on the host (each block's position depends on
the one before it, as in the reference bridge's ``parse_stream``); the
streams themselves go to the device as they are, end to end, and the
kernel reads packed words and exception pairs from them in place.  One
``pfor_unpack`` launch decodes every block of every list, whatever its
width; the d-gap prefix sum then runs per list in int64 on the same device
and is narrowed to int32 after the same overflow check as
``index/compress.py:undgaps``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.pfor.kernel import pfor_unpack
from repro_torch.kernels.pfor.ref import META


def parse_stream(words: np.ndarray, n: int) -> np.ndarray:
    """Walk an optpfd stream's block headers -> (n_blocks, 6) int64 meta rows
    [width, first packed word, length, first output, first exception word,
    exception count], word and output positions relative to the stream."""
    rows = []
    pos = done = 0
    while done < n:
        h = int(words[pos])
        b, n_exc, blen = h & 0xFF, (h >> 8) & 0xFFFF, h >> 24
        if b > 32 or blen == 0:
            raise ValueError(f"corrupt optpfd header {h:#x} at word {pos}")
        n_words = (blen * b + 31) // 32
        rows.append((b, pos + 1, blen, done, pos + 1 + n_words, n_exc))
        pos += 1 + n_words + 2 * n_exc
        done += blen
    if pos > len(words):
        raise ValueError(f"optpfd stream of {len(words)} words ends inside block data")
    return np.array(rows, np.int64).reshape(-1, META)


def decode_lists(
    streams: list[np.ndarray], lens: list[int], *, device: torch.device | str
) -> list[np.ndarray]:
    """Exact decode of many optpfd streams (d-gapped ids) -> int32 id arrays,
    bit-identical to ``undgaps(optpfd_decode(words, n))``."""
    out: list[np.ndarray] = [np.zeros(0, np.int32)] * len(lens)
    nonempty = [i for i, n in enumerate(lens) if n > 0]
    if not nonempty:
        return out
    word_base = out_base = 0
    metas, words = [], []
    for i in nonempty:
        m = parse_stream(streams[i], lens[i])
        m[:, [1, 4]] += word_base
        m[:, 3] += out_base
        metas.append(m)
        words.append(streams[i])
        word_base += len(streams[i])
        out_base += lens[i]
    if word_base >= 2**31 or out_base >= 2**31:
        raise ValueError(f"{word_base} words / {out_base} postings exceed int32 positions")
    dev = torch.device(device)
    w = torch.from_numpy(np.concatenate(words).astype(np.uint32).view(np.int32)).to(dev)
    meta = torch.from_numpy(np.concatenate(metas).astype(np.int32)).to(dev)
    gaps = pfor_unpack(w, meta, out_base).to(torch.int64) & 0xFFFFFFFF
    # per-list prefix sum: a global int64 cumsum minus the sum before each list
    csum = torch.cumsum(gaps, 0)
    n = torch.tensor([lens[i] for i in nonempty], dtype=torch.int64, device=dev)
    ends = torch.cumsum(n, 0)
    before = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), csum[ends[:-1] - 1]])
    ids = csum - torch.repeat_interleave(before, n)
    lasts = ids[ends - 1].cpu().numpy()
    if int(lasts.max()) > np.iinfo(np.int32).max:
        raise OverflowError(f"doc id {int(lasts.max())} exceeds int32 range")
    flat = ids.to(torch.int32).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum([lens[i] for i in nonempty])])
    for row, i in enumerate(nonempty):
        out[i] = flat[offs[row] : offs[row + 1]]
    return out

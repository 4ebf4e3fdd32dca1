"""Plain PyTorch version of the OptPFD batch-decode kernel.

Every value of every block at once: value i of block b sits at bits
[i*w, (i+1)*w) of the little-endian stream from the block's first packed
word (the reference's ``unpack_block_ref``, with a per-block width), then
each exception pair (pos, hi) with pos < blen ORs ``hi << w`` into its value
— the patch of ``index/compress.py:optpfd_decode`` — and the gaps of each
list are summed in int64 from its head block on (``undgaps``).  Words are
carried as int32 bit patterns and widened to int64 for the shifts.

``meta`` is (n_blocks, 8) int32: width, first packed word, block length,
first output position, first exception word, exception count, head (1 on a
list's first block), 0.  The lists lie end to end, their blocks in order.
The result is (n_out + 1,) int32: each id's low 32 bits, then 1 if any id
exceeds INT32_MAX, else 0.
"""
from __future__ import annotations

import torch

META = 8
INT32_MAX = 2**31 - 1
_U32 = 0xFFFFFFFF


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pfor_gaps_ref(words: torch.Tensor, meta: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_words,) int32 stream words + (n_blocks, 8) meta -> (n_out,) int64 gaps."""
    dev = words.device
    w64 = words.to(torch.int64) & _U32
    m = meta.to(torch.int64)
    width, word_off, blen, out_off, exc_off, n_exc = m[:, :6].unbind(1)
    pos = torch.arange(n_out, dtype=torch.int64, device=dev)
    b = torch.searchsorted(out_off.contiguous(), pos, right=True) - 1
    w = width[b]
    bitpos = (pos - out_off[b]) * w
    word = word_off[b] + bitpos // 32
    off = bitpos % 32
    out = torch.zeros(n_out, dtype=torch.int64, device=dev)
    if w64.numel():
        last = w64.numel() - 1
        lo = w64[word.clamp(0, last)] >> off
        nxt = w64[(word + 1).clamp(0, last)]
        hi = torch.where(off + w > 32, (nxt << (32 - off)) & _U32, torch.zeros_like(nxt))
        out = torch.where(w > 0, (lo | hi) & ((1 << w) - 1), out)
    # exception patch: pair e of block b is words[exc_off + 2e], words[... + 1]
    n_pairs = int(n_exc.sum())
    if n_pairs:
        eb = torch.repeat_interleave(torch.arange(len(m), device=dev), n_exc)
        first = torch.repeat_interleave(torch.cumsum(n_exc, 0) - n_exc, n_exc)
        e = torch.arange(n_pairs, dtype=torch.int64, device=dev) - first
        at = exc_off[eb] + 2 * e
        p = w64[at]
        ok = p < blen[eb]
        hi = (w64[at + 1] << width[eb]) & _U32
        out[(out_off[eb] + p)[ok]] |= hi[ok]
    return out


def pfor_decode_ref(words: torch.Tensor, meta: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_words,) int32 words + (n_blocks, 8) meta -> (n_out + 1,) int32 ids
    and the overflow flag."""
    gaps = pfor_gaps_ref(words, meta, n_out)
    m = meta.to(torch.int64)
    pos = torch.arange(n_out, dtype=torch.int64, device=words.device)
    b = torch.searchsorted(m[:, 3].contiguous(), pos, right=True) - 1
    # each value's list head: the last head block at or before its block
    heads = torch.where(m[:, 6] != 0, torch.arange(len(m), device=words.device), -1)
    head_of = torch.cummax(heads, 0).values.clamp(min=0)
    csum = torch.cumsum(gaps, 0)
    start = m[head_of[b], 3]  # first output position of the value's list
    ids = csum - torch.where(start > 0, csum[(start - 1).clamp(min=0)], torch.zeros_like(csum))
    flag = (ids > INT32_MAX).any().to(torch.int32).reshape(1)
    return torch.cat([_as_int32(ids & _U32), flag])

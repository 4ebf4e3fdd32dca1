"""Postings-list compression codecs.

The paper measures storage under OptPFOR [Lemire & Boytsov '15]; we implement
OptPFD (per-128-block optimal bit width + exception patching) plus varbyte,
Elias-Fano and raw bitvectors, so the Fig-1/Fig-2 storage analysis and the
hybrid representations of §3.3 are all measurable.

All codecs operate on a sorted doc-id list; d-gap transform first. Encoders
return a uint32 word array; sizes are exact bit counts (compressed_size_bits)
so Eq. (2) can be evaluated without byte-alignment noise.
"""
from __future__ import annotations

import numpy as np

BLOCK = 128  # PFor block length; matches SIMD-friendly CPU codecs & 128-lane VREG


# --------------------------------------------------------------------------- dgap
def dgaps(doc_ids: np.ndarray) -> np.ndarray:
    if len(doc_ids) == 0:
        return doc_ids.astype(np.uint32)
    out = np.empty_like(doc_ids, dtype=np.uint32)
    out[0] = doc_ids[0]
    np.subtract(doc_ids[1:], doc_ids[:-1], out=out[1:], casting="unsafe")
    return out


def undgaps(gaps: np.ndarray) -> np.ndarray:
    """Inverse d-gap transform, int64-safe.

    The cumulative sum runs in int64 and is checked before narrowing: a doc id
    past 2^31-1 (corrupt stream or gap overflow) raises instead of silently
    wrapping to a negative int32.
    """
    ids = np.cumsum(gaps.astype(np.int64))
    if ids.size and int(ids[-1]) > np.iinfo(np.int32).max:
        raise OverflowError(f"doc id {int(ids[-1])} exceeds int32 range")
    return ids.astype(np.int32)


# --------------------------------------------------------------------------- varbyte
def varbyte_size_bits(gaps: np.ndarray) -> int:
    if len(gaps) == 0:
        return 0
    v = np.maximum(gaps.astype(np.int64), 1)
    nbytes = (np.floor(np.log2(v)).astype(np.int64) // 7) + 1
    return int(nbytes.sum() * 8)


def varbyte_encode(gaps: np.ndarray) -> np.ndarray:
    out = bytearray()
    for g in gaps.tolist():
        g = int(g)
        while True:
            b = g & 0x7F
            g >>= 7
            if g:
                out.append(b)
            else:
                out.append(b | 0x80)
                break
    buf = np.frombuffer(bytes(out), dtype=np.uint8)
    pad = (-len(buf)) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    return buf.view(np.uint32).copy()


def varbyte_decode(words: np.ndarray, n: int) -> np.ndarray:
    buf = words.view(np.uint8)
    out = np.empty(n, dtype=np.uint32)
    val, shift, j = 0, 0, 0
    for b in buf.tolist():
        val |= (b & 0x7F) << shift
        if b & 0x80:
            out[j] = val
            j += 1
            if j == n:
                break
            val, shift = 0, 0
        else:
            shift += 7
    return out


# --------------------------------------------------------------------------- bitpack
def pack_bits(vals: np.ndarray, width: int) -> np.ndarray:
    """Pack uint32 vals (each < 2**width) into a dense little-endian bitstream."""
    n = len(vals)
    if width == 0 or n == 0:
        return np.zeros(0, dtype=np.uint32)
    total_bits = n * width
    words = np.zeros((total_bits + 31) // 32, dtype=np.uint64)
    bitpos = np.arange(n, dtype=np.int64) * width
    word_idx, off = bitpos // 32, (bitpos % 32).astype(np.uint64)
    v = vals.astype(np.uint64)
    lo = (v << off) & np.uint64(0xFFFFFFFF)
    hi = v >> (np.uint64(32) - off).clip(max=np.uint64(63))
    hi = np.where(off == 0, 0, hi)
    np.bitwise_or.at(words, word_idx, lo)
    spill = word_idx + 1 < len(words)
    np.bitwise_or.at(words, word_idx[spill] + 1, hi[spill])
    return words.astype(np.uint32)


def unpack_bits(words: np.ndarray, width: int, n: int) -> np.ndarray:
    if width == 0 or n == 0:
        return np.zeros(n, dtype=np.uint32)
    return unpack_bits_at(words, width, np.arange(n, dtype=np.int64))


def unpack_bits_at(words: np.ndarray, width: int, indices: np.ndarray) -> np.ndarray:
    """Unpack only the values at `indices` from a pack_bits stream.

    The guided-search probe path decodes ε-windows, not whole lists, so it
    must read packed corrections at arbitrary positions without touching the
    rest of the stream.
    """
    if width == 0 or len(indices) == 0:
        return np.zeros(len(indices), dtype=np.uint32)
    w = words.astype(np.uint64)
    bitpos = np.asarray(indices, dtype=np.int64) * width
    word_idx, off = bitpos // 32, (bitpos % 32).astype(np.uint64)
    lo = w[word_idx] >> off
    nxt = np.where(word_idx + 1 < len(w), w[np.minimum(word_idx + 1, len(w) - 1)], 0)
    hi = np.where(off == 0, 0, nxt << (np.uint64(32) - off))
    mask = (np.uint64(1) << np.uint64(width)) - np.uint64(1)
    return ((lo | hi) & mask).astype(np.uint32)


# --------------------------------------------------------------------------- OptPFD
def _block_cost_bits(block: np.ndarray, b: int) -> int:
    """Cost of one block at base width b: header + packed + exceptions.

    Exceptions (vals >= 2**b) store their high bits in a 32-bit overflow slot
    plus an 8-bit position; header = 8 bits (width) + 16 bits (n_exceptions).
    """
    exc = int((block >> np.uint32(b)).astype(bool).sum()) if b < 32 else 0
    return 24 + len(block) * b + exc * 40


def optpfd_size_bits(gaps: np.ndarray) -> int:
    """Per-block optimal width (the 'Opt' in OptPFD)."""
    if len(gaps) == 0:
        return 0
    total = 0
    for s in range(0, len(gaps), BLOCK):
        block = gaps[s : s + BLOCK].astype(np.uint32)
        maxv = int(block.max())
        widths = range(0, max(1, maxv.bit_length()) + 1)
        total += min(_block_cost_bits(block, b) for b in widths)
    return total


def optpfd_encode(gaps: np.ndarray) -> np.ndarray:
    """Streamable encoding: per block [width|n_exc|n] + packed + exception pairs."""
    chunks: list[np.ndarray] = []
    for s in range(0, len(gaps), BLOCK):
        block = gaps[s : s + BLOCK].astype(np.uint32)
        maxv = int(block.max()) if len(block) else 0
        best_b, best_c = 0, None
        for b in range(0, max(1, maxv.bit_length()) + 1):
            c = _block_cost_bits(block, b)
            if best_c is None or c < best_c:
                best_b, best_c = b, c
        b = best_b
        if b < 32:
            exc_pos = np.nonzero(block >> np.uint32(b))[0]
        else:
            exc_pos = np.zeros(0, dtype=np.int64)
        low = block & ((np.uint32(1) << np.uint32(b)) - np.uint32(1)) if b < 32 else block
        header = np.array([b | (len(exc_pos) << 8) | (len(block) << 24)], dtype=np.uint32)
        packed = pack_bits(low, b)
        exc = np.stack(
            [exc_pos.astype(np.uint32), (block[exc_pos] >> np.uint32(b))], axis=1
        ).reshape(-1) if len(exc_pos) else np.zeros(0, np.uint32)
        chunks += [header, packed, exc]
    return np.concatenate(chunks) if chunks else np.zeros(0, np.uint32)


def optpfd_decode(words: np.ndarray, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint32)
    pos, done = 0, 0
    while done < n:
        h = int(words[pos]); pos += 1
        b, n_exc, blen = h & 0xFF, (h >> 8) & 0xFFFF, h >> 24
        n_words = (blen * b + 31) // 32
        block = unpack_bits(words[pos : pos + n_words], b, blen)
        pos += n_words
        for _ in range(n_exc):
            p, hi = int(words[pos]), int(words[pos + 1]); pos += 2
            block[p] |= np.uint32(hi << b)
        out[done : done + blen] = block
        done += blen
    return out


# --------------------------------------------------------------------------- Elias-Fano
def _ef_split(n: int, universe: int) -> int:
    """Low-bit width l for Elias-Fano: floor(log2(u/n)), 0 when the list is
    dense (universe <= n, where the high-bit unary part alone is optimal)."""
    if universe <= n:
        return 0
    return int(np.floor(np.log2(universe / n)))


def eliasfano_size_bits(doc_ids: np.ndarray, universe: int) -> int:
    n = len(doc_ids)
    if n == 0:
        return 0
    universe = max(universe, int(doc_ids[-1]) + 1)
    l = _ef_split(n, universe)
    # n low halves + unary high halves (n stop bits + universe>>l bucket bits)
    return n * l + 2 * n + (universe >> l) + 2


def eliasfano_encode(doc_ids: np.ndarray, universe: int) -> np.ndarray:
    """Streamable Elias-Fano: [l | n_high_words<<8] + packed lows + unary highs."""
    n = len(doc_ids)
    if n == 0:
        return np.zeros(0, np.uint32)
    ids = np.asarray(doc_ids, np.int64)
    universe = max(universe, int(ids[-1]) + 1)
    l = _ef_split(n, universe)
    low = (ids & ((1 << l) - 1)).astype(np.uint32)
    high = (ids >> l).astype(np.int64)
    hv_bits = n + (universe >> l) + 1
    hv = np.zeros(hv_bits, np.uint8)
    hv[high + np.arange(n, dtype=np.int64)] = 1
    hv_words = np.packbits(hv, bitorder="little")
    pad = (-len(hv_words)) % 4
    if pad:
        hv_words = np.concatenate([hv_words, np.zeros(pad, np.uint8)])
    hv_words = hv_words.view(np.uint32)
    header = np.array([l | (len(hv_words) << 8)], dtype=np.uint32)
    return np.concatenate([header, pack_bits(low, l), hv_words])


def eliasfano_decode(words: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int32)
    h = int(words[0])
    l, n_high_words = h & 0xFF, h >> 8
    n_low_words = (n * l + 31) // 32
    low = unpack_bits(words[1 : 1 + n_low_words], l, n).astype(np.int64)
    hv = np.unpackbits(
        words[1 + n_low_words : 1 + n_low_words + n_high_words].view(np.uint8),
        bitorder="little",
    )
    ones = np.flatnonzero(hv)[:n]
    high = ones - np.arange(n, dtype=np.int64)
    return ((high << l) | low).astype(np.int32)


def bitvector_size_bits(universe: int) -> int:
    return universe


def bitvector_encode(doc_ids: np.ndarray, universe: int) -> np.ndarray:
    n = len(doc_ids)
    if n == 0:
        return np.zeros(0, np.uint32)
    ids = np.asarray(doc_ids, np.int64)
    universe = max(universe, int(ids[-1]) + 1)
    bits = np.zeros(universe, np.uint8)
    bits[ids] = 1
    by = np.packbits(bits, bitorder="little")
    pad = (-len(by)) % 4
    if pad:
        by = np.concatenate([by, np.zeros(pad, np.uint8)])
    return by.view(np.uint32).copy()


def bitvector_decode(words: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits)[:n].astype(np.int32)


# --------------------------------------------------------------------------- dispatch
# Every codec has a size model; every codec here also has an exact lossless
# encoder/decoder pair.  "plm"/"rmi" are the learned rank-model codecs of
# repro_torch.postings (lazy-imported to keep this module numpy-only at import
# time); "hybrid" is the per-term min-bits selector (repro_torch.postings.hybrid).
CODECS = ("optpfd", "varbyte", "eliasfano", "bitvector", "plm", "rmi")


def _default_universe(doc_ids: np.ndarray, universe: int | None) -> int:
    if universe is not None:
        return universe
    return int(doc_ids[-1]) + 1 if len(doc_ids) else 0


def compressed_size_bits(
    doc_ids: np.ndarray,
    universe: int,
    codec: str = "optpfd",
    *,
    eps: int | None = None,
) -> int:
    """Exact compressed bits of one posting list under `codec`.

    `eps` is the learned-codec error bound (plm correction budget); classical
    codecs ignore it.  codec="hybrid" returns the per-term minimum over all
    codecs plus the selector tag bits.
    """
    doc_ids = np.asarray(doc_ids)
    if codec == "optpfd":
        return optpfd_size_bits(dgaps(doc_ids))
    if codec == "varbyte":
        return varbyte_size_bits(dgaps(doc_ids))
    if codec == "eliasfano":
        return eliasfano_size_bits(doc_ids, universe)
    if codec == "bitvector":
        return bitvector_size_bits(universe)
    if codec == "plm":
        from repro_torch.postings.plm import DEFAULT_EPS, plm_size_bits

        return plm_size_bits(doc_ids, DEFAULT_EPS if eps is None else eps)
    if codec == "rmi":
        from repro_torch.postings.rmi import rmi_size_bits

        return rmi_size_bits(doc_ids)
    if codec == "hybrid":
        from repro_torch.postings.hybrid import hybrid_size_bits

        return hybrid_size_bits(doc_ids, universe, eps=eps)
    raise ValueError(f"unknown codec {codec}")


def encode_postings(
    doc_ids: np.ndarray,
    codec: str = "optpfd",
    *,
    universe: int | None = None,
    eps: int | None = None,
) -> np.ndarray:
    """Encode a sorted doc-id list to a uint32 word stream under `codec`."""
    doc_ids = np.asarray(doc_ids)
    if codec == "optpfd":
        return optpfd_encode(dgaps(doc_ids))
    if codec == "varbyte":
        return varbyte_encode(dgaps(doc_ids))
    if codec == "eliasfano":
        return eliasfano_encode(doc_ids, _default_universe(doc_ids, universe))
    if codec == "bitvector":
        return bitvector_encode(doc_ids, _default_universe(doc_ids, universe))
    if codec == "plm":
        from repro_torch.postings.plm import DEFAULT_EPS, plm_encode

        return plm_encode(doc_ids, DEFAULT_EPS if eps is None else eps)
    if codec == "rmi":
        from repro_torch.postings.rmi import rmi_encode

        return rmi_encode(doc_ids)
    if codec == "hybrid":
        from repro_torch.postings.hybrid import hybrid_encode

        return hybrid_encode(doc_ids, _default_universe(doc_ids, universe), eps=eps)
    raise ValueError(f"unknown codec {codec}")


def decode_postings(words: np.ndarray, n: int, codec: str = "optpfd") -> np.ndarray:
    """Exact inverse of encode_postings -> sorted int32 doc ids."""
    if codec == "optpfd":
        return undgaps(optpfd_decode(words, n))
    if codec == "varbyte":
        return undgaps(varbyte_decode(words, n))
    if codec == "eliasfano":
        return eliasfano_decode(words, n)
    if codec == "bitvector":
        return bitvector_decode(words, n)
    if codec == "plm":
        from repro_torch.postings.plm import plm_decode

        return plm_decode(words, n)
    if codec == "rmi":
        from repro_torch.postings.rmi import rmi_decode

        return rmi_decode(words, n)
    if codec == "hybrid":
        from repro_torch.postings.hybrid import hybrid_decode

        return hybrid_decode(words, n)
    raise ValueError(f"unknown codec {codec}")


def index_size_bits(
    term_offsets: np.ndarray,
    doc_ids: np.ndarray,
    universe: int,
    codec: str = "optpfd",
    *,
    eps: int | None = None,
) -> np.ndarray:
    """Per-term compressed sizes for a whole index (vector over terms)."""
    n_terms = len(term_offsets) - 1
    sizes = np.zeros(n_terms, dtype=np.int64)
    for t in range(n_terms):
        lo, hi = term_offsets[t], term_offsets[t + 1]
        if hi > lo:
            sizes[t] = compressed_size_bits(doc_ids[lo:hi], universe, codec, eps=eps)
    return sizes

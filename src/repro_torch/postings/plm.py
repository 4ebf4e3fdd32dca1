"""ε-bounded piecewise-linear model (PLM) codec for sorted doc-id lists.

The learned-index view of a posting list [Kraska et al. '18; Ferragina &
Vinciguerra's PGM-index]: the list is the graph of a monotone function
rank -> doc_id, and a piecewise-linear approximation with maximum error ε
plus one ⌈log2(2ε+1)⌉-bit correction per posting is an exact, lossless
representation — often far below bit-packed d-gaps for smooth (long, dense,
or clustered) lists.  This module provides:

  * ``fit_segments``      — O(n) shrinking-cone optimal-PLA fitter,
  * ``plm_encode/decode`` — exact lossless (de)serialization to uint32 words,
  * ``plm_size_bits``     — exact bit accounting for Eq. (2) comparisons.

Stream layout (uint32 words; shared with rmi.py via emit/parse helpers)::

  w0            n_segments S
  w1            corr_width (bits 0..7) | eps (bits 8..23)
  w2            corr_min  (int32 bit pattern)
  w3..          starts[S]  u32   first rank covered by each segment
  ..            bases[S]   i32   exact integer intercept of each segment
  ..            slopes[S]  f32   bit pattern
  ..            corrections, pack_bits(corr - corr_min, corr_width)

Decode of rank i in segment s is ``base_s + rint_f32(slope_s * (i - start_s))
+ corr_i``.  The intercept is kept integer (base) so the float step is a
single multiply: with one rounding there is no FMA-contraction ambiguity,
and host numpy, the jnp reference, and the Pallas kernel agree bit-for-bit.
Corrections are measured against the *stored* float32 slope, so quantization
error is absorbed and decode is exactly lossless for any ids < 2^31.
"""
from __future__ import annotations

import numpy as np

from repro_torch.index.compress import pack_bits, unpack_bits

DEFAULT_EPS = 63  # 7-bit corrections; the paper's Eq.(2) sweet spot for long lists

_HEADER_WORDS = 3
_SEGMENT_WORDS = 3  # start + base + slope


# ------------------------------------------------------------------ fitting
def fit_segments(doc_ids: np.ndarray, eps: int) -> tuple[np.ndarray, ...]:
    """Greedy shrinking-cone PLA over (rank, doc_id) with |error| <= eps.

    Each segment's line is anchored at its first point (start, base), so only
    the slope is free; the feasible-slope interval shrinks as points arrive
    and a new segment opens when it empties.  O(n), provably minimal #segments
    among anchored PLAs (the cone argument of O'Rourke '81 / PGM).

    Returns (starts int64, bases int64, slopes f32).
    """
    n = len(doc_ids)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    ys = np.asarray(doc_ids, dtype=np.int64).tolist()
    starts, bases, slopes = [0], [ys[0]], []
    lo, hi = -np.inf, np.inf
    i0, y0 = 0, ys[0]
    for i in range(1, n):
        dx = i - i0
        dy = ys[i] - y0
        nlo = max(lo, (dy - eps) / dx)
        nhi = min(hi, (dy + eps) / dx)
        if nlo > nhi:  # cone empty -> close segment, open a new one at i
            slopes.append(0.0 if lo == -np.inf else (lo + hi) / 2.0)
            i0, y0 = i, ys[i]
            starts.append(i0)
            bases.append(y0)
            lo, hi = -np.inf, np.inf
        else:
            lo, hi = nlo, nhi
    slopes.append(0.0 if lo == -np.inf else (lo + hi) / 2.0)
    return (
        np.asarray(starts, np.int64),
        np.asarray(bases, np.int64),
        np.asarray(slopes, np.float32),
    )


# ------------------------------------------------------------- shared eval
def eval_segments(
    starts: np.ndarray,
    bases: np.ndarray,
    slopes: np.ndarray,
    n: int,
) -> np.ndarray:
    """Canonical model prediction for ranks 0..n-1 (int64).

    A single float32 multiply then banker's rint: with exactly one float
    rounding the result is bit-identical across host numpy, the jnp
    reference, and the Pallas plm_decode kernel (no FMA contraction can
    change it), so corrections transfer across decode paths.
    """
    if n == 0:
        return np.zeros(0, np.int64)
    ranks = np.arange(n, dtype=np.int64)
    seg = np.searchsorted(starts.astype(np.int64), ranks, side="right") - 1
    di = (ranks - starts.astype(np.int64)[seg]).astype(np.float32)
    frac = np.rint(slopes[seg] * di).astype(np.int64)
    return bases.astype(np.int64)[seg] + frac


def emit_stream(
    doc_ids: np.ndarray,
    starts: np.ndarray,
    bases: np.ndarray,
    slopes: np.ndarray,
    eps: int,
) -> np.ndarray:
    """Serialize segments + exact corrections to a uint32 word stream."""
    n = len(doc_ids)
    pred = eval_segments(starts, bases, slopes, n)
    corr = np.asarray(doc_ids, np.int64) - pred
    corr_min = int(corr.min()) if n else 0
    spread = int(corr.max()) - corr_min if n else 0
    width = int(spread).bit_length()
    assert width <= 32, "correction spread exceeds 32 bits (degenerate fit)"
    header = np.array(
        [len(starts), (width & 0xFF) | ((eps & 0xFFFF) << 8), np.int64(corr_min) & 0xFFFFFFFF],
        dtype=np.uint32,
    )
    packed = pack_bits((corr - corr_min).astype(np.uint32), width)
    return np.concatenate(
        [
            header,
            starts.astype(np.uint32),
            (bases & 0xFFFFFFFF).astype(np.uint32),
            np.ascontiguousarray(slopes, np.float32).view(np.uint32),
            packed,
        ]
    )


def parse_segments(
    words: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int, np.ndarray]:
    """Header + segment tables only, corrections left packed.

    -> (starts i64, bases i64, slopes f32, corr_width, corr_min, corr_words).
    The single owner of the stream layout: full decode (parse_stream) and the
    guided-search metadata loader both build on it.  bases round-trip through
    a signed int32 view (an RMI intercept fold can push a base slightly
    negative)."""
    s = int(words[0])
    width = int(words[1]) & 0xFF
    corr_min = int(np.int32(np.uint32(words[2])))
    p = _HEADER_WORDS
    starts = words[p : p + s].astype(np.int64); p += s
    bases = words[p : p + s].astype(np.uint32).view(np.int32).astype(np.int64); p += s
    slopes = words[p : p + s].view(np.float32); p += s
    return starts, bases, slopes, width, corr_min, words[p:]


def parse_stream(words: np.ndarray, n: int) -> tuple[np.ndarray, ...]:
    """Inverse of emit_stream -> (starts i64, bases i64, slopes f32, corr i64)."""
    starts, bases, slopes, width, corr_min, corr_words = parse_segments(words)
    corr = unpack_bits(corr_words, width, n).astype(np.int64) + corr_min
    return starts, bases, slopes, corr


def _stream_size_bits(n: int, n_segments: int, corr_width: int) -> int:
    return 32 * _HEADER_WORDS + _SEGMENT_WORDS * 32 * n_segments + n * corr_width


def stream_size_bits(words: np.ndarray, n: int) -> int:
    """Exact bits of an already-emitted stream (header carries S and width),
    so a caller that encodes anyway never fits the model twice to size it."""
    return _stream_size_bits(n, int(words[0]), int(words[1]) & 0xFF)


def decode_stream(words: np.ndarray, n: int) -> np.ndarray:
    starts, bases, slopes, corr = parse_stream(words, n)
    ids = eval_segments(starts, bases, slopes, n) + corr
    if n and not (0 <= ids.min() and ids.max() <= np.iinfo(np.int32).max):
        raise OverflowError("decoded doc id outside int32 range")
    return ids.astype(np.int32)


# ------------------------------------------------------------------- codec
def plm_encode(doc_ids: np.ndarray, eps: int = DEFAULT_EPS) -> np.ndarray:
    starts, bases, slopes = fit_segments(doc_ids, eps)
    return emit_stream(doc_ids, starts, bases, slopes, eps)


def plm_decode(words: np.ndarray, n: int) -> np.ndarray:
    return decode_stream(words, n)


def plm_size_bits(doc_ids: np.ndarray, eps: int = DEFAULT_EPS) -> int:
    """Exact bits: header + 96b/segment + measured correction width * n."""
    starts, bases, slopes = fit_segments(doc_ids, eps)
    n = len(doc_ids)
    pred = eval_segments(starts, bases, slopes, n)
    corr = np.asarray(doc_ids, np.int64) - pred
    width = int(int(corr.max() - corr.min()).bit_length()) if n else 0
    return _stream_size_bits(n, len(starts), width)

"""Hybrid per-term codec selection: learned where it wins, classical elsewhere.

The paper's §3.3 hybrid representation, generalized: every posting list is
stored under the codec that measures smallest for *that* list, chosen among
{optpfd, varbyte, eliasfano, bitvector, plm, rmi}.  The choice is serialized
as a tag word in front of the stream (TAG_BITS in the exact-bit accounting),
so a hybrid stream is self-describing and `decode` needs no side channel.

`HybridPostings` is the tier-2 store used by serve/boolean.py's exact
verification: it keeps every term compressed and decodes on access, replacing
raw int32 arrays with the min-bits representation.

This is the Boolean half: the ranked tier's payload streams and segment
bounds belong to the ranked slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.index.compress import (
    CODECS,
    compressed_size_bits,
    decode_postings,
    encode_postings,
)
from repro_torch.postings.plm import DEFAULT_EPS, plm_encode, stream_size_bits
from repro_torch.postings.rmi import rmi_encode

# the tag encoding is CODECS order — compress.py owns the list; append only
CANDIDATES = CODECS
TAG_BITS = 3  # ceil(log2(len(CANDIDATES)))
RMI_MIN_N = 128  # RMI leaves only pay off on long lists

_LEARNED = {"plm": plm_encode, "rmi": rmi_encode}


def candidate_codecs(n: int) -> tuple[str, ...]:
    if n >= RMI_MIN_N:
        return CANDIDATES
    return tuple(c for c in CANDIDATES if c != "rmi")


def _measure(
    doc_ids: np.ndarray,
    universe: int,
    eps: int | None,
    candidates: tuple[str, ...],
) -> tuple[dict[str, int], dict[str, np.ndarray]]:
    """Per-candidate exact sizes.  Learned codecs are *encoded* once and sized
    from the stream header, so the winner's fit is never repeated; classical
    codecs use their closed-form size models."""
    sizes: dict[str, int] = {}
    streams: dict[str, np.ndarray] = {}
    for c in candidates:
        if c in _LEARNED:
            if c == "plm":
                words = plm_encode(doc_ids, DEFAULT_EPS if eps is None else eps)
            else:
                words = rmi_encode(doc_ids)
            streams[c] = words
            sizes[c] = stream_size_bits(words, len(doc_ids))
        else:
            sizes[c] = int(compressed_size_bits(doc_ids, universe, c, eps=eps))
    return sizes, streams


def choose_codec(
    doc_ids: np.ndarray,
    universe: int,
    *,
    eps: int | None = None,
    candidates: tuple[str, ...] | None = None,
) -> tuple[str, int, dict[str, int]]:
    """Measure every candidate and pick the min-bits codec.

    Returns (codec, bits, all measured sizes).  Ties break toward the earlier
    entry in CANDIDATES (the faster classical decoder).
    """
    doc_ids = np.asarray(doc_ids)
    cands = candidate_codecs(len(doc_ids)) if candidates is None else candidates
    sizes, _ = _measure(doc_ids, universe, eps, cands)
    best = min(cands, key=lambda c: sizes[c])
    return best, sizes[best], sizes


def hybrid_size_bits(doc_ids: np.ndarray, universe: int, *, eps: int | None = None) -> int:
    _, bits, _ = choose_codec(doc_ids, universe, eps=eps)
    return bits + TAG_BITS


def _encode_chosen(
    doc_ids: np.ndarray, universe: int, eps: int | None
) -> tuple[str, int, np.ndarray]:
    """Choose + emit the tag-prefixed stream, reusing a learned fit's words."""
    doc_ids = np.asarray(doc_ids)
    cands = candidate_codecs(len(doc_ids))
    sizes, streams = _measure(doc_ids, universe, eps, cands)
    best = min(cands, key=lambda c: sizes[c])
    body = streams.get(best)
    if body is None:
        body = encode_postings(doc_ids, best, universe=universe, eps=eps)
    tag = np.array([CANDIDATES.index(best)], dtype=np.uint32)
    return best, sizes[best], np.concatenate([tag, body])


def hybrid_encode(doc_ids: np.ndarray, universe: int, *, eps: int | None = None) -> np.ndarray:
    return _encode_chosen(doc_ids, universe, eps)[2]


def hybrid_decode(words: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int32)
    tag = int(words[0])
    if tag >= len(CANDIDATES):
        raise ValueError(f"corrupt hybrid stream: codec tag {tag}")
    return decode_postings(words[1:], n, CANDIDATES[tag])


# ----------------------------------------------------------------- the store
@dataclass
class HybridPostings:
    """Whole-index compressed postings store with per-term codec choice."""

    universe: int
    lens: np.ndarray  # (n_terms,) int64 list lengths
    tags: np.ndarray  # (n_terms,) uint8 index into CANDIDATES
    bits: np.ndarray  # (n_terms,) int64 measured size incl. TAG_BITS
    streams: list[np.ndarray]  # per-term uint32 word streams (tag-prefixed)

    @classmethod
    def build(
        cls,
        term_offsets: np.ndarray,
        doc_ids: np.ndarray,
        universe: int,
        *,
        eps: int | None = None,
    ) -> "HybridPostings":
        n_terms = len(term_offsets) - 1
        lens = np.diff(term_offsets).astype(np.int64)
        tags = np.zeros(n_terms, np.uint8)
        bits = np.zeros(n_terms, np.int64)
        streams: list[np.ndarray] = []
        empty = np.zeros(0, np.uint32)
        for t in range(n_terms):
            lo, hi = int(term_offsets[t]), int(term_offsets[t + 1])
            if hi == lo:
                streams.append(empty)
                continue
            ids = doc_ids[lo:hi]
            codec, best_bits, stream = _encode_chosen(ids, universe, eps)
            tags[t] = CANDIDATES.index(codec)
            bits[t] = best_bits + TAG_BITS
            streams.append(stream)
        return cls(universe=universe, lens=lens, tags=tags, bits=bits, streams=streams)

    @classmethod
    def from_index(cls, inv, *, eps: int | None = None) -> "HybridPostings":
        return cls.build(inv.term_offsets, inv.doc_ids, inv.n_docs, eps=eps)

    def postings(self, t: int) -> np.ndarray:
        n = int(self.lens[t])
        if n == 0:
            return np.zeros(0, np.int32)
        return hybrid_decode(self.streams[t], n)

    @property
    def n_terms(self) -> int:
        return len(self.lens)

    def size_bits(self) -> int:
        return int(self.bits.sum())

    def codec_histogram(self) -> dict[str, int]:
        """How many terms each codec won — the learned-vs-classical split."""
        counts = np.bincount(self.tags[self.lens > 0], minlength=len(CANDIDATES))
        return {c: int(counts[i]) for i, c in enumerate(CANDIDATES) if counts[i]}

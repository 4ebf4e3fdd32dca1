"""Hybrid per-term codec selection: learned where it wins, classical elsewhere.

The paper's §3.3 hybrid representation, generalized: every posting list is
stored under the codec that measures smallest for *that* list, chosen among
{optpfd, varbyte, eliasfano, bitvector, plm, rmi}.  The choice is serialized
as a tag word in front of the stream (TAG_BITS in the exact-bit accounting),
so a hybrid stream is self-describing and `decode` needs no side channel.

`HybridPostings` is the tier-2 store used by serve/boolean.py's exact
verification: it keeps every term compressed and decodes on access, replacing
raw int32 arrays with the min-bits representation.

The ranked tier adds an optional *payload stream* per term: quantized BM25
impact values (repro_torch.rank.score), bit-packed rank-aligned with the
docid stream — a guided ε-window rank probe lands directly on its payload via
``payload_at`` without decoding the list.  Alongside it, per-term score
upper bounds at *segment* granularity: for learned-codec terms the PLA/RMI
segment table partitions the rank space, so the max impact per segment is a
block-max table the store gets for free; classical-codec terms carry one
whole-list bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.index.compress import (
    CODECS,
    compressed_size_bits,
    decode_postings,
    encode_postings,
    pack_bits,
    unpack_bits,
    unpack_bits_at,
)
from repro_torch.postings.plm import DEFAULT_EPS, parse_segments, plm_encode, stream_size_bits
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


_LEARNED_TAG_IDS = frozenset(CANDIDATES.index(c) for c in ("plm", "rmi"))


def _segment_starts(stream: np.ndarray, tag: int, n: int) -> np.ndarray:
    """Rank-space partition of one term's stream for the block-max table:
    the learned codecs' own segment table, one whole-list block otherwise."""
    if tag in _LEARNED_TAG_IDS:
        return parse_segments(stream[1:])[0]  # strip the hybrid tag word
    return np.zeros(1, np.int64)


# ----------------------------------------------------------------- the store
@dataclass
class HybridPostings:
    """Whole-index compressed postings store with per-term codec choice."""

    universe: int
    lens: np.ndarray  # (n_terms,) int64 list lengths
    tags: np.ndarray  # (n_terms,) uint8 index into CANDIDATES
    bits: np.ndarray  # (n_terms,) int64 measured size incl. TAG_BITS
    # per-term uint32 word streams (tag-prefixed): a list when built here, a
    # lazy view of one memmapped array when loaded (index/store.StreamArena)
    streams: list[np.ndarray]
    # ------- optional ranked-tier payloads (attach_payloads)
    payload_bits: int = 0  # quantized-impact width; 0 = no payloads
    payload_scale: float = 0.0  # dequant scale (ImpactModel.scale)
    payload_streams: "list[np.ndarray] | None" = None  # per-term packed impacts
    ub_offsets: np.ndarray | None = None  # (n_terms+1,) int64 into seg_ubs
    seg_ubs: np.ndarray | None = None  # per-segment max quantized impact (u32)
    term_ubs: np.ndarray | None = None  # (n_terms,) int64 derived whole-list max
    # parsed optpfd block headers per term, walked once per process
    # (postings/search.py:decode_terms fills it)
    block_tables: dict = field(default_factory=dict, repr=False, compare=False)

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

    # ------------------------------------------------------------- payloads
    @property
    def has_payloads(self) -> bool:
        return self.payload_bits > 0 and self.payload_streams is not None

    def attach_payloads(self, quants: np.ndarray, *, bits: int, scale: float) -> None:
        """Pack per-posting quantized impacts + build the segment-ub table.

        ``quants`` is flat, aligned with the concatenation of every term's
        postings in term order (the same order the store was built from).
        """
        quants = np.asarray(quants, np.uint32)
        if int(self.lens.sum()) != len(quants):
            raise ValueError(
                f"{len(quants)} payload values for {int(self.lens.sum())} postings"
            )
        if bits <= 0 or (len(quants) and int(quants.max()) >> bits):
            raise ValueError(f"payload values exceed {bits} bits")
        offsets = np.zeros(len(self.lens) + 1, np.int64)
        np.cumsum(self.lens, out=offsets[1:])
        streams: list[np.ndarray] = []
        ub_offsets = np.zeros(len(self.lens) + 1, np.int64)
        seg_ubs: list[np.ndarray] = []
        empty = np.zeros(0, np.uint32)
        for t in range(len(self.lens)):
            n = int(self.lens[t])
            if n == 0:
                streams.append(empty)
                ub_offsets[t + 1] = ub_offsets[t]
                continue
            q = quants[offsets[t] : offsets[t + 1]]
            streams.append(pack_bits(q, bits))
            starts = _segment_starts(self.streams[t], int(self.tags[t]), n)
            seg_ubs.append(np.maximum.reduceat(q, starts).astype(np.uint32))
            ub_offsets[t + 1] = ub_offsets[t] + len(starts)
        self.set_payloads(
            streams, bits=bits, scale=scale, ub_offsets=ub_offsets,
            seg_ubs=np.concatenate(seg_ubs) if seg_ubs else np.zeros(0, np.uint32),
        )

    def set_payloads(self, streams, *, bits: int, scale: float, ub_offsets: np.ndarray,
                     seg_ubs: np.ndarray) -> None:
        """Take packed payload streams as they are: ``attach_payloads``'
        output, or a loaded store's arrays (index/store.py), where
        ``streams`` is a lazy view of one memmapped word array and the
        offsets and bounds are read-only memmaps."""
        self.payload_bits = int(bits)
        self.payload_scale = float(scale)
        self.payload_streams = streams
        self.ub_offsets = ub_offsets
        self.seg_ubs = seg_ubs
        self.term_ubs = None  # rebuild the derived cache lazily

    def _require_payloads(self) -> None:
        if not self.has_payloads:
            raise ValueError("store carries no ranked payloads (attach_payloads)")

    def payloads(self, t: int) -> np.ndarray:
        """Full quantized-impact vector of term t, rank-aligned with postings."""
        self._require_payloads()
        return unpack_bits(self.payload_streams[t], self.payload_bits, int(self.lens[t]))

    def payload_at(self, t: int, ranks: np.ndarray) -> np.ndarray:
        """Quantized impacts at the given ranks only — the probe-path access:
        a guided rank probe reads its payload without decoding the list."""
        self._require_payloads()
        return unpack_bits_at(self.payload_streams[t], self.payload_bits, ranks)

    def term_ub(self, t: int) -> int:
        """Whole-list score upper bound (max quantized impact) of term t."""
        if self.term_ubs is None:
            self._require_payloads()
            ubs = np.zeros(len(self.lens), np.int64)
            nz = np.nonzero(np.diff(self.ub_offsets) > 0)[0]
            if len(nz):
                ubs[nz] = np.maximum.reduceat(
                    np.asarray(self.seg_ubs, np.int64), self.ub_offsets[nz]
                )[: len(nz)]
            self.term_ubs = ubs
        return int(self.term_ubs[t])

    def term_seg_ubs(self, t: int) -> np.ndarray:
        """Per-segment bounds of term t, aligned with its segment table."""
        self._require_payloads()
        return self.seg_ubs[int(self.ub_offsets[t]) : int(self.ub_offsets[t + 1])]

    def payload_size_bits(self) -> int:
        """Exact payload-tier bits as stored: packed impact words (including
        each term's trailing word padding) + 32b/segment bound."""
        if not self.has_payloads:
            return 0
        words = sum(int(s.size) for s in self.payload_streams)
        return 32 * words + 32 * len(self.seg_ubs)

"""Model-guided search over learned posting streams — serving without decode.

The PLM/RMI rank models compress the lists; this module also uses them as
ε-bounded search structures [Kraska et al. '18; PGM-index].  A posting list
stored as segments (start, base, slope) + per-rank corrections supports

  ``rank(term, d)``     — #postings < d,
  ``contains(term, d)`` — membership,

by *predicting* the rank of d from the inverted segment model and decoding
only the correction window that the ε-bound proves can contain it — never the
full list.  The probe cost is O(window) bits instead of O(n · width):

  window ranks ≈ (corr_max − corr_min) / slope   (≤ 2ε/slope for PLM).

Exactness argument (per probe): let segment s be the one whose exact first
doc id brackets d (seg_first[s] ≤ d < seg_first[s+1]; seg_first is
materialized once per term from S single-rank decodes).  Within s every rank
r decodes to pred(r) + corr_r with corr_r ∈ [corr_min, corr_max], and decoded
ids are strictly increasing, so

  pred(r) + corr_max < d  ⇒  id(r) < d      (r below the window)
  pred(r) + corr_min > d  ⇒  id(r) > d      (r above the window)

which yields a closed-form rank bracket [r_lo, r_hi] (a float32 slack term
absorbs the single-multiply rounding of pred).  Decoding exactly that window
with the canonical plm formula reproduces the true sublist, so membership and
rank are bit-exact against full decode.  Classical-codec terms (the hybrid
store keeps whichever codec measured smallest) fall back to full decode via a
caller-supplied accessor.

``GuidedPostings`` wraps a HybridPostings store and keeps honest byte
accounting (``ProbeStats``) so benchmarks can compare the stream bytes a
guided probe touches against what a full decode would have read.  The
segment tables and packed corrections of every learned term lie on the
prober's ``device`` in one ``StreamArena``, uploaded at its first guided
probe; ``probe_many``/``contains_many`` answer the ε-window probes of a
whole batch of (term, candidate set) items, of any terms, with one
``guided_search`` launch: the CUDA kernel on a card, the plain PyTorch
version on the CPU.  Full decodes (``decode_terms``, and ``full_decode`` for
one term) run on the ``plm_decode`` kernel for learned-codec terms and on
the ``pfor`` kernel for optpfd terms the same way, one launch per kernel for
a whole batch of lists.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.index.compress import CODECS, unpack_bits_at
from repro_torch.index.intersect import gallop_membership
from repro_torch.obs import trace
from repro_torch.postings.hybrid import HybridPostings
from repro_torch.postings.plm import parse_segments

_LEARNED_TAGS = frozenset(CODECS.index(c) for c in ("plm", "rmi"))
_OPTPFD_TAG = CODECS.index("optpfd")

# float32 slack for the rank bracket: |pred_f32 - slope*di| <= 0.5 (rint)
# plus ~2^-23 relative product error; 2 + |d-base| * 2^-22 dominates both.
_SLACK_ABS = 2.0
_SLACK_REL = 2.0**-22


@dataclass
class TermModel:
    """Parsed PLM/RMI stream metadata for one term — no corrections decoded."""

    n: int
    starts: np.ndarray  # (S,) int64 first rank per segment
    ends: np.ndarray  # (S,) int64 exclusive last rank per segment
    bases: np.ndarray  # (S,) int64 integer intercepts
    slopes: np.ndarray  # (S,) float32
    seg_first: np.ndarray  # (S,) int64 exact first doc id per segment
    corr_words: np.ndarray  # packed corrections (uint32 view into the stream)
    width: int  # correction bit width
    corr_min: int
    corr_max: int  # conservative: corr_min + 2**width - 1
    meta_bytes: int  # stream bytes touched to build this model
    avg_window: float  # expected probe-window ranks (the ε-window cost model)


def load_term_model(words: np.ndarray, n: int) -> TermModel:
    """Parse a plm/rmi stream's header + segment table (layout: plm.py).

    Touches header + segment words + one correction per segment (for the
    exact seg_first anchors); the packed correction body is kept as an
    opaque word view for windowed access.
    """
    starts, bases, slopes, width, corr_min, corr_words = parse_segments(words)
    ends = np.concatenate([starts[1:], np.array([n], np.int64)])
    # pred(start_s) = base_s exactly (di = 0), so the exact first id per
    # segment is base + correction-at-start: S point lookups, no full decode.
    first_corr = unpack_bits_at(corr_words, width, starts).astype(np.int64) + corr_min
    seg_first = bases + first_corr
    header_words = len(words) - len(corr_words)
    meta_bytes = 4 * (header_words + _touched_words(starts, width))
    # ε-window cost model: expected probe-window length in ranks is the
    # correction spread divided by the segment slope (rank-per-id inversion),
    # averaged over segments weighted by the ranks they cover.
    spread = float((1 << width) - 1)
    seg_lens = (ends - starts).astype(np.float64)
    win = spread / np.maximum(slopes.astype(np.float64), 1e-3) + 1.0
    avg_window = float((win * seg_lens).sum() / max(float(seg_lens.sum()), 1.0))
    return TermModel(
        n=n,
        starts=starts,
        ends=ends,
        bases=bases,
        slopes=slopes,
        seg_first=seg_first,
        corr_words=corr_words,
        width=width,
        corr_min=corr_min,
        corr_max=corr_min + (1 << width) - 1,
        meta_bytes=meta_bytes,
        avg_window=avg_window,
    )


def _touched_words(indices: np.ndarray, width: int) -> int:
    """#distinct 32-bit words a scattered unpack at `indices` reads."""
    if width == 0 or len(indices) == 0:
        return 0
    bitpos = np.asarray(indices, np.int64) * width
    return len(np.unique(bitpos // 32))


def window_words(r_lo: np.ndarray, lens: np.ndarray, width: int) -> int:
    """``_touched_words`` of every rank of the windows [r_lo, r_lo + lens),
    without listing the ranks: for width <= 32 the ranks of one window start
    in every word from r_lo*w // 32 to (r_lo+len-1)*w // 32, so the count is
    the size of the union of those word intervals."""
    keep = np.asarray(lens) > 0
    if width == 0:
        return 0
    lo = np.asarray(r_lo, np.int64)[keep]
    return union_size(lo * width // 32, (lo + np.asarray(lens, np.int64)[keep] - 1) * width // 32)


def union_size(first: np.ndarray, last: np.ndarray) -> int:
    """#integers in the union of the closed intervals [first_i, last_i]."""
    if len(first) == 0:
        return 0
    order = np.argsort(first, kind="stable")
    first, last = first[order], last[order]
    # the integers of interval i that no interval before it covers
    reach = np.maximum.accumulate(last)
    prev = np.concatenate([[first[0] - 1], reach[:-1]])
    return int(np.maximum(last - np.maximum(first - 1, prev), 0).sum())


def rank_windows(tm: TermModel, cands: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-candidate exact rank bracket -> (seg, r_lo, r_hi) int64 arrays.

    r_hi is inclusive; an empty window (r_lo > r_hi) proves absence with
    rank(d) = r_lo.  Brackets never cross segment boundaries (the seg_first
    bracketing confines the true rank to one segment).
    """
    d = np.asarray(cands, np.int64)
    seg = np.searchsorted(tm.seg_first, d, side="right") - 1
    below = seg < 0  # d precedes the whole list
    seg = np.maximum(seg, 0)
    base = tm.bases[seg]
    lo_r = tm.starts[seg]
    hi_r = tm.ends[seg]
    slope = tm.slopes[seg].astype(np.float64)
    slack = _SLACK_ABS + np.abs(d - base).astype(np.float64) * _SLACK_REL
    ok = slope > 0
    safe = np.where(ok, slope, 1.0)
    r_hi = lo_r + np.floor((d - base - tm.corr_min + slack) / safe).astype(np.int64)
    r_lo = lo_r + np.ceil((d - base - tm.corr_max - slack) / safe).astype(np.int64)
    # degenerate slope: no inversion possible, scan the whole segment
    r_lo = np.where(ok, r_lo, lo_r)
    r_hi = np.where(ok, r_hi, hi_r - 1)
    r_lo = np.clip(r_lo, lo_r, hi_r)
    r_hi = np.clip(r_hi, lo_r - 1, hi_r - 1)
    # d below the first id: empty window at rank 0
    r_lo = np.where(below, 0, r_lo)
    r_hi = np.where(below, -1, r_hi)
    seg = np.where(below, 0, seg)
    return seg, r_lo, r_hi


def decode_window(tm: TermModel, seg: np.ndarray, ranks: np.ndarray) -> np.ndarray:
    """Exact ids at `ranks` (each inside its `seg`): canonical plm formula."""
    di = (ranks - tm.starts[seg]).astype(np.float32)
    pred = tm.bases[seg] + np.rint(tm.slopes[seg] * di).astype(np.int64)
    corr = unpack_bits_at(tm.corr_words, tm.width, ranks).astype(np.int64) + tm.corr_min
    return pred + corr


def flatten_windows(
    tm: TermModel, cands: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rank brackets flattened to one rank vector for batched decode.

    -> (seg, r_lo, lens, probe_of, col, flat_ranks): probe_of[i] is the
    candidate index owning flat rank i, col[i] its position inside that
    candidate's window (flat_ranks = r_lo[probe_of] + col).  For host checks
    and tests: the probe path itself never lists the ranks.
    """
    seg, r_lo, r_hi = rank_windows(tm, cands)
    lens = np.maximum(r_hi - r_lo + 1, 0)
    total = int(lens.sum())
    probe_of = np.repeat(np.arange(len(cands)), lens)
    offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
    col = np.arange(total) - offs[probe_of]
    flat_ranks = r_lo[probe_of] + col
    return seg, r_lo, lens, probe_of, col, flat_ranks


# decoded ids one decode launch produces at most (64 MiB of int32): the
# misses of a Robust-scale batch on one shard fit in one launch, and the
# host and device buffers of a launch stay bounded
DECODE_CHUNK_BYTES = 64 << 20


def decode_kernel(store: HybridPostings, t: int) -> str | None:
    """The kernel a full decode of term t runs on: 'pfor' (optpfd), 'plm'
    (plm, rmi), or None (an empty list, or a codec the host decodes)."""
    if int(store.lens[t]) == 0:
        return None
    tag = int(store.tags[t])
    if tag == _OPTPFD_TAG:
        return "pfor"
    return "plm" if tag in _LEARNED_TAGS else None


def decode_terms(
    store: HybridPostings, terms, device: torch.device | str
) -> list[np.ndarray]:
    """All postings of each term, in order: every optpfd term of a chunk in
    one ``pfor`` launch and every plm/rmi term in one ``plm_decode`` launch
    on ``device`` (their plain versions on the CPU), the other classical
    codecs by the host decoder.  Chunks hold at most ``DECODE_CHUNK_BYTES``
    of decoded ids (a longer list is a chunk of its own).  The optpfd block
    headers of a term are walked once and kept in ``store.block_tables``."""
    from repro_torch.kernels.pfor import ops as pfor_ops
    from repro_torch.kernels.plm_decode import ops as plm_ops

    terms = [int(t) for t in terms]
    out: list[np.ndarray | None] = [None] * len(terms)
    groups: dict[str, list[int]] = {"pfor": [], "plm": []}
    for j, t in enumerate(terms):
        kernel = decode_kernel(store, t)
        if kernel is None:
            out[j] = store.postings(t)
        else:
            groups[kernel].append(j)
    for kind, idx in groups.items():
        for chunk in byte_chunks(idx, [4 * int(store.lens[terms[j]]) for j in idx]):
            ts = [terms[j] for j in chunk]
            streams = [store.streams[t][1:] for t in ts]  # strip the hybrid tag
            lens = [int(store.lens[t]) for t in ts]
            if kind == "pfor":
                tables = store.block_tables
                for t, w, n in zip(ts, streams, lens):
                    if t not in tables:
                        tables[t] = pfor_ops.parse_stream(w, n)
                got = pfor_ops.decode_lists(streams, lens, device=device,
                                            tables=[tables[t] for t in ts])
            else:
                got = plm_ops.decode_lists(streams, lens, device=device)
            for j, ids in zip(chunk, got):
                out[j] = ids
    return out


def byte_chunks(idx: list[int], nbytes: list[int]) -> list[list[int]]:
    """Consecutive runs of ``idx`` whose ``nbytes`` sum to at most
    DECODE_CHUNK_BYTES each (a larger item is a run of its own)."""
    runs: list[list[int]] = []
    size = 0
    for j, b in zip(idx, nbytes):
        if not runs or size + b > DECODE_CHUNK_BYTES:
            runs.append([])
            size = 0
        runs[-1].append(j)
        size += b
    return runs


def full_decode(store: HybridPostings, t: int, device: torch.device) -> np.ndarray:
    """All postings of term t: ``decode_terms`` of one term."""
    return decode_terms(store, [t], device)[0]


@dataclass
class StreamArena:
    """The learned (plm/rmi) streams of a store, resident on a device, as
    ``guided_search`` reads them: term row l = [first word, width, corr_min]
    of its packed corrections in ``words`` (terms end to end), segment row g
    = [start, base, slope bits] (terms end to end, term row l's first at
    ``first_seg[l]``).  ``row[t]`` is term t's term row."""

    row: dict[int, int]
    first_seg: np.ndarray  # (L,) int64
    terms: torch.Tensor  # (L, 3) int32
    segs: torch.Tensor  # (S, 3) int32
    words: torch.Tensor  # (n_words,) int32


def build_arena(store: HybridPostings, device: torch.device) -> StreamArena:
    """Parse every non-empty plm/rmi stream of ``store`` and upload the
    three tables through one pinned staging buffer in one copy."""
    from repro_torch.kernels.cuda import staging

    learned = [t for t in range(store.n_terms)
               if int(store.lens[t]) and int(store.tags[t]) in _LEARNED_TAGS]
    parsed = [parse_segments(store.streams[t][1:]) for t in learned]
    n_seg = np.array([len(p[0]) for p in parsed], np.int64)
    n_words = np.array([len(p[5]) for p in parsed], np.int64)
    L, S, W = len(learned), int(n_seg.sum()), int(n_words.sum())
    if W >= 2**31 or 3 * (L + S) + W >= 2**31:
        raise ValueError(f"{W} correction words exceed the kernel's int32 positions")
    host = staging(3 * (L + S) + W, device)
    h = host.numpy()
    terms, segs = h[: 3 * L].reshape(L, 3), h[3 * L : 3 * (L + S)].reshape(S, 3)
    if L:
        terms[:, 0] = np.cumsum(n_words) - n_words
        terms[:, 1] = [p[3] for p in parsed]
        terms[:, 2] = [p[4] for p in parsed]
        segs[:, 0] = np.concatenate([p[0] for p in parsed])
        segs[:, 1] = np.concatenate([p[1] for p in parsed])
        segs[:, 2] = np.concatenate([p[2] for p in parsed]).view(np.int32)
        np.concatenate([p[5] for p in parsed], out=h[3 * (L + S) :].view(np.uint32),
                       casting="unsafe")
    buf = host.to(device, non_blocking=True)
    return StreamArena(
        row={t: l for l, t in enumerate(learned)},
        first_seg=np.cumsum(n_seg) - n_seg,
        terms=buf[: 3 * L].view(L, 3),
        segs=buf[3 * L : 3 * (L + S)].view(S, 3),
        words=buf[3 * (L + S) :],
    )


@dataclass
class ProbeStats:
    """Stream-byte accounting for the guided-vs-full comparison."""

    probes: int = 0
    guided_terms: int = 0
    fallback_terms: int = 0
    routed_terms: int = 0  # learned terms sent to full decode by the cost model
    window_bytes: int = 0  # correction bytes decoded by ε-window probes
    metadata_bytes: int = 0  # header/segment-table bytes (once per term)
    fallback_bytes: int = 0  # full stream bytes of classical-codec decodes
    full_equiv_bytes: int = 0  # what full decode would have touched instead
    wide_probes: int = 0  # guided probes whose window exceeds CHUNK_RANKS (cut into chunks)
    wide_ranks: int = 0  # ranks those windows decoded

    def guided_bytes(self) -> int:
        return self.window_bytes + self.metadata_bytes + self.fallback_bytes

    def as_dict(self) -> dict[str, int | float]:
        d = {k: int(getattr(self, k)) for k in (
            "probes", "guided_terms", "fallback_terms", "routed_terms",
            "window_bytes", "metadata_bytes", "fallback_bytes", "full_equiv_bytes",
            "wide_probes", "wide_ranks",
        )}
        d["guided_bytes"] = int(self.guided_bytes())
        d["bytes_ratio"] = (
            self.guided_bytes() / self.full_equiv_bytes if self.full_equiv_bytes else 0.0
        )
        return d


class _Record:
    """One routed probe's probe-log fields while its batch is answered:
    ``own`` bytes are its ε-windows, ``meta`` the models its routing parsed,
    ``once`` its term's first fallback decode (charged once per term)."""

    __slots__ = ("term", "n_cands", "query", "shard", "route", "n_found", "n_postings",
                 "eps_window", "own", "meta", "once", "wall_ns", "seq")

    def __init__(self, term: int, n_cands: int, query: int | None):
        self.term, self.n_cands, self.query = term, n_cands, query
        self.own = self.meta = self.once = self.wall_ns = self.seq = 0

    def finish(self, gp: "GuidedPostings", route: str, tm, n_found: int) -> None:
        self.route, self.n_found = route, n_found
        self.n_postings = int(gp.store.lens[self.term])
        self.eps_window = tm.avg_window if tm is not None else 0.0
        gp._emit(self)

    def log(self, log, nbytes: int) -> None:
        log.log(self.term, self.route, n_cands=self.n_cands, n_found=self.n_found,
                n_postings=self.n_postings, eps_window=self.eps_window, bytes=nbytes,
                wall_us=self.wall_ns / 1e3, query=self.query, shard=self.shard)


class GuidedPostings:
    """contains/rank probes over a HybridPostings store, model-guided.

    Learned-codec terms (plm/rmi) answer from stream metadata + ε-window
    decodes on ``device``; classical-codec terms fall back to `fallback(t)`
    (full decode).  The fallback must cache decodes — `stats.fallback_bytes`
    charges each term's stream once, which is only honest if repeat calls
    don't re-decode.  The default is a per-term cache that a batch fills
    with one ``decode_terms`` call; the serving engine passes its
    decode-cost budgeted LRU accessor instead.

    With a ``probe_log`` (obs.probelog.ProbeLog) every routed probe logs one
    record — the reference's fields — and opens one ``probe.term`` span.  An
    item may name its query (``queries=``), which a batched verify needs: it
    answers a round of many queries at once.  Inside ``batch_log`` the
    records are held and logged query by query, each term's once-per-term
    bytes (its first fallback decode) on the record of the smallest query
    that routed it there — what answering the queries one after another, as
    the reference does, charges.
    """

    def __init__(
        self,
        store: HybridPostings,
        *,
        fallback: Callable[[int], np.ndarray] | None = None,
        device: torch.device | str = "cuda",
        probe_log=None,  # obs.probelog.ProbeLog: one record per routed term
    ):
        self.store = store
        self.device = resolve_device(device)
        self.probe_log = probe_log
        # the default decode cache, which _answer fills a batch at a time
        # before it reads any list
        self._cache: dict[int, np.ndarray] | None = None if fallback else {}
        self.fallback = fallback or self._cache.__getitem__
        self.stats = ProbeStats()
        self._models: dict[int, TermModel | None] = {}
        self._charged: set[int] = set()  # terms whose metadata bytes are charged
        self._fallback_seen: set[int] = set()
        self._arena: StreamArena | None = None
        self._held: list[_Record] | None = None  # batch_log's records

    # ------------------------------------------------------------- models
    def _model(self, t: int) -> TermModel | None:
        """Parsed (cached) TermModel of term t, with no accounting."""
        tm = self._models.get(t, False)
        if tm is False:
            n = int(self.store.lens[t])
            learned = n > 0 and int(self.store.tags[t]) in _LEARNED_TAGS
            tm = load_term_model(self.store.streams[t][1:], n) if learned else None  # strip tag
            self._models[t] = tm
        return tm

    def term_model(self, t: int) -> TermModel | None:
        """TermModel for learned-coded term t, None for classical codecs; its
        metadata bytes are charged at the first call in an accounting window
        (a probe's, or the planner's route decision)."""
        tm = self._model(t)
        if tm is not None and t not in self._charged:
            self._charged.add(t)
            self.stats.metadata_bytes += tm.meta_bytes
        return tm

    def is_guided(self, t: int) -> bool:
        return self.term_model(t) is not None

    @property
    def arena(self) -> StreamArena:
        """Every learned stream of the store on ``device``, uploaded once, at
        the first guided probe; no accounting (the bytes a probe reads are
        charged per window and per parsed model, as without an arena)."""
        if self._arena is None:
            self._arena = build_arena(self.store, self.device)
        return self._arena

    # ------------------------------------------------------------- probes
    def route(self, t: int, n_cands: int, hint: str | None = None) -> str:
        """The route a probe of term t over ``n_cands`` candidates takes,
        with no accounting (the model is parsed, its bytes not charged):
        'empty' | 'fallback' (classical codec, full
        decode) | 'decode' (learned codec sent to full decode by the cost
        model or a planner hint) | 'guided' (ε-window probes).

        ``hint`` is a planner override ('guided' | 'decode'): the sharded
        planner runs the same cost model at plan time with its candidate
        estimate, so the executor honors its decision instead of re-deciding
        per probe.  A hint never forces a guided probe on a classical-codec
        term — absence of a TermModel always falls back.
        """
        if int(self.store.lens[t]) == 0:
            return "empty"
        tm = self._model(t)
        if tm is None:
            return "fallback"
        if hint == "decode" or (hint is None and n_cands * tm.avg_window >= tm.n):
            # cost model: the ε-windows of this many probes would decode more
            # correction bytes than the whole list — full decode is cheaper
            return "decode"
        return "guided"

    def _route(
        self, t: int, n_cands: int, hint: str | None = None
    ) -> tuple[str, TermModel | None]:
        """Shared probe preamble: stats + ``route``.  The TermModel comes
        back for both learned routes so callers can log the ε-window
        feature the router thresholds on."""
        self.stats.probes += n_cands
        route = self.route(t, n_cands, hint)
        if route == "empty":
            return route, None
        self.stats.full_equiv_bytes += 4 * int(self.store.streams[t].size)
        if route == "fallback":
            self.stats.fallback_terms += 1
            return route, None
        if route == "decode":
            self.stats.routed_terms += 1
        else:
            self.stats.guided_terms += 1
        return route, self.term_model(t)

    def _fallback_list(self, t: int) -> np.ndarray:
        """Fully-decoded postings via the (caching) fallback, bytes charged
        once per term to match the cache's decode-once behaviour."""
        p = self.fallback(t)
        if t not in self._fallback_seen:
            self._fallback_seen.add(t)
            self.stats.fallback_bytes += 4 * int(self.store.streams[t].size)
        return p

    def _probe_guided(self, work, recs=None) -> list[tuple[np.ndarray, np.ndarray]]:
        """ε-window probes of (t, TermModel, candidates) items, all in one
        ``guided_search`` launch -> (found, rank) per item.  Each item's
        windows are bracketed under its own ``probe.term`` span; with
        ``recs`` (the items' _Records) each is charged its window bytes and
        its share of the launch's wall time."""
        from repro_torch.kernels.guided_search.ops import CHUNK_RANKS, probe_windows

        arena = self.arena
        parts = []
        for j, (t, tm, cands) in enumerate(work):
            t0 = time.perf_counter_ns()
            with trace.span("probe.term", term=int(t), route="guided", n_cands=len(cands)):
                seg, r_lo, r_hi = rank_windows(tm, cands)
                lens = np.maximum(r_hi - r_lo + 1, 0)
                touched = 4 * window_words(r_lo, lens, tm.width)
                self.stats.window_bytes += touched
                wide = lens[lens > CHUNK_RANKS]
                self.stats.wide_probes += len(wide)
                self.stats.wide_ranks += int(wide.sum())
                row = arena.row[t]
                parts.append((np.full(len(cands), row), arena.first_seg[row] + seg, r_lo, lens,
                              cands))
            if recs is not None:
                recs[j].own += touched
                recs[j].wall_ns += time.perf_counter_ns() - t0
        term, seg, r_lo, lens, cands = (np.concatenate(c) for c in zip(*parts))
        t0 = time.perf_counter_ns()
        found, lt = probe_windows(arena, term, seg, r_lo, lens, cands, device=self.device)
        if recs is not None:
            share = (time.perf_counter_ns() - t0) // len(work)
            for r in recs:
                r.wall_ns += share
        rank = r_lo + lt
        bounds = np.cumsum([0] + [len(c) for _, _, c in work])
        return [(found[a:b], rank[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]

    def _answer(self, items, ranks: bool, queries=None) -> list:
        """The probes of (t, sorted candidates, route hint) items, in item
        order, with the accounting of answering them one by one: the default
        decode cache fetches the batch's full lists in one ``decode_terms``
        call, and the guided items share one ``guided_search`` launch.  Each
        answer is (found, rank) with ``ranks``, else found (fallback terms
        gallop instead of binary-searching every candidate).  ``queries``
        names each item's query in its probe record (None: the log's
        ambient context)."""
        items = [(int(t), np.asarray(c), hint) for t, c, hint in items]
        log = self.probe_log
        recs = None if log is None else [
            _Record(t, len(c), None if queries is None else int(queries[i]))
            for i, (t, c, _) in enumerate(items)]
        routes = []
        for i, (t, c, hint) in enumerate(items):
            m0 = self.stats.metadata_bytes
            routes.append(self._route(t, len(c), hint))
            if recs is not None:
                recs[i].meta = self.stats.metadata_bytes - m0
        full = [t for (t, _, _), (r, _) in zip(items, routes) if r in ("fallback", "decode")]
        if self._cache is not None:
            todo = list(dict.fromkeys(t for t in full if t not in self._cache))
            if todo:
                self._cache.update(zip(todo, decode_terms(self.store, todo, self.device)))
        out: list = [None] * len(items)
        guided = []
        for i, ((t, cands, _), (route, tm)) in enumerate(zip(items, routes)):
            if route == "guided":
                guided.append(i)
                continue
            t0 = time.perf_counter_ns()
            f0 = self.stats.fallback_bytes
            with trace.span("probe.term", term=t, route=route, n_cands=len(cands)):
                if route == "empty":
                    found = np.zeros(len(cands), bool)
                    out[i] = (found, np.zeros(len(cands), np.int64)) if ranks else found
                elif ranks:
                    p = self._fallback_list(t)
                    sel = np.searchsorted(p, cands)
                    found = (sel < len(p)) & (p[np.minimum(sel, len(p) - 1)] == cands)
                    out[i] = (found, sel.astype(np.int64))
                else:
                    out[i] = gallop_membership(self._fallback_list(t), cands)
            if recs is not None:
                recs[i].once = self.stats.fallback_bytes - f0
                recs[i].wall_ns += time.perf_counter_ns() - t0
        if guided:
            got = self._probe_guided(
                [(items[i][0], routes[i][1], items[i][1]) for i in guided],
                None if recs is None else [recs[i] for i in guided])
            for i, res in zip(guided, got):
                out[i] = res if ranks else res[0]
        if recs is not None:
            for i, (rec, (route, tm)) in enumerate(zip(recs, routes)):
                found = out[i][0] if ranks else out[i]
                rec.finish(self, route, tm, int(found.sum()))
        return out

    def _emit(self, rec: "_Record") -> None:
        """Log one finished record, or hold it for ``batch_log``."""
        log = self.probe_log
        query, shard = log.current()
        rec.shard = shard
        if rec.query is None:
            rec.query = query
        if self._held is not None:
            rec.seq = len(self._held)
            self._held.append(rec)
        else:
            rec.log(log, rec.own + rec.meta + rec.once)

    @contextmanager
    def batch_log(self):
        """Hold the probe records logged inside, then log them query by
        query (the order the reference logs them in), each term's
        once-per-term bytes — its parsed model, its first fallback decode —
        on the record of its smallest query that paid them there."""
        if self.probe_log is None or self._held is not None:
            yield
            return
        self._held = []
        try:
            yield
        finally:
            held, self._held = self._held, None
            held.sort(key=lambda r: (r.query, r.seq))
            meta: dict[int, int] = {}
            once: dict[int, int] = {}
            for r in held:
                meta[r.term] = meta.get(r.term, 0) + r.meta
                once[r.term] = once.get(r.term, 0) + r.once
            for r in held:
                b = r.own
                if r.route != "empty" and r.term in meta:
                    b += meta.pop(r.term)
                if r.route in ("fallback", "decode") and r.term in once:
                    b += once.pop(r.term)
                r.log(self.probe_log, b)

    def probe_many(self, items, *, queries=None) -> list[tuple[np.ndarray, np.ndarray]]:
        """(t, candidates, route hint) items -> (contains bool mask, rank
        int64) per item, each what ``probe`` gives it alone."""
        return self._answer(items, ranks=True, queries=queries)

    def contains_many(self, items, *, queries=None) -> list[np.ndarray]:
        """(t, sorted ascending candidates, route hint) items -> membership
        mask per item, each what ``contains`` gives it alone."""
        return self._answer(items, ranks=False, queries=queries)

    def probe(
        self, t: int, cands: np.ndarray, *, route: str | None = None, query: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (contains bool mask, rank int64) for every candidate.

        rank(d) = #postings of t strictly below d (searchsorted-left), exact
        whether or not d is present.
        """
        return self.probe_many([(t, cands, route)], queries=None if query is None else [query])[0]

    def contains(
        self, t: int, cands: np.ndarray, *, route: str | None = None, query: int | None = None
    ) -> np.ndarray:
        """Membership mask for *sorted ascending* candidates (the shape the
        verification loop produces).  Fallback terms skip rank computation
        and gallop instead of binary-searching every candidate."""
        return self.contains_many([(t, cands, route)],
                                  queries=None if query is None else [query])[0]

    def rank(self, t: int, cands: np.ndarray) -> np.ndarray:
        """rank(d) = #postings of t strictly below d, for every candidate."""
        return self.probe(t, cands)[1]

    def reset_stats(self) -> None:
        """Zero the accounting window: models and fallback decodes will both
        recharge their bytes on next use (parsed metadata is re-read too, so
        the two paths stay symmetric across a reset).  The arena stays."""
        self.stats = ProbeStats()
        self._fallback_seen.clear()
        self._charged.clear()
        self._models.clear()

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
guided probe touches against what a full decode would have read.  Its
ε-window probes run as one batched ``guided_search`` call per (term,
candidate set) on the prober's ``device``: the CUDA kernel on a card, the
plain PyTorch version on the CPU.  Full decodes of learned-codec terms
(``full_decode``) run on the ``plm_decode`` kernel the same way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.index.compress import CODECS, unpack_bits_at
from repro_torch.index.intersect import gallop_membership
from repro_torch.postings.hybrid import HybridPostings
from repro_torch.postings.plm import parse_segments

_LEARNED_TAGS = frozenset(CODECS.index(c) for c in ("plm", "rmi"))

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
    candidate's window (flat_ranks = r_lo[probe_of] + col).  The single
    source of truth for the kernel bridge, host checks, and tests.
    """
    seg, r_lo, r_hi = rank_windows(tm, cands)
    lens = np.maximum(r_hi - r_lo + 1, 0)
    total = int(lens.sum())
    probe_of = np.repeat(np.arange(len(cands)), lens)
    offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
    col = np.arange(total) - offs[probe_of]
    flat_ranks = r_lo[probe_of] + col
    return seg, r_lo, lens, probe_of, col, flat_ranks


def full_decode(store: HybridPostings, t: int, device: torch.device) -> np.ndarray:
    """All postings of term t: learned-codec streams on the ``plm_decode``
    kernel on ``device`` (its plain version on the CPU), classical codecs by
    the host decoder."""
    n = int(store.lens[t])
    if n and int(store.tags[t]) in _LEARNED_TAGS:
        from repro_torch.kernels.plm_decode.ops import decode_lists

        return decode_lists([store.streams[t][1:]], [n], device=device)[0]  # strip hybrid tag
    return store.postings(t)


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
    wide_probes: int = 0  # guided probes whose window exceeded the main launch's MAX_W
    wide_ranks: int = 0  # ranks those windows decoded (in launches of their own)

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


class GuidedPostings:
    """contains/rank probes over a HybridPostings store, model-guided.

    Learned-codec terms (plm/rmi) answer from stream metadata + ε-window
    decodes on ``device``; classical-codec terms fall back to `fallback(t)`
    (full decode).  The fallback must cache decodes — `stats.fallback_bytes`
    charges each term's stream once, which is only honest if repeat calls
    don't re-decode.  The default wraps store.postings in a per-term cache;
    the serving engine passes its decode-cost-budgeted LRU accessor instead.
    """

    def __init__(
        self,
        store: HybridPostings,
        *,
        fallback: Callable[[int], np.ndarray] | None = None,
        device: torch.device | str = "cuda",
    ):
        self.store = store
        self.device = resolve_device(device)
        if fallback is None:
            cache: dict[int, np.ndarray] = {}

            def fallback(t: int) -> np.ndarray:
                p = cache.get(t)
                if p is None:
                    cache[t] = p = full_decode(store, t, self.device)
                return p

        self.fallback = fallback
        self.stats = ProbeStats()
        self._models: dict[int, TermModel | None] = {}
        self._fallback_seen: set[int] = set()

    # ------------------------------------------------------------- models
    def term_model(self, t: int) -> TermModel | None:
        """TermModel for learned-coded term t, None for classical codecs."""
        tm = self._models.get(t, False)
        if tm is not False:
            return tm
        n = int(self.store.lens[t])
        if n == 0 or int(self.store.tags[t]) not in _LEARNED_TAGS:
            self._models[t] = None
            return None
        tm = load_term_model(self.store.streams[t][1:], n)  # strip hybrid tag
        self._models[t] = tm
        self.stats.metadata_bytes += tm.meta_bytes
        return tm

    def is_guided(self, t: int) -> bool:
        return self.term_model(t) is not None

    # ------------------------------------------------------------- probes
    def _route(
        self, t: int, n_cands: int, hint: str | None = None
    ) -> tuple[str, TermModel | None]:
        """Shared probe preamble: stats + route decision.

        Routes are 'empty' | 'fallback' (classical codec, full decode) |
        'decode' (learned codec sent to full decode by the cost model or a
        planner hint) | 'guided' (ε-window probes).  The TermModel comes
        back for both learned routes so callers can log the ε-window
        feature the router thresholds on.

        ``hint`` is a planner override ('guided' | 'decode'): the sharded
        planner runs the same cost model at plan time with its candidate
        estimate, so the executor honors its decision instead of re-deciding
        per probe.  A hint never forces a guided probe on a classical-codec
        term — absence of a TermModel always falls back.
        """
        self.stats.probes += n_cands
        if int(self.store.lens[t]) == 0:
            return "empty", None
        self.stats.full_equiv_bytes += 4 * int(self.store.streams[t].size)
        tm = self.term_model(t)
        if tm is None:
            self.stats.fallback_terms += 1
            return "fallback", None
        if hint == "decode" or (hint is None and n_cands * tm.avg_window >= tm.n):
            # cost model: the ε-windows of this many probes would decode more
            # correction bytes than the whole list — full decode is cheaper
            self.stats.routed_terms += 1
            return "decode", tm
        self.stats.guided_terms += 1
        return "guided", tm

    def _fallback_list(self, t: int) -> np.ndarray:
        """Fully-decoded postings via the (caching) fallback, bytes charged
        once per term to match the cache's decode-once behaviour."""
        p = self.fallback(t)
        if t not in self._fallback_seen:
            self._fallback_seen.add(t)
            self.stats.fallback_bytes += 4 * int(self.store.streams[t].size)
        return p

    def _probe_guided(self, tm: TermModel, cands: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        from repro_torch.kernels.guided_search.ops import probe_windows

        found, rank, touched, wide = probe_windows(tm, cands, device=self.device)
        self.stats.window_bytes += touched
        self.stats.wide_probes += len(wide)
        self.stats.wide_ranks += int(wide.sum())
        return found, rank

    def probe(
        self, t: int, cands: np.ndarray, *, route: str | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (contains bool mask, rank int64) for every candidate.

        rank(d) = #postings of t strictly below d (searchsorted-left), exact
        whether or not d is present.
        """
        cands = np.asarray(cands)
        route, tm = self._route(t, len(cands), route)
        if route == "empty":
            return np.zeros(len(cands), bool), np.zeros(len(cands), np.int64)
        if route in ("fallback", "decode"):
            p = self._fallback_list(t)
            sel = np.searchsorted(p, cands)
            found = (sel < len(p)) & (p[np.minimum(sel, len(p) - 1)] == cands)
            return found, sel.astype(np.int64)
        return self._probe_guided(tm, cands)

    def contains(
        self, t: int, cands: np.ndarray, *, route: str | None = None
    ) -> np.ndarray:
        """Membership mask for *sorted ascending* candidates (the shape the
        verification loop produces).  Fallback terms skip rank computation
        and gallop instead of binary-searching every candidate."""
        cands = np.asarray(cands)
        route, tm = self._route(t, len(cands), route)
        if route == "empty":
            return np.zeros(len(cands), bool)
        if route in ("fallback", "decode"):
            return gallop_membership(self._fallback_list(t), cands)
        return self._probe_guided(tm, cands)[0]

    def reset_stats(self) -> None:
        """Zero the accounting window: models and fallback decodes will both
        recharge their bytes on next use (parsed metadata is re-read too, so
        the two paths stay symmetric across a reset)."""
        self.stats = ProbeStats()
        self._fallback_seen.clear()
        self._models.clear()

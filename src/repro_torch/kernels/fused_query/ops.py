"""Host bridge: a ranked batch -> MaxScore peel -> fused kernel launches.

``fused_topk_batch`` answers a whole shard batch of ranked queries with one
``fused_topk`` launch per candidate-size bucket.  Per item it first mirrors
``rank.topk.topk_query``'s host phases *exactly* — required-term
conjunctive seeding, the essential-term peel (terms by descending upper
bound, merged while an unseen document could still reach the running
threshold θ), and the exhaustive-cutoff shortcut — because those phases are
sequential by nature (θ tightens after every decode).  What remains per
item is the probe tail: surviving candidates × non-essential terms, which
becomes lanes of one (query, term, candidate, window) tile per bucket; the
kernel returns each query's final top-k.

Exactness: candidates are dropped only when
``partial + Σ_tail seg_ub < max(floor + 1, θ)`` — θ is the kth largest
partial, so at least k candidates finish >= θ and nothing below the bound can
enter the top-k; ties at the bound are kept.  Survivors get *complete*
scores in the kernel (every tail term probed), so the final selection is the
oracle's — bit-identical to the multi-phase path.

Tail lanes come in two flavours:
  * learned-codec terms with a narrow rank bracket -> real ε-window lanes
    (the kernel re-runs guided search + the word-pair unpack);
  * classical-codec terms, learned terms whose correction width is outside
    1..31, and brackets wider than W_CAP -> resolved on the host (binary
    search / window decode) into a 1-lane window whose segment line
    reproduces the known doc id, with the payload words still unpacked in
    the kernel at the found rank.  ``RankedStats.fused_wide_lanes`` counts
    the lanes of learned-codec terms resolved this way.

The candidate axis is padded to 128·2^j buckets and rows are grouped by
bucket, one launch per populated bucket, so a query with few candidates
never pays the widest query's candidate axis.  The window axis is padded to
a power of two from 1 (most windows resolve to a single lane).

When the shard carries a ``DeviceArena`` (kernels.arena), items without
required terms and with k <= DENSE_MAX_K skip the host peel entirely: the
whole scoring loop — gather, sum, top-k — runs as one ``dense_topk`` launch
on the resident impact table (kernels.fused_query.dense).  Dense groups are issued
first and their outputs copied back only at merge time, so the card works on
them while the host peels and packs the other items.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.fused_query import dense
from repro_torch.kernels.fused_query.kernel import fused_topk
from repro_torch.kernels.fused_query.ref import NEVER
from repro_torch.obs import trace
from repro_torch.postings.search import _touched_words, decode_window, rank_windows
from repro_torch.rank.score import TopKResult, select_topk
from repro_torch.rank.topk import (
    _EMPTY, RankedStats, _exhaustive, _kth_partial, _merge_add, _peel_terms,
)

_CANDQ = 128  # candidate-axis bucket quantum
_ROWQ = 4  # query-row bucket quantum (the reference's kernel block)
W_CAP = 32  # widest ε-window shipped to the kernel; wider lanes resolve on host


def _bucket(n: int, quantum: int) -> int:
    """Round n up to quantum * 2^k."""
    b = quantum
    while b < n:
        b *= 2
    return b


@dataclass
class _Pending:
    """One item's kernel-bound remainder after the host peel."""

    cands: np.ndarray  # (C,) int64 surviving candidates, ascending
    partial: np.ndarray  # (C,) int64 partial scores from essential terms
    tail: list  # non-essential term ids, descending upper bound
    k: int
    floor: int


def _tail_reads_list(tm) -> bool:
    """Whether ``_term_lanes`` resolves a tail term against its full list:
    a classical codec (no TermModel), or a learned correction width outside
    1..31."""
    return tm is None or not 0 < tm.width < 32


def _peel(src, terms, k, required, floor, cutoff, stats):
    """topk_query's host phases, stopping where the probe tail begins.

    Returns a finished TopKResult when the item never reaches the tail
    (trivial/exhaustive/fully-peeled), else a _Pending for the kernel.
    """
    if k <= 0:
        return _EMPTY
    stats.queries += 1
    order = _peel_terms(src, terms, required, cutoff)
    if order is None:
        return _EMPTY
    terms, req, optional, exhaustive = order
    stats.exhaustive_postings += sum(src.n(t) for t in terms)

    if exhaustive:
        stats.exhaustive_queries += 1
        return _exhaustive(src, terms, k, floor, stats)

    if req:
        cands, partial = src.full(req[0])
        partial = partial.astype(np.int64)
        stats.scored_postings += len(cands)
        for t in req[1:]:
            if len(cands) == 0:
                return _EMPTY
            found, q = src.probe(t, cands)
            stats.probed_postings += len(cands)
            cands, partial = cands[found], partial[found] + q[found]
        if len(cands) == 0:
            return _EMPTY
        accepting_new = False
    else:
        cands = np.zeros(0, np.int32)
        partial = np.zeros(0, np.int64)
        accepting_new = True

    ubs = np.array([src.ub(t) for t in optional], np.int64)
    suffix = np.concatenate([np.cumsum(ubs[::-1])[::-1], [0]])
    theta = _kth_partial(partial, k)
    j = 0
    while j < len(optional):
        if not (accepting_new and suffix[j] >= max(floor + 1, theta)):
            break
        ids, q = src.full(optional[j])
        stats.scored_postings += len(ids)
        cands, partial = _merge_add(cands, partial, ids, q)
        theta = max(theta, _kth_partial(partial, k))
        j += 1
    tail = optional[j:]
    if not tail or len(cands) == 0:
        return select_topk(cands, partial, k, floor)

    # joint candidate prune at segment granularity: everything below cannot
    # reach the threshold even if every tail term pays its block max
    alive_min = max(floor + 1, theta)
    bound = partial.copy()
    for t in tail:
        bound += src.seg_ub(t, np.asarray(cands, np.int64)).astype(np.int64)
    keep = bound >= alive_min
    cands, partial = cands[keep], partial[keep]
    if len(cands) == 0:
        return select_topk(cands, partial, k, floor)
    stats.probed_postings += len(cands) * len(tail)
    return _Pending(np.asarray(cands, np.int64), partial, tail, k, floor)


def _peel_decodes(src, items, cutoff) -> list[int]:
    """Terms ``_peel`` decodes in full for these items, as far as the lists'
    lengths and bounds tell before any is decoded (``_peel_terms`` gives
    both the same order): every term of an exhaustive item, the required
    seed or the first essential term, and every optpfd term (the peel and
    the probe tail decode such a term in full whenever they touch it)."""
    out: list[int] = []
    for terms, k, required, floor in items:
        order = _peel_terms(src, terms, required, cutoff) if k > 0 else None
        if order is None:
            continue
        live, req, optional, exhaustive = order
        if exhaustive:
            out += live
            continue
        out += [t for t in live if src.decode_kernel(t) == "pfor"]
        if req:
            out.append(req[0])
        elif sum(src.ub(t) for t in optional) >= floor + 1:  # θ is 0 before any scoring
            out.append(optional[0])
    return out


def _tail_decodes(src, pend) -> list[int]:
    """Tail terms ``_term_lanes`` resolves against a full decode
    (``_tail_reads_list``)."""
    return [t for _, p in pend for t in p.tail if _tail_reads_list(src.term_model(t))]


def _window_ranks(rlo, wlen):
    """Flatten per-candidate [rlo, rlo+wlen) brackets into one rank vector."""
    lens = np.asarray(wlen, np.int64)
    if lens.max(initial=0) <= 1:  # the common case: every window resolved
        return np.asarray(rlo, np.int64)
    first = np.repeat(np.cumsum(lens) - lens, lens)
    return np.repeat(rlo, lens) + np.arange(len(first), dtype=np.int64) - first


def _gather_words(stream, word_idx, use):
    """Lo/hi packed-word pairs at word_idx where use, 0 elsewhere/out-of-range
    — the host half of the kernel's word-pair unpack."""
    s = np.asarray(stream, np.uint32)
    lo = np.zeros(word_idx.shape, np.uint32)
    hi = np.zeros(word_idx.shape, np.uint32)
    n = len(s)
    if n and use.any():
        wi = np.clip(word_idx, 0, n - 1)
        lo[use] = s[wi[use]]
        nxt = use & (word_idx + 1 < n)
        hi[nxt] = s[(wi + 1)[nxt]]
    return lo, hi


def _term_lanes(src, t, cands, pbits):
    """One (item, tail-term) slot -> per-candidate window lanes + streams.

    Returns (rlo, wlen, start, base, slope, width, cmin, corr_words,
    use_corr, stream_bytes, wide_lanes); resolved lanes carry use_corr=False
    and a segment line that reproduces the known doc id exactly.
    """
    C = len(cands)
    rlo = np.zeros(C, np.int64)
    wlen = np.zeros(C, np.int64)
    start = np.zeros(C, np.int64)
    base = np.zeros(C, np.int64)
    slope = np.zeros(C, np.float32)
    use_corr = np.zeros(C, bool)
    tm = src.term_model(t)
    stream_bytes = wide_lanes = 0

    if not _tail_reads_list(tm):
        width, cmin, corr_words = int(tm.width), int(tm.corr_min), tm.corr_words
        seg, r_lo, r_hi = rank_windows(tm, cands)
        lens = np.maximum(r_hi - r_lo + 1, 0)
        wide = lens > W_CAP
        narrow = ~wide & (lens > 0)
        rlo[narrow] = r_lo[narrow]
        wlen[narrow] = lens[narrow]
        start[narrow] = tm.starts[seg[narrow]]
        base[narrow] = tm.bases[seg[narrow]]
        slope[narrow] = tm.slopes[seg[narrow]]
        use_corr[narrow] = True
        if narrow.any():
            stream_bytes += 4 * _touched_words(
                _window_ranks(rlo[narrow], wlen[narrow]), width
            )
        if wide.any():  # outlier brackets: host-decode, don't widen the batch
            widx = np.nonzero(wide)[0]
            wide_lanes = len(widx)
            lens_w = lens[widx].astype(np.int64)
            probe_of = np.repeat(widx, lens_w)
            loc = np.repeat(np.arange(len(widx)), lens_w)
            first = np.repeat(np.cumsum(lens_w) - lens_w, lens_w)
            fl_ranks = r_lo[probe_of] + (np.arange(len(probe_of)) - first)
            ids_dec = decode_window(tm, seg[probe_of], fl_ranks)
            dw = cands[probe_of]
            eqc = np.bincount(loc, weights=(ids_dec == dw), minlength=len(widx))
            ltc = np.bincount(loc, weights=(ids_dec < dw), minlength=len(widx))
            stream_bytes += 4 * _touched_words(fl_ranks, width)
            hit = eqc > 0
            h = widx[hit]
            rlo[h] = (r_lo[widx] + ltc.astype(np.int64))[hit]
            wlen[h] = 1
            base[h] = cands[h] - cmin  # line reproduces the id; corr zeroed
    else:
        # classical codec (or a learned width outside 1..31): rank by binary
        # search in the cached decode; a found candidate becomes a 1-lane
        # resolved window
        if tm is not None:
            wide_lanes = C
        width, cmin, corr_words = 0, 0, np.zeros(0, np.uint32)
        p = src.postings(t)
        rank = np.searchsorted(p, cands).astype(np.int64)
        found = (rank < len(p)) & (p[np.minimum(rank, max(len(p) - 1, 0))] == cands)
        rlo[found] = rank[found]
        wlen[found] = 1
        base[found] = cands[found]

    valid = wlen > 0
    if valid.any():
        stream_bytes += 4 * _touched_words(_window_ranks(rlo[valid], wlen[valid]), pbits)
    return (rlo, wlen, start, base, slope, width, cmin, corr_words, use_corr,
            stream_bytes, wide_lanes)


def fused_topk_batch(src, items, *, exhaustive_cutoff: int = 2048, stats=None):
    """Answer [(terms, k, required, floor), ...] with fused launches.

    ``src`` is a shard _RankedSource (the RankedSource protocol plus
    device/arena/term_model/postings/payload_words/payload_bits).  Returns
    one TopKResult per item, in *local* doc ids, bit-identical to looping
    topk_query.
    """
    stats = stats if stats is not None else RankedStats()
    t_all0 = time.perf_counter_ns()
    kernel_ns0 = stats.fused_kernel_ns
    results: list = [None] * len(items)

    # split: items a resident arena can answer in one dense pass (no
    # required terms, peelable k) never touch the host peel at all
    arena = src.arena
    dense_items: list[tuple[int, list[int], int, int]] = []
    legacy: list[int] = []
    for i, (terms, k, required, floor) in enumerate(items):
        if arena is None or len(required) or not (0 < k <= dense.DENSE_MAX_K):
            legacy.append(i)
            continue
        stats.queries += 1
        tt = sorted({int(t) for t in terms if src.n(int(t)) > 0})
        if not tt:
            results[i] = _EMPTY
            continue
        n_sum = sum(src.n(t) for t in tt)
        stats.exhaustive_postings += n_sum
        stats.scored_postings += n_sum
        stats.exhaustive_queries += 1
        dense_items.append((i, tt, int(k), int(floor)))

    # dense groups are issued first; the card runs them while the host peels
    # and packs the other items below
    inflight = _dispatch_dense(arena, dense_items, stats) if dense_items else []

    pend: list[tuple[int, _Pending]] = []
    # the lists the peel decodes in full are fetched together up front, and
    # those the probe tail decodes before its tiles are built
    with src.prefetch(_peel_decodes(src, [items[i] for i in legacy], exhaustive_cutoff)):
        for i in legacy:
            terms, k, required, floor = items[i]
            r = _peel(src, terms, k, required, floor, exhaustive_cutoff, stats)
            if isinstance(r, _Pending):
                pend.append((i, r))
            else:
                results[i] = r

        # candidate counts are heavy-tailed: group rows by power-of-two
        # candidate bucket, one launch per populated bucket, each with a
        # tight (T, C, W) tile for its rows
        groups: dict[int, list[tuple[int, _Pending]]] = {}
        for i, p in pend:
            groups.setdefault(_bucket(len(p.cands), _CANDQ), []).append((i, p))
        with src.prefetch(_tail_decodes(src, pend)):
            for C, grp in sorted(groups.items()):
                _dispatch_group(src, grp, C, int(src.payload_bits), stats, results)

    for fut in inflight:  # only now wait for the dense outputs
        _extract_dense(fut, stats, results)
    stats.fused_bridge_ns += max(
        0, (time.perf_counter_ns() - t_all0) - (stats.fused_kernel_ns - kernel_ns0)
    )
    return results


def _dispatch_dense(arena, dense_items, stats):
    """Dense-eligible items -> one dense pass per k bucket over the arena.

    Returns in-flight handles (device tensors still being computed); the
    caller copies them back at merge time.
    """
    tp = dense.tile_params()
    groups: dict[int, list] = {}
    for it in dense_items:
        groups.setdefault(_bucket(it[2], 1), []).append(it)
    inflight = []
    for kb, grp in sorted(groups.items()):
        Qb = _bucket(len(grp), tp["row_quantum"])
        T = _bucket(max(len(tt) for _, tt, _, _ in grp), tp["term_quantum"])
        qt = np.full((Qb, T), -1, np.int32)
        floors = np.zeros(Qb, np.int32)
        for row, (_, tt, _, fl) in enumerate(grp):
            qt[row, : len(tt)] = tt
            floors[row] = fl
        stats.fused_queries += len(grp)
        stats.fused_lanes += sum(arena.lanes(tt) for _, tt, _, _ in grp)
        # stream traffic: the table rows each live term slot gathers
        stats.fused_stream_bytes += (
            sum(len(tt) for _, tt, _, _ in grp) * arena.n_docs * arena.itemsize
        )
        out = dense.dense_topk(arena, qt, floors, k=kb)
        inflight.append((arena, grp, kb, Qb, T, out))
    return inflight


def _extract_dense(fut, stats, results):
    """Copy one dense pass's outputs back and merge its rows."""
    arena, grp, kb, Qb, T, out = fut
    n_docs, isz = arena.n_docs, arena.itemsize
    with trace.span("kernel.fused_query", queries=int(Qb), terms=int(T), k=int(kb), dense=1,
                    candidates=int(n_docs)):
        t0 = time.perf_counter_ns()
        ids_d, sc_d, rounds = out
        ids_o, sc_o, rounds = ids_d.cpu().numpy(), sc_d.cpu().numpy(), int(rounds)
        stats.fused_kernel_ns += time.perf_counter_ns() - t0
    # device traffic actually performed: table-row gather, accumulator,
    # one accumulator scan per peel round performed, in/out tiles
    stats.fused_device_bytes += (
        Qb * T * n_docs * isz
        + Qb * n_docs * 4
        + rounds * Qb * n_docs * 4
        + Qb * T * 4 + Qb * 4
        + 2 * Qb * kb * 4
    )
    for row, (i, _tt, k, _fl) in enumerate(grp):
        hit = sc_o[row] > 0  # non-empty heap slots form a prefix
        results[i] = TopKResult(
            ids=ids_o[row][hit][:k].astype(np.int32),
            scores=sc_o[row][hit][:k].astype(np.int64),
        )


def build_tiles(src, pend, C, pbits, stats):
    """One candidate-bucket group -> the kernel's 14 numpy tiles and K.

    The tiles hold the words as uint32; ``_dispatch_group`` hands them to
    the kernel as int32 bit patterns."""
    T = max(len(p.tail) for _, p in pend)
    K = min(max(p.k for _, p in pend), C)
    Qb = _bucket(len(pend), _ROWQ)

    lanes = []  # (row, slot, C_i, lane data) from the host window builder
    Wmax, stream_bytes = 1, 0
    for row, (_, p) in enumerate(pend):
        for slot, t in enumerate(p.tail):
            ln = _term_lanes(src, t, p.cands, pbits)
            Wmax = max(Wmax, int(ln[1].max()) if len(ln[1]) else 1)
            stream_bytes += ln[9]
            stats.fused_wide_lanes += ln[10]
            lanes.append((row, slot, t, len(p.cands), ln))
    W = _bucket(Wmax, 1)

    width_a = np.zeros((Qb, T), np.uint32)
    cmin_a = np.zeros((Qb, T), np.int32)
    rlo_a = np.zeros((Qb, T, C), np.int32)
    wlen_a = np.zeros((Qb, T, C), np.int32)
    start_a = np.zeros((Qb, T, C), np.int32)
    base_a = np.zeros((Qb, T, C), np.int32)
    slope_a = np.zeros((Qb, T, C), np.float32)
    clo_a = np.zeros((Qb, T, C, W), np.uint32)
    chi_a = np.zeros((Qb, T, C, W), np.uint32)
    plo_a = np.zeros((Qb, T, C, W), np.uint32)
    phi_a = np.zeros((Qb, T, C, W), np.uint32)
    cand_a = np.full((Qb, C), NEVER, np.int32)
    part_a = np.zeros((Qb, C), np.int32)
    floor_a = np.zeros((Qb, 1), np.int32)

    for row, (_, p) in enumerate(pend):
        n = len(p.cands)
        cand_a[row, :n] = p.cands
        part_a[row, :n] = p.partial
        floor_a[row, 0] = p.floor
    jw = np.arange(W, dtype=np.int64)
    for row, slot, t, n, ln in lanes:
        rlo, wlen, start, base, slope, width, cmin, corr_words, use_corr = ln[:9]
        width_a[row, slot] = width
        cmin_a[row, slot] = cmin
        rlo_a[row, slot, :n] = rlo
        wlen_a[row, slot, :n] = wlen
        start_a[row, slot, :n] = start
        base_a[row, slot, :n] = base
        slope_a[row, slot, :n] = slope
        ranks = rlo[:, None] + jw[None, :]
        use = jw[None, :] < wlen[:, None]
        if width:
            clo, chi = _gather_words(
                corr_words, (ranks * width) >> 5, use & use_corr[:, None]
            )
            clo_a[row, slot, :n], chi_a[row, slot, :n] = clo, chi
        plo, phi = _gather_words(src.payload_words(t), (ranks * pbits) >> 5, use)
        plo_a[row, slot, :n], phi_a[row, slot, :n] = plo, phi
    stats.fused_stream_bytes += stream_bytes
    return (width_a, cmin_a, rlo_a, wlen_a, start_a, base_a, slope_a,
            clo_a, chi_a, plo_a, phi_a, cand_a, part_a, floor_a), K


def _dispatch_group(src, pend, C, pbits, stats, results):
    """One candidate-bucket group -> one fused_topk launch on src.device."""
    arrays, K = build_tiles(src, pend, C, pbits, stats)
    Qb = arrays[0].shape[0]
    n_lanes = int(arrays[3].sum())
    device_bytes = sum(a.nbytes for a in arrays) + 2 * Qb * K * 4
    stats.fused_queries += len(pend)
    stats.fused_lanes += n_lanes
    stats.fused_device_bytes += device_bytes
    dev = src.device
    _, T, C, W = arrays[7].shape
    with trace.span("kernel.fused_query", queries=int(Qb), terms=int(T), candidates=int(C),
                    window=int(W), k=int(K), lanes=n_lanes, bytes=int(device_bytes)):
        tiles = [
            torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
            for a in arrays
        ]
        ids_d, sc_d = fused_topk(*tiles, k=K, pbits=pbits)
        t0 = time.perf_counter_ns()
        ids_o, sc_o = ids_d.cpu().numpy(), sc_d.cpu().numpy()
        stats.fused_kernel_ns += time.perf_counter_ns() - t0

    for row, (i, p) in enumerate(pend):
        hit = sc_o[row] > 0  # non-empty heap slots form a prefix
        results[i] = TopKResult(
            ids=ids_o[row][hit][: p.k].astype(np.int32),
            scores=sc_o[row][hit][: p.k].astype(np.int64),
        )

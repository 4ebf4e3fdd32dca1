"""The port's index codecs and learned postings against the reference.

Every codec's stream must be byte-identical to the reference's for the same
ids (the port's RMI fit sums in float32 with torch where the reference uses
jax segment sums), the hybrid store must pick the same codec per term, and
guided ε-window probes must return the reference's verdicts and ranks.
Smooth lists are included so the learned codecs (plm, rmi) win.
"""
import numpy as np
import pytest

from repro.index import compress as ref_compress
from repro.postings import hybrid as ref_hybrid
from repro.postings.search import GuidedPostings as RefGuided, load_term_model as ref_load_model
from repro_torch.index import compress
from repro_torch.postings import hybrid, search
from repro_torch.postings.search import (
    GuidedPostings, decode_terms, decode_window, flatten_windows, full_decode, load_term_model,
)

UNIVERSE = 1 << 20


def _smooth(rng, n, universe=UNIVERSE):
    """Near-linear ids with bounded jitter: the regime where rank models win."""
    slope = int(rng.integers(16, max(17, min(256, universe // (n + 1) - 1))))
    start = int(rng.integers(0, universe - n * slope - slope))
    ids = start + np.arange(n, dtype=np.int64) * slope + rng.integers(0, max(1, slope // 4), n)
    return ids.astype(np.int32)


def _lists(kind: str) -> list[np.ndarray]:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "random":
        return [np.sort(rng.choice(UNIVERSE, n, replace=False)).astype(np.int32)
                for n in (0, 1, 2, 127, 128, 129, 300)]
    if kind == "smooth":
        return [_smooth(rng, n) for n in (200, 2000)]
    if kind == "runs":
        return [np.arange(5000, 5000 + 3 * n, 3, dtype=np.int32) for n in (130, 900)]
    return [np.sort(rng.choice(4096, 3000, replace=False)).astype(np.int32)]  # dense


@pytest.mark.parametrize("kind", ["random", "smooth", "runs", "dense"])
@pytest.mark.parametrize("codec", list(compress.CODECS) + ["hybrid"])
def test_codec_streams_byte_identical(codec, kind):
    for ids in _lists(kind):
        if codec == "rmi" and len(ids) == 0:
            continue
        got = compress.encode_postings(ids, codec, universe=UNIVERSE)
        want = ref_compress.encode_postings(ids, codec, universe=UNIVERSE)
        assert got.dtype == want.dtype and np.array_equal(got, want), (codec, len(ids))
        assert np.array_equal(compress.decode_postings(got, len(ids), codec), ids)
        if codec != "hybrid":
            assert (compress.compressed_size_bits(ids, UNIVERSE, codec)
                    == ref_compress.compressed_size_bits(ids, UNIVERSE, codec))


def test_learned_codecs_win_on_smooth_lists():
    rng = np.random.default_rng(11)
    winners = set()
    for n in (300, 1500, 6000):
        ids = _smooth(rng, n)
        got = hybrid.choose_codec(ids, UNIVERSE)
        assert got == ref_hybrid.choose_codec(ids, UNIVERSE)
        winners.add(got[0])
    assert winners & {"plm", "rmi"}


# ------------------------------------------------------------ the store
def _collection(seed=23, n_terms=40):
    """Zipf-df lists in three regimes (smooth, runs, rough), as the
    reference's guided-intersection benchmark builds them, at a small size."""
    rng = np.random.default_rng(seed)
    lists = []
    for r in range(n_terms):
        df = max(20, int(3000 * (r + 1) ** -0.9))
        u = rng.random()
        if u < 0.7:
            ids = _smooth(rng, df)
        elif u < 0.85:
            ids = np.arange(1000, 1000 + 2 * df, 2, dtype=np.int32)
        else:
            ids = np.sort(rng.choice(UNIVERSE, min(df, 800), replace=False)).astype(np.int32)
        lists.append(np.unique(ids))
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    return offsets, np.concatenate(lists).astype(np.int32)


@pytest.fixture(scope="module")
def stores():
    offsets, doc_ids = _collection()
    return (hybrid.HybridPostings.build(offsets, doc_ids, UNIVERSE),
            ref_hybrid.HybridPostings.build(offsets, doc_ids, UNIVERSE))


def test_hybrid_store_identical(stores):
    port, ref = stores
    assert np.array_equal(port.lens, ref.lens)
    assert np.array_equal(port.tags, ref.tags)
    assert np.array_equal(port.bits, ref.bits)
    assert all(np.array_equal(a, b) for a, b in zip(port.streams, ref.streams))
    hist = port.codec_histogram()
    assert hist == ref.codec_histogram() and {"plm", "rmi"} & set(hist)


def test_full_decode_matches_reference(stores):
    port, ref = stores
    for t in range(port.n_terms):
        assert np.array_equal(full_decode(port, t, "cpu"), ref.postings(t))


def test_full_decode_routes_optpfd_through_pfor(stores, monkeypatch):
    from repro_torch.kernels.pfor import ops as pfor_ops

    port, ref = stores
    calls = []
    decode = pfor_ops.pfor_decode
    monkeypatch.setattr(pfor_ops, "pfor_decode", lambda *a: calls.append(a[2]) or decode(*a))
    optpfd = [t for t in range(port.n_terms) if hybrid.CANDIDATES[port.tags[t]] == "optpfd"]
    assert optpfd
    for t in optpfd:
        assert np.array_equal(full_decode(port, t, "cpu"), ref.postings(t))
    assert calls == [int(port.lens[t]) for t in optpfd]  # one launch per decoded list


def _count_launches(monkeypatch):
    from repro_torch.kernels.pfor import ops as pfor_ops
    from repro_torch.kernels.plm_decode import ops as plm_ops

    calls = {"pfor": 0, "plm": 0}
    for mod, attr, name in ((pfor_ops, "pfor_decode", "pfor"), (plm_ops, "decode_batch", "plm")):
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(mod, attr, counted)
    return calls


def test_decode_terms_matches_full_decode_over_mixed_codecs(stores, monkeypatch):
    """Every term of the store at once (optpfd, plm, rmi and host codecs,
    an empty list, repeats): the lists of full_decode term by term and of the
    reference, in one launch per decode kernel."""
    port, ref = stores
    terms = list(range(port.n_terms))[::-1] + [3, 0]
    codecs = {hybrid.CANDIDATES[port.tags[t]] for t in terms}
    assert {"optpfd", "plm", "rmi"} <= codecs and len(codecs) > 3
    one = [full_decode(port, t, "cpu") for t in terms]
    calls = _count_launches(monkeypatch)
    got = decode_terms(port, terms, "cpu")
    assert calls == {"pfor": 1, "plm": 1}
    for t, g, o in zip(terms, got, one):
        assert g.dtype == np.int32 and np.array_equal(g, o) and np.array_equal(g, ref.postings(t))
    # a byte budget under every list: one launch per list, the same lists
    monkeypatch.setattr(search, "DECODE_CHUNK_BYTES", 1)
    for t, g in zip(terms, decode_terms(port, terms, "cpu")):
        assert np.array_equal(g, ref.postings(t))
    kinds = [search.decode_kernel(port, t) for t in terms]
    assert calls == {"pfor": 1 + kinds.count("pfor"), "plm": 1 + kinds.count("plm")}
    assert decode_terms(port, [], "cpu") == []


def test_optpfd_block_headers_walked_once_per_term(monkeypatch):
    from repro_torch.kernels.pfor import ops as pfor_ops

    offsets, doc_ids = _collection()
    port = hybrid.HybridPostings.build(offsets, doc_ids, UNIVERSE)
    walked = []
    parse = pfor_ops.parse_stream
    monkeypatch.setattr(pfor_ops, "parse_stream", lambda w, n: walked.append(n) or parse(w, n))
    optpfd = [t for t in range(port.n_terms) if hybrid.CANDIDATES[port.tags[t]] == "optpfd"]
    assert optpfd
    for _ in range(3):
        for t, g in zip(optpfd, decode_terms(port, optpfd, "cpu")):
            assert np.array_equal(g, doc_ids[offsets[t] : offsets[t + 1]])
    assert sorted(walked) == sorted(int(port.lens[t]) for t in optpfd)
    assert set(port.block_tables) == set(optpfd)


def test_payload_half_matches_reference_on_learned_and_classical_terms(stores):
    """Segment-granular bounds come from the learned codecs' own segment
    tables; both stores must pack and bound the same impacts identically."""
    port, ref = stores
    quants = np.random.default_rng(4).integers(1, 256, int(port.lens.sum())).astype(np.uint32)
    port.attach_payloads(quants, bits=8, scale=3.25)
    ref.attach_payloads(quants, bits=8, scale=3.25)
    assert all(np.array_equal(a, b) for a, b in zip(port.payload_streams, ref.payload_streams))
    assert np.array_equal(port.ub_offsets, ref.ub_offsets)
    assert np.array_equal(port.seg_ubs, ref.seg_ubs)
    assert len(port.seg_ubs) > port.n_terms  # learned terms carry several segments
    for t in range(port.n_terms):
        assert port.term_ub(t) == ref.term_ub(t)
        assert np.array_equal(port.term_seg_ubs(t), ref.term_seg_ubs(t))
        assert np.array_equal(port.payloads(t), ref.payloads(t))
    assert port.payload_size_bits() == ref.payload_size_bits()
    with pytest.raises(ValueError):
        port.attach_payloads(quants[:-1], bits=8, scale=1.0)
    with pytest.raises(ValueError):
        port.attach_payloads(quants, bits=4, scale=1.0)


def _cands(rng, ids):
    """Sorted candidates: members, near misses, and ids outside the list."""
    members = rng.choice(ids, min(len(ids), 50), replace=False)
    others = rng.integers(0, UNIVERSE, 80)
    edges = [0, int(ids[0]) - 1, int(ids[0]), int(ids[-1]), int(ids[-1]) + 1, UNIVERSE - 1]
    return np.unique(np.concatenate([members, members + 1, others, edges]).clip(0, UNIVERSE - 1))


def test_term_models_match_reference(stores):
    port, ref = stores
    learned = [t for t in range(port.n_terms) if hybrid.CANDIDATES[port.tags[t]] in ("plm", "rmi")]
    assert learned
    for t in learned:
        a = load_term_model(port.streams[t][1:], int(port.lens[t]))
        b = ref_load_model(ref.streams[t][1:], int(ref.lens[t]))
        for f in ("starts", "ends", "bases", "slopes", "seg_first"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.width, a.corr_min, a.corr_max, a.meta_bytes, a.avg_window) == (
            b.width, b.corr_min, b.corr_max, b.meta_bytes, b.avg_window)


def _host_probe(tm, cands):
    """The epsilon-window probe in host numpy: decode each window, compare."""
    d = np.asarray(cands, np.int64)
    seg, r_lo, _, probe_of, _, ranks = flatten_windows(tm, d)
    if len(ranks) == 0:
        return np.zeros(len(d), bool), r_lo
    ids = decode_window(tm, seg[probe_of], ranks)
    found = np.zeros(len(d), bool)
    np.logical_or.at(found, probe_of, ids == d[probe_of])
    lt = ids < d[probe_of]
    return found, r_lo + np.bincount(probe_of, weights=lt, minlength=len(d)).astype(np.int64)


@pytest.mark.parametrize("route", [None, "guided", "decode"])
def test_guided_probes_match_reference(stores, route):
    port, ref = stores
    rng = np.random.default_rng(5)
    gp, gr = GuidedPostings(port, device="cpu"), RefGuided(ref)
    for t in range(port.n_terms):
        cands = _cands(rng, ref.postings(t))
        found, rank = gp.probe(t, cands, route=route)
        want_found, want_rank = gr.probe(t, cands, route=route)
        assert np.array_equal(found, want_found) and np.array_equal(rank, want_rank), t
        assert np.array_equal(gp.contains(t, cands, route=route),
                              gr.contains(t, cands, route=route))
        if gp.is_guided(t):
            hf, hr = _host_probe(gp.term_model(t), cands)
            assert np.array_equal(hf, found) and np.array_equal(hr, rank)
    got, want = gp.stats.as_dict(), gr.stats.as_dict()
    assert {k: got[k] for k in want} == want
    assert gp.stats.guided_terms > 0 or route == "decode"


def _flat_list(rng):
    """A 1,500-id list stored as one plm segment of slope 0: every bracket
    is the whole list, wider than CHUNK_RANKS."""
    from repro_torch.postings.plm import emit_stream

    ids = np.sort(rng.choice(UNIVERSE, 1500, replace=False)).astype(np.int32)
    words = emit_stream(ids, np.array([0], np.int64), np.array([int(ids[0])], np.int64),
                        np.array([0.0], np.float32), eps=0)
    return ids, words


def _with_terms(store, extra):
    """``store`` with terms appended: (ids, plm stream words or None)."""
    from dataclasses import replace

    lens = [len(ids) for ids, _ in extra]
    tags = [hybrid.CANDIDATES.index("plm") if len(ids) else 0 for ids, _ in extra]
    streams = [np.concatenate([np.array([tag], np.uint32), words]) if words is not None
               else np.zeros(0, np.uint32) for tag, (_, words) in zip(tags, extra)]
    return replace(store, lens=np.concatenate([store.lens, lens]).astype(np.int64),
                   tags=np.concatenate([store.tags, tags]).astype(np.uint8),
                   bits=np.concatenate([store.bits, [32 * len(x) for x in streams]]),
                   streams=[*store.streams, *streams])


def test_wide_windows_run_on_the_kernel_path(monkeypatch):
    """Brackets wider than CHUNK_RANKS (slope 0: every bracket is the whole
    list) are cut into rows of CHUNK_RANKS and answered in the same, single
    launch as the rest, with the reference's verdicts; the prober counts
    them."""
    from repro.postings.search import ProbeStats as RefStats
    from repro_torch.kernels.guided_search import ops

    rng = np.random.default_rng(19)
    ids, words = _flat_list(rng)
    store = _with_terms(hybrid.HybridPostings.build(np.zeros(1, np.int64),
                                                    np.zeros(0, np.int32), UNIVERSE),
                        [(ids, words)])
    cands = _cands(rng, ids)
    ref_gp = RefGuided.__new__(RefGuided)
    ref_gp.stats = RefStats()
    want_found, want_rank = ref_gp._probe_host(ref_load_model(words, len(ids)), cands)

    launches = []
    launch = ops.probe_batch

    def counted(rows, *rest):
        launches.append(rows.shape[0])
        return launch(rows, *rest)

    monkeypatch.setattr(ops, "probe_batch", counted)
    gp = GuidedPostings(store, device="cpu")
    found, rank = gp.probe(0, cands, route="guided")
    assert np.array_equal(found, want_found) and np.array_equal(rank, want_rank)
    lens = flatten_windows(gp.term_model(0), cands)[2]
    wide = lens[lens > ops.CHUNK_RANKS]
    assert len(wide) > 20 and gp.stats.window_bytes == ref_gp.stats.window_bytes > 0
    assert (gp.stats.wide_probes, gp.stats.wide_ranks) == (len(wide), int(wide.sum()))
    assert launches == [int((-(-lens // ops.CHUNK_RANKS)).sum())]


def test_probe_table_cut_at_probe_boundaries(stores, monkeypatch):
    """A probe table larger than TABLE_CHUNK_BYTES goes out in several
    launches, each holding whole probes (a probe with more rows than a
    launch takes gets a launch of its own), with the answers of one launch."""
    from repro_torch.kernels.guided_search import ops

    port, _ = stores
    rng = np.random.default_rng(37)
    flat, words = _flat_list(rng)
    port = _with_terms(port, [(flat, words)])
    items = [(t, _cands(rng, port.postings(t)), "guided") for t in (0, 7, port.n_terms - 1)]
    want = GuidedPostings(port, device="cpu").probe_many(items)
    tables = []
    launch = ops.probe_batch

    def counted(rows, *rest):
        tables.append(rows.numpy().copy())
        return launch(rows, *rest)

    monkeypatch.setattr(ops, "probe_batch", counted)
    monkeypatch.setattr(ops, "TABLE_CHUNK_BYTES", 4 * ops.ROW_COLS * 3)  # 3 rows a launch
    got = GuidedPostings(port, device="cpu").probe_many(items)
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    rows = np.concatenate(tables)
    assert len(tables) > 2 and (rows[:, 3] > 0).all()
    for t in tables:  # slots rebased to each launch (a split probe would lose a chunk's lt)
        assert t[0, 5] == 0 and len(t) <= 3
    split = [len(t) for t in tables if len(np.unique(t[:, 5])) < len(t)]
    assert split  # the slope-0 list's windows: 2 rows of one probe in one launch


@pytest.mark.parametrize("ranks", [True, False], ids=["probe_many", "contains_many"])
def test_probe_many_matches_reference(stores, monkeypatch, ranks):
    """One batch of mixed items (guided, planner hints 'guided' and
    'decode', classical fallbacks, an empty list, empty windows, candidates
    below the first id, the slope-0 list's wide windows, a term twice)
    gives every item the reference's answer, from the host probe and from
    the Pallas kernel in interpret mode, and the accounting of answering
    the items one by one, with one guided_search launch and one decode call."""
    from repro.kernels.guided_search.ops import probe_windows as pallas_windows
    from repro_torch.kernels.guided_search import ops

    port, ref = stores
    rng = np.random.default_rng(29)
    flat, words = _flat_list(rng)
    port = _with_terms(port, [(flat, words), (np.zeros(0, np.int32), None)])
    ref = _with_terms(ref, [(flat, words), (np.zeros(0, np.int32), None)])
    n = port.n_terms
    hints = [None, "guided", "decode"]
    items = [(t, _cands(rng, ref.postings(t)) if ref.lens[t] else np.arange(5), hints[t % 3])
             for t in range(n)]
    items += [(n - 2, _cands(rng, flat), "guided"), (0, np.zeros(0, np.int64), None),
              (3, np.array([0, 1, 2]), "guided")]

    calls = {"probe_batch": 0, "decode_terms": 0}
    launch, decode = ops.probe_batch, search.decode_terms
    monkeypatch.setattr(ops, "probe_batch",
                        lambda *a: calls.__setitem__("probe_batch", calls["probe_batch"] + 1)
                        or launch(*a))
    monkeypatch.setattr(search, "decode_terms",
                        lambda *a: calls.__setitem__("decode_terms", calls["decode_terms"] + 1)
                        or decode(*a))
    gp = GuidedPostings(port, device="cpu")
    got = gp.probe_many(items) if ranks else gp.contains_many(items)
    assert calls == {"probe_batch": 1, "decode_terms": 1}

    one, gr = GuidedPostings(port, device="cpu"), RefGuided(ref)
    for (t, cands, hint), g in zip(items, got):
        if ranks:
            want = gr.probe(t, cands, route=hint)
            assert all(np.array_equal(a, b) for a, b in zip(g, want)), (t, hint)
            assert all(np.array_equal(a, b) for a, b in zip(g, one.probe(t, cands, route=hint)))
            if gp.route(t, len(cands), hint) == "guided":
                pf, pr, _ = pallas_windows(ref_load_model(ref.streams[t][1:], int(ref.lens[t])),
                                           cands, interpret=True)
                assert np.array_equal(g[0], pf) and np.array_equal(g[1], pr), t
        else:
            assert np.array_equal(g, gr.contains(t, cands, route=hint)), (t, hint)
            assert np.array_equal(g, one.contains(t, cands, route=hint))
    assert gp.stats == one.stats
    assert gp.stats.wide_probes > 20 and gp.stats.guided_terms and gp.stats.routed_terms
    assert gp.stats.fallback_terms
    want = gr.stats.as_dict()
    assert {k: gp.stats.as_dict()[k] for k in want} == want


def test_arena_survives_reset_and_window_bytes_match_touched_words(stores):
    """The arena is built once and kept across ``reset_stats``; the byte
    count of a batch of windows equals ``_touched_words`` of their ranks."""
    port, _ = stores
    gp = GuidedPostings(port, device="cpu")
    rng = np.random.default_rng(31)
    learned = [t for t in range(port.n_terms) if gp.is_guided(t)]
    gp.probe_many([(t, _cands(rng, port.postings(t)), "guided") for t in learned])
    arena = gp.arena
    assert sorted(arena.row) == learned and len(arena.first_seg) == len(learned)
    gp.reset_stats()
    assert gp.arena is arena and gp.stats == search.ProbeStats()
    for t in learned:
        tm = gp.term_model(t)
        _, r_lo, lens, _, _, ranks = flatten_windows(tm, _cands(rng, port.postings(t)))
        assert search.window_words(r_lo, lens, tm.width) == search._touched_words(ranks, tm.width)
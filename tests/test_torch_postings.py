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
from repro_torch.postings import hybrid
from repro_torch.postings.search import (
    GuidedPostings, decode_window, flatten_windows, full_decode, load_term_model,
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


def test_wide_windows_run_on_the_kernel_path(monkeypatch):
    """Brackets wider than MAX_W (slope 0: every bracket is the whole list)
    go to launches of their own, cut at WIDE_CELLS corrections, and give the
    reference's verdicts; the prober counts them."""
    from repro.postings.search import ProbeStats as RefStats
    from repro_torch.kernels.guided_search import ops
    from repro_torch.postings.plm import emit_stream
    from repro_torch.postings.search import ProbeStats

    rng = np.random.default_rng(19)
    ids = np.sort(rng.choice(UNIVERSE, 1500, replace=False)).astype(np.int32)
    words = emit_stream(ids, np.array([0], np.int64), np.array([int(ids[0])], np.int64),
                        np.array([0.0], np.float32), eps=0)
    tm = load_term_model(words, len(ids))
    cands = _cands(rng, ids)
    ref_gp = RefGuided.__new__(RefGuided)
    ref_gp.stats = RefStats()
    want_found, want_rank = ref_gp._probe_host(ref_load_model(words, len(ids)), cands)

    rows_per_launch = []
    launch = ops._launch

    def counted(tm_, d, seg, r_lo, lens, rows, *rest):
        rows_per_launch.append(len(rows))
        return launch(tm_, d, seg, r_lo, lens, rows, *rest)

    monkeypatch.setattr(ops, "_launch", counted)
    monkeypatch.setattr(ops, "WIDE_CELLS", 2048 * 20)  # 20 wide rows per launch
    gp = GuidedPostings.__new__(GuidedPostings)
    gp.stats, gp.device = ProbeStats(), "cpu"
    found, rank = gp._probe_guided(tm, cands)
    assert np.array_equal(found, want_found) and np.array_equal(rank, want_rank)
    lens = flatten_windows(tm, cands)[2]
    wide = lens[lens > ops.MAX_W]
    assert len(wide) > 20 and gp.stats.window_bytes > 0
    assert (gp.stats.wide_probes, gp.stats.wide_ranks) == (len(wide), int(wide.sum()))
    assert sum(rows_per_launch) == int((lens > 0).sum()) and max(rows_per_launch) <= 20

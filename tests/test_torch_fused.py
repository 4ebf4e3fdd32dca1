"""The port's fused ranked path against the reference, on the CPU.

Kernel level: the port's ``fused_topk`` (its plain version on the CPU) must
equal the reference's ``fused_topk_ref`` and its Pallas ``fused_topk`` in
interpret mode on the same tiles — with ties, an empty row, NEVER-padded
candidates, garbage past each window's length and W > 1 — and the port's
dense loop (its plain version ``dense_ref``) must equal the reference's
``_dense_impl``, rounds included.

Path level, on an index engineered so that plm wins the smooth lists (real
ε-window lanes next to classical host-resolved lanes in one tile): the
bridge's tiles, results and counters equal the reference bridge's, and the
engine's fused results equal the multi-phase path, the reference engine and
``brute_force_topk``.  Tolerance: exact everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import _t, fused_tiles

from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
from repro.kernels.fused_query.dense import _dense_impl as ref_dense_impl
from repro.kernels.fused_query.kernel import fused_topk as ref_fused_topk
from repro.kernels.fused_query.ops import fused_topk_batch as ref_fused_topk_batch
from repro.kernels.fused_query.ref import fused_topk_ref as np_fused_topk_ref
from repro.rank.topk import RankedStats as RefRankedStats
from repro.serve import BooleanEngine as RefEngine, ServeConfig as RefServeConfig
from repro_torch.common.config import LearnedIndexConfig
from repro_torch.core.learned_bloom import fit_thresholds
from repro_torch.core.membership import params_from_jax
from repro_torch.index.build import InvertedIndex
from repro_torch.kernels.fused_query import ops as fused_ops
from repro_torch.kernels.fused_query.dense import NEVER, dense_impl
from repro_torch.kernels.fused_query.kernel import fused_topk
from repro_torch.kernels.fused_query.ref import dense_ref
from repro_torch.rank import RankedStats
from repro_torch.rank.score import ImpactModel, brute_force_topk
from repro_torch.serve import BooleanEngine, ServeConfig

K = 10
_SHARED: dict = {}


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.ids, w.ids) and np.array_equal(g.scores, w.scores), (what, i)


# ------------------------------------------------------------ kernel level
@pytest.mark.parametrize("shape", [
    dict(), dict(Q=9, T=5, C=384, W=1), dict(C=128, W=8, pbits=4),
    dict(C=2048, W=1, k=1, tied=True), dict(C=2048, W=2, k=2048, tied=True),
], ids=["base", "w1", "w8-pbits4", "c2048-k1-tied", "c2048-kC-tied"])
def test_fused_topk_plain_matches_reference_and_pallas(shape):
    tiles, kw = fused_tiles(np.random.default_rng(11), **shape)
    ids, scores = fused_topk(*[_t(a) for a in tiles], **kw)
    ids, scores = ids.numpy(), scores.numpy()
    want_i, want_s = np_fused_topk_ref(*tiles, **kw)
    assert np.array_equal(ids, want_i) and np.array_equal(scores, want_s)
    if kw["k"] <= 16:  # the Pallas kernel unrolls k peel rounds: k = C takes minutes to trace
        pi, ps = ref_fused_topk(*(jnp.asarray(a) for a in tiles), interpret=True, **kw)
        assert np.array_equal(ids, np.asarray(pi)) and np.array_equal(scores, np.asarray(ps))
    assert (ids[1] == -1).all() and (scores[1] == 0).all()  # the empty row
    row = scores[2][scores[2] > 0]  # all-tied row: ascending candidate ids
    assert (row == row[0]).all() and (np.diff(ids[2][: len(row)]) > 0).all()
    if shape.get("tied"):  # every row ties all its candidates, so it returns the first k
        n_real = (tiles[11] != NEVER).sum(1)
        assert ((scores > 0).sum(1) == np.minimum(n_real, kw["k"])).all()


@pytest.mark.parametrize("k,density,ties", [
    (0, 0.1, False), (1, 0.1, False), (10, 0.1, False), (32, 0.1, False), (32, 0.004, False),
    (10, 0.1, True), (32, 0.1, True),
], ids=["k0", "k1", "k10", "k32", "k32-runs-out", "k10-tied-row", "k32-tied-row"])
def test_dense_loop_matches_reference(k, density, ties):
    """The plain version ``dense_ref`` (what ``dense_impl`` runs on a CPU
    table) against the reference's ``_dense_impl``: Q = 9 rows (not a
    multiple of the row quantum), an all-pad row, a floor nothing beats,
    impacts in 1..3 (ties everywhere) and, in the tied-row cases, a row whose
    docs all score the same.  Then one ``dense_topk`` pass through each
    package's arena: the same outputs and the same observed shape."""
    from repro.kernels.arena import DeviceArena as RefDeviceArena
    from repro.kernels.fused_query import dense as ref_dense
    from repro_torch.kernels.arena import DeviceArena
    from repro_torch.kernels.fused_query import dense

    rng = np.random.default_rng(k)
    n_terms, n_docs, Q = 40, 700, 9
    table = np.zeros((n_terms + 1, n_docs), np.uint8)
    mask = rng.random((n_terms, n_docs)) < density
    table[:n_terms][mask] = rng.integers(1, 4, int(mask.sum()))  # ties everywhere
    qt = rng.integers(-1, n_terms, (Q, 4)).astype(np.int32)
    qt[5] = -1  # an all-pad row
    floors = rng.integers(0, 5, Q).astype(np.int32)
    floors[2] = 1000  # nothing beats it
    if ties:  # every doc of row 8 scores 2
        table[n_terms - 1] = 2
        qt[8] = [n_terms - 1, -1, -1, -1]
        floors[8] = 0
    ids, scores, rounds = dense_ref(torch.from_numpy(table), torch.from_numpy(qt),
                                    torch.from_numpy(floors), k=k)
    if k == 0:  # the reference's loop body cannot be traced at k = 0 (its bridge never asks):
        # the port gives what the loop defines, no slot and no round
        with pytest.raises(IndexError):
            ref_dense_impl(jnp.asarray(table), jnp.asarray(qt), jnp.asarray(floors), k=k)
        assert ids.shape == scores.shape == (Q, 0) and int(rounds) == 0
        return
    ri, rs, rr = ref_dense_impl(jnp.asarray(table), jnp.asarray(qt), jnp.asarray(floors), k=k)
    assert np.array_equal(ids.numpy(), np.asarray(ri))
    assert np.array_equal(scores.numpy(), np.asarray(rs)) and int(rounds) == int(rr)
    assert ids.shape == (Q, k) and (ids.numpy()[5] == NEVER).all() and (ids.numpy()[2] == NEVER).all()
    assert (int(rounds) < k) == (density < 0.01)  # the sparse table stops the loop early
    if ties:  # the first k doc ids, in order
        assert np.array_equal(ids.numpy()[8], np.arange(k)) and (scores.numpy()[8] == 2).all()
    di = dense_impl(torch.from_numpy(table), torch.from_numpy(qt), torch.from_numpy(floors), k=k)
    assert all(torch.equal(a, b) for a, b in zip(di, (ids, scores, rounds)))

    lens = (table[:n_terms] > 0).sum(1).astype(np.int64)
    arena = DeviceArena(n_docs=n_docs, n_terms=n_terms, table=torch.from_numpy(table),
                        host_lens=lens)
    ref_arena = RefDeviceArena(n_docs=n_docs, n_terms=n_terms, table=jnp.asarray(table),
                               host_lens=lens)
    got = dense.dense_topk(arena, qt, floors, k=k)
    want = ref_dense.dense_topk(ref_arena, qt, floors, k=k)
    assert all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))
    assert (n_docs, Q, 4, k) in set(dense.observed_shapes()) & set(ref_dense.observed_shapes())
    assert arena.counters.hits == ref_arena.counters.hits == 1


# ------------------------------------------------------------ tiered index
def _tiered():
    """Smooth strided-with-jitter lists (plm wins them with a small nonzero
    correction width: real ε-window lanes) next to random sparse lists that
    stay classical — the reference's own engineered test index."""
    if "tiered" not in _SHARED:
        from repro.common.config import LearnedIndexConfig as RefLIConfig

        rng = np.random.default_rng(3)
        universe = 101_000
        lists = [np.arange(2000) * 50 + rng.integers(0, 12, 2000) + s for s in range(6)]
        lists += [np.sort(rng.choice(universe, 900, replace=False)) for _ in range(6)]
        offsets = np.zeros(len(lists) + 1, np.int64)
        np.cumsum([len(x) for x in lists], out=offsets[1:])
        inv = InvertedIndex(n_docs=universe, n_terms=len(lists), term_offsets=offsets,
                            doc_ids=np.concatenate(lists).astype(np.int32),
                            tfs=rng.integers(1, 8, int(offsets[-1])).astype(np.int32))
        params_np = {
            "term_embed": {"table": (rng.standard_normal((inv.n_terms, 8)) * 0.3).astype(np.float32)},
            "doc_embed": {"table": (rng.standard_normal((universe, 8)) * 0.3).astype(np.float32)},
            "bias": np.float32(0.0),
        }
        lb = fit_thresholds(params_from_jax(params_np, device="cpu"), inv)
        ref_lb = RefLearnedBloom(
            params={"term_embed": {"table": jnp.asarray(params_np["term_embed"]["table"])},
                    "doc_embed": {"table": jnp.asarray(params_np["doc_embed"]["table"])},
                    "bias": jnp.asarray(params_np["bias"])},
            tau=lb.tau.numpy(), backup_keys=np.zeros(0, np.int64), n_docs=universe)
        li = LearnedIndexConfig(embed_dim=8, truncation_k=16, block_size=128)
        ref_li = RefLIConfig(embed_dim=8, truncation_k=16, block_size=128)
        engs = {
            name: BooleanEngine(lb, inv, li, ServeConfig(n_shards=1, device="cpu", ranked=rc))
            for name, rc in (
                ("multiphase", dict(topk_exhaustive_cutoff=0)),
                ("fused", dict(fused_kernel=True, topk_exhaustive_cutoff=0, device_arena=False)),
                ("dense", dict(fused_kernel=True, topk_exhaustive_cutoff=0, device_arena=True)),
            )
        }
        ref = RefEngine(ref_lb, inv, ref_li, RefServeConfig(
            n_shards=1, ranked=dict(fused_kernel=True, topk_exhaustive_cutoff=0,
                                    device_arena=False)))
        src = engs["fused"].shards[0].ranked
        learned, classical = [], []
        for t in range(inv.n_terms):
            tm = src.term_model(t)
            (learned if tm is not None and 0 < tm.width < 32 else classical).append(t)
        q = np.full((6, 6), -1, np.int32)
        q[0, :6] = learned[:3] + classical[:3]
        q[1, :4] = learned[:4]
        q[2, :3] = classical[:3]
        q[3, :5] = [learned[0], classical[0], learned[1], classical[1], learned[2]]
        q[4, :2] = [learned[2], classical[2]]
        req = np.zeros(q.shape, bool)
        req[3, 0] = req[4, 1] = True
        _SHARED["tiered"] = (inv, engs, ref, learned, classical, q, req)
    return _SHARED["tiered"]


def test_tiered_index_exercises_both_lane_flavours():
    _, _, _, learned, classical, *_ = _tiered()
    assert len(learned) >= 4 and len(classical) >= 3


@pytest.mark.parametrize("path", ["fused", "dense"])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_fused_paths_exact_across_codec_tiers(path, k):
    inv, engs, ref, *_, q, req = _tiered()
    eng = engs[path]
    im = ImpactModel.build(inv)
    for kw in (dict(), dict(required=req)):
        got = eng.query_topk(q, k, **kw)
        _same(got, engs["multiphase"].query_topk(q, k, **kw), (path, "multiphase"))
        _same(got, ref.query_topk(q, k, **kw), (path, "reference"))
        _same(got, brute_force_topk(inv, im, q, k, **kw), (path, "brute force"))
    s = eng.metrics.snapshot()["ranked"]
    assert s["fused_queries"] > 0 and s["fused_lanes"] > 0


def test_bridge_tiles_results_and_counters_match_reference():
    _, engs, ref, *_, q, _ = _tiered()
    src, ref_src = engs["fused"].shards[0].ranked, ref.shards[0].ranked
    items = [(tuple(int(t) for t in row[row >= 0]), K, (), 0) for row in q if (row >= 0).any()]
    stats, ref_stats = RankedStats(), RefRankedStats()
    got = fused_ops.fused_topk_batch(src, items, exhaustive_cutoff=0, stats=stats)
    want = ref_fused_topk_batch(ref_src, items, exhaustive_cutoff=0, stats=ref_stats,
                                use_kernel=False)
    _same(got, want, "bridge")
    for f in ("queries", "exhaustive_queries", "scored_postings", "probed_postings",
              "exhaustive_postings", "fused_queries", "fused_lanes", "fused_stream_bytes",
              "fused_device_bytes"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    # the tiles themselves: one candidate bucket, built by both bridges
    pend = [(i, fused_ops._peel(src, *it[:2], it[2], it[3], 0, RankedStats()))
            for i, it in enumerate(items)]
    pend = [(i, p) for i, p in pend if isinstance(p, fused_ops._Pending)]
    assert pend and any(len(p.tail) for _, p in pend)
    C = fused_ops._bucket(max(len(p.cands) for _, p in pend), fused_ops._CANDQ)
    tiles, k = fused_ops.build_tiles(src, pend, C, src.payload_bits, RankedStats())
    ids, scores = fused_topk(*[_t(a) for a in tiles], k=k, pbits=src.payload_bits)
    want_i, want_s = np_fused_topk_ref(*tiles, k=k, pbits=src.payload_bits)
    assert np.array_equal(ids.numpy(), want_i) and np.array_equal(scores.numpy(), want_s)
    assert (tiles[0] > 0).any()  # ε-window lanes of a learned term reached the kernel


def test_wide_brackets_resolve_on_host_and_are_counted(monkeypatch):
    inv, engs, _, *_, q, req = _tiered()
    monkeypatch.setattr(fused_ops, "W_CAP", 0)  # every bracket is wide
    eng = engs["fused"]
    eng.reset_stats()
    im = ImpactModel.build(inv)
    for kw in (dict(), dict(required=req)):
        _same(eng.query_topk(q, K, **kw), brute_force_topk(inv, im, q, K, **kw), "W_CAP=0")
    assert eng.metrics.snapshot()["ranked"]["fused_wide_lanes"] > 0

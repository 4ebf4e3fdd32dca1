"""The port's ranked tier against the reference, on the CPU at a small size.

The ranked state is derived from the index, not trained: the port builds
its ImpactModel, payload streams and segment bounds from the same
collection, and they must equal the reference's word for word.  Ranked
results are integer impact sums with ties going to the smaller doc id, so
``BooleanEngine.query_topk`` must be bit-identical (ids and scores) to the
reference engine and to ``brute_force_topk`` in all three configurations:
  (a) multi-phase MaxScore with exhaustive queries on the bm25_score kernel,
  (b) fused_topk launches (no arena, no exhaustive shortcut),
  (c) the fused path with the dense arena loop,
for every shard count, k, and OR / AND / mixed-required queries.  On the CPU
each kernel wrapper runs its plain version.  Tolerance: exact everywhere.
"""
import numpy as np
import pytest

from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
from repro.data.queries import zipf_disjunctions as ref_zipf_disjunctions
from repro.rank.score import BM25Params as RefBM25Params
from repro.rank.score import ImpactModel as RefImpactModel
from repro.rank.score import brute_force_topk as ref_brute_force_topk
from repro.rank.score import select_topk as ref_select_topk
from repro.serve import BooleanEngine as RefEngine, ServeConfig as RefServeConfig
from repro.serve.planner import plan_ranked as ref_plan_ranked
from repro.serve.planner import ranked_run_mask as ref_ranked_run_mask
from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core.learned_bloom import fit_thresholds
from repro_torch.core.membership import params_from_jax
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import zipf_disjunctions
from repro_torch.index.build import build_inverted_index
from repro_torch.launch.serve import main as serve_main
from repro_torch.rank import RankedStats
from repro_torch.rank.score import (
    BM25Params, ImpactModel, TopKResult, brute_force_topk, select_topk,
)
from repro_torch.serve import BooleanEngine, ServeConfig
from repro_torch.serve.planner import plan_ranked, ranked_run_mask

CONFIGS = {
    "a": dict(score_kernel=True),
    "b": dict(fused_kernel=True, topk_exhaustive_cutoff=0, device_arena=False),
    "c": dict(fused_kernel=True, topk_exhaustive_cutoff=0, device_arena=True),
}
_ENGINES: dict = {}


@pytest.fixture(scope="module")
def system():
    import jax.numpy as jnp

    from repro.common.config import LearnedIndexConfig as RefLIConfig

    corpus = synthesize_corpus(CorpusConfig(n_docs=400, n_terms=1600, avg_doc_len=50, seed=31))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(9)
    params_np = {
        "term_embed": {"table": (rng.standard_normal((1600, 16)) * 0.3).astype(np.float32)},
        "doc_embed": {"table": (rng.standard_normal((400, 16)) * 0.3).astype(np.float32)},
        "bias": np.float32(0.0),
    }
    lb = fit_thresholds(params_from_jax(params_np, device="cpu"), inv)
    ref_params = {"term_embed": {"table": jnp.asarray(params_np["term_embed"]["table"])},
                  "doc_embed": {"table": jnp.asarray(params_np["doc_embed"]["table"])},
                  "bias": jnp.asarray(params_np["bias"])}
    ref_lb = RefLearnedBloom(params=ref_params, tau=lb.tau.numpy(),
                             backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    li = LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64)
    ref_li = RefLIConfig(embed_dim=16, truncation_k=16, block_size=64)
    q, req = zipf_disjunctions(inv.dfs, 24, seed=5, n_required=1)
    q[3] = -1  # an all-pad query
    return inv, lb, li, ref_lb, ref_li, q, req


def _engine(system, config, n_shards):
    key = ("port", config, n_shards)
    if key not in _ENGINES:
        inv, lb, li, *_ = system
        _ENGINES[key] = BooleanEngine(lb, inv, li, ServeConfig(
            n_shards=n_shards, device="cpu", ranked=CONFIGS[config]))
    return _ENGINES[key]


def _ref_engine(system, n_shards, config=None):
    key = ("ref", config, n_shards)
    if key not in _ENGINES:
        inv, _, _, ref_lb, ref_li, *_ = system
        ranked = CONFIGS[config] if config else {}
        _ENGINES[key] = RefEngine(ref_lb, inv, ref_li,
                                  RefServeConfig(n_shards=n_shards, ranked=ranked))
    return _ENGINES[key]


def _assert_same(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.ids.dtype == np.int32 and g.scores.dtype == np.int64, what
        assert np.array_equal(g.ids, w.ids) and np.array_equal(g.scores, w.scores), (what, i)


def _modes(system):
    *_, q, req = system
    return (("or", dict(mode="or")), ("and", dict(mode="and")),
            ("mixed", dict(mode="or", required=req)))


# ------------------------------------------------------------ ranked state
def test_zipf_disjunctions_match_reference(system):
    inv, *_ = system
    for kw in (dict(seed=7), dict(seed=3, n_required=2, max_terms=4)):
        (q, r), (rq, rr) = zipf_disjunctions(inv.dfs, 40, **kw), ref_zipf_disjunctions(inv.dfs, 40, **kw)
        assert np.array_equal(q, rq) and np.array_equal(r, rr)


@pytest.mark.parametrize("bits", [4, 8])
def test_impact_model_matches_reference(system, bits):
    inv, *_ = system
    im = ImpactModel.build(inv, BM25Params(bits=bits))
    ref = RefImpactModel.build(inv, RefBM25Params(bits=bits))
    assert im.scale == ref.scale and im.avg_len == ref.avg_len
    assert np.array_equal(im.idf, ref.idf) and np.array_equal(im.doc_lens, ref.doc_lens)
    assert np.array_equal(im.quantize_index(inv), ref.quantize_index(inv))
    assert im.weight_f32() == ref.weight_f32()


@pytest.mark.parametrize("n_shards", [1, 2])
def test_payload_streams_and_bounds_match_reference_word_for_word(system, n_shards):
    eng, ref = _engine(system, "a", n_shards), _ref_engine(system, n_shards)
    for sh, rsh in zip(eng.shards, ref.shards):
        sh.ensure_payloads()
        rsh.ensure_payloads()
        a, b = sh.tier2, rsh.tier2
        assert (a.payload_bits, a.payload_scale) == (b.payload_bits, b.payload_scale)
        assert len(a.payload_streams) == len(b.payload_streams)
        for x, y in zip(a.payload_streams, b.payload_streams):
            assert x.dtype == y.dtype == np.uint32 and np.array_equal(x, y)
        assert np.array_equal(a.ub_offsets, b.ub_offsets) and np.array_equal(a.seg_ubs, b.seg_ubs)
        for t in range(0, a.n_terms, 7):
            assert a.term_ub(t) == b.term_ub(t)
            assert np.array_equal(a.term_seg_ubs(t), b.term_seg_ubs(t))
            if a.lens[t]:
                assert np.array_equal(a.payloads(t), b.payloads(t))
                ranks = np.arange(0, int(a.lens[t]), 3)
                assert np.array_equal(a.payload_at(t, ranks), b.payload_at(t, ranks))
        assert a.payload_size_bits() == b.payload_size_bits()
    assert eng.memory_report()["payload_bits"] == ref.memory_report()["payload_bits"]


def test_plans_and_run_masks_match_reference(system):
    inv, *_, q, req = system
    dfs = inv.dfs.copy()
    dfs[q[0, 0]] = 0  # a dead term
    local = np.random.default_rng(4).integers(0, 3, len(dfs))
    for kw in (dict(mode="or"), dict(mode="and"), dict(required=req)):
        got, want = plan_ranked(q, dfs, **kw), ref_plan_ranked(q, dfs, **kw)
        assert [vars(p) for p in got] == [vars(p) for p in want]
        assert np.array_equal(ranked_run_mask(got, local), ref_ranked_run_mask(want, local))


def test_select_topk_and_oracle_match_reference(system):
    inv, *_, q, req = system
    rng = np.random.default_rng(2)
    ids, scores = np.arange(300, dtype=np.int32), rng.integers(0, 6, 300)
    for k, floor in ((1, 0), (10, 2), (400, 0)):
        _assert_same([select_topk(ids, scores, k, floor)],
                     [ref_select_topk(ids, scores, k, floor)], "select_topk")
    im = ImpactModel.build(inv)
    ref_im = RefImpactModel.build(inv)
    for kw in (dict(mode="or"), dict(mode="and"), dict(required=req)):
        _assert_same(brute_force_topk(inv, im, q, 10, **kw),
                     ref_brute_force_topk(inv, ref_im, q, 10, **kw), "oracle")


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("config", ["a", "b", "c"])
def test_query_topk_bit_identical_to_reference_and_brute_force(system, config, n_shards, k):
    inv, *_, q, _ = system
    eng, ref = _engine(system, config, n_shards), _ref_engine(system, n_shards)
    assert len(eng.shards) == n_shards
    for name, kw in _modes(system):
        got = eng.query_topk(q, k, **kw)
        _assert_same(got, ref.query_topk(q, k, **kw), (config, name, "reference"))
        _assert_same(got, brute_force_topk(inv, eng.impact_model, q, k, **kw),
                     (config, name, "brute force"))
        assert got[3].ids.size == 0


def test_configurations_take_their_paths(system, monkeypatch):
    """(a) scores exhaustive queries on bm25_score, (b) launches fused_topk
    and never the dense loop, (c) answers OR items with the dense loop."""
    import repro_torch.kernels.bm25_score.ops as bm25_ops
    import repro_torch.kernels.fused_query.ops as fused_ops
    from repro_torch.kernels.fused_query import dense

    calls = {"bm25": 0, "fused": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(bm25_ops, "score_batch", count("bm25", bm25_ops.score_batch))
    monkeypatch.setattr(fused_ops, "fused_topk", count("fused", fused_ops.fused_topk))
    *_, q, req = system
    for config in ("a", "b", "c"):
        eng = _engine(system, config, 2)
        eng.reset_stats()
        before, dense_before = dict(calls), dense.launches
        eng.query_topk(q, 10, required=req)
        eng.query_topk(q, 10)
        ran = {n: calls[n] - before[n] for n in calls}
        ranked = eng.metrics.snapshot()["ranked"]
        if config == "a":
            assert ran["bm25"] > 0 and ran["fused"] == 0 and ranked["exhaustive_queries"] > 0
        elif config == "b":
            assert ran["fused"] > 0 and dense.launches == dense_before
            assert ranked["fused_queries"] > 0 and ranked["fused_lanes"] > 0
        else:
            assert dense.launches > dense_before and ran["fused"] > 0  # required items
            arena = eng.metrics.snapshot()["shards"][0]["arena"]
            assert arena["uploads"] == 1 and arena["hits"] > 0


@pytest.mark.parametrize("config", ["a", "b", "c"])
def test_query_topk_matches_reference_engine_in_the_same_configuration(system, config):
    *_, q, req = system
    eng, ref = _engine(system, config, 2), _ref_engine(system, 2, config)
    for kw in (dict(), dict(required=req)):
        _assert_same(eng.query_topk(q, 10, **kw), ref.query_topk(q, 10, **kw), config)


def _per_item_topk(eng, q, k, **kw):
    """The loop the batched multi-phase path replaces: queries outer,
    shards inner, one ``query_topk_local`` call per (query, shard), the
    running k-th best score forwarded as the next shard's floor."""
    from repro_torch.serve.boolean import _merge_heap

    empty = TopKResult(ids=np.zeros(0, np.int32), scores=np.zeros(0, np.int64))
    qplans = plan_ranked(q, eng._global_dfs, **kw)
    runs = [ranked_run_mask(qplans, sh.local_dfs) for sh in eng.shards]
    out = []
    for i, qp in enumerate(qplans):
        heap = empty
        for sh, run in zip(eng.shards, runs):
            if qp.dead or not run[i]:
                continue
            floor = int(heap.scores[k - 1]) if len(heap.scores) == k else 0
            part = sh.query_topk_local(qp.terms, k, required=qp.required, floor=floor)
            if len(part.ids):
                heap = _merge_heap(heap, part, k)
        out.append(heap)
    return out


def _lru(eng):
    return [[(key, value) for key, (value, _) in sh._decode_cache._entries.items()]
            for sh in eng.shards]


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("score_kernel", [True, False], ids=["kernel", "host"])
def test_batched_multiphase_matches_per_item_loop_and_reference(system, score_kernel, n_shards):
    """The multi-phase path serves each shard's items in one batch
    (``topk_batch``): exhaustive items decoded together and, with the score
    kernel, scored in one call.  A mix of exhaustive, pruned and
    required-term items, a decode budget that evicts, and floors forwarded
    between shards: ids, scores, RankedStats, and the decode LRU's entries
    and counters equal the per-item loop's; results equal the reference
    engine's in the same configuration and brute force.  Prefetch calls,
    decodes and takes may differ (that is the batching); no prefetched list
    goes unread, and the batch decodes no list the loop does not."""
    inv, lb, li, ref_lb, ref_li, q, req = system
    ranked = dict(score_kernel=score_kernel, topk_exhaustive_cutoff=450 // n_shards)
    cfg = dict(n_shards=n_shards, cache_budget_bytes=6000, ranked=ranked)
    batched, loop = (BooleanEngine(lb, inv, li, ServeConfig(device="cpu", **cfg))
                     for _ in range(2))
    ref = RefEngine(ref_lb, inv, ref_li, RefServeConfig(**cfg))
    for kw in (dict(), dict(required=req), dict(mode="and")):
        got = batched.query_topk(q, 10, **kw)
        _assert_same(got, _per_item_topk(loop, q, 10, **kw), ("loop", kw))
        _assert_same(got, ref.query_topk(q, 10, **kw), ("reference", kw))
        _assert_same(got, brute_force_topk(inv, batched.impact_model, q, 10, **kw), kw)
    stats, stats0 = batched.metrics.snapshot(), loop.metrics.snapshot()
    assert stats["ranked"] == stats0["ranked"]
    assert 0 < stats["ranked"]["exhaustive_queries"] < stats["ranked"]["queries"]
    assert stats["ranked"]["probed_postings"] > 0
    assert stats["decode_cache"] == stats0["decode_cache"]
    assert stats["decode_cache"]["evictions"] > 0
    got_lru, want_lru = _lru(batched), _lru(loop)
    assert [[k for k, _ in sh] for sh in got_lru] == [[k for k, _ in sh] for sh in want_lru]
    for sa, sb in zip(got_lru, want_lru):
        for (_, va), (_, vb) in zip(sa, sb):
            assert np.array_equal(va, vb)
    pre, pre0 = stats["prefetch"], stats0["prefetch"]
    assert pre["unused"] == pre0["unused"] == 0
    assert pre["decoded"] <= pre0["decoded"] and pre["calls"] <= pre0["calls"]
    if n_shards == 1:  # the K=4 shards of 100 docs hold few kernel-coded lists
        assert 0 < pre["calls"] < pre0["calls"]


@pytest.mark.parametrize("score_kernel", [True, False], ids=["kernel", "host"])
def test_shard_batch_with_floors_matches_reference_shard(system, score_kernel):
    """One shard's batch with nonzero floors (every item's own) against the
    reference shard's per-item ``query_topk_local``: ids, scores and the
    shard's RankedStats."""
    inv, lb, li, ref_lb, ref_li, q, req = system
    ranked = dict(score_kernel=score_kernel, topk_exhaustive_cutoff=450)
    eng = BooleanEngine(lb, inv, li, ServeConfig(device="cpu", ranked=ranked))
    ref = RefEngine(ref_lb, inv, ref_li, RefServeConfig(ranked=ranked))
    rng = np.random.default_rng(12)
    items = []
    for row, r in zip(q, req):
        terms = tuple(sorted({int(t) for t in row if t >= 0}))
        required = tuple(int(t) for t, m in zip(row, r) if m and t >= 0) if rng.random() < 0.3 else ()
        items.append((terms, int(rng.choice([1, 10])), required, int(rng.integers(0, 40))))
    sh, rsh = eng.shards[0], ref.shards[0]
    got = sh.query_topk_batch(items)
    _assert_same(got, [rsh.query_topk_local(t, k, required=r, floor=f) for t, k, r, f in items],
                 "shard")
    assert any(f > 0 and len(g.ids) for (*_, f), g in zip(items, got))
    assert any(len(g.ids) < k for (_, k, _, _), g in zip(items, got))  # a floor cut some
    want = rsh.ranked_stats
    for field in ("queries", "exhaustive_queries", "scored_postings", "probed_postings",
                  "exhaustive_postings"):
        assert getattr(sh.ranked_stats, field) == getattr(want, field), field


def test_exhaustive_items_score_in_one_launch_per_shard(system, monkeypatch):
    """Configuration (a) at two shards: a batch with several exhaustive
    items on each shard makes one score_batch call per shard."""
    import repro_torch.kernels.bm25_score.ops as bm25_ops

    calls = []
    score = bm25_ops.score_batch
    monkeypatch.setattr(bm25_ops, "score_batch",
                        lambda imp, scale: calls.append(tuple(imp.shape)) or score(imp, scale))
    inv, lb, li, *_, q, _ = system
    eng = BooleanEngine(lb, inv, li, ServeConfig(n_shards=2, device="cpu", ranked=CONFIGS["a"]))
    eng.query_topk(q, 10)
    per_shard = [sh.ranked_stats.exhaustive_queries for sh in eng.shards]
    assert min(per_shard) > 1 and len(calls) == 2


def test_ranked_stats_keys_and_counts(system):
    eng = _engine(system, "b", 1)
    eng.reset_stats()
    *_, q, _ = system
    eng.query_topk(q, 10)
    d = eng.metrics.snapshot()["ranked"]
    assert set(RankedStats().as_dict()) == set(d)
    assert d["fused_wide_lanes"] == 0 and d["queries"] == int((q >= 0).any(axis=1).sum())
    assert 0 < d["touched_postings"] <= d["exhaustive_postings"]


def test_engine_without_tfs_cannot_rank(system):
    inv, lb, li, *_ = system
    from dataclasses import replace

    eng = BooleanEngine(lb, replace(inv, tfs=None), li, ServeConfig(device="cpu"))
    with pytest.raises(ValueError, match="payload streams"):
        eng.query_topk(np.array([[1, 2]]), 5)


@pytest.mark.parametrize("fused", [False, True], ids=["multiphase", "fused"])
def test_launcher_serves_ranked_exact_on_cpu(capsys, fused):
    serve_main(["--device", "cpu", "--docs", "300", "--terms", "1200", "--train-steps", "5",
                "--queries", "8", "--shards", "2", "--topk", "10"] + (["--fused"] if fused else []))
    out = capsys.readouterr().out
    assert "exact=8/8" in out and "exact-vs-BM25-brute-force=True" in out
    assert "fused_wide_lanes" in out

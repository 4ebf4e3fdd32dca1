"""The port's Boolean serving against the reference engine and brute force.

Both engines get the same collection, the same membership parameters (made
with numpy from a seed) and the port's fitted thresholds.  Verified results
are exact, so ``query_batch`` must be bit-identical to the
reference's and to ``brute_force_answers`` for every shard count.
"""
import numpy as np
import pytest
import torch

from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
from repro.serve import BooleanEngine as RefEngine, ServeConfig as RefServeConfig
from repro.serve.cache import CostLRU as RefCostLRU
from repro.serve.planner import plan_queries as ref_plan_queries
from repro.serve.shard import pack_ids as ref_pack_ids, shard_ranges as ref_shard_ranges
from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core.learned_bloom import fit_thresholds
from repro_torch.core.membership import MembershipModel, params_from_jax
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_conjunctions
from repro_torch.index.build import build_inverted_index
from repro_torch.launch.serve import main as serve_main
from repro_torch.postings.search import GuidedPostings
from repro_torch.serve import BooleanEngine, CostLRU, ServeConfig
from repro_torch.serve.planner import plan_queries
from repro_torch.serve.shard import pack_ids, shard_ranges, unpack_row


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
    # the reference engine serves the same thresholds (the fits themselves
    # are compared in test_torch_core.py)
    ref_params = {"term_embed": {"table": jnp.asarray(params_np["term_embed"]["table"])},
                  "doc_embed": {"table": jnp.asarray(params_np["doc_embed"]["table"])},
                  "bias": jnp.asarray(params_np["bias"])}
    ref_lb = RefLearnedBloom(params=ref_params, tau=lb.tau.numpy(),
                             backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    li_cfg = LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64)
    ref_li = RefLIConfig(embed_dim=16, truncation_k=16, block_size=64)
    q = np.concatenate([sample_queries(corpus, 24, seed=8), zipf_conjunctions(inv.dfs, 16)])
    q[5] = -1  # an all-pad query
    return corpus, inv, lb, li_cfg, ref_lb, ref_li, q


@pytest.mark.parametrize("k", [1, 4])
def test_query_batch_bit_identical_to_reference_and_brute_force(system, k):
    corpus, inv, lb, li_cfg, ref_lb, ref_li, q = system
    eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(n_shards=k, device="cpu"))
    ref = RefEngine(ref_lb, inv, ref_li, RefServeConfig(n_shards=k))
    got, want = eng.query_batch(q), ref.query_batch(q)
    exact = brute_force_answers(corpus, q)
    assert len(eng.shards) == k
    for g, w, e in zip(got, want, exact):
        assert g.dtype == w.dtype and np.array_equal(g, w) and np.array_equal(g, e)
    assert np.array_equal(eng.query_batch_bitmap(q), ref.query_batch_bitmap(q))
    stats = eng.metrics.snapshot()
    assert stats["guided"]["probes"] > 0 and len(stats["shards"]) == k
    assert eng.memory_report() == ref.memory_report()


@pytest.mark.parametrize("cfg", [
    dict(algorithm="exhaustive"), dict(use_guided=False), dict(postings_store="raw"),
], ids=["exhaustive", "unguided", "raw"])
def test_query_batch_variants_exact(system, cfg):
    corpus, inv, lb, li_cfg, *_, q = system
    eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(device="cpu", **cfg))
    for g, e in zip(eng.query_batch(q), brute_force_answers(corpus, q)):
        assert np.array_equal(g, e)


def test_unverified_candidates_are_supersets(system):
    corpus, inv, lb, li_cfg, *_, q = system
    eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(verified=False, n_shards=2, device="cpu"))
    for g, e in zip(eng.query_batch(q), brute_force_answers(corpus, q)):
        assert np.isin(e, g).all()


def test_empty_batches(system):
    _, inv, lb, li_cfg, *_ = system
    eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(device="cpu"))
    assert eng.query_batch(np.zeros((0, 3), np.int32)) == []
    out = eng.query_batch(np.full((2, 3), -1, np.int32))
    assert [len(r) for r in out] == [0, 0]
    assert eng.query_batch_bitmap(np.full((2, 3), -1, np.int32)).shape == (2, 13)


def _decode_entries(eng):
    """Every shard's decode-cache entries, in LRU order."""
    return [[(key, value) for key, (value, _) in sh._decode_cache._entries.items()]
            for sh in eng.shards]


def _same_entries(a, b):
    assert [[k for k, _ in sh] for sh in a] == [[k for k, _ in sh] for sh in b]
    for sa, sb in zip(a, b):
        for (_, va), (_, vb) in zip(sa, sb):
            assert np.array_equal(va, vb)


def _count_decodes(m, counts):
    """Count the shard's full decodes of kernel-coded lists: one at a time
    (``full_decode``) and batched (``decode_terms``)."""
    from repro_torch.postings.search import decode_kernel
    from repro_torch.serve import shard

    one, many = shard.full_decode, shard.decode_terms

    def full_decode(store, t, device):
        counts["one"] += decode_kernel(store, t) is not None
        return one(store, t, device)

    def decode_terms(store, terms, device):
        counts["many"] += sum(decode_kernel(store, t) is not None for t in terms)
        return many(store, terms, device)

    m.setattr(shard, "full_decode", full_decode)
    m.setattr(shard, "decode_terms", decode_terms)


@pytest.mark.parametrize("k,budget", [(1, 32 << 20), (1, 4000), (4, 4000)],
                         ids=["k1", "k1-evicting", "k4-evicting"])
def test_prefetch_keeps_results_and_decode_cache(system, monkeypatch, k, budget):
    """A cold and a warm batch with the batched prefetch and without it (each
    list decoded on its own): the same results, the same decode-cache
    entries and counters, and no more pfor launches (fewer at K=1; the K=4
    shards hold one optpfd list or so each).  The prefetch decodes exactly
    the lists the batch reads, none one at a time and none it leaves
    unread.  A budget of 4,000 bytes evicts lists in mid-batch."""
    from repro_torch.kernels.pfor import ops as pfor_ops
    from repro_torch.serve.shard import ShardEngine

    corpus, inv, lb, li_cfg, *_, q = system
    exact = brute_force_answers(corpus, q)
    decode = pfor_ops.pfor_decode
    runs = {}
    for prefetch in (True, False):
        launches, counts = [], {"one": 0, "many": 0}
        with monkeypatch.context() as m:
            m.setattr(pfor_ops, "pfor_decode", lambda *a: launches.append(a[2]) or decode(*a))
            _count_decodes(m, counts)
            if not prefetch:
                m.setattr(ShardEngine, "_postings_many", lambda self, terms: None)
            eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(
                n_shards=k, device="cpu", cache_budget_bytes=budget))
            res = [eng.query_batch(q), eng.query_batch(q)]
        runs[prefetch] = (res, _decode_entries(eng), eng.metrics.snapshot(), launches, counts)
    (got, entries, stats, fewer, counts), (want, entries0, stats0, per_term, counts0) = (
        runs[True], runs[False])
    for batch, batch0 in zip(got, want):
        for g, w, e in zip(batch, batch0, exact):
            assert np.array_equal(g, w) and np.array_equal(g, e)
    _same_entries(entries, entries0)
    assert stats["decode_cache"] == stats0["decode_cache"]
    pre = stats["prefetch"]
    assert pre["decoded"] > 0 and pre["taken"] > 0 and stats0["prefetch"]["decoded"] == 0
    assert len(fewer) < len(per_term) if k == 1 else len(fewer) <= len(per_term)
    # the same lists, all fetched in batches, none unread
    assert counts == {"one": 0, "many": pre["decoded"]}
    assert counts0 == {"one": pre["decoded"], "many": 0}
    assert pre["unused"] == 0
    # each LRU miss of a prefetched list is a decode the per-term path makes;
    # without evictions every decoded list misses exactly once
    if budget > 1 << 20:
        assert pre["taken"] == pre["decoded"]
    else:
        assert pre["taken"] > pre["decoded"]


@pytest.mark.parametrize("config", [
    dict(score_kernel=True),
    dict(score_kernel=True, topk_exhaustive_cutoff=0),
    dict(fused_kernel=True, topk_exhaustive_cutoff=0, device_arena=False),
    dict(fused_kernel=True, device_arena=False),
    dict(fused_kernel=True, topk_exhaustive_cutoff=0, device_arena=True),
], ids=["a", "a-pruned", "b", "b-exhaustive", "c"])
def test_ranked_prefetch_keeps_results_and_decode_cache(system, monkeypatch, config):
    """Ranked batches (OR, then mixed-required) at two shards, with the
    batched prefetch (exhaustive branch, fused peel and tail, arena build)
    and without it: the same top-k and the same decode-cache entries, and
    no prefetched list left unread."""
    from repro_torch.data.queries import zipf_disjunctions
    from repro_torch.rank.score import brute_force_topk
    from repro_torch.serve.shard import ShardEngine

    _, inv, lb, li_cfg, *_ = system
    q, req = zipf_disjunctions(inv.dfs, 24, seed=5, n_required=1)
    runs = {}
    for prefetch in (True, False):
        counts = {"one": 0, "many": 0}
        with monkeypatch.context() as m:
            _count_decodes(m, counts)
            if not prefetch:
                m.setattr(ShardEngine, "_postings_many", lambda self, terms: None)
            eng = BooleanEngine(lb, inv, li_cfg, ServeConfig(
                n_shards=2, device="cpu", cache_budget_bytes=6000, ranked=config))
            res = [eng.query_topk(q, 10), eng.query_topk(q, 10, required=req)]
        runs[prefetch] = (res, _decode_entries(eng), eng.metrics.snapshot(), counts)
    (got, entries, stats, counts), (want, entries0, stats0, _) = runs[True], runs[False]
    oracle = [brute_force_topk(inv, eng.impact_model, q, 10),
              brute_force_topk(inv, eng.impact_model, q, 10, required=req)]
    for batch, batch0, exact in zip(got, want, oracle):
        for g, w, e in zip(batch, batch0, exact):
            assert np.array_equal(g.ids, w.ids) and np.array_equal(g.scores, w.scores)
            assert np.array_equal(g.ids, e.ids) and np.array_equal(g.scores, e.scores)
    _same_entries(entries, entries0)
    assert stats["decode_cache"] == stats0["decode_cache"]
    # the multi-phase MaxScore loop decodes term by term; every other path
    # fetches its lists in batches
    batched = config.get("fused_kernel") or config.get("topk_exhaustive_cutoff", 1) > 0
    pre = stats["prefetch"]
    assert (pre["taken"] > 0) == bool(batched)
    # the prefetches decode only lists the batch reads; a fused batch
    # decodes no kernel-coded list one at a time
    assert counts["many"] == pre["decoded"] and pre["unused"] == 0
    assert pre["taken"] >= pre["decoded"]
    if config.get("fused_kernel"):
        assert counts["one"] == 0


def _learned_tier2(inv, terms, seed=41, universe=1 << 20):
    """A tier-2 store over ``inv``'s vocabulary whose lists for ``terms``
    are long and smooth (plm/rmi win) or, every fourth, random (a classical
    codec wins); every other term's list is empty."""
    from repro_torch.postings import HybridPostings

    rng = np.random.default_rng(seed)
    lists = [np.zeros(0, np.int32)] * inv.n_terms
    for i, t in enumerate(terms):
        n = 4000 // (i + 1) + 300
        if i % 4 == 3:
            ids = rng.choice(universe, n, replace=False)
        else:
            slope = int(rng.integers(16, 200))
            ids = int(rng.integers(0, universe // 2)) + np.arange(n) * slope \
                + rng.integers(0, slope // 4, n)
        lists[t] = np.unique(ids).astype(np.int32)
    offsets = np.zeros(inv.n_terms + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    return HybridPostings.build(offsets, np.concatenate(lists), universe), lists


@pytest.mark.parametrize("budget", [32 << 20, 6000], ids=["cached", "evicting"])
def test_learned_shard_verifies_each_round_in_one_guided_call(system, monkeypatch, budget):
    """A shard whose tier-2 holds learned-codec lists: ``_verify_batch``
    answers each round's guided items with one ``contains_many`` call, one
    guided_search launch (the plain version here), and gives the results,
    ``serving_stats()`` and decode-cache entries of the same batch answered
    item by item, and the results, guided accounting and decode-cache
    counters of verifying query after query."""
    from repro_torch.kernels.guided_search import kernel as guided_kernel
    from repro_torch.postings.search import GuidedPostings
    from repro_torch.serve.shard import ShardEngine

    _, inv, lb, li_cfg, *_ = system
    terms = [int(t) for t in np.argsort(-inv.dfs, kind="stable")[:12]]
    store, lists = _learned_tier2(inv, terms)
    assert {"plm", "rmi"} & set(store.codec_histogram())
    rng = np.random.default_rng(43)
    jobs = []
    for q in range(20):
        ts = sorted(rng.choice(terms, int(rng.integers(2, 6)), replace=False),
                    key=lambda t: len(lists[t]))
        cur = lists[ts[0]]
        for t in ts[1:]:
            cur = np.intersect1d(cur, lists[t])
        cands = np.union1d(np.union1d(cur, rng.choice(lists[ts[0]], 40)),
                           rng.integers(0, 1 << 20, 60)).astype(np.int32)
        routes = {int(ts[-1]): "decode"} if q % 5 == 4 else None
        jobs.append((tuple(int(t) for t in ts), cands, routes))
    exact = []
    for ts, cands, _ in jobs:
        for t in ts:
            cands = cands[np.isin(cands, lists[t])]
        exact.append(cands)

    def run(mode):
        calls = {"plain": 0, "guided": 0}
        with monkeypatch.context() as m:
            plain, many = guided_kernel.probe_ref, GuidedPostings.contains_many

            def counted_plain(*a):
                calls["plain"] += 1
                return plain(*a)

            def counted_many(self, items, queries=None):  # the calls that hold guided items
                calls["guided"] += any(self.route(t, len(c), h) == "guided" for t, c, h in items)
                if mode == "items":
                    return [many(self, [item])[0] for item in items]
                return many(self, items, queries=queries)

            m.setattr(guided_kernel, "probe_ref", counted_plain)
            m.setattr(GuidedPostings, "contains_many", counted_many)
            shard = ShardEngine(lb, inv, li_cfg, ServeConfig(device="cpu",
                                cache_budget_bytes=budget), tier2=store)
            if mode == "queries":
                res = [shard._verify_batch([job])[0] for job in jobs]
            else:
                res = shard._verify_batch(jobs)
        entries = [(k, v) for k, (v, _) in shard._decode_cache._entries.items()]
        return res, shard.serving_stats(), entries, calls

    (got, stats, entries, calls), (want, stats1, entries1, calls1), (got_q, stats_q, _, _) = (
        run("batch"), run("items"), run("queries"))
    for g, w, q, e in zip(got, want, got_q, exact):
        assert np.array_equal(g, e) and np.array_equal(w, e) and np.array_equal(q, e)
    assert stats == stats1 and stats["guided"]["guided_terms"] > 0
    assert stats["guided"]["routed_terms"] > 0 and stats["guided"]["fallback_terms"] > 0
    _same_entries([entries], [entries1])
    assert stats_q["guided"] == stats["guided"]
    assert stats_q["decode_cache"] == stats["decode_cache"]
    # one launch per round with guided items, at most one per term position
    assert 1 < calls["plain"] == calls["guided"] <= max(len(ts) for ts, _, _ in jobs)
    # item by item: one launch per guided item whose windows are not all empty
    assert stats["guided"]["guided_terms"] >= calls1["plain"] > calls["plain"]


# ------------------------------------------------------------ host pieces
@pytest.mark.parametrize("n_docs,k", [(400, 1), (400, 4), (1000, 3), (40, 4)])
def test_shard_ranges_and_bitmaps_match_reference(n_docs, k):
    assert shard_ranges(n_docs, k) == ref_shard_ranges(n_docs, k)
    ids = np.unique(np.random.default_rng(n_docs + k).integers(0, n_docs, n_docs // 3))
    words = pack_ids(ids, n_docs)
    assert np.array_equal(words, ref_pack_ids(ids, n_docs))
    assert np.array_equal(unpack_row(words, n_docs), ids)


def test_plan_queries_match_reference(system):
    *_, q = system
    dfs = np.random.default_rng(1).integers(0, 5, 1600)
    assert [vars(p) for p in plan_queries(q, dfs)] == [vars(p) for p in ref_plan_queries(q, dfs)]


def test_cost_lru_matches_reference():
    ops = np.random.default_rng(3).integers(0, 12, 200)
    a, b = CostLRU(100), RefCostLRU(100)
    for i, key in enumerate(ops):
        if i % 3:
            assert (a.get(int(key)) is None) == (b.get(int(key)) is None)
        else:
            a.put(int(key), key, int(key) * 3)
            b.put(int(key), key, int(key) * 3)
    assert a.stats() == b.stats()


# ------------------------------------------------------------ entry points
def test_launcher_runs_exact_on_cpu(capsys):
    serve_main(["--device", "cpu", "--docs", "300", "--terms", "1200", "--train-steps", "5",
                "--queries", "8", "--shards", "2"])
    out = capsys.readouterr().out
    assert "exact=8/8" in out and "false-negative rate 0.0" in out


def test_entry_points_default_to_cuda_and_raise_without_it(system, monkeypatch):
    _, inv, lb, li_cfg, *_ = system
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BooleanEngine(lb, inv, li_cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MembershipModel.init(li_cfg, 10, 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GuidedPostings(BooleanEngine(lb, inv, li_cfg, ServeConfig(device="cpu")).tier2)

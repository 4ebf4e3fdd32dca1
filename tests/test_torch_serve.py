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
    stats = eng.serving_stats()
    assert stats["guided"]["probes"] > 0 and len(stats["shards"]) == k
    mem, ref_mem = eng.memory_report(), ref.memory_report()
    for key in ("model_bits", "block_bitmap_bits", "tier2_bits", "backup_bits"):
        assert mem[key] == ref_mem[key], key


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

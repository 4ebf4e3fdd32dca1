"""The port's two-tier index (the paper's Algorithm 2) against the reference,
on the CPU at a small size.

Inputs are made with numpy from a seed and handed to both packages; the
membership weights reach the port through ``params_from_jax``, and both
engines serve the port's fitted thresholds.  Tolerances, and why:
  * truncated lists, unions, intersections, tier-1 tables and guarantees:
    exact (integers);
  * candidate bitmaps: equal except a bit whose logit lies within
    NUMERIC_MARGIN (1 + |tau|) of a query term's threshold, since the
    float32 products sum in different orders (XLA, BLAS, the plain
    version's gathered rows);
  * verified results: bit-identical to the reference engine's (candidates
    near tau are never answers: the margin lies below every positive).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import LearnedIndexConfig as RefLIConfig
from repro.core import algorithms as ref_alg
from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
from repro.index.build import truncate_index as ref_truncate
from repro.index.intersect import intersect_many as ref_intersect_many
from repro.index.intersect import padded_intersect as ref_padded_intersect
from repro.index.intersect import padded_union as ref_padded_union
from repro.serve import BooleanEngine as RefEngine, ServeConfig as RefServeConfig
from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core import algorithms as alg
from repro_torch.core.learned_bloom import NUMERIC_MARGIN, fit_thresholds
from repro_torch.core.membership import params_from_jax
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_conjunctions
from repro_torch.index.build import build_inverted_index, truncate_index
from repro_torch.index.intersect import INT32_MAX, intersect_many, padded_intersect, padded_union
from repro_torch.kernels.two_tier import kernel as two_tier_kernel
from repro_torch.kernels.two_tier.ref import tier1_union, two_tier_ref
from repro_torch.launch.serve import main as serve_main
from repro_torch.serve import BooleanEngine, ServeConfig

N_DOCS, N_TERMS, EMBED = 400, 1600, 16


@pytest.fixture(scope="module")
def system():
    corpus = synthesize_corpus(CorpusConfig(n_docs=N_DOCS, n_terms=N_TERMS, avg_doc_len=50,
                                            seed=31))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(9)
    params_np = {
        "term_embed": {"table": (rng.standard_normal((N_TERMS, EMBED)) * 0.3).astype(np.float32)},
        "doc_embed": {"table": (rng.standard_normal((N_DOCS, EMBED)) * 0.3).astype(np.float32)},
        "bias": np.float32(0.1),
    }
    model = params_from_jax(params_np, device="cpu")
    lb = fit_thresholds(model, inv)
    ref_params = {"term_embed": {"table": jnp.asarray(params_np["term_embed"]["table"])},
                  "doc_embed": {"table": jnp.asarray(params_np["doc_embed"]["table"])},
                  "bias": jnp.asarray(params_np["bias"])}
    ref_lb = RefLearnedBloom(params=ref_params, tau=lb.tau.numpy(),
                             backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    q = np.concatenate([sample_queries(corpus, 24, seed=8), zipf_conjunctions(inv.dfs, 16)])
    q = np.pad(q, ((0, 0), (0, 8 - q.shape[1])), constant_values=-1)
    q[5] = -1  # an all-pad query
    q[6, 1:] = -1  # a one-term query
    q[7, 1] = q[7, 0]  # a duplicate term
    logits = params_np["term_embed"]["table"].astype(np.float64) @ params_np["doc_embed"][
        "table"].astype(np.float64).T + float(params_np["bias"])
    return corpus, inv, lb, ref_lb, q, logits


def _bits(words: torch.Tensor, n: int) -> np.ndarray:
    w = words.numpy().view(np.uint32)
    return np.unpackbits(w.view(np.uint8), axis=-1, bitorder="little")[:, :n].astype(bool)


def _near(logits, tau, q, i, d) -> bool:
    """Does candidate bit (i, d) hang on a valid term's logit within the margin?"""
    terms = q[i][q[i] >= 0]
    return bool((np.abs(logits[terms, d] - tau[terms])
                 <= NUMERIC_MARGIN * (1 + np.abs(tau[terms]))).any())


# ------------------------------------------------------------ index pieces
@pytest.mark.parametrize("k", [1, 7, 64, 10_000])
def test_truncate_index_matches_reference(system, k):
    inv = system[1]
    got, want = truncate_index(inv, k), ref_truncate(inv, k)
    assert np.array_equal(got.term_offsets, want.term_offsets)
    assert got.doc_ids.dtype == want.doc_ids.dtype and np.array_equal(got.doc_ids, want.doc_ids)
    assert (got.n_docs, got.n_terms) == (want.n_docs, want.n_terms)


def _padded_lists(rng, n, m, pad):
    """(n, m) int32 rows, each sorted unique in its first lens[i] entries
    and ``pad`` after them -> (lists, lens)."""
    lens = rng.integers(0, m + 1, n).astype(np.int32)
    lists = np.full((n, m), pad, np.int32)
    for i, ln in enumerate(lens):
        lists[i, :ln] = np.sort(rng.choice(3 * m, ln, replace=False))
    return lists, lens


@pytest.mark.parametrize("seed", range(4))
def test_padded_union_and_intersect_match_reference(seed):
    """Unions over -1 and INT32_MAX padding (both out of the union), and
    intersections over rows padded past their ends with INT32_MAX (so each
    row stays sorted, where the reference's binary search is defined)."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(1, 6)), int(rng.integers(1, 40))
    for pad in (-1, INT32_MAX):
        lists, lens = _padded_lists(rng, n, m, pad)
        got, count = padded_union(torch.from_numpy(lists), torch.from_numpy(lens))
        want, want_count = ref_padded_union(jnp.asarray(lists), jnp.asarray(lens))
        assert int(count) == int(want_count)
        assert np.array_equal(got.numpy(), np.asarray(want))
    lists, lens = _padded_lists(rng, n, m, INT32_MAX)
    lists[1:, : m // 2] = np.sort(lists[1:, : m // 2])  # keep rows sorted
    lists[1:] = np.where(np.arange(m) < lens[1:, None], lists[1:], INT32_MAX)
    if n > 1:  # make some of row 0 common to every row
        common = lists[0, : lens[0] // 2]
        for i in range(1, n):
            row = np.union1d(lists[i, : lens[i]], common)[:m]
            lists[i, : len(row)], lens[i] = row, len(row)
    got = padded_intersect(torch.from_numpy(lists), torch.from_numpy(lens))
    want = ref_padded_intersect(jnp.asarray(lists), jnp.asarray(lens))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_intersect_many_matches_reference(system):
    inv = system[1]
    rng = np.random.default_rng(3)
    for _ in range(20):
        terms = rng.choice(np.nonzero(inv.dfs)[0], int(rng.integers(0, 5)), replace=False)
        lists = [inv.postings(int(t)) for t in terms]
        got, want = intersect_many(lists), ref_intersect_many(lists)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------------ Algorithm 2
@pytest.mark.parametrize("with_model", [True, False])
@pytest.mark.parametrize("k", [4, 16])
def test_two_tier_guaranteed_matches_reference(system, k, with_model):
    _, inv, *_, q, _ = system
    dfs = inv.dfs.astype(np.int32)
    got = alg.two_tier_guaranteed(dfs, q, k, with_model=with_model)
    want = np.asarray(ref_alg.two_tier_guaranteed(jnp.asarray(dfs), jnp.asarray(q), k,
                                                  with_model=with_model))
    assert got.dtype == bool and np.array_equal(got, want)
    assert 0 < got.sum() < len(q) and not got[5]


@pytest.mark.parametrize("k", [4, 16, 64])
def test_two_tier_candidates_match_reference(system, k):
    """run_queries(state, q, "two_tier"): the reference's dense mask packed,
    within the margin rule; its tier-1 table equals the reference's; the
    all-pad query has no bit and the tail bits of the last word are zero."""
    _, inv, lb, ref_lb, q, logits = system
    state = alg.build_engine(lb.model, lb.tau, inv, truncation_k=k, block_size=64)
    ref_state = ref_alg.build_engine(ref_lb.params, lb.tau.numpy(), inv, truncation_k=k,
                                     block_size=64)
    assert state._tier1 is None  # built at the first two-tier call
    words = alg.run_queries(state, q, "two_tier")
    assert np.array_equal(state.tier1.numpy(), np.asarray(ref_state.tier1))
    assert np.array_equal(state.tier1_len.numpy(), np.asarray(ref_state.tier1_len))
    assert np.array_equal(state.dfs, np.asarray(ref_state.dfs))
    assert state.tier1_bits == ref_state.tier1.size * 32
    assert words.shape == (len(q), -(-N_DOCS // 32))
    w = words.numpy().view(np.uint32)
    assert (w[:, -1] >> np.uint32(N_DOCS % 32)).max() == 0
    got = _bits(words, N_DOCS)
    want = ref_alg.run_queries(ref_state, q, "two_tier")
    assert not got[5].any() and got.any()
    tau = lb.tau.numpy()
    for i, d in np.argwhere(got != want):
        assert _near(logits, tau, q, i, d), (i, d)
    # never outside the union, and never a false negative where tier-1 covers
    union = tier1_union(state.tier1, state.tier1_len, torch.from_numpy(q), N_DOCS).numpy()
    assert not (got & ~union).any()
    guar = alg.two_tier_guaranteed(state.dfs, q, k, with_model=True)
    for i, ans in enumerate(brute_force_answers(system[0], q)):
        if guar[i]:
            assert got[i, ans].all()


def test_f_hat_docs_matches_reference(system):
    _, inv, lb, ref_lb, q, logits = system
    state = alg.build_engine(lb.model, lb.tau, inv, truncation_k=16, block_size=64)
    terms, docs = np.array([3, 17, 400, 1599]), np.arange(0, N_DOCS, 7)
    got = alg._f_hat_docs(state, torch.from_numpy(terms), torch.from_numpy(docs)).numpy()
    want = np.asarray(ref_alg._f_hat_docs(ref_lb.params, jnp.asarray(lb.tau.numpy()),
                                          jnp.asarray(terms), jnp.asarray(docs)))
    tau = lb.tau.numpy()
    for t, d in np.argwhere(got != want):
        gap = abs(logits[terms[t], docs[d]] - tau[terms[t]])
        assert gap <= NUMERIC_MARGIN * (1 + abs(tau[terms[t]]))


@pytest.mark.parametrize("k", [4, 16])
def test_plain_kernel_is_exhaustive_and_tier1_union(system, k):
    """The kernel's plain version is Algorithm 1's candidates ANDed with the
    tier-1 union (on the card, bit for bit; here within the margin rule,
    since the plain products are gathered-row sums and Algorithm 1's a
    matrix product), and the wrapper on CPU tensors is the plain version."""
    _, inv, lb, _, q, logits = system
    state = alg.build_engine(lb.model, lb.tau, inv, truncation_k=k, block_size=64)
    qt = torch.from_numpy(q)
    args = (state.tier1, state.tier1_len, qt, lb.model.term_embed.weight.detach(),
            lb.model.doc_embed.weight.detach(), lb.tau, float(lb.model.bias.detach()))
    got = two_tier_ref(*args)
    assert torch.equal(two_tier_kernel.two_tier_candidates(*args), got)
    assert two_tier_kernel.KERNEL.launches == 0  # CPU tensors never launch
    union = tier1_union(state.tier1, state.tier1_len, qt, N_DOCS).numpy()
    want = _bits(alg.exhaustive_query(state, q), N_DOCS) & union
    got = _bits(got, N_DOCS)
    tau = lb.tau.numpy()
    for i, d in np.argwhere(got != want):
        assert _near(logits, tau, q, i, d), (i, d)
    assert got.sum() > 0 and not got[5].any()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_verified_two_tier_engine_matches_reference(system, n_shards):
    """A verified two-tier engine: bit-identical to the reference engine's
    results and bitmaps, exact on every query guaranteed on every shard, a
    subset of the exact answer elsewhere; its memory report is the
    reference's, key for key."""
    corpus, inv, lb, ref_lb, q, _ = system
    li = LearnedIndexConfig(embed_dim=EMBED, truncation_k=16, block_size=64)
    ref_li = RefLIConfig(embed_dim=EMBED, truncation_k=16, block_size=64)
    eng = BooleanEngine(lb, inv, li, ServeConfig(algorithm="two_tier", n_shards=n_shards,
                                                 device="cpu"))
    ref = RefEngine(ref_lb, inv, ref_li, RefServeConfig(algorithm="two_tier", n_shards=n_shards))
    got, want = eng.query_batch(q), ref.query_batch(q)
    exact = brute_force_answers(corpus, q)
    guar = np.ones(len(q), bool)
    for sh in eng.shards:
        guar &= alg.two_tier_guaranteed(sh.state.dfs, q, 16, with_model=True)
    assert 0 < guar.sum() < len(q)
    n_short = 0
    for g, w, e, ok in zip(got, want, exact, guar):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.isin(g, e).all()
        if ok:
            assert np.array_equal(g, e)
        n_short += len(g) < len(e)
    assert n_short > 0  # some unguaranteed query does miss answers
    assert np.array_equal(eng.query_batch_bitmap(q), ref.query_batch_bitmap(q))
    assert eng.memory_report() == ref.memory_report()


def test_tier1_table_is_built_only_for_two_tier(system):
    """A block engine never builds the tier-1 table; its memory report
    counts it all the same, as the reference's does."""
    _, inv, lb, ref_lb, q, _ = system
    li = LearnedIndexConfig(embed_dim=EMBED, truncation_k=16, block_size=64)
    eng = BooleanEngine(lb, inv, li, ServeConfig(n_shards=2, device="cpu"))
    eng.query_batch(q)
    assert all(sh.state._tier1 is None for sh in eng.shards)
    assert eng.memory_report()["tier1_bits"] == 2 * N_TERMS * 16 * 32


def test_launcher_runs_two_tier_on_cpu(capsys):
    serve_main(["--device", "cpu", "--docs", "300", "--terms", "1200", "--train-steps", "5",
                "--queries", "16", "--shards", "2", "--algorithm", "two_tier", "--k", "16",
                "--topk", "0"])
    out = capsys.readouterr().out
    assert "queries guaranteed on every shard and exact" in out
    assert "false-negative rate 0.0" in out


def test_bench_batch_is_seeded_and_well_formed():
    """The two_tier bench's synthetic batch: the same seed gives the same
    arrays; each used term's tier-1 row holds its lowest ids, ascending and
    under D, padded with D; the plain version's candidates are a proper,
    nonempty subset of the tier-1 union."""
    from repro_torch.kernels.two_tier.bench import synthetic_batch

    shape = dict(D=3000, E=16, k=60, Q=12, T=8, n_terms=200)
    (tier1, lens, queries, te, de, tau), bias = synthetic_batch(5, **shape)
    again, bias2 = synthetic_batch(5, **shape)
    assert bias == bias2 and all(np.array_equal(a, b) for a, b in
                                 zip((tier1, lens, queries, te, de, tau), again))
    used = np.unique(queries[queries >= 0])
    assert len(used) and (lens[np.setdiff1d(np.arange(200), used)] == 0).all()
    for t in used:
        row = tier1[t, : lens[t]]
        assert 0 < lens[t] <= 60 and (np.diff(row) > 0).all() and row.max() < 3000
        assert (tier1[t, lens[t]:] == 3000).all()
    args = [torch.from_numpy(a) for a in (tier1, lens, queries, te, de, tau)]
    got = two_tier_ref(*args, bias).numpy().view(np.uint32)
    bits = np.unpackbits(got.view(np.uint8), axis=-1, bitorder="little")[:, :3000].astype(bool)
    union = tier1_union(args[0], args[1], args[2], 3000).numpy()
    assert not (bits & ~union).any() and bits.any() and (bits.sum() < union.sum())

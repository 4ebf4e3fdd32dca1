"""The port's MLP membership head against the reference, on the CPU at a
small size: the nn helpers, the head's logits, its candidates through
Algorithms 1-3 (``mlp_membership``'s plain version), its threshold fit, a
shard's slice and a process replica's spec.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:
  * nn helpers: 1e-6 absolute — float32 products and tanh-GELU evaluated by
    two libraries in different orders;
  * head logits: NUMERIC_MARGIN (1 + |logit|) — the slack the threshold fit
    reserves for exactly that drift (the port adds the first layer's halves
    where the reference multiplies the concatenated pair);
  * candidate masks: equal except a bit whose logit (the reference's, for
    some valid term of the query) lies within the margin of its threshold;
  * thresholds: the margin of the reference's; the false-negative rate is
    exactly 0.0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import nn as ref_nn
from repro.common.config import CorpusConfig as RefCorpusConfig
from repro.core import algorithms as ref_alg
from repro.core import membership as ref_membership
from repro.core.learned_bloom import fit_thresholds as ref_fit_thresholds
from repro.data.corpus import synthesize_corpus as ref_synthesize
from repro_torch.common import nn
from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
from repro_torch.core import algorithms as alg
from repro_torch.core import init_membership, pair_logits, params_from_jax, predict, term_doc_logits
from repro_torch.core.learned_bloom import NUMERIC_MARGIN, false_negative_rate, fit_thresholds
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.queries import brute_force_answers, sample_queries
from repro_torch.index.build import build_inverted_index
from repro_torch.kernels.membership.ops import score_terms_bitmask
from repro_torch.kernels.membership.ref import pack_bool_words
from repro_torch.kernels.mlp_membership.kernel import mlp_membership
from repro_torch.kernels.mlp_membership.ref import mlp_logits_ref, mlp_membership_ref
from repro_torch.kernels.two_tier.ref import tier1_union

CORPUS = dict(n_docs=400, n_terms=1600, avg_doc_len=50, seed=31)
EMBED = 16


def _params(head, seed=2):
    rng = np.random.default_rng(seed)
    p = {"term_embed": {"table": (rng.standard_normal((1600, EMBED)) * 0.3).astype(np.float32)},
         "doc_embed": {"table": (rng.standard_normal((400, EMBED)) * 0.3).astype(np.float32)},
         "bias": np.float32(0.1)}
    dims = [2 * EMBED, *head, 1]
    p["mlp"] = [{"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                 "b": (rng.standard_normal(o) * 0.1).astype(np.float32)}
                for i, o in zip(dims[:-1], dims[1:])]
    return p


def _ref(params_np):
    return jax.tree.map(jnp.asarray, params_np)


@pytest.fixture(scope="module")
def corpus():
    c = synthesize_corpus(CorpusConfig(**CORPUS))
    assert np.array_equal(c.term_ids, ref_synthesize(RefCorpusConfig(**CORPUS)).term_ids)
    return c


HEADS = [(24,), (24, 12)]


# ------------------------------------------------------------ nn helpers
def test_nn_helpers_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 3, 32)).astype(np.float32)
    layers = _params((24, 12))["mlp"]
    got = nn.mlp([{k: torch.from_numpy(v) for k, v in p.items()} for p in layers],
                 torch.from_numpy(x), act=nn.gelu)
    want = ref_nn.mlp(_ref(layers), jnp.asarray(x), act=jax.nn.gelu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the erf GELU is another function: the head must use the tanh one
    erf = nn.mlp([{k: torch.from_numpy(v) for k, v in p.items()} for p in layers],
                 torch.from_numpy(x), act=torch.nn.functional.gelu)
    assert np.abs(erf.numpy() - np.asarray(want)).max() > 1e-5
    scale = {"scale": rng.standard_normal(32).astype(np.float32)}
    ln = {"scale": rng.standard_normal(32).astype(np.float32),
          "bias": rng.standard_normal(32).astype(np.float32)}
    t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa: E731
    pairs = [
        (nn.rmsnorm(t(scale), torch.from_numpy(x)), ref_nn.rmsnorm(_ref(scale), jnp.asarray(x))),
        (nn.layernorm(t(ln), torch.from_numpy(x)), ref_nn.layernorm(_ref(ln), jnp.asarray(x))),
        (nn.softcap(torch.from_numpy(x), 2.5), ref_nn.softcap(jnp.asarray(x), 2.5)),
        (nn.dense(t(layers[0]), torch.from_numpy(x)), ref_nn.dense(_ref(layers[0]), jnp.asarray(x))),
        (nn.embed({"table": torch.from_numpy(x[0])}, torch.tensor([2, 0, 2])),
         ref_nn.embed({"table": jnp.asarray(x[0])}, jnp.asarray([2, 0, 2]))),
    ]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert nn.softcap(torch.from_numpy(x), None) is not None


def test_init_membership_layout():
    cfg = LearnedIndexConfig(embed_dim=8, mlp_hidden=(16, 4))
    m = init_membership(cfg, 50, 30, seed=3, device="cpu")
    assert [tuple(p["w"].shape) for p in m.mlp] == [(16, 16), (16, 4), (4, 1)]
    assert all(not p["b"].any() for p in m.mlp)
    again = init_membership(cfg, 50, 30, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))
    assert init_membership(LearnedIndexConfig(embed_dim=8), 50, 30, device="cpu").mlp is None
    t = torch.tensor([1, 2, 3])
    assert torch.equal(predict(m, t, t, threshold=0.0), pair_logits(m, t, t) >= 0.0)


# ------------------------------------------------------------ logits
@pytest.mark.parametrize("head", HEADS)
def test_head_logits_match_reference(head):
    params_np = _params(head)
    model = params_from_jax(params_np, device="cpu")
    rng = np.random.default_rng(7)
    t = rng.integers(0, 1600, 500).astype(np.int32)
    d = rng.integers(0, 400, 500).astype(np.int32)
    got = pair_logits(model, torch.from_numpy(t.astype(np.int64)),
                      torch.from_numpy(d.astype(np.int64))).detach().numpy()
    want = np.asarray(ref_membership.pair_logits(_ref(params_np), jnp.asarray(t), jnp.asarray(d)))
    assert (np.abs(got - want) <= NUMERIC_MARGIN * (1 + np.abs(want))).all()
    terms = np.array([0, 5, 77, 1599], np.int32)
    tile = np.arange(0, 400, 3, dtype=np.int32)
    got = term_doc_logits(model, torch.from_numpy(terms.astype(np.int64)),
                          torch.from_numpy(tile.astype(np.int64))).detach().numpy()
    want = np.asarray(ref_membership.term_doc_logits(_ref(params_np), jnp.asarray(terms),
                                                     jnp.asarray(tile)))
    assert got.shape == want.shape == (4, len(tile))
    assert (np.abs(got - want) <= NUMERIC_MARGIN * (1 + np.abs(want))).all()
    # the serving pieces: the plain kernel's logits are the model's
    bd, later, dims = model.doc_side()
    a = model.term_side(torch.from_numpy(terms.astype(np.int64)))
    plain = mlp_logits_ref(a, bd[torch.from_numpy(tile.astype(np.int64))], later, dims,
                           float(model.bias.detach()))
    assert (np.abs(plain.numpy() - want) <= NUMERIC_MARGIN * (1 + np.abs(want))).all()


def test_doc_side_cached_until_the_model_changes():
    model = params_from_jax(_params((24,)), device="cpu")
    first = model.doc_side()
    assert model.doc_side() is first
    with torch.no_grad():
        model.mlp[0]["b"].add_(1.0)
    second = model.doc_side()
    assert second is not first
    assert torch.allclose(second[0], first[0] + 1.0)


# ------------------------------------------------------------ Algorithms 1-3
def _queries(corpus):
    q = sample_queries(corpus, 24, seed=8, max_terms=4)
    q[3] = -1  # an all-pad query matches nothing
    q[4, 1:] = -1
    return np.pad(q, ((0, 0), (0, 2)), constant_values=-1)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("algorithm", ["block", "exhaustive", "two_tier"])
def test_head_candidates_match_reference(corpus, head, algorithm):
    """The head's candidates through the plain mlp_membership (one call a
    batch) against the reference's block_query, exhaustive_query and
    two_tier_query with the same head and thresholds."""
    params_np = _params(head)
    inv = build_inverted_index(corpus)
    model = params_from_jax(params_np, device="cpu")
    tau = fit_thresholds(model, inv).tau
    state = alg.build_engine(model, tau, inv, truncation_k=16, block_size=64)
    tau = tau.numpy()
    ref_state = ref_alg.build_engine(_ref(params_np), tau, inv, truncation_k=16, block_size=64)
    q = _queries(corpus)
    calls = []
    plain = alg.mlp_membership
    alg.mlp_membership = lambda *a: calls.append(a[0].shape[0]) or plain(*a)
    try:
        words = alg.run_queries(state, q, algorithm).numpy().view(np.uint32)
    finally:
        alg.mlp_membership = plain
    assert calls == [int((q >= 0).sum())]  # one call over the valid slots
    got = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    assert not got[:, inv.n_docs:].any()
    got = got[:, : inv.n_docs]
    want = ref_alg.run_queries(ref_state, q, algorithm)
    assert not got[3].any() and not want[3].any() and got[4].any()
    terms = np.unique(q[q >= 0])
    logits = np.full((1600, inv.n_docs), np.nan)
    logits[terms] = np.asarray(ref_membership.term_doc_logits(_ref(params_np),
                                                              jnp.asarray(terms)))
    margin = NUMERIC_MARGIN * (1 + np.abs(tau))
    differ = np.argwhere(got.astype(bool) != want)
    for i, d in differ:
        ts = q[i][q[i] >= 0]
        assert (np.abs(logits[ts, d] - tau[ts]) <= margin[ts]).any(), (i, d)
    covered = (alg.two_tier_guaranteed(state.dfs, q, 16, with_model=True)
               if algorithm == "two_tier" else np.ones(len(q), bool))
    assert covered.sum() > 2
    for i, ans in enumerate(brute_force_answers(corpus, q)):
        assert got[i, ans].all() or not covered[i]


def test_two_tier_with_head_is_exhaustive_and_union(corpus):
    inv = build_inverted_index(corpus)
    model = params_from_jax(_params((24,)), device="cpu")
    state = alg.build_engine(model, fit_thresholds(model, inv).tau, inv, truncation_k=16,
                             block_size=64)
    q = _queries(corpus)
    union = tier1_union(state.tier1, state.tier1_len, torch.from_numpy(q), inv.n_docs)
    assert torch.equal(alg.two_tier_query(state, q),
                       alg.exhaustive_query(state, q) & pack_bool_words(union))
    assert not union[3].any()
    for i, row in enumerate(q):  # the union, list by list
        ids = np.unique(np.concatenate([inv.postings(int(t))[:16] for t in row if t >= 0] or
                                       [np.zeros(0, np.int32)]))
        assert np.array_equal(np.nonzero(union[i].numpy())[0], ids)


@pytest.mark.parametrize("S,D,dims", [(5, 70, (24, 1)), (3, 33, (8, 6, 1))])
def test_plain_kernel_tiles_and_score_terms(S, D, dims):
    """The plain version over doc tiles (one doc a tile at the smallest
    size) equals one pass; score_terms_bitmask is that call for a head."""
    import repro_torch.kernels.mlp_membership.ref as ref

    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((S, dims[0])).astype(np.float32))
    bd = torch.from_numpy(rng.standard_normal((D, dims[0])).astype(np.float32))
    n = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    later = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    tau = torch.from_numpy(rng.standard_normal(S).astype(np.float32))
    whole = mlp_membership(a, bd, later, dims, tau, 0.1)
    saved = ref.TILE_FLOATS
    ref.TILE_FLOATS = 1
    try:
        tiled = mlp_membership_ref(a, bd, later, dims, tau, 0.1)
    finally:
        ref.TILE_FLOATS = saved
    assert torch.equal(whole, tiled)
    bits = np.unpackbits(whole.numpy().view(np.uint8), axis=-1, bitorder="little")
    assert not bits[:, D:].any()
    with pytest.raises(ValueError):
        mlp_membership(a, bd, later[:-1], dims, tau, 0.1)


def test_score_terms_bitmask_with_head_matches_reference_logits():
    params_np = _params((24,))
    model = params_from_jax(params_np, device="cpu")
    rng = np.random.default_rng(9)
    tau = torch.from_numpy(rng.standard_normal(1600).astype(np.float32) * 0.3)
    terms = torch.from_numpy(rng.integers(0, 1600, 45))
    bm = score_terms_bitmask(model, terms, tau).numpy().view(np.uint32)
    logits = np.asarray(ref_membership.term_doc_logits(_ref(params_np),
                                                       jnp.asarray(terms.numpy())))
    want = logits >= tau.numpy()[terms.numpy()][:, None]
    got = np.unpackbits(bm.view(np.uint8), axis=-1, bitorder="little")[:, :400].astype(bool)
    near = np.abs(logits - tau.numpy()[terms.numpy()][:, None]) <= NUMERIC_MARGIN * (
        1 + np.abs(tau.numpy()[terms.numpy()][:, None]))
    assert not ((got != want) & ~near).any()
    assert (bm[:, -1] >> np.uint32(400 % 32)).max() == 0


# ------------------------------------------------------------ thresholds
@pytest.mark.parametrize("head", HEADS)
def test_fit_thresholds_with_head_zero_fn(corpus, head):
    params_np = _params(head)
    inv = build_inverted_index(corpus)
    lb = fit_thresholds(params_from_jax(params_np, device="cpu"), inv, chunk=4096)
    assert false_negative_rate(lb, inv) == 0.0
    terms = np.unique(np.concatenate([np.argsort(inv.dfs)[::97], np.argsort(inv.dfs)[-4:]]))
    ref_tau = ref_fit_thresholds(_ref(params_np), inv, terms=terms).tau[terms]
    tau = lb.tau.numpy()[terms]
    assert np.array_equal(np.isinf(tau), np.isinf(ref_tau)) and np.isfinite(tau).any()
    fin = np.isfinite(ref_tau)
    assert (np.abs(tau[fin] - ref_tau[fin]) <= NUMERIC_MARGIN * (1 + np.abs(ref_tau[fin]))).all()
    # the default chunk (other product shapes) agrees within the margin;
    # size_bits leaves the head out
    other = fit_thresholds(lb.model, inv).tau.numpy()
    fin = np.isfinite(other)
    assert np.array_equal(fin, np.isfinite(lb.tau.numpy()))
    assert (np.abs(other[fin] - lb.tau.numpy()[fin]) <= NUMERIC_MARGIN * (1 + np.abs(other[fin]))).all()
    assert lb.size_bits() == (1600 + 400) * EMBED * 32 + 1600 * 32


# ------------------------------------------------------------ shards and workers
def test_slice_shares_the_head():
    model = params_from_jax(_params((24,)), device="cpu")
    sl = model.slice_docs(64, 160)
    assert all(a.data_ptr() == b.data_ptr() for p, q in zip(model.mlp, sl.mlp)
               for a, b in ((p["w"], q["w"]), (p["b"], q["b"])))
    assert sl.term_embed.weight.data_ptr() == model.term_embed.weight.data_ptr()
    t = torch.arange(20)
    d = torch.arange(20) % 96
    assert torch.allclose(pair_logits(sl, t, d), pair_logits(model, t, d + 64), rtol=0, atol=1e-6)


def test_worker_spec_round_trips_the_head(corpus, tmp_path):
    """A process replica's spec carries the head, and the shard a worker
    rebuilds from it (in this process, nothing spawned) serves exactly what
    the inline shard serves."""
    from repro_torch.serve import BooleanEngine, ServeConfig, Session
    from repro_torch.serve.sched.worker import _build_shard, execute_bool

    inv = build_inverted_index(corpus)
    lb = fit_thresholds(params_from_jax(_params((24, 12)), device="cpu"), inv)
    li = LearnedIndexConfig(embed_dim=EMBED, truncation_k=16, block_size=64, mlp_hidden=(24, 12))
    eng = BooleanEngine(lb, inv, li, ServeConfig(n_shards=2, device="cpu",
                                                 sched=dict(n_replicas=1)))
    q = eng._padded(_queries(corpus))
    with Session(eng, store_dir=str(tmp_path)) as s:
        specs = [r.spec for g in s._groups for r in g.replicas]
    assert len(specs) == 2
    for spec, sh in zip(specs, eng.shards):
        assert len(spec["mlp"]) == 3
        shard, _ = _build_shard(spec, {})
        for p, w in zip(shard.lb.model.mlp, sh.lb.model.mlp):
            assert torch.equal(p["w"], w["w"]) and torch.equal(p["b"], w["b"])
        got = execute_bool(shard, q, eng._global_dfs, True)
        want = execute_bool(sh, q, eng._global_dfs, True)
        assert np.array_equal(got, want)

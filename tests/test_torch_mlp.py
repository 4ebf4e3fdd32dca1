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
from repro_torch.kernels.mlp_membership.kernel import mlp_membership, mlp_two_tier
from repro_torch.kernels.mlp_membership.ref import (LiveBlocks, mlp_logits_ref,
                                                    mlp_membership_ref, mlp_two_tier_ref)
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
def _queries(corpus, seed=8):
    q = sample_queries(corpus, 24, seed=seed, max_terms=4)
    q[3] = -1  # an all-pad query matches nothing
    q[4, 1:] = -1
    return np.pad(q, ((0, 0), (0, 2)), constant_values=-1)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("algorithm", ["block", "exhaustive", "two_tier"])
def test_head_candidates_match_reference(corpus, head, algorithm):
    """The head's candidates through the plain mlp_membership kernels (one
    call a batch: Algorithm 1's rows, Algorithm 3's masked rows, Algorithm
    2's union scoring) against the reference's block_query,
    exhaustive_query and two_tier_query with the same head and thresholds."""
    _check_head_candidates(corpus, head, algorithm, seed=2)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("algorithm", ["block", "two_tier"])
def test_head_candidates_match_reference_second_seed(corpus, head, algorithm):
    """As above, with other weights and other queries."""
    _check_head_candidates(corpus, head, algorithm, seed=9)


def _check_head_candidates(corpus, head, algorithm, seed):
    params_np = _params(head, seed)
    inv = build_inverted_index(corpus)
    model = params_from_jax(params_np, device="cpu")
    tau = fit_thresholds(model, inv).tau
    state = alg.build_engine(model, tau, inv, truncation_k=16, block_size=64)
    tau = tau.numpy()
    ref_state = ref_alg.build_engine(_ref(params_np), tau, inv, truncation_k=16, block_size=64)
    q = _queries(corpus, seed + 6)
    calls = []
    rows, union = alg.mlp_membership, alg.mlp_two_tier
    alg.mlp_membership = lambda *a, **kw: calls.append(
        ("masked" if kw.get("live") is not None else "rows", a[0].shape[0])) or rows(*a, **kw)
    alg.mlp_two_tier = lambda *a, **kw: calls.append(("two_tier", a[4].shape[0])) or union(*a, **kw)
    try:
        words = alg.run_queries(state, q, algorithm).numpy().view(np.uint32)
    finally:
        alg.mlp_membership, alg.mlp_two_tier = rows, union
    entry = {"block": "masked", "exhaustive": "rows", "two_tier": "two_tier"}[algorithm]
    assert calls == [(entry, int((q >= 0).sum()))]  # one call over the valid slots
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


def _head_inputs(rng, S, D, dims):
    a = torch.from_numpy((rng.standard_normal((S, dims[0])) * 0.7).astype(np.float32))
    bd = torch.from_numpy((rng.standard_normal((D, dims[0])) * 0.7).astype(np.float32))
    n = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    later = torch.from_numpy((rng.standard_normal(n) * 0.3).astype(np.float32))
    logits = mlp_logits_ref(a, bd, later, dims, 0.05)
    tau = torch.quantile(logits, 0.3, dim=1).contiguous()
    return a, bd, later, tau


@pytest.mark.parametrize("block_size,dims", [(32, (24, 1)), (64, (24, 12, 1)), (1024, (16, 1))])
def test_masked_rows_are_full_rows_in_live_blocks(block_size, dims):
    """Algorithm 3's masked rows: the full rows in the words of blocks that
    survive the slot's query's block AND (pad terms all-ones, an all-pad
    query keeps none), zero words in dead ones."""
    rng = np.random.default_rng(block_size)
    D, Q, T = 2500, 6, 4
    words = -(-D // 32)
    Wb = -(-words // block_size)
    n_terms = 10
    table = rng.integers(0, 2 ** 32, (n_terms, Wb), dtype=np.uint64).astype(np.uint32)
    table |= rng.integers(0, 2 ** 32, (n_terms, Wb), dtype=np.uint64).astype(np.uint32)
    terms = rng.integers(0, n_terms, (Q, T)).astype(np.int32)
    terms[:, 2:] = -1
    terms[1, 1:] = -1
    terms[2] = -1  # keeps no block and has no slot
    flat = terms.reshape(-1)
    valid = np.nonzero(flat >= 0)[0]
    slot_query = (valid // T).astype(np.int32)
    a, bd, later, tau = _head_inputs(rng, len(valid), D, dims)
    live = LiveBlocks(torch.from_numpy(table.view(np.int32)), torch.from_numpy(terms),
                      torch.from_numpy(slot_query), block_size)
    full = mlp_membership(a, bd, later, dims, tau, 0.05).numpy().view(np.uint32)
    masked = mlp_membership(a, bd, later, dims, tau, 0.05, live=live).numpy().view(np.uint32)
    seen = set()
    for s, q in enumerate(slot_query):
        anded = np.bitwise_and.reduce(table[terms[q][terms[q] >= 0]], axis=0)
        blk = np.arange(words) // (block_size // 32)
        alive = (anded[blk // 32] >> (blk % 32).astype(np.uint32)) & 1 == 1
        assert np.array_equal(masked[s, alive], full[s, alive])
        assert not masked[s, ~alive].any()
        seen |= set(alive.tolist())
    assert seen == {True, False} and full.any()


def _union_batch(rng, D=700, n_terms=40, k=24, Q=10, T=8):
    """A tier-1 table and a batch of 1 to 8 valid slots a query, with an
    all-pad query, a query whose lists are empty (an empty union) and a
    repeated term."""
    tier1 = np.full((n_terms, k), D, np.int32)
    lens = rng.integers(0, k + 1, n_terms).astype(np.int32)
    lens[:2] = 0
    for t in range(n_terms):
        tier1[t, : lens[t]] = np.sort(rng.choice(D, lens[t], replace=False))
    queries = np.full((Q, T), -1, np.int32)
    for i in range(Q):
        n = 1 + i % T
        queries[i, :n] = rng.choice(np.arange(2, n_terms), n, replace=False)
    queries[1] = -1
    queries[2] = -1
    queries[2, :2] = [0, 1]  # both lists empty
    queries[3, 1] = queries[3, 0]
    flat = queries.reshape(-1)
    slots = np.full(Q * T, -1, np.int32)
    slots[flat >= 0] = np.arange(int((flat >= 0).sum()), dtype=np.int32)
    return tier1, lens, queries, slots.reshape(Q, T)


@pytest.mark.parametrize("dims", [(24, 1), (20, 12, 1)])
def test_sparse_plain_version_is_exhaustive_and_union(dims):
    """Algorithm 2 with a head, plain: the union's docs that pass every
    valid slot, i.e. the full rows ANDed over the query's slots and with
    the union (bits may differ only where a slot's logit lies within the
    margin of its tau: the two sum over different shapes)."""
    rng = np.random.default_rng(len(dims))
    tier1, lens, queries, slots = _union_batch(rng)
    S, D = int((queries >= 0).sum()), 700
    a, bd, later, tau = _head_inputs(rng, S, D, dims)
    t = [torch.from_numpy(x) for x in (tier1, lens, queries, slots)]
    got = mlp_two_tier(*t, a, bd, later, dims, tau, 0.05)
    assert torch.equal(got, mlp_two_tier_ref(*t, a, bd, later, dims, tau, 0.05))
    rows = mlp_membership(a, bd, later, dims, tau, 0.05)
    bits = lambda w: np.unpackbits(w.numpy().view(np.uint8), axis=-1,  # noqa: E731
                                   bitorder="little")[:, :D].astype(bool)
    row_bits = bits(rows)
    logits = mlp_logits_ref(a, bd, later, dims, 0.05).numpy()
    near = np.abs(logits - tau.numpy()[:, None]) <= NUMERIC_MARGIN * (1 + np.abs(tau.numpy()))[:, None]
    union = tier1_union(t[0], t[1], t[2], D).numpy()
    g = bits(got)
    for i in range(len(queries)):
        ss = slots[i][slots[i] >= 0]
        want = union[i] & (row_bits[ss].all(axis=0) if len(ss) else False)
        assert not ((g[i] != want) & ~near[ss].any(axis=0)).any(), i
    assert not g[1].any() and not g[2].any() and g.any()
    assert not union[2].any()


def test_gelu_form_of_the_kernel_is_within_a_tenth_of_the_margin():
    """The kernel's GELU with its constants as written in
    csrc/mlp_membership.cu (C1, C3, T_MAX), evaluated in float32 over [-30,
    30] against float64 tanh-GELU, within a tenth of NUMERIC_MARGIN (1 +
    |gelu|): the deep path's unit form x / (1 + 2^t), t = x (C1 + C3 x^2),
    and the shallow kernels' pair form x0 d1 / (d0 d1), d = 1 + 2^min(t,
    T_MAX), with each x paired with its mirror and with its neighbour.  For
    very negative x the unit form overflows 2^t and gives -0, GELU's limit;
    the pair form gives x 2^-T_MAX, negative and under 4e-18."""
    import re
    from pathlib import Path

    import repro_torch.kernels.cuda as cuda

    src = (Path(cuda.__file__).parent / "csrc" / "mlp_membership.cu").read_text()
    c1, c3, t_max = (np.float32(re.search(rf"constexpr float {n} = (-?[0-9.e-]+)f;", src).group(1))
                     for n in ("C1", "C3", "T_MAX"))
    assert c3 == np.float32(float(c1) * 0.044715)
    x = np.linspace(-30, 30, 600_001).astype(np.float32)
    x64 = x.astype(np.float64)
    want = 0.5 * x64 * (1 + np.tanh(np.sqrt(2 / np.pi) * (x64 + 0.044715 * x64 ** 3)))
    one = np.float32(1)
    with np.errstate(over="ignore"):
        t = x * (c3 * (x * x) + c1)
        unit = x * (one / (one + np.exp2(t)))
        assert np.isinf(np.exp2(t[0]))
        d = one + np.exp2(np.minimum(t, t_max))
        pairs = [x * ((one / (d * p)) * p) for p in (d[::-1], np.roll(d, 1))]
    for g in (unit, *pairs):
        assert g.dtype == np.float32
        assert (np.abs(g - want) <= 0.1 * NUMERIC_MARGIN * (1 + np.abs(want))).all()
        assert g[-1] == np.float32(30)
    assert unit[0] == 0 and np.signbit(unit[0])
    for g in pairs:
        low = g[x <= -10]
        assert (low < 0).all() and (np.abs(low) < 4e-18).all()


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

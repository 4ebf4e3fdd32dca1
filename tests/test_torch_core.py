"""The port's data layer, membership model, thresholds, training step and
Algorithms 1 and 3 against the reference, on the CPU at a small size.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:
  * logits: 1e-6 of the largest |logit| — both are float32 products whose
    sums run in different orders (torch vs XLA);
  * thresholds: NUMERIC_MARGIN (1 + |tau|), the slack the fit reserves for
    exactly that drift; the false-negative rate is exactly 0.0;
  * one AdamW step: 1e-5 relative (rtol) with an absolute floor of 1e-5 of
    the largest parameter — float32 gradients summed in different orders;
  * candidate masks: equal except a bit whose logit lies within the margin
    of its threshold.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import CorpusConfig as RefCorpusConfig
from repro.common.config import OptimizerConfig as RefOptConfig
from repro.core import algorithms as ref_alg
from repro.core import membership as ref_membership
from repro.core.learned_bloom import fit_thresholds as ref_fit_thresholds
from repro.data.corpus import synthesize_corpus as ref_synthesize
from repro.data.loader import membership_batches as ref_batches
from repro.data.queries import brute_force_answers as ref_brute_force
from repro.data.queries import sample_queries as ref_sample_queries
from repro.data.queries import zipf_conjunctions as ref_zipf
from repro.index.build import block_lists as ref_block_lists
from repro.index.build import build_inverted_index as ref_build_index
from repro.index.build import slice_index as ref_slice_index
from repro.train import init_train_state as ref_init_train, make_train_step as ref_make_step
from repro_torch.common.config import CorpusConfig, OptimizerConfig
from repro_torch.core import algorithms as alg
from repro_torch.core.learned_bloom import NUMERIC_MARGIN, false_negative_rate, fit_thresholds
from repro_torch.core.membership import membership_loss, params_from_jax, term_doc_logits
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.data.loader import membership_batches
from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_conjunctions
from repro_torch.index.build import block_lists, build_inverted_index, slice_index
from repro_torch.train import init_train_state, make_train_step

CORPUS = dict(n_docs=400, n_terms=1600, avg_doc_len=50, seed=31)
EMBED = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    corpus = synthesize_corpus(CorpusConfig(**CORPUS))
    ref_corpus = ref_synthesize(RefCorpusConfig(**CORPUS))
    rng = np.random.default_rng(2)
    params_np = {
        "term_embed": {"table": (rng.standard_normal((1600, EMBED)) * 0.3).astype(np.float32)},
        "doc_embed": {"table": (rng.standard_normal((400, EMBED)) * 0.3).astype(np.float32)},
        "bias": np.float32(0.1),
    }
    return corpus, ref_corpus, params_np


def _ref_params(params_np):
    return jax.tree.map(jnp.asarray, params_np)


# ------------------------------------------------------------ data layer
def test_corpus_index_and_blocks_match_reference(tiny):
    corpus, ref_corpus, _ = tiny
    for f in ("doc_offsets", "term_ids", "term_freqs"):
        assert np.array_equal(getattr(corpus, f), getattr(ref_corpus, f))
    inv, ref_inv = build_inverted_index(corpus), ref_build_index(ref_corpus)
    for f in ("term_offsets", "doc_ids", "tfs"):
        assert np.array_equal(getattr(inv, f), getattr(ref_inv, f))
    a, b = slice_index(inv, 96, 320), ref_slice_index(ref_inv, 96, 320)
    assert np.array_equal(a.term_offsets, b.term_offsets) and np.array_equal(a.doc_ids, b.doc_ids)
    for bs in (64, 100):
        (m, n), (rm, rn) = block_lists(inv, bs), ref_block_lists(ref_inv, bs)
        assert n == rn and np.array_equal(m, rm)


def test_queries_and_batches_match_reference(tiny):
    corpus, ref_corpus, _ = tiny
    q = sample_queries(corpus, 30, seed=8)
    assert np.array_equal(q, ref_sample_queries(ref_corpus, 30, seed=8))
    dfs = build_inverted_index(corpus).dfs
    z = zipf_conjunctions(dfs, 30)
    assert np.array_equal(z, ref_zipf(dfs, 30))
    for a, b in zip(brute_force_answers(corpus, q), ref_brute_force(ref_corpus, q)):
        assert np.array_equal(a, b)
    got = next(membership_batches(corpus, batch_size=256, replaced_terms=np.arange(40), seed=4))
    want = next(ref_batches(ref_corpus, batch_size=256, replaced_terms=np.arange(40), seed=4))
    assert all(np.array_equal(got[k], want[k]) for k in ("terms", "docs", "labels"))


# ------------------------------------------------------------ the model
def test_params_from_jax_logits(tiny):
    _, _, params_np = tiny
    model = params_from_jax(params_np, device="cpu")
    terms = np.array([0, 5, 77, 1599], np.int32)
    got = term_doc_logits(model, torch.from_numpy(terms.astype(np.int64))).detach().numpy()
    want = np.asarray(ref_membership.term_doc_logits(_ref_params(params_np), jnp.asarray(terms)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_fit_thresholds_within_margin_zero_fn(tiny):
    corpus, _, params_np = tiny
    inv = build_inverted_index(corpus)
    lb = fit_thresholds(params_from_jax(params_np, device="cpu"), inv)
    # the reference compiles its per-term fit once per list length: a sample
    # of terms (empty, rare and frequent ones) keeps this test short
    terms = np.unique(np.concatenate([np.argsort(inv.dfs)[::53], np.argsort(inv.dfs)[-8:]]))
    ref_tau = ref_fit_thresholds(_ref_params(params_np), inv, terms=terms).tau[terms]
    tau = lb.tau.numpy()[terms]
    assert np.isinf(ref_tau).any() and np.isfinite(ref_tau).any()
    assert np.array_equal(np.isinf(tau), np.isinf(ref_tau))
    fin = np.isfinite(ref_tau)
    assert (np.abs(tau[fin] - ref_tau[fin]) <= NUMERIC_MARGIN * (1 + np.abs(ref_tau[fin]))).all()
    assert false_negative_rate(lb, inv) == 0.0


@pytest.mark.parametrize("ocfg", [
    dict(lr=0.05, warmup_steps=20, total_steps=300, weight_decay=0.0),  # the launcher's
    dict(lr=0.01, warmup_steps=1, total_steps=10, weight_decay=0.1, grad_clip=0.05),
], ids=["launcher", "clipped"])
def test_train_steps_match_reference(tiny, ocfg):
    corpus, _, params_np = tiny
    model = params_from_jax(params_np, device="cpu")
    step = make_train_step(membership_loss, OptimizerConfig(**ocfg))
    st = init_train_state(model, OptimizerConfig(**ocfg))
    ref_step = jax.jit(ref_make_step(ref_membership.membership_loss, RefOptConfig(**ocfg)))
    params = _ref_params(params_np)
    ref_st = ref_init_train(params, RefOptConfig(**ocfg))
    batches = membership_batches(corpus, batch_size=512, seed=1)
    for _ in range(3):
        b = next(batches)
        m = step(model, st, {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
                             for k, v in b.items()})
        params, ref_st, ref_m = ref_step(params, ref_st, {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    for got, want in ((model.term_embed.weight, params["term_embed"]["table"]),
                      (model.doc_embed.weight, params["doc_embed"]["table"]),
                      (model.bias, params["bias"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------ algorithms
def _queries(corpus):
    q = sample_queries(corpus, 24, seed=8, max_terms=4)
    q[3] = -1  # an all-pad query matches nothing
    q[4, 1:] = -1
    return np.pad(q, ((0, 0), (0, 2)), constant_values=-1)


@pytest.mark.parametrize("algorithm", ["block", "exhaustive", "two_tier"])
def test_candidate_masks_match_reference(tiny, algorithm):
    corpus, _, params_np = tiny
    inv = build_inverted_index(corpus)
    model = params_from_jax(params_np, device="cpu")
    tau = fit_thresholds(model, inv).tau  # both engines get the same thresholds
    state = alg.build_engine(model, tau, inv, truncation_k=16, block_size=64)
    tau = tau.numpy()
    ref_state = ref_alg.build_engine(_ref_params(params_np), tau, inv,
                                     truncation_k=16, block_size=64)
    q = _queries(corpus)
    words = alg.run_queries(state, q, algorithm).numpy().view(np.uint32)
    got = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")[:, : inv.n_docs]
    want = ref_alg.run_queries(ref_state, q, algorithm)
    assert not got[3].any() and not want[3].any()
    # a differing bit must hang on some query term's logit within the margin
    logits = params_np["term_embed"]["table"].astype(np.float64) @ params_np["doc_embed"][
        "table"].astype(np.float64).T + float(params_np["bias"])
    margin = NUMERIC_MARGIN * (1 + np.abs(tau))
    for i, d in np.argwhere(got.astype(bool) != want):
        terms = q[i][q[i] >= 0]
        assert (np.abs(logits[terms, d] - tau[terms]) <= margin[terms]).any(), (i, d)
    # zero false negatives: every exact answer is a candidate (for two_tier,
    # of the queries whose tier-1 lists cover their answers)
    covered = (alg.two_tier_guaranteed(state.dfs, q, 16, with_model=True)
               if algorithm == "two_tier" else np.ones(len(q), bool))
    assert covered.sum() > 2
    for i, ans in enumerate(brute_force_answers(corpus, q)):
        assert got[i, ans].all() or not covered[i]


@pytest.mark.parametrize("block_size", [32, 128])
def test_block_step_matches_reference_block_query(tiny, block_size, monkeypatch):
    """Algorithm 3 through the fused block step (one masked membership call,
    which scores only each slot's live blocks, and one block_candidates
    call; no dense membership call) at two more block sizes, 400 docs (off
    a word edge), an all-pad query (3) and a one-term query (4): within the
    margin of the reference's block_query, zero false negatives, and bit
    for bit the composition it replaces (Algorithm 1's AND over the terms,
    from one dense membership call, masked by the expanded
    bitset_and_popcount of the block bitmaps)."""
    from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref

    calls = {"dense": 0, "masked": 0}
    scored = alg.membership_bitmask

    def counted(*args, live=None):
        calls["masked" if live is not None else "dense"] += 1
        return scored(*args, live=live)

    monkeypatch.setattr(alg, "membership_bitmask", counted)
    corpus, _, params_np = tiny
    inv = build_inverted_index(corpus)
    model = params_from_jax(params_np, device="cpu")
    tau = fit_thresholds(model, inv).tau
    state = alg.build_engine(model, tau, inv, truncation_k=16, block_size=block_size)
    ref_state = ref_alg.build_engine(_ref_params(params_np), tau.numpy(), inv,
                                     truncation_k=16, block_size=block_size)
    q = _queries(corpus)
    words = alg.run_queries(state, q, "block").numpy().view(np.uint32)
    assert calls == {"dense": 0, "masked": 1}
    got = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    assert not got[:, inv.n_docs:].any()
    got = got[:, : inv.n_docs]
    want = ref_alg.run_queries(ref_state, q, "block")
    assert not got[3].any() and not want[3].any() and got[4].any()
    logits = params_np["term_embed"]["table"].astype(np.float64) @ params_np["doc_embed"][
        "table"].astype(np.float64).T + float(params_np["bias"])
    margin = NUMERIC_MARGIN * (1 + np.abs(tau.numpy()))
    for i, d in np.argwhere(got.astype(bool) != want):
        terms = q[i][q[i] >= 0]
        assert (np.abs(logits[terms, d] - tau.numpy()[terms]) <= margin[terms]).any(), (i, d)
    for i, ans in enumerate(brute_force_answers(corpus, q)):
        assert got[i, ans].all()
    qt = torch.from_numpy(q.astype(np.int64))
    inter, _ = bitset_and_popcount_ref(state.block_bitmaps[qt.clamp(min=0)],
                                       (qt >= 0).to(torch.int32))
    wb = torch.arange(words.shape[1]) * 32 // block_size
    expand = -((inter[:, wb // 32] >> (wb % 32).to(torch.int32)) & 1)
    composed = (alg.exhaustive_query(state, q) & expand).numpy().view(np.uint32)
    assert calls == {"dense": 1, "masked": 1}
    assert np.array_equal(words, composed)


# ------------------------------------------------------------ isolation
def test_port_imports_neither_jax_nor_reference():
    """Every module of the port imports with jax and repro made unimportable."""
    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
ranked = {"repro_torch.rank.score", "repro_torch.rank.topk", "repro_torch.kernels.arena",
          "repro_torch.kernels.pfor.ops", "repro_torch.kernels.bm25_score.ops",
          "repro_torch.kernels.fused_query.ops", "repro_torch.kernels.fused_query.dense"}
assert ranked <= set(mods), ranked - set(mods)
two_tier = {"repro_torch.index.store", "repro_torch.index.intersect",
            "repro_torch.kernels.two_tier.kernel", "repro_torch.kernels.two_tier.ref",
            "repro_torch.kernels.two_tier.bench"}
assert two_tier <= set(mods), two_tier - set(mods)
tuned = {"repro_torch.kernels.autotune", "repro_torch.kernels.fused_query.dense",
         "repro_torch.kernels.fused_query.ref"}
assert tuned <= set(mods), tuned - set(mods)
obs = {"repro_torch.obs." + m for m in ("metrics", "trace", "probelog", "slo", "export",
                                        "collate")}
sched = {"repro_torch.serve.sched." + m for m in ("api", "admission", "replica", "worker",
                                                  "session")}
assert obs | sched | {"repro_torch.obs", "repro_torch.serve.sched"} <= set(mods), \
    (obs | sched) - set(mods)
slice10 = {"repro_torch.core.gain", "repro_torch.common.nn", "repro_torch.kernels.bitset.ops",
           "repro_torch.kernels.membership.ops", "repro_torch.kernels.mlp_membership.kernel",
           "repro_torch.kernels.mlp_membership.ref", "repro_torch.kernels.mlp_membership.bench",
           "repro_torch.launch.quickstart", "repro_torch.launch.product_search"}
assert slice10 <= set(mods), slice10 - set(mods)
mesh = {"repro_torch.distributed." + m for m in ("comm", "compression", "collective_matmul",
                                                 "pipeline")}
mesh |= {"repro_torch.distributed", "repro_torch.models.moe_a2a", "repro_torch.launch.mesh",
         "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_learned_index"}
assert mesh <= set(mods), mesh - set(mods)
print(len(mods))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 56

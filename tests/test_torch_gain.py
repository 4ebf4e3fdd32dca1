"""The port's storage analysis (core/gain.py), false-positive rate and the
reference's public ops wrappers, against the reference on the CPU.

Gain reports and curves are integers and fractions of integers: equal, to
the float.  ``false_positive_rate`` draws the reference's samples in its
order: equal for the same bloom weights, thresholds and seed.  The bitset
wrapper's words are equal bit for bit; the membership wrapper's bits may
differ only where the logit lies within NUMERIC_MARGIN of tau (float32
products summed in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import CorpusConfig as RefCorpusConfig
from repro.common.config import PAPER_COLLECTIONS as REF_COLLECTIONS
from repro.common.config import TrainConfig as RefTrainConfig
from repro.common.config import scaled_collection as ref_scaled
from repro.core import gain as ref_gain
from repro.core.learned_bloom import LearnedBloom as RefLearnedBloom
from repro.core.learned_bloom import false_positive_rate as ref_fpr
from repro.data.corpus import synthesize_corpus as ref_synthesize
from repro.index.build import build_inverted_index as ref_build_index
from repro.kernels.bitset.ops import query_block_intersect as ref_query_block_intersect
from repro.kernels.membership.ops import score_terms_bitmask as ref_score_terms_bitmask
from repro_torch.common.config import PAPER_COLLECTIONS, CorpusConfig, TrainConfig, scaled_collection
from repro_torch.core import (
    estimate_gain,
    false_positive_rate,
    fit_thresholds,
    gain_curve,
    learned_storage_fractions,
    params_from_jax,
    storage_fraction_curve,
)
from repro_torch.core.gain import avg_size_for_length
from repro_torch.core.learned_bloom import NUMERIC_MARGIN
from repro_torch.data.corpus import synthesize_corpus
from repro_torch.index.build import build_inverted_index
from repro_torch.kernels.bitset.ops import query_block_intersect
from repro_torch.kernels.membership.ops import score_terms_bitmask

CORPUS = dict(n_docs=500, n_terms=900, avg_doc_len=40, seed=13)


@pytest.fixture(scope="module")
def indexes():
    inv = build_inverted_index(synthesize_corpus(CorpusConfig(**CORPUS)))
    ref = ref_build_index(ref_synthesize(RefCorpusConfig(**CORPUS)))
    assert np.array_equal(inv.doc_ids, ref.doc_ids)
    return inv, ref


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("gain_upper_frac", "gain_lower_frac"):
        if hasattr(a, prop):
            assert getattr(a, prop) == getattr(b, prop)


@pytest.mark.parametrize("codec,k", [("optpfd", 8), ("optpfd", 48), ("eliasfano", 31),
                                     ("varbyte", 200)])
def test_estimate_gain_equals_reference(indexes, codec, k):
    inv, ref = indexes
    _same(estimate_gain(inv, k, codec=codec), ref_gain.estimate_gain(ref, k, codec=codec))


def test_gain_curve_and_storage_fractions_equal_reference(indexes):
    inv, ref = indexes
    for a, b in zip(gain_curve(inv, [4, 16, 64, 10_000]),
                    ref_gain.gain_curve(ref, [4, 16, 64, 10_000]), strict=True):
        _same(a, b)
    for a, b in zip(learned_storage_fractions(inv, (7, 63)),
                    ref_gain.learned_storage_fractions(ref, (7, 63)), strict=True):
        _same(a, b)
    cum, n = storage_fraction_curve(inv)
    ref_cum, ref_n = ref_gain.storage_fraction_curve(ref)
    assert np.array_equal(cum, ref_cum) and np.array_equal(n, ref_n)
    sizes = np.array([5.0, 7.0, 9.0, 11.0])
    dfs = np.array([3, 4, 4, 9])
    for k in (4, 5, 100):
        assert avg_size_for_length(sizes, dfs, k) == ref_gain.avg_size_for_length(sizes, dfs, k)


@pytest.mark.parametrize("head", [(), (16,)])
def test_false_positive_rate_equals_reference(indexes, head):
    inv, ref = indexes
    rng = np.random.default_rng(3)
    params = {"term_embed": {"table": (rng.standard_normal((900, 8)) * 0.4).astype(np.float32)},
              "doc_embed": {"table": (rng.standard_normal((500, 8)) * 0.4).astype(np.float32)},
              "bias": np.float32(0.2)}
    if head:
        params["mlp"] = [{"w": (rng.standard_normal((16, 16)) / 4).astype(np.float32),
                          "b": np.zeros(16, np.float32)},
                         {"w": (rng.standard_normal((16, 1)) / 4).astype(np.float32),
                          "b": np.zeros(1, np.float32)}]
    lb = fit_thresholds(params_from_jax(params, device="cpu"), inv)
    ref_lb = RefLearnedBloom(params=jax.tree.map(jnp.asarray, params), tau=lb.tau.numpy(),
                             backup_keys=np.zeros(0, np.int64), n_docs=inv.n_docs)
    for seed in (0, 5):
        got, want = false_positive_rate(lb, inv, sample=3000, seed=seed), \
            ref_fpr(ref_lb, ref, sample=3000, seed=seed)
        assert got == want and 0.0 < got < 1.0


def test_query_block_intersect_equals_reference_words():
    rng = np.random.default_rng(6)
    for w in (70, 1024, 1030):
        bitmaps = rng.integers(0, 2**32, size=(40, w), dtype=np.uint64).astype(np.uint32)
        queries = np.array([[1, 5, -1, -1], [7, -1, -1, -1], [2, 3, 11, 39], [-1, -1, -1, -1]],
                           np.int32)
        anded, cnt = query_block_intersect(torch.from_numpy(bitmaps.view(np.int32)),
                                           torch.from_numpy(queries))
        ref_anded, ref_cnt = ref_query_block_intersect(jnp.asarray(bitmaps), jnp.asarray(queries))
        assert np.array_equal(anded.numpy().view(np.uint32), np.asarray(ref_anded))
        assert np.array_equal(cnt.numpy(), np.asarray(ref_cnt))


def test_score_terms_bitmask_equals_reference_words():
    rng = np.random.default_rng(8)
    params = {"term_embed": {"table": rng.standard_normal((300, 48)).astype(np.float32)},
              "doc_embed": {"table": rng.standard_normal((1111, 48)).astype(np.float32)},
              "bias": np.float32(0.05)}
    tau = rng.standard_normal(300).astype(np.float32)
    terms = rng.integers(0, 300, 45).astype(np.int32)
    got = score_terms_bitmask(params_from_jax(params, device="cpu"),
                              torch.from_numpy(terms), torch.from_numpy(tau)).numpy()
    want = np.asarray(ref_score_terms_bitmask(jax.tree.map(jnp.asarray, params),
                                              jnp.asarray(terms), jnp.asarray(tau)))
    assert got.shape == want.shape == (45, 35)
    differ = np.unpackbits((got.view(np.uint32) ^ want).view(np.uint8), axis=-1,
                           bitorder="little")[:, :1111].astype(bool)
    logits = params["term_embed"]["table"][terms].astype(np.float64) @ \
        params["doc_embed"]["table"].astype(np.float64).T + 0.05
    near = np.abs(logits - tau[terms][:, None]) <= NUMERIC_MARGIN * (1 + np.abs(tau[terms][:, None]))
    assert not (differ & ~near).any()
    assert (got.view(np.uint32)[:, -1] >> np.uint32(1111 % 32)).max() == 0


def test_collections_and_train_config_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in PAPER_COLLECTIONS.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_COLLECTIONS.items()}
    for scale in (1.0, 0.01, 1e-6):
        assert dataclasses.asdict(scaled_collection(PAPER_COLLECTIONS["gov2"], scale)) == \
            dataclasses.asdict(ref_scaled(REF_COLLECTIONS["gov2"], scale))
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(RefTrainConfig())

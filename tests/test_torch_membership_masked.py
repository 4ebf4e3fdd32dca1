"""Algorithm 3's masked membership rows on the CPU, against the reference.

The port's masked plain version (``membership_bitmask`` with ``live`` on a
CPU tensor) must equal its dense plain version in the words of live blocks
and be zero in the others, and agree with the reference: the Pallas
membership kernel in interpret mode (``score_terms_bitmask``) masked by the
reference's block AND (``bitset_and_ref``) over each slot's query, bit for
bit except where a logit lies within NUMERIC_MARGIN * (1 + |tau|) of tau
(the two float32 products sum in different orders).  Inputs are made with
numpy from a seed: 1,111 docs (off a word and a block edge), 45 slots in 12
queries of 1 to 5 terms, E = 48.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitset.ref import bitset_and_ref
from repro.kernels.membership.ops import score_terms_bitmask as ref_score_terms
from repro_torch.core.learned_bloom import NUMERIC_MARGIN
from repro_torch.kernels.membership.kernel import _pieces, membership_bitmask
from repro_torch.kernels.membership.ref import LiveBlocks, live_words

N_DOCS, N_TERMS, E, Q, T = 1111, 300, 48, 12, 5


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(27)
    te = (rng.standard_normal((N_TERMS, E)) * 0.3).astype(np.float32)
    de = (rng.standard_normal((N_DOCS, E)) * 0.3).astype(np.float32)
    tau_all = (rng.standard_normal(N_TERMS) * 0.3).astype(np.float32)
    queries = np.full((Q, T), -1, np.int32)
    for i in range(Q):
        n = int(rng.integers(1, T + 1))
        queries[i, rng.choice(T, n, replace=False)] = rng.choice(N_TERMS, n, replace=False)
    flat = queries.reshape(-1)
    valid = np.nonzero(flat >= 0)[0]
    slot_terms = flat[valid]
    params = {"term_embed": {"table": jnp.asarray(te)}, "doc_embed": {"table": jnp.asarray(de)},
              "bias": jnp.float32(0.0)}
    want_dense = np.asarray(ref_score_terms(params, jnp.asarray(slot_terms), jnp.asarray(tau_all)))
    logits = te[slot_terms].astype(np.float64) @ de.astype(np.float64).T
    tau = tau_all[slot_terms]
    near = np.abs(logits - tau[:, None]) <= NUMERIC_MARGIN * (1 + np.abs(tau[:, None]))
    return dict(q=torch.from_numpy(te[slot_terms]), d=torch.from_numpy(de),
                tau=torch.from_numpy(tau), queries=queries,
                slot_query=(valid // T).astype(np.int32), want_dense=want_dense, near=near)


def _bits(words: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1,
                         bitorder="little")[:, :N_DOCS].astype(bool)


@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("block_size", [32, 96, 1024])
def test_masked_plain_matches_dense_and_reference(batch, block_size, density):
    rng = np.random.default_rng(block_size + int(10 * density))
    n_blocks = -(-N_DOCS // block_size)
    wb = -(-n_blocks // 32)
    table = np.packbits(rng.random((N_TERMS, wb * 32)) < density, axis=1,
                        bitorder="little").view(np.uint32)
    live = LiveBlocks(torch.from_numpy(table.view(np.int32)), torch.from_numpy(batch["queries"]),
                      torch.from_numpy(batch["slot_query"]), block_size)
    got = membership_bitmask(batch["q"], batch["d"], batch["tau"], 0.0, live=live)
    dense = membership_bitmask(batch["q"], batch["d"], batch["tau"], 0.0)
    words = got.shape[1]
    alive = live_words(live, words)
    assert torch.equal(got, torch.where(alive, dense, torch.zeros_like(dense)))

    # the reference's block AND of each slot's query, expanded to words
    anded = np.stack([np.asarray(bitset_and_ref(jnp.asarray(table[np.maximum(row, 0)]),
                                                jnp.asarray(row >= 0)))
                      for row in batch["queries"]])
    blk = np.arange(words) * 32 // block_size
    alive_ref = ((anded[:, blk // 32] >> (blk % 32).astype(np.uint32)) & 1).astype(bool)
    alive_ref = alive_ref[batch["slot_query"]]
    assert np.array_equal(alive.numpy(), alive_ref)
    want = np.where(alive_ref, batch["want_dense"], np.uint32(0))
    got = got.numpy().view(np.uint32)
    assert not got[~alive_ref].any()
    assert not (_bits(got ^ want) & ~batch["near"]).any()
    if density == 0.0:
        assert not alive_ref.any()
    elif density == 1.0:
        assert alive_ref.all() and np.array_equal(got, dense.numpy().view(np.uint32))
    else:
        assert alive_ref.any() and not alive_ref.all() and got.any()


@pytest.mark.parametrize("e,dtype,padded", [(48, torch.float32, 48), (50, torch.float32, 52),
                                            (50, torch.bfloat16, 56), (128, torch.bfloat16, 128)])
def test_rows_padded_to_whole_pieces(e, dtype, padded):
    """The wrapper's rows are whole 16-byte pieces: E padded with zero dims
    (4 floats, or 8 bf16 values, a piece), which leave every product as it
    was, and an unaligned table copied to an aligned one."""
    rng = np.random.default_rng(e)
    q = torch.from_numpy(rng.standard_normal((5, e)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((9, e + 1)).astype(np.float32))[:, 1:].to(dtype)
    d = d.contiguous()[1:]  # rows off the allocation's 16-byte edge
    qp, dp = _pieces(q, d)
    assert qp.shape[1] == dp.shape[1] == padded and dp.dtype == dtype
    assert dp.data_ptr() % 16 == 0 and qp.data_ptr() % 16 == 0
    assert torch.equal(qp[:, :e], q) and torch.equal(dp[:, :e], d)
    assert not qp[:, e:].any() and not dp[:, e:].any()

"""The port's four kernels against the reference's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the reference
kernels run in Pallas interpret mode, as the reference's own tests run them.
Same inputs, made with numpy from a seed, go to both.  Bitset words and
counts, probe verdicts and decoded ids must be exactly equal.  Membership
bits must be equal too, except a bit whose logit lies within
NUMERIC_MARGIN * (1 + |tau|) of tau: the two float32 products sum in
different orders, and that margin is what the thresholds reserve for it.

tests/test_torch_cuda.py holds each CUDA kernel against its plain version on
a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitset.kernel import W_BLK, bitset_and_popcount as ref_bitset
from repro.kernels.guided_search.kernel import probe_batch as ref_probe
from repro.kernels.membership.kernel import D_BLK, Q_BLK, membership_bitmask as ref_membership
from repro.kernels.membership.ops import score_terms_bitmask as ref_score_terms
from repro.kernels.plm_decode.kernel import decode_batch as ref_decode
from repro.kernels.plm_decode.ref import SENTINEL
from repro.postings.plm import parse_stream as ref_parse_stream, plm_encode as ref_plm_encode
from repro.postings.rmi import rmi_encode as ref_rmi_encode
from repro_torch.core.learned_bloom import NUMERIC_MARGIN
from repro_torch.kernels.bitset.kernel import bitset_and_popcount
from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref
from repro_torch.kernels.guided_search.kernel import probe_batch
from repro_torch.kernels.guided_search.ref import probe_ref
from repro_torch.kernels.membership.kernel import membership_bitmask
from repro_torch.kernels.membership.ref import membership_bitmask_ref, pack_bool_words
from repro_torch.kernels.plm_decode.kernel import decode_batch
from repro_torch.kernels.plm_decode.ref import decode_ref


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _unpack(words: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1,
                         bitorder="little")[:, :n].astype(bool)


def _membership_inputs(rng, q, d, e):
    qe = (rng.standard_normal((q, e)) * 0.5).astype(np.float32)
    de = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    tau = rng.standard_normal(q).astype(np.float32)
    # a few thresholds exactly on a logit: the comparison's boundary case
    logits = qe.astype(np.float64) @ de.astype(np.float64).T
    tau[: q // 4] = logits[np.arange(q // 4), rng.integers(0, d, q // 4)].astype(np.float32)
    return qe, de, tau, np.float32(0.05)


def _assert_bits_within_margin(got: np.ndarray, want: np.ndarray, qe, de, tau, bias, n_docs):
    """Bits may differ only within the thresholds' numerical margin."""
    logits = qe.astype(np.float64) @ de.astype(np.float64).T + float(bias)
    near = np.abs(logits - tau[:, None]) <= NUMERIC_MARGIN * (1 + np.abs(tau[:, None]))
    differ = _unpack(got ^ want, n_docs)
    assert not (differ & ~near).any()
    return int(differ.sum())


# ----------------------------------------------------------- membership
@pytest.mark.parametrize("q_tiles,d_tiles,e", [(1, 1, 16), (2, 1, 64), (1, 2, 128)])
def test_membership_plain_matches_pallas(q_tiles, d_tiles, e):
    rng = np.random.default_rng(100 + e)
    qe, de, tau, bias = _membership_inputs(rng, Q_BLK * q_tiles, D_BLK * d_tiles, e)
    want = np.asarray(ref_membership(jnp.asarray(qe), jnp.asarray(de), jnp.asarray(tau),
                                     jnp.asarray(bias), interpret=True))
    got = _words(membership_bitmask(_t(qe), _t(de), _t(tau), float(bias)))
    assert got.shape == want.shape
    _assert_bits_within_margin(got, want, qe, de, tau, bias, de.shape[0])


def test_membership_ragged_matches_reference_ops():
    """Ragged Q and D: the reference pads (tau=+inf rows, 512-doc tiles) and
    masks the tail word; the port's wrapper returns the same words."""
    rng = np.random.default_rng(7)
    te = rng.standard_normal((300, 48)).astype(np.float32)
    de = rng.standard_normal((1111, 48)).astype(np.float32)
    tau_all = rng.standard_normal(300).astype(np.float32)
    terms = rng.integers(0, 300, 45).astype(np.int32)
    params = {"term_embed": {"table": jnp.asarray(te)}, "doc_embed": {"table": jnp.asarray(de)},
              "bias": jnp.float32(0.0)}
    want = np.asarray(ref_score_terms(params, jnp.asarray(terms), jnp.asarray(tau_all)))
    got = _words(membership_bitmask(_t(te[terms]), _t(de), _t(tau_all[terms]), 0.0))
    assert got.shape == want.shape == (45, 35)
    assert (got[:, -1] >> np.uint32(1111 % 32)).max() == 0  # tail bits zero
    _assert_bits_within_margin(got, want, te[terms], de, tau_all[terms], 0.0, 1111)


def test_pack_bool_words_little_endian():
    bits = np.random.default_rng(3).integers(0, 2, size=(7, 101)).astype(bool)
    words = _words(pack_bool_words(_t(bits)))
    assert words.shape == (7, 4)
    assert np.array_equal(_unpack(words, 101), bits)
    assert (words[:, -1] >> np.uint32(101 % 32)).max() == 0


# ----------------------------------------------------------- bitset
@pytest.mark.parametrize("t", [1, 3, 8])
def test_bitset_plain_matches_pallas(t):
    rng = np.random.default_rng(200 + t)
    q, w = 5, W_BLK
    maps = rng.integers(0, 2**32, size=(q, t, w), dtype=np.uint64).astype(np.uint32)
    maps[0, :, :4] = 0xFFFFFFFF  # sign bit set in the int32 view
    valid = rng.integers(0, 2, size=(q, t)).astype(np.int32)
    valid[1] = 0  # an all-invalid row is all-ones
    want_and, want_cnt = ref_bitset(jnp.asarray(maps), jnp.asarray(valid), interpret=True)
    got_and, got_cnt = bitset_and_popcount(_t(maps.view(np.int32)), _t(valid))
    assert np.array_equal(_words(got_and), np.asarray(want_and))
    assert np.array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert int(got_cnt[1]) == 32 * w


# ----------------------------------------------------------- guided_search
def _probe_inputs(rng, p, w):
    seg = rng.integers(0, 5000, p).astype(np.int32)
    base = rng.integers(0, 1 << 22, p).astype(np.int32)
    # half-integer products (slope 0.5, 1.5, 2.5) exercise round-half-to-even
    slope = np.where(rng.random(p) < 0.3, rng.integers(0, 6, p) + 0.5,
                     rng.random(p) * 300).astype(np.float32)
    r_lo = (seg + rng.integers(0, 3000, p)).astype(np.int32)
    n_valid = rng.integers(0, w + 1, p).astype(np.int32)
    corr = rng.integers(-64, 64, (p, w)).astype(np.int32)
    j = rng.integers(0, w, p)
    di = (r_lo + j - seg).astype(np.float32)
    cand = base + np.rint(slope * di).astype(np.int32) + corr[np.arange(p), j]
    cand = np.where(rng.random(p) < 0.5, cand, cand + 1).astype(np.int32)
    return seg, base, slope, r_lo, n_valid, cand, corr


@pytest.mark.parametrize("p,w", [(8, 128), (37, 256), (200, 1024)])
def test_guided_search_plain_matches_pallas(p, w):
    cols = _probe_inputs(np.random.default_rng(300 + p), p, w)
    want_f, want_lt = ref_probe(*(jnp.asarray(c.reshape(-1, 1)) for c in cols[:6]),
                                jnp.asarray(cols[6]), interpret=True)
    got_f, got_lt = probe_batch(*(_t(c) for c in cols))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f).reshape(-1))
    assert np.array_equal(got_lt.numpy(), np.asarray(want_lt).reshape(-1))
    assert got_f.numpy().any() and not got_f.numpy().all()


# ----------------------------------------------------------- plm_decode
def _decode_tables(lists, encode):
    """The reference's padded (B, S) / (B, R) batch, one all-padding row
    last, and the port's ragged batch of the same lists."""
    parsed = [ref_parse_stream(encode(ids), len(ids)) for ids in lists]
    S = max(len(p[0]) for p in parsed)
    R = -(-max(len(x) for x in lists) // 128) * 128
    B = len(parsed) + 1
    starts = np.full((B, S), SENTINEL, np.int32)
    bases = np.zeros((B, S), np.int32)
    slopes = np.zeros((B, S), np.float32)
    corr = np.random.default_rng(0).integers(-9, 9, (B, R)).astype(np.int32)
    for row, (st, ba, sl, co) in enumerate(parsed):
        starts[row, : len(st)] = st
        bases[row, : len(st)] = ba
        slopes[row, : len(st)] = sl
        corr[row, : len(co)] = co
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    ragged = (
        np.concatenate([p[0] + off for p, off in zip(parsed, offsets)]).astype(np.int32),
        np.concatenate([p[1] for p in parsed]).astype(np.int32),
        np.concatenate([p[2] for p in parsed]).astype(np.float32),
        np.concatenate([p[3] for p in parsed]).astype(np.int32),
    )
    return (starts, bases, slopes, corr), ragged, offsets


@pytest.mark.parametrize("encode", [ref_plm_encode, ref_rmi_encode], ids=["plm", "rmi"])
def test_plm_decode_plain_matches_pallas(encode):
    """Every rank of every list decodes as the Pallas kernel decodes it; the
    port's batch is ragged, so the reference's padding ranks have no
    counterpart."""
    rng = np.random.default_rng(400)
    lists = [np.sort(rng.choice(1 << 24, n, replace=False)).astype(np.int32)
             for n in (1, 5, 127, 129, 700, 2000)]
    lists.append((np.arange(3000) * 37 + rng.integers(0, 9, 3000)).astype(np.int32))
    padded, ragged, offsets = _decode_tables(lists, encode)
    want = np.asarray(ref_decode(*(jnp.asarray(a) for a in padded), interpret=True))
    got = decode_batch(*(_t(a) for a in ragged)).numpy()
    assert got.shape == (offsets[-1],)
    for row, ids in enumerate(lists):
        assert np.array_equal(got[offsets[row] : offsets[row + 1]], want[row, : len(ids)])
        assert np.array_equal(got[offsets[row] : offsets[row + 1]], ids)


# ----------------------------------------------------------- host bridges
def test_decode_lists_matches_reference_bridge():
    from repro.kernels.plm_decode.ops import decode_lists as ref_decode_lists
    from repro_torch.kernels.plm_decode.ops import decode_lists
    from repro_torch.postings.plm import plm_encode
    from repro_torch.postings.rmi import rmi_encode

    rng = np.random.default_rng(6)
    lens = [0, 1, 64, 129, 1000]
    lists = [np.sort(rng.choice(1 << 22, n, replace=False)).astype(np.int32) for n in lens]
    for enc in (plm_encode, rmi_encode):
        streams = [enc(ids) for ids in lists]
        got = decode_lists(streams, lens, device="cpu")
        want = ref_decode_lists(streams, lens)
        for ids, g, w in zip(lists, got, want):
            assert np.array_equal(g, w) and np.array_equal(g, ids)

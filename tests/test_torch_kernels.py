"""The port's kernels against the reference's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the reference
kernels run in Pallas interpret mode, as the reference's own tests run them.
Same inputs, made with numpy from a seed, go to both.  Bitset words and
counts, probe verdicts, decoded ids (and the PFor overflow flag) and BM25
integer and float scores must be exactly equal.  Membership
bits must be equal too, except a bit whose logit lies within
NUMERIC_MARGIN * (1 + |tau|) of tau: the two float32 products sum in
different orders, and that margin is what the thresholds reserve for it.

tests/test_torch_cuda.py holds each CUDA kernel against its plain version on
a card; the fused_topk kernel's parity tests are in tests/test_torch_fused.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import _t as _tw
from test_torch_cuda import block_step, pfor_blocks, pfor_lists, plm_batch, probe_tables

from repro.index.compress import optpfd_decode as ref_optpfd_decode
from repro.index.compress import undgaps as ref_undgaps
from repro.kernels.bitset.kernel import W_BLK, bitset_and_popcount as ref_bitset
from repro.kernels.bm25_score.kernel import score_batch as ref_score_batch
from repro.kernels.bm25_score.ref import score_ref as np_score_ref
from repro.kernels.guided_search.kernel import probe_batch as ref_probe
from repro.kernels.membership.kernel import D_BLK, Q_BLK, membership_bitmask as ref_membership
from repro.kernels.membership.ops import score_terms_bitmask as ref_score_terms
from repro.kernels.plm_decode.kernel import decode_batch as ref_decode
from repro.kernels.pfor.kernel import unpack_blocks as ref_unpack_blocks
from repro.kernels.pfor.ops import decode_stream as ref_decode_stream
from repro.kernels.pfor.ref import unpack_block_ref, words_per_block
from repro.kernels.plm_decode.ref import SENTINEL
from repro.postings.plm import decode_stream as ref_plm_decode_stream
from repro.postings.plm import parse_stream as ref_parse_stream, plm_encode as ref_plm_encode
from repro.postings.rmi import rmi_encode as ref_rmi_encode
from repro_torch.core.learned_bloom import NUMERIC_MARGIN
from repro_torch.kernels.bitset.kernel import block_candidates
from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref
from repro_torch.kernels.bm25_score.kernel import score_batch
from repro_torch.kernels.bm25_score.ops import score_candidates
from repro_torch.kernels.guided_search.kernel import probe_batch
from repro_torch.kernels.guided_search.ref import probe_ref
from repro_torch.kernels.membership.kernel import membership_bitmask
from repro_torch.kernels.membership.ref import membership_bitmask_ref, pack_bool_words
from repro_torch.kernels.pfor.kernel import pfor_decode
from repro_torch.kernels.pfor.ops import decode_lists as pfor_decode_lists
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


def _ragged_membership(rng, n_q, e, scale=1.0):
    """Ragged Q and D (1,111 docs, 35 words): the reference pads (tau=+inf
    rows, 512-doc tiles) and masks the tail word; the port's wrapper must
    return the same words, within the margin."""
    te = rng.standard_normal((300, e)).astype(np.float32) * np.float32(scale)
    de = rng.standard_normal((1111, e)).astype(np.float32) * np.float32(scale)
    tau_all = rng.standard_normal(300).astype(np.float32)
    terms = rng.integers(0, 300, n_q).astype(np.int32)
    params = {"term_embed": {"table": jnp.asarray(te)}, "doc_embed": {"table": jnp.asarray(de)},
              "bias": jnp.float32(0.0)}
    want = np.asarray(ref_score_terms(params, jnp.asarray(terms), jnp.asarray(tau_all)))
    got = _words(membership_bitmask(_t(te[terms]), _t(de), _t(tau_all[terms]), 0.0))
    assert got.shape == want.shape == (n_q, 35)
    assert (got[:, -1] >> np.uint32(1111 % 32)).max() == 0  # tail bits zero
    _assert_bits_within_margin(got, want, te[terms], de, tau_all[terms], 0.0, 1111)
    return got


def test_membership_ragged_matches_reference_ops():
    _ragged_membership(np.random.default_rng(7), 45, 48)


@pytest.mark.parametrize("n_q,e", [(65, 96), (63, 16)])
def test_membership_ragged_rows_match_reference_ops(n_q, e):
    """Q around the kernel's 16-row interleave of slot rows and 128-slot
    items, E off its 32-dim stage."""
    got = _ragged_membership(np.random.default_rng(n_q + e), n_q, e, scale=0.3)
    assert 0 < np.unpackbits(got.view(np.uint8)).sum() < n_q * 1111  # both verdicts occur


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
    got_and, got_cnt = bitset_and_popcount_ref(_t(maps.view(np.int32)), _t(valid))
    assert np.array_equal(_words(got_and), np.asarray(want_and))
    assert np.array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert int(got_cnt[1]) == 32 * w


@pytest.mark.parametrize("n_docs,block_size", [(400, 64), (1000, 32), (5000, 1024)])
def test_block_candidates_plain_matches_pallas_bitset(n_docs, block_size):
    """Algorithm 3's fused block step, plain version: its (Q, Wb) AND and
    count are the reference's Pallas bitset_and_popcount (interpret mode) of
    the queries' table rows, and its candidate words are, word by word, the
    rows ANDed over the valid slots where the word's block survives, zero
    past n_docs and for the all-pad query 0."""
    rng = np.random.default_rng(n_docs + block_size)
    table, terms, slots, rows = block_step(rng, n_docs, block_size, Q=12, T=5, n_terms=40)
    cand, anded, count = block_candidates(*map(_tw, (table, terms, slots, rows)),
                                          n_docs, block_size)
    wb = table.shape[1]
    # the reference kernel tiles W by W_BLK: zero words past Wb AND to zero
    maps = np.zeros((len(terms), terms.shape[1], W_BLK), np.uint32)
    maps[:, :, :wb] = table[np.maximum(terms, 0)]
    valid = (terms >= 0).astype(np.int32)
    want_and, want_cnt = ref_bitset(jnp.asarray(maps), jnp.asarray(valid), interpret=True)
    want_and, want_cnt = np.asarray(want_and), np.asarray(want_cnt)
    assert np.array_equal(_words(anded), want_and[:, :wb])
    live = valid.any(axis=1)
    # an all-pad query's pad words are all-ones in the reference's wider tile
    assert np.array_equal(count.numpy(), want_cnt - np.where(live, 0, 32 * (W_BLK - wb)))
    words = rows.shape[1]
    blk = np.arange(words) * 32 // block_size
    for q in range(len(terms)):
        acc = np.full(words, 0xFFFFFFFF, np.uint32)
        for s in slots[q][slots[q] >= 0]:
            acc &= rows[s]
        alive = (want_and[q, blk // 32] >> (blk % 32).astype(np.uint32)) & 1
        want = np.where(alive.astype(bool) & live[q], acc, 0).astype(np.uint32)
        if n_docs % 32:
            want[-1] &= np.uint32((1 << (n_docs % 32)) - 1)
        assert np.array_equal(_words(cand)[q], want), q
    assert not _words(cand)[0].any() and _words(cand).any()


# ----------------------------------------------------------- guided_search
@pytest.mark.parametrize("p,w", [(8, 128), (37, 256), (200, 1024)])
def test_guided_search_plain_matches_pallas(p, w):
    """Packed probe rows (widths 0, 7, 13 and 32, values straddling word
    boundaries, half-integer products) against the reference kernel on the
    same windows unpacked into its dense (P, 1) / (P, W) inputs."""
    rng = np.random.default_rng(300 + p)
    lengths = rng.integers(0, w + 1, p)
    lengths[:4] = (0, 1, w, w - 1)
    rows, terms, segs, words, vals = probe_tables(rng, p, lengths)
    term, seg, r_lo, n, cand = (rows[:, c].astype(np.int64) for c in range(5))
    corr = np.zeros((p, w), np.int64)
    for i in range(p):
        corr[i, : n[i]] = vals[term[i]][r_lo[i] : r_lo[i] + n[i]]
    dense = (segs[seg, 0], segs[seg, 1], segs[seg, 2].view(np.float32), r_lo, n, cand)
    want_f, want_lt = ref_probe(*(jnp.asarray(np.asarray(c, np.int32 if k != 2 else np.float32)
                                              .reshape(-1, 1)) for k, c in enumerate(dense)),
                                jnp.asarray(corr.astype(np.uint32).view(np.int32)),
                                interpret=True)
    got = probe_batch(_t(rows), _t(terms), _t(segs), _t(words.view(np.int32)), p)
    assert np.array_equal(got[0].numpy(), np.asarray(want_f).reshape(-1))
    assert np.array_equal(got[1].numpy(), np.asarray(want_lt).reshape(-1))
    assert got[0].numpy().any() and not got[0].numpy().all()
    assert {0, 7, 13, 32} == set(terms[np.unique(term), 1])


# ----------------------------------------------------------- plm_decode
def _decode_tables(lists, encode):
    """The reference's padded (B, S) / (B, R) batch, one all-padding row
    last, and the port's ragged batch of the same lists (corrections left
    packed)."""
    streams = [encode(ids) for ids in lists]
    parsed = [ref_parse_stream(w, len(ids)) for w, ids in zip(streams, lists)]
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
    return (starts, bases, slopes, corr), plm_batch(streams, [len(x) for x in lists]), offsets


@pytest.mark.parametrize("encode", [ref_plm_encode, ref_rmi_encode], ids=["plm", "rmi"])
def test_plm_decode_plain_matches_pallas(encode):
    """Every rank of every list decodes as the Pallas kernel decodes it; the
    port's batch is ragged, so the reference's padding ranks have no
    counterpart."""
    rng = np.random.default_rng(400)
    lists = [np.sort(rng.choice(1 << 24, n, replace=False)).astype(np.int32)
             for n in (1, 5, 127, 129, 700, 2000)]
    lists.append((np.arange(3000) * 37 + rng.integers(0, 9, 3000)).astype(np.int32))
    padded, (*ragged, n), offsets = _decode_tables(lists, encode)
    want = np.asarray(ref_decode(*(jnp.asarray(a) for a in padded), interpret=True))
    got = decode_batch(*(_tw(a) for a in ragged), n).numpy()
    assert got.shape == (offsets[-1],)
    for row, ids in enumerate(lists):
        assert np.array_equal(got[offsets[row] : offsets[row + 1]], want[row, : len(ids)])
        assert np.array_equal(got[offsets[row] : offsets[row + 1]], ids)
        w = encode(ids)
        assert np.array_equal(got[offsets[row] : offsets[row + 1]], ref_plm_decode_stream(w, len(ids)))


@pytest.mark.parametrize("width", [0, 1, 7, 13, 31, 32])
def test_plm_decode_plain_unpacks_every_width(width):
    """Packed corrections of one width, across word boundaries, against the
    reference's host unpack; segments laid on the lists' own ranks."""
    from repro.index.compress import pack_bits as ref_pack_bits, unpack_bits as ref_unpack_bits

    rng = np.random.default_rng(500 + width)
    ns = [1, 33, 130, 1100]
    top = 1 << min(width, 31)
    corr = [rng.integers(0, top, n).astype(np.uint32) for n in ns]
    words = [ref_pack_bits(c, width) for c in corr]
    offs = np.concatenate([[0], np.cumsum(ns)])
    rows = np.array([(offs[i], sum(len(w) for w in words[:i]), width, -i) for i in range(len(ns))],
                    np.int32)
    seg_pos = np.concatenate([[o, o + n // 2] if n > 1 else [o] for o, n in zip(offs, ns)])
    bases = rng.integers(0, 1000, len(seg_pos)).astype(np.int32)
    slopes = (rng.random(len(seg_pos)) * 9).astype(np.float32)
    got = decode_batch(*(_tw(a) for a in (seg_pos.astype(np.int32), bases, slopes, rows,
                                          np.concatenate(words))), int(offs[-1])).numpy()
    seg = np.searchsorted(seg_pos, np.arange(offs[-1]), side="right") - 1
    line = bases[seg] + np.rint(slopes[seg] * (np.arange(offs[-1]) - seg_pos[seg])
                                .astype(np.float32)).astype(np.int64)
    want = np.concatenate([ref_unpack_bits(w, width, n).astype(np.int64) - i
                           for i, (w, n) in enumerate(zip(words, ns))]) + line
    assert np.array_equal(got, want.astype(np.int32))


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


# ----------------------------------------------------------- pfor
def _block_gaps(got: torch.Tensor, meta: np.ndarray) -> np.ndarray:
    """Each block's gaps back from its ids when every block is a list of its
    own: differences mod 2^32 (the ids are the sums' low 32 bits)."""
    ids = got.numpy()[:-1].view(np.uint32).astype(np.int64)
    gaps = np.empty_like(ids)
    for _, _, blen, out, *_ in meta:
        gaps[out : out + blen] = np.diff(ids[out : out + blen], prepend=0) % (1 << 32)
    return gaps.astype(np.uint32)


@pytest.mark.parametrize("width", range(33))
def test_pfor_plain_matches_reference_unpack(width):
    """Full and short blocks of one width, no exceptions, each a list of its
    own: the plain decode against the reference's unpack_block_ref and its
    Pallas unpack_blocks (interpret mode) on the same packed words."""
    rng = np.random.default_rng(100 + width)
    words, meta6, want = pfor_blocks(rng, widths=[width], exceptions=False)
    meta, ids = pfor_lists(meta6, want, np.ones(len(meta6), np.int64))
    got = pfor_decode(_tw(words), _tw(meta), len(want))
    assert np.array_equal(got.numpy(), ids)
    gaps = _block_gaps(got, meta)
    assert np.array_equal(gaps, want)
    wpb = words_per_block(width)
    rows = np.zeros((len(meta6), wpb), np.uint32)
    for row, (w, start, blen, out, *_) in zip(rows, meta6):
        n_words = (blen * w + 31) // 32
        row[:n_words] = words[start : start + n_words]
    pallas = np.asarray(ref_unpack_blocks(jnp.asarray(rows), width=width, interpret=True))
    ref = np.asarray(unpack_block_ref(jnp.asarray(rows), width))
    for k, (_, _, blen, out, *_) in enumerate(meta6):
        assert np.array_equal(gaps[out : out + blen], ref[k, :blen])
        assert np.array_equal(gaps[out : out + blen], pallas[k, :blen])


def test_pfor_plain_patches_exceptions():
    words, meta6, want = pfor_blocks(np.random.default_rng(7))
    assert meta6[:, 5].sum() > 50  # exception pairs in most widths
    meta, ids = pfor_lists(meta6, want, np.ones(len(meta6), np.int64))
    got = pfor_decode(_tw(words), _tw(meta), len(want))
    assert np.array_equal(got.numpy(), ids)
    assert np.array_equal(_block_gaps(got, meta), want)


def test_pfor_plain_sums_many_lists_in_one_call():
    """Blocks of every width (0 and 32 included, short blocks, exceptions)
    in ragged lists, one-block and one-value lists among them: each list's
    ids are the reference's undgaps of its gaps; a list past INT32_MAX
    raises the flag."""
    rng = np.random.default_rng(70)
    words, meta6, gaps = pfor_blocks(rng, blocks_per_width=4, high=1 << 14)
    sizes = [1, 2, 5, 1, 17, 30, 3]
    sizes.append(len(meta6) - sum(sizes))
    meta, want = pfor_lists(meta6, gaps, sizes)
    got = pfor_decode(_tw(words), _tw(meta), len(gaps)).numpy()
    assert np.array_equal(got, want)
    heads = np.append(meta6[np.cumsum(sizes) - sizes, 3], len(gaps))
    for a, b in zip(heads[:-1], heads[1:]):
        try:
            ref = ref_undgaps(gaps[a:b])
        except OverflowError:
            assert got[-1] == 1
            continue
        assert np.array_equal(got[a:b], ref)
    # a one-value list of width 32 just under INT32_MAX, then a width-0 list
    # whose one exception sets its last value: the flag stays down
    words = np.array([0x7FFFFFF0, 2, 9], np.uint32)
    meta = np.array([(32, 0, 1, 0, 1, 0, 1, 0), (0, 1, 3, 1, 1, 1, 1, 0)], np.int32)
    got = pfor_decode(_tw(words), _tw(meta), 4).numpy()
    assert np.array_equal(got, [0x7FFFFFF0, 0, 0, 9, 0])


def _optpfd_lists(rng):
    lists = [np.sort(rng.choice(1 << 30, n, replace=False)).astype(np.int32)
             for n in (1, 2, 127, 128, 129, 3000)]
    lists.append(np.arange(5, 1000, 3, dtype=np.int32))  # one narrow width
    gaps = rng.integers(1, 4, 2000).astype(np.int64)
    gaps[rng.integers(0, 2000, 60)] += rng.integers(1000, 1 << 20, 60)  # exceptions
    lists.append(np.cumsum(gaps).astype(np.int32))
    lists.append(np.array([0, 1, 2, 2**31 - 1], np.int32))  # gap 0, a 31-bit gap
    return lists


def test_pfor_streams_match_reference_decoders():
    from repro.index.compress import encode_postings as ref_encode

    lists = _optpfd_lists(np.random.default_rng(8))
    streams = [ref_encode(x, "optpfd") for x in lists]
    got = pfor_decode_lists(streams, [len(x) for x in lists], device="cpu")
    for g, x, w in zip(got, lists, streams):
        assert g.dtype == np.int32 and np.array_equal(g, x)
        assert np.array_equal(g, ref_decode_stream(w, len(x)))
        assert np.array_equal(g, ref_undgaps(ref_optpfd_decode(w, len(x))))


def test_decode_stream_equals_reference():
    """``decode_stream`` (one stream through ``decode_lists``) gives the
    reference's ids bit for bit, dtype included."""
    from repro.index.compress import encode_postings as ref_encode
    from repro_torch.kernels.pfor.ops import decode_stream

    lists = _optpfd_lists(np.random.default_rng(8))
    for x in lists:
        w = ref_encode(x, "optpfd")
        got, want = decode_stream(w, len(x), device="cpu"), ref_decode_stream(w, len(x))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_pfor_batch_of_lists_and_overflow():
    from repro_torch.index.compress import encode_postings, optpfd_encode, undgaps

    lists = _optpfd_lists(np.random.default_rng(9))
    streams = [encode_postings(x, "optpfd") for x in lists]
    got = pfor_decode_lists([np.zeros(0, np.uint32)] + streams, [0] + [len(x) for x in lists],
                            device="cpu")
    assert len(got[0]) == 0
    for g, x in zip(got[1:], lists):
        assert np.array_equal(g, x)
    gaps = np.array([2**31 - 1, 5], np.uint32)  # ids past int32: both decoders refuse
    with pytest.raises(OverflowError):
        undgaps(gaps)
    with pytest.raises(OverflowError):
        pfor_decode_lists([optpfd_encode(gaps)], [2], device="cpu")
    with pytest.raises(OverflowError):  # in a batch, behind lists that fit
        pfor_decode_lists(streams + [optpfd_encode(gaps)], [len(x) for x in lists] + [2],
                          device="cpu")


# ----------------------------------------------------------- bm25_score
@pytest.mark.parametrize("p,t", [(1, 1), (37, 3), (300, 6)])
def test_bm25_score_plain_matches_reference_and_pallas(p, t):
    rng = np.random.default_rng(p + t)
    imp = rng.integers(0, 256, (p, t)).astype(np.int32)
    scale = np.float32(0.05172413)
    gi, gf = score_batch(_t(imp), float(scale))
    wi, wf = np_score_ref(imp, float(scale))
    assert np.array_equal(gi.numpy(), wi) and np.array_equal(gf.numpy(), wf)
    # the reference kernel takes the bridge's 128-lane, 8-row padding
    pad = np.zeros(((p + 7) // 8 * 8, 128), np.int32)
    pad[:p, :t] = imp
    pi, pf = ref_score_batch(jnp.asarray(pad), jnp.asarray(scale.reshape(1, 1)), interpret=True)
    assert np.array_equal(gi.numpy(), np.asarray(pi)[:p, 0])
    assert np.array_equal(gf.numpy(), np.asarray(pf)[:p, 0])
    ci, cf = score_candidates(imp, float(scale), device="cpu")
    assert np.array_equal(ci, wi) and np.array_equal(cf, wf)

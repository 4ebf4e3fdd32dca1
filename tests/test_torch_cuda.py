"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

These tests import neither jax nor the reference, so they run where only
the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each decides inside the test whether a card exists and skips without one
(a CUDA kernel has no CPU mode).  Inputs are made with numpy from a seed.
Bitset words and counts, probe verdicts, decoded ids and overflow flags,
integer and float BM25 scores and fused top-k ids and scores must be exactly
equal;
membership, mlp_membership and two_tier bits may differ from their plain
versions only where the logit lies within NUMERIC_MARGIN * (1 + |tau|) of
tau, since the float32 products sum in different orders; two_tier equals membership's
candidates ANDed with the tier-1 union exactly (the same sequential FMAs), and
so do the masked membership launch's words the dense launch's in live blocks
and a bf16 doc table's words those of the table widened to float32.

``pfor_blocks``, ``pfor_lists``, ``plm_batch``, ``fused_tiles`` and
``block_step`` make the inputs that tests/test_torch_kernels.py and
tests/test_torch_fused.py also hand to the reference's kernels on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.learned_bloom import NUMERIC_MARGIN
from repro_torch.index.compress import encode_postings, optpfd_encode, pack_bits
from repro_torch.kernels.bm25_score.kernel import score_batch
from repro_torch.kernels.bm25_score.ref import score_ref
from repro_torch.kernels.fused_query.dense import dense_impl
from repro_torch.kernels.fused_query.kernel import fused_topk
from repro_torch.kernels.fused_query.ref import NEVER, dense_ref, fused_topk_ref
from repro_torch.kernels.pfor.kernel import pfor_decode
from repro_torch.kernels.pfor.ops import decode_lists as pfor_decode_lists
from repro_torch.kernels.pfor.ref import pfor_decode_ref
from repro_torch.kernels.bitset.kernel import block_candidates
from repro_torch.kernels.bitset.ref import block_candidates_ref
from repro_torch.kernels.guided_search.kernel import probe_batch
from repro_torch.kernels.guided_search.ref import probe_ref
from repro_torch.kernels.membership.kernel import MASKED as MEMBERSHIP_MASKED, membership_bitmask
from repro_torch.kernels.membership.ref import live_words, membership_bitmask_ref
from repro_torch.kernels.mlp_membership.kernel import KERNEL as MLP, MASKED as MLP_MASKED
from repro_torch.kernels.mlp_membership.kernel import TWO_TIER as MLP_TWO_TIER
from repro_torch.kernels.mlp_membership.kernel import mlp_membership, mlp_two_tier
from repro_torch.kernels.mlp_membership.ref import (LiveBlocks, mlp_logits_ref,
                                                    mlp_membership_ref, mlp_two_tier_ref)
from repro_torch.kernels.plm_decode.kernel import decode_batch
from repro_torch.kernels.plm_decode.ops import decode_lists as plm_decode_lists
from repro_torch.kernels.plm_decode.ref import decode_ref
from repro_torch.kernels.two_tier.kernel import KERNEL as TWO_TIER, two_tier_candidates
from repro_torch.kernels.two_tier.ref import tier1_union, two_tier_ref
from repro_torch.postings.plm import plm_encode
from repro_torch.postings.rmi import rmi_encode


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def pfor_blocks(rng, widths=range(33), blocks_per_width=3, exceptions=True, high=None):
    """PFor blocks of every width, some short, with exception pairs (width
    < 32) -> (stream words uint32, meta (n_blocks, 6) int32, expected gaps
    uint32), each block's output right after the one before.  ``high`` caps
    the values (exceptions included) below 2^32."""
    words, meta, want = [], [], []
    pos = out = 0
    for w in widths:
        for i in range(blocks_per_width):
            blen = 128 if i else int(rng.integers(1, 128))
            top = min(1 << w, high or 1 << 32)
            vals = rng.integers(0, top, blen, dtype=np.uint64).astype(np.uint32) if w else \
                np.zeros(blen, np.uint32)
            packed = pack_bits(vals, w)
            n_exc = int(rng.integers(0, 6)) if w < 32 and exceptions else 0
            exc_pos = np.sort(rng.choice(blen, min(n_exc, blen), replace=False)).astype(np.uint32)
            hi_top = max(2, min(1 << (32 - w), (high or 1 << 32) >> w))
            hi = rng.integers(1, hi_top, len(exc_pos), dtype=np.uint64).astype(np.uint32)
            full = vals.copy()
            full[exc_pos] |= (hi.astype(np.uint64) << np.uint64(w)).astype(np.uint32)
            pairs = np.stack([exc_pos, hi], axis=1).reshape(-1)
            meta.append((w, pos, blen, out, pos + len(packed), len(exc_pos)))
            words += [packed, pairs]
            want.append(full)
            pos += len(packed) + len(pairs)
            out += blen
    return (np.concatenate(words).astype(np.uint32), np.array(meta, np.int32),
            np.concatenate(want))


def pfor_lists(meta6, gaps, list_blocks):
    """Consecutive blocks grouped into lists of ``list_blocks`` blocks each ->
    (meta (n_blocks, 8) int32 as pfor_decode takes it, expected (n_out + 1,)
    int32: each id's low 32 bits, then the overflow flag)."""
    list_blocks = np.asarray(list_blocks, np.int64)
    assert list_blocks.sum() == len(meta6)
    meta = np.zeros((len(meta6), 8), np.int32)
    meta[:, :6] = meta6
    heads = np.cumsum(list_blocks) - list_blocks
    meta[heads, 6] = 1
    bounds = np.append(meta6[heads, 3], len(gaps)).astype(np.int64)
    ids = np.concatenate([np.cumsum(gaps[a:b].astype(np.int64))
                          for a, b in zip(bounds[:-1], bounds[1:])])
    flag = int((ids > 2**31 - 1).any())
    return meta, np.append((ids & 0xFFFFFFFF).astype(np.uint32).view(np.int32), flag)


def probe_tables(rng, n_probes, lengths, widths=(0, 7, 13, 32), n_ranks=4096, n_seg=4):
    """Packed inputs of the guided_search kernel: one term row per width
    (``n_ranks`` corrections packed at that width, some straddling word
    boundaries), ``n_seg`` segments a term (some half-integer slopes, for
    round-half-to-even), and ``n_probes`` rows of one slot each, window
    lengths drawn from ``lengths``, half of the candidates in their window.
    -> (rows, terms, segs, words, vals): int32 arrays as probe_batch takes
    them, and each term's unpacked corrections (int64, corr_min added)."""
    terms, segs, words, vals = [], [], [], []
    n_words = 0
    for w in widths:
        v = rng.integers(0, 1 << w, n_ranks, dtype=np.uint64).astype(np.uint32) if w else \
            np.zeros(n_ranks, np.uint32)
        packed = pack_bits(v, w)
        cmin = int(rng.integers(-64, 64))
        terms.append((n_words, w, cmin))
        words.append(packed)
        vals.append(v.astype(np.int64) + cmin)
        n_words += len(packed)
        for g in range(n_seg):
            slope = (rng.integers(0, 6) + 0.5) if g % 2 else rng.random() * 300
            segs.append((g * n_ranks // n_seg, int(rng.integers(0, 1 << 22)),
                         int(np.array(slope, np.float32).view(np.int32))))
    terms, segs = np.array(terms, np.int32), np.array(segs, np.int32)
    rows = np.zeros((n_probes, 6), np.int32)
    for p in range(n_probes):
        l = int(rng.integers(len(widths)))
        n = int(lengths[p % len(lengths)])
        g = l * n_seg + int(rng.integers(n_seg))
        r_lo = int(rng.integers(0, n_ranks - n + 1))
        j = r_lo + int(rng.integers(max(n, 1)))
        start, base, bits = (int(x) for x in segs[g])
        slope = np.array(bits, np.int32).view(np.float32)
        cand = base + int(np.rint(slope * np.float32(j - start))) + int(vals[l][j % n_ranks])
        cand += int(rng.random() < 0.5)
        rows[p] = (l, g, r_lo, n, np.array(cand, np.int64).astype(np.int32), p)
    return rows, terms, segs, np.concatenate(words).astype(np.uint32), vals


def plm_batch(streams, lens):
    """plm/rmi streams (postings/plm.py layout) -> the (seg_pos, bases,
    slopes, list rows, packed words, n) arrays decode_batch takes, read
    straight from the stream words."""
    seg_pos, bases, slopes, rows, words = [], [], [], [], []
    off = word = 0
    for w, n in zip(streams, lens):
        S = int(w[0])
        seg_pos.append(w[3 : 3 + S].astype(np.int64) + off)
        bases.append(w[3 + S : 3 + 2 * S].view(np.int32))
        slopes.append(w[3 + 2 * S : 3 + 3 * S].view(np.float32))
        corr = w[3 + 3 * S :]
        rows.append((off, word, int(w[1]) & 0xFF, int(w[2:3].view(np.int32)[0])))
        words.append(corr)
        off += n
        word += len(corr)
    return (np.concatenate(seg_pos).astype(np.int32), np.concatenate(bases).astype(np.int32),
            np.concatenate(slopes).astype(np.float32), np.array(rows, np.int32).reshape(-1, 4),
            np.concatenate(words).astype(np.uint32), off)


def _unpack_np(lo, hi, shift, width):
    lo, hi = lo.astype(np.uint64), hi.astype(np.uint64)
    up = np.where(shift > 0, hi << (np.uint64(32) - shift), np.uint64(0)) & np.uint64(0xFFFFFFFF)
    return ((lo >> shift) | up) & ((np.uint64(1) << width) - np.uint64(1))


def fused_tiles(rng, Q=6, T=3, C=256, W=4, pbits=8, k=None, tied=False):
    """Random fused_topk tiles: a row of NEVER padding only, rows with
    candidates padded by NEVER, windows of 0..W lanes (garbage past wlen),
    about half the (term, candidate) windows holding a matching lane, and
    small partial scores and impacts (0..3) so that ties are common; row 2
    matches nothing and ties every candidate.  With ``tied`` every impact is
    0 and every candidate's partial score 3, so each row ties all its
    candidates while the lanes are still walked.  ``k`` defaults to
    min(12, C)."""
    width = rng.integers(0, 25, (Q, T)).astype(np.uint32)
    cmin = rng.integers(-50, 1, (Q, T)).astype(np.int32)
    rlo = rng.integers(0, 5000, (Q, T, C)).astype(np.int32)
    wlen = rng.integers(0, W + 1, (Q, T, C)).astype(np.int32)
    start = (rlo - rng.integers(0, 900, (Q, T, C))).astype(np.int32)
    slope = np.where(rng.random((Q, T, C)) < 0.3, rng.integers(0, 6, (Q, T, C)) + 0.5,
                     rng.random((Q, T, C)) * 300).astype(np.float32)
    words = [rng.integers(0, 1 << 32, (Q, T, C, W), dtype=np.uint64).astype(np.uint32)
             for _ in range(4)]
    clo, chi, plo, phi = words
    plo &= np.uint32(0x03030303)
    phi &= np.uint32(0x03030303)
    n_cands = rng.integers(C // 3, C + 1, Q)
    n_cands[1] = 0  # an empty row
    cand = np.full((Q, C), NEVER, np.int32)
    part = np.zeros((Q, C), np.int32)
    for q in range(Q):
        ids = np.sort(rng.choice(1 << 20, n_cands[q], replace=False))
        cand[q, : n_cands[q]] = ids
        part[q, : n_cands[q]] = rng.integers(0, 6, n_cands[q])
    # point the segment line of one lane per matching window at its candidate
    j = rng.integers(0, W, (Q, T, C))
    hit = (rng.random((Q, T, C)) < 0.5) & (j < wlen) & (cand[:, None, :] != NEVER)
    hit[2] = False
    part[2, : n_cands[2]] = 3
    r = rlo.astype(np.int64) + j
    di = (r - start).astype(np.float32)
    pred = np.rint(slope * di).astype(np.int64)
    jj = j[..., None]
    lo_w = np.take_along_axis(clo, jj, 3)[..., 0]
    hi_w = np.take_along_axis(chi, jj, 3)[..., 0]
    w64 = width.astype(np.uint64)[:, :, None]
    corr = _unpack_np(lo_w, hi_w, (r.astype(np.uint64) * w64) % np.uint64(32), w64)
    base = cand[:, None, :].astype(np.int64) - pred - corr.astype(np.int64) - cmin[:, :, None]
    base = np.where(hit, base, rng.integers(0, 1 << 20, (Q, T, C))).astype(np.int32)
    floor = rng.integers(0, 4, (Q, 1)).astype(np.int32)
    floor[2] = 0
    if tied:
        plo[:], phi[:] = 0, 0
        part[cand != NEVER] = 3
        floor[:] = np.minimum(floor, 2)
    return (width, cmin, rlo, wlen, start, base, slope, clo, chi, plo, phi, cand, part,
            floor), dict(k=min(12, C) if k is None else k, pbits=pbits)


# (Q, D, E): every Q in {1, 63, 65, 300, 398}, D in {31, 4097, 5000, 132000}
# and E in {16, 48, 64, 128} at least once; ragged query and doc tiles (128 x
# 128 in the kernel, query warps of 32 and 16 rows), E = 50 on the kernel's
# 4-byte copy path and E = 200 past the main path's width
MEMBERSHIP_SHAPES = [(300, 5000, 128), (1, 31, 16), (63, 4097, 48), (65, 4097, 64),
                     (398, 132000, 128), (65, 31, 128), (1, 132000, 64), (63, 132000, 16),
                     (398, 4097, 48), (65, 4097, 50), (130, 300, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,d,e", MEMBERSHIP_SHAPES)
def test_membership_kernel_matches_plain_on_card(q, d, e):
    dev = _card()
    rng = np.random.default_rng(1)
    qe = (rng.standard_normal((q, e)) * 0.5).astype(np.float32)
    de = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    logits = qe.astype(np.float64) @ de.astype(np.float64).T + 0.05
    tau = rng.standard_normal(q).astype(np.float32)
    n_on = max(1, q // 4)  # thresholds exactly on a logit: the comparison's boundary
    tau[:n_on] = logits[np.arange(n_on), rng.integers(0, d, n_on)].astype(np.float32)
    args = (_t(qe).to(dev), _t(de).to(dev), _t(tau).to(dev), 0.05)
    got = membership_bitmask(*args).cpu().numpy().view(np.uint32)
    want = membership_bitmask_ref(*args).cpu().numpy().view(np.uint32)
    assert got.shape == want.shape == (q, -(-d // 32))
    differ = np.unpackbits((got ^ want).view(np.uint8), axis=-1, bitorder="little")[:, :d]
    near = np.abs(logits - tau[:, None]) <= NUMERIC_MARGIN * (1 + np.abs(tau[:, None]))
    assert not (differ.astype(bool) & ~near).any()
    if d % 32:
        assert (got[:, -1] >> np.uint32(d % 32)).max() == 0  # tail bits zero
    assert 0 < np.unpackbits(got.view(np.uint8)).sum() < q * d  # both verdicts occur


def block_step(rng, n_docs, block_size, Q=64, T=8, n_terms=300, density=0.85):
    """Inputs of Algorithm 3's block step -> (table (n_terms, Wb), terms
    (Q, T), slots (Q, T), rows (R, words)), numpy int32/uint32.  Query 0 is
    all pad, query 1 has one term, the others a random mix of terms and pad
    slots; table bits are set with ``density`` (so some blocks survive an
    8-way AND and some die); rows are random, tail bits included."""
    n_blocks = -(-n_docs // block_size)
    words = -(-n_docs // 32)
    wb = -(-n_blocks // 32)
    table = (rng.random((n_terms, wb * 32)) < density)
    table = np.packbits(table, axis=1, bitorder="little").view(np.uint32)
    terms = rng.integers(0, n_terms, (Q, T)).astype(np.int32)
    terms[rng.random((Q, T)) < 0.3] = -1
    terms[0] = -1
    terms[1] = -1
    terms[1, T // 2] = int(rng.integers(0, n_terms))
    slots = np.full((Q, T), -1, np.int32)
    valid = terms >= 0
    slots[valid] = np.arange(int(valid.sum()), dtype=np.int32)
    rows = rng.integers(0, 2**32, (int(valid.sum()), words), dtype=np.uint64).astype(np.uint32)
    return table, terms, slots, rows


@pytest.mark.cuda
@pytest.mark.parametrize("n_docs,block_size", [(1000, 64), (100_003, 32), (528_000, 1024),
                                               (40_001, 4096), (3_072_000, 32)])
def test_block_candidates_kernel_matches_plain_on_card(n_docs, block_size):
    """All-pad and one-term queries, n_docs off a word edge, block words
    spanning less than, exactly and more than a CTA's 1,024 words, and
    3,000 block words a term (the block AND's count summed over many CTAs,
    words with the sign bit set); the launch zeroes its own count, so a
    CUDA graph replays to the same output."""
    dev = _card()
    rng = np.random.default_rng(n_docs)
    args = [_t(a).to(dev) for a in block_step(rng, n_docs, block_size, Q=128)]
    got = block_candidates(*args, n_docs, block_size)
    want = block_candidates_ref(*args, n_docs, block_size)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cand = got[0]
    assert not cand[0].any() and cand.any()  # the all-pad query and some survivors
    for out in _replays(lambda: block_candidates(*args, n_docs, block_size)[2]):
        assert torch.equal(out, want[2])


@pytest.mark.cuda
def test_guided_search_kernel_matches_plain_on_card():
    """A ragged table of 5,000+ probes over terms of widths 0..32: windows of
    0, 1, 31, 33 and 1,024 ranks, and longer ones cut into rows of 1,024
    whose found/lt combine by atomics; a CUDA graph replayed twice gives the
    same outputs (the launch's memset zeroes them each time)."""
    from repro_torch.kernels.guided_search.ops import probe_rows

    dev = _card()
    rng = np.random.default_rng(3)
    lengths = (0, 1, 31, 33, 1024, 5000, 7, 300)
    rows, terms, segs, words, _ = probe_tables(rng, 5200, lengths, widths=range(33),
                                               n_ranks=8192)
    rows = probe_rows(*rows[:, :5].T)  # the host's chunking of long windows
    assert len(rows) > 5200 and (rows[:, 3] <= 1024).all()
    args = [_t(a).to(dev) for a in (rows, terms, segs, words)] + [5200]
    got, want = probe_batch(*args), probe_ref(*args)
    assert torch.equal(got, want)
    assert 0 < int(got[0].sum()) < 5200 and int(got[1].max()) > 1024
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        probe_batch(*args)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = probe_batch(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("encode", [plm_encode, rmi_encode], ids=["plm", "rmi"])
def test_plm_decode_kernel_matches_plain_on_card(encode):
    """A ragged batch whose lists span many CTAs of 1,024 postings."""
    dev = _card()
    rng = np.random.default_rng(4)
    lists = [np.sort(rng.choice(1 << 24, n, replace=False)).astype(np.int32)
             for n in (1, 300, 5000, 20000, 3, 1023, 1025)]
    streams = [encode(ids) for ids in lists]
    *tabs, n = plm_batch(streams, [len(x) for x in lists])
    tabs = [_t(a).to(dev) for a in tabs]
    got = decode_batch(*tabs, n)
    assert torch.equal(got, decode_ref(*tabs, n))
    assert np.array_equal(got.cpu().numpy(), np.concatenate(lists))
    for g, x in zip(plm_decode_lists(streams, [len(x) for x in lists], device=dev), lists):
        assert np.array_equal(g, x)


def _plm_tables(rng, widths=range(33)):
    """One list per correction width, segments every few hundred ranks and
    some straddling the kernel's 1,024-posting CTA edges, random lines."""
    seg_pos, bases, slopes, rows, words = [], [], [], [], []
    off = n_words = 0
    for w in widths:
        n = int(rng.integers(1500, 3000))
        starts = np.unique(np.concatenate([[0], rng.integers(1, n, 6),
                                           [s for s in (1023, 1024, 1025) if s < n]]))
        seg_pos.append(starts + off)
        bases.append(rng.integers(0, 1 << 20, len(starts)))
        slopes.append((rng.random(len(starts)) * 40).astype(np.float32))
        top = 1 << 32 if w == 32 else 1 << w
        corr = rng.integers(0, top, n, dtype=np.uint64).astype(np.uint32) if w else \
            np.zeros(n, np.uint32)
        packed = pack_bits(corr, w)
        rows.append((off, n_words, w, int(rng.integers(-100, 1))))
        words.append(packed)
        off += n
        n_words += len(packed)
    return (np.concatenate(seg_pos).astype(np.int32), np.concatenate(bases).astype(np.int32),
            np.concatenate(slopes), np.array(rows, np.int32),
            np.concatenate(words).astype(np.uint32), off)


@pytest.mark.cuda
def test_plm_decode_widths_and_cta_edges_on_card():
    dev = _card()
    *tabs, n = _plm_tables(np.random.default_rng(40))
    tabs = [_t(a).to(dev) for a in tabs]
    assert torch.equal(decode_batch(*tabs, n), decode_ref(*tabs, n))


@pytest.mark.cuda
def test_pfor_kernel_matches_plain_on_card():
    """Blocks of every width in ragged lists of 1 to 40 blocks, so lists
    start inside CTAs of 32 blocks and carry across up to three of them."""
    dev = _card()
    rng = np.random.default_rng(5)
    words, meta6, gaps = pfor_blocks(rng, blocks_per_width=12, high=1 << 12)
    sizes = []
    while sum(sizes) < len(meta6):
        sizes.append(min(int(rng.integers(1, 41)), len(meta6) - sum(sizes)))
    meta, want = pfor_lists(meta6, gaps, sizes)
    w, m = _t(words).to(dev), _t(meta).to(dev)
    got = pfor_decode(w, m, len(gaps))
    assert torch.equal(got, pfor_decode_ref(w, m, len(gaps)))
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_pfor_look_back_and_overflow_on_card():
    """Lists of up to 1,600 full blocks (50 CTAs of 32 blocks) whose last
    ids end at INT32_MAX exactly, then one more gap of 1: the flag goes up."""
    dev = _card()
    rng = np.random.default_rng(50)
    lists, streams = [], []
    for n in (1600 * 128, 128 * 37 + 5, 1, 9000):
        gaps = rng.integers(1, 5000, n).astype(np.int64)
        gaps[0] = 2**31 - 1 - int(gaps[1:].sum())
        lists.append(np.cumsum(gaps).astype(np.int32))
        streams.append(encode_postings(lists[-1], "optpfd"))
    got = pfor_decode_lists(streams, [len(x) for x in lists], device=dev)
    for g, x in zip(got, lists):
        assert np.array_equal(g, x) and g[-1] == 2**31 - 1
    gaps = np.diff(lists[0], prepend=0).astype(np.uint32)
    over = optpfd_encode(np.append(gaps, 1).astype(np.uint32))  # its last id is 2^31
    with pytest.raises(OverflowError):
        pfor_decode_lists(streams[1:] + [over], [len(x) for x in lists[1:]] + [len(gaps) + 1],
                          device=dev)


@pytest.mark.cuda
def test_pfor_stream_decode_on_card():
    dev = _card()
    rng = np.random.default_rng(6)
    lists = [np.sort(rng.choice(1 << 30, n, replace=False)).astype(np.int32)
             for n in (1, 127, 128, 129, 5000, 100_000)]
    gaps = rng.integers(1, 4, 3000).astype(np.int64)
    gaps[rng.integers(0, 3000, 80)] += rng.integers(1000, 1 << 20, 80)  # exceptions
    lists.append(np.cumsum(gaps).astype(np.int32))
    streams = [encode_postings(x, "optpfd") for x in lists]
    got = pfor_decode_lists(streams, [len(x) for x in lists], device=dev)
    for g, x in zip(got, lists):
        assert g.dtype == np.int32 and np.array_equal(g, x)


def _replays(fn):
    """fn captured in a CUDA graph and replayed twice -> both outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    return first, out.clone()


@pytest.mark.cuda
def test_decode_kernels_replay_in_cuda_graphs():
    """The pfor scratch (look-back status words, overflow flag) is
    reset by every launch, so two replays give the same output."""
    dev = _card()
    rng = np.random.default_rng(60)
    words, meta6, gaps = pfor_blocks(rng, blocks_per_width=20, high=1 << 10)
    meta, want = pfor_lists(meta6, gaps, [len(meta6) - 7, 7])
    w, m = _t(words).to(dev), _t(meta).to(dev)
    for out in _replays(lambda: pfor_decode(w, m, len(gaps))):
        assert np.array_equal(out.cpu().numpy(), want)
    *tabs, n = _plm_tables(rng, widths=(0, 7, 31))
    tabs = [_t(a).to(dev) for a in tabs]
    want = decode_ref(*tabs, n)
    for out in _replays(lambda: decode_batch(*tabs, n)):
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 4, 6, 8, 40])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_bm25_score_rows_on_card(t, offset):
    """Thread-per-row (T <= 8, 16-, 8- or 4-byte loads as the stride and
    the base address allow: an offset of one int32 forces narrower loads)
    and warp-per-row (T = 40) layouts, P spanning several CTAs."""
    dev = _card()
    rng = np.random.default_rng(70 + t)
    p = 1331
    flat = _t(rng.integers(0, 256, p * t + offset).astype(np.int32)).to(dev)
    imp = flat[offset:].view(p, t)
    (gi, gf), (wi, wf) = score_batch(imp, 0.0371), score_ref(imp, 0.0371)
    assert torch.equal(gi, wi) and torch.equal(gf, wf)


@pytest.mark.cuda
def test_bm25_score_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(7)
    for p, t in ((1, 1), (3000, 5), (777, 40)):
        imp = _t(rng.integers(0, 256, (p, t)).astype(np.int32)).to(dev)
        (gi, gf), (wi, wf) = score_batch(imp, 0.0371), score_ref(imp, 0.0371)
        assert torch.equal(gi, wi) and torch.equal(gf, wf)


MANY_SLICES = 2**16 + 37  # 65 select blocks of 1,024 candidates, the last one ragged


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(), dict(Q=9, T=5, C=1024, W=1), dict(C=128, W=8),
    dict(C=MANY_SLICES, W=1, k=10),
    dict(C=MANY_SLICES, W=2, k=1, tied=True),
    dict(C=MANY_SLICES, W=2, k=10, tied=True),
    dict(C=MANY_SLICES, W=1, k=1025, tied=True),
    dict(C=MANY_SLICES, W=1, k=MANY_SLICES, tied=True),
    dict(C=MANY_SLICES, W=1, k=40, floor=12),
], ids=["base", "wide-c", "w8", "slices-k10", "tied-k1", "tied-k10", "tied-slice+1",
        "tied-kC", "floors"])
def test_fused_topk_kernel_matches_plain_on_card(shape):
    dev = _card()
    shape = dict(shape)
    floor = shape.pop("floor", None)
    tiles, kw = fused_tiles(np.random.default_rng(8), **shape)
    if floor is not None:  # few candidates beat it: rows run out before k
        tiles[13][:] = floor
    args = [_t(a).to(dev) for a in tiles]
    gi, gs = fused_topk(*args, **kw)
    wi, ws = fused_topk_ref(*args, **kw)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)
    assert (gi[1] == -1).all() and (gs[0] > 0).any()
    if floor is not None:
        assert ((ws > 0).sum(1) < kw["k"]).all()
    if shape.get("tied"):  # one score per row: ascending ids across slice edges
        n = int((ws[0] > 0).sum())
        assert n == min(kw["k"], int((args[11][0] != NEVER).sum()))
        assert (gs[0, :n] == 3).all() and (gi[0, 1:n] > gi[0, : n - 1]).all()


def dense_inputs(rng, n_docs, n_terms=300, Q=64, T=8, density=0.05, high=4, dtype=np.uint8):
    """A dense pass's inputs -> numpy (table, qt, floors): impacts in
    [1, high) (ties everywhere at high=4), -1 pads, floors in 0..5; row 0 is
    all pad, row 1's floor nothing beats, row 2 reads one term that every doc
    holds at 2 (an all-tied row), row 3 repeats a term."""
    table = np.zeros((n_terms + 1, n_docs), dtype)
    mask = rng.random((n_terms, n_docs)) < density
    table[:n_terms][mask] = rng.integers(1, high, int(mask.sum()))
    table[n_terms - 1] = 2
    qt = rng.integers(-1, n_terms - 1, (Q, T)).astype(np.int32)
    floors = rng.integers(0, 6, Q).astype(np.int32)
    qt[0] = -1
    floors[1] = 1 << 30
    qt[2] = -1
    qt[2, T // 2] = n_terms - 1
    floors[2] = 0
    qt[3, :2] = qt[3, 2]
    return table, qt, floors


@pytest.mark.cuda
def test_dense_loop_on_card_matches_cpu():
    """The dense pass's kernel (dense_impl on a CUDA table) against its plain
    version on the same card and on the CPU: ids, scores and rounds equal,
    one dense_topk launch a pass."""
    from repro_torch.kernels.fused_query.dense import KERNEL as DENSE

    dev = _card()
    table, qt, floors = dense_inputs(np.random.default_rng(9), 5000)
    args = [_t(a).to(dev) for a in (table, qt, floors)]
    for k in (1, 16, 32):
        before = DENSE.launches
        got = dense_impl(*args, k=k)
        assert DENSE.launches == before + 1
        want = dense_ref(*args, k=k)
        cpu = dense_ref(_t(table), _t(qt), _t(floors), k=k)
        assert all(torch.equal(g, w) and torch.equal(g.cpu(), c) for g, w, c in zip(got, want, cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("n_docs,n_terms,dtype,high", [
    (5000, 300, np.uint8, 4),
    (131_072, 511, np.uint8, 4),      # the arena's caps: 32 chunks a row, 16-byte loads
    (3 * 4096 + 1, 300, np.uint8, 4),  # one doc past a chunk edge; rows off 16 bytes
    (100_003, 200, np.uint8, 200),     # odd width, wide scores: 4-byte loads, long s* search
    (8192, 300, np.int16, 4),
    (4100, 100, np.int32, 1 << 20),
], ids=["5000", "cap", "chunk+1", "odd-wide", "int16", "int32"])
@pytest.mark.parametrize("k", [1, 16, 32])
def test_dense_topk_kernel_matches_plain_on_card(n_docs, n_terms, dtype, high, k):
    dev = _card()
    rng = np.random.default_rng(n_docs + k)
    table, qt, floors = dense_inputs(rng, n_docs, n_terms, dtype=dtype, high=high)
    args = [_t(a).to(dev) for a in (table, qt, floors)]
    got, want = dense_impl(*args, k=k), dense_ref(*args, k=k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ids, scores = got[0].cpu().numpy(), got[1].cpu().numpy()
    assert (ids[0] == NEVER).all() and (ids[1] == NEVER).all()
    assert np.array_equal(ids[2], np.arange(k)) and (scores[2] == 2).all()
    assert int(got[2]) == k  # the tied row fills every slot


@pytest.mark.cuda
def test_dense_topk_counters_zeroed_by_graph_replay():
    """The launch zeroes its arrival counters and the batch's hit maximum,
    so two CUDA-graph replays give the plain version's ids, scores and
    rounds."""
    dev = _card()
    table, qt, floors = dense_inputs(np.random.default_rng(10), 20_000, density=0.0001)
    args = [_t(a).to(dev) for a in (table, qt, floors)]
    qt_sparse = args[1].clone()
    qt_sparse[2] = -1  # no tied row: every row runs out before k
    for q in (args[1], qt_sparse):
        want = dense_ref(args[0], q, args[2], k=32)
        for i, part in enumerate(want):
            for out in _replays(lambda: dense_impl(args[0], q, args[2], k=32)[i]):
                assert torch.equal(out, part)
    assert int(dense_ref(args[0], qt_sparse, args[2], k=32)[2]) < 32


def two_tier_inputs(rng, Q, T, E, n_terms=300, k=50, D=5000):
    """Inputs of Algorithm 2's candidate step -> numpy (tier1 (n_terms, k)
    padded with D, tier1_len, queries (Q, T), term_embed, doc_embed, tau)
    and the float64 logits.  Query 0 is all pad, query 1 has one term,
    query 2 repeats a term, query 3 holds a term whose list is empty;
    every fifth term's list is empty; tau sits mid-logits, and for some
    terms exactly on one."""
    lens = rng.integers(1, k + 1, n_terms).astype(np.int32)
    lens[::5] = 0
    tier1 = np.full((n_terms, k), D, np.int32)
    for t in range(n_terms):
        tier1[t, : lens[t]] = np.sort(rng.choice(D, lens[t], replace=False))
    queries = rng.integers(0, n_terms, (Q, T)).astype(np.int32)
    queries[rng.random((Q, T)) < 0.4] = -1
    queries[0] = -1
    queries[1] = -1
    queries[1, T // 2] = 7
    queries[2, :2] = 11
    queries[3, :2] = (10, 12)  # term 10's list is empty
    te = (rng.standard_normal((n_terms, E)) * 0.5).astype(np.float32)
    de = (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    logits = te.astype(np.float64) @ de.astype(np.float64).T + 0.05
    tau = np.quantile(logits, 0.3, axis=1).astype(np.float32)
    on = rng.choice(n_terms, n_terms // 4, replace=False)
    tau[on] = logits[on, rng.integers(0, D, len(on))].astype(np.float32)
    return (tier1, lens, queries, te, de, tau), logits


def _check_two_tier(arrays, logits, got, want, D):
    """got and want (numpy uint32 words) differ only where some valid
    term's logit lies within the margin of its tau; bits past D are clear."""
    Q = arrays[2].shape[0]
    assert got.shape == want.shape == (Q, -(-D // 32))
    differ = np.unpackbits((got ^ want).view(np.uint8), axis=-1, bitorder="little")[:, :D]
    queries, tau = arrays[2], arrays[5]
    for i, d in np.argwhere(differ):
        terms = queries[i][queries[i] >= 0]
        assert (np.abs(logits[terms, d] - tau[terms])
                <= NUMERIC_MARGIN * (1 + np.abs(tau[terms]))).any(), (i, d)
    if D % 32:
        assert (got[:, -1] >> np.uint32(D % 32)).max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("Q,T,E,D,k", [
    (37, 8, 128, 5000, 50), (128, 8, 16, 5000, 50), (5, 3, 50, 5000, 50), (70, 64, 33, 5000, 50),
    (40, 8, 128, 4099, 50),     # D = 3 mod 32
    (40, 8, 132, 5000, 50),     # rows off a 512-byte stride
    (24, 8, 128, 20_000, 2000),  # long lists: several CTAs a query
])
def test_two_tier_kernel_matches_plain_on_card(Q, T, E, D, k):
    """Ragged Q, an all-pad query, a one-term query, a repeated term, an
    empty list, E off a multiple of 4 (4-byte loads) and 64 slots, D off a
    multiple of 32, rows off a 512-byte stride, lists of 2,000 entries; the
    grid sized from the candidate count or one CTA per query (the
    grid-stride loop); bits past D never set."""
    dev = _card()
    rng = np.random.default_rng(Q * T + E)
    arrays, logits = two_tier_inputs(rng, Q, T, E, k=k, D=D)
    args = [_t(a).to(dev) for a in arrays]
    want = two_tier_ref(*args, 0.05).cpu().numpy().view(np.uint32)
    for hint in (None, 1):
        got = two_tier_candidates(*args, 0.05, max_candidates=hint)
        got = got.cpu().numpy().view(np.uint32)
        _check_two_tier(arrays, logits, got, want, D)
        assert not got[0].any() and got[1].any() and got.any()


@pytest.mark.cuda
def test_two_tier_large_shard_on_card():
    """600,000 docs (a bitmap row of 18,750 words) and lists of up to 6,000
    entries spread over the whole doc space; the grid sized from the
    candidate count or one CTA per query."""
    dev = _card()
    D = 600_000
    arrays, logits = two_tier_inputs(np.random.default_rng(12), 20, 8, 32, n_terms=60, k=6000, D=D)
    args = [_t(a).to(dev) for a in arrays]
    want = two_tier_ref(*args, 0.05).cpu().numpy().view(np.uint32)
    for hint in (None, 1):
        got = two_tier_candidates(*args, 0.05, max_candidates=hint).cpu().numpy().view(np.uint32)
        _check_two_tier(arrays, logits, got, want, D)
        assert got[:, : 9375].any() and got[:, 9375:].any()  # both halves of the docs


@pytest.mark.cuda
def test_two_tier_is_exhaustive_and_tier1_union_on_card():
    """The f_hat identity: on the card, Algorithm 2's candidates are
    Algorithm 1's (the membership kernel) ANDed with the tier-1 union, word
    for word, with one two_tier launch for the batch."""
    from repro_torch.common.config import CorpusConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.core.learned_bloom import fit_thresholds
    from repro_torch.core.membership import params_from_jax
    from repro_torch.data.corpus import synthesize_corpus
    from repro_torch.data.queries import sample_queries
    from repro_torch.index.build import build_inverted_index
    from repro_torch.kernels.membership.ref import pack_bool_words

    dev = _card()
    corpus = synthesize_corpus(CorpusConfig(n_docs=3000, n_terms=4000, avg_doc_len=60, seed=3))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(4)
    params = {"term_embed": {"table": (rng.standard_normal((4000, 64)) * 0.2).astype(np.float32)},
              "doc_embed": {"table": (rng.standard_normal((3000, 64)) * 0.2).astype(np.float32)},
              "bias": np.float32(0.1)}
    lb = fit_thresholds(params_from_jax(params, device=dev), inv)
    state = alg.build_engine(lb.model, lb.tau, inv, truncation_k=40, block_size=128)
    q = np.pad(sample_queries(corpus, 100, seed=5), ((0, 0), (0, 2)), constant_values=-1)
    q[0] = -1
    before = TWO_TIER.launches
    got = alg.run_queries(state, q, "two_tier")
    assert TWO_TIER.launches == before + 1
    union = pack_bool_words(tier1_union(state.tier1, state.tier1_len, _t(q).to(dev), 3000))
    want = alg.run_queries(state, q, "exhaustive") & union
    assert torch.equal(got, want) and got.any() and not got[0].any()


@pytest.mark.cuda
def test_two_tier_bitmap_zeroed_by_graph_replay():
    """The launch zeroes its bitmap before the atomicOr pass, so two CUDA
    graph replays give the same words."""
    dev = _card()
    arrays, _ = two_tier_inputs(np.random.default_rng(8), 64, 8, 128)
    args = [_t(a).to(dev) for a in arrays]
    want = two_tier_candidates(*args, 0.05)
    for out in _replays(lambda: two_tier_candidates(*args, 0.05)):
        assert torch.equal(out, want)


# ------------------------------------------------- the scheduler on the card
def _small_engine(dev, head=(), **cfg):
    """A 2-shard engine on ``dev`` over a 600-doc collection, parameters made
    with numpy from a seed (with an MLP head of hidden widths ``head``)."""
    from repro_torch.common.config import CorpusConfig, LearnedIndexConfig
    from repro_torch.core.learned_bloom import fit_thresholds
    from repro_torch.core.membership import params_from_jax
    from repro_torch.data.corpus import synthesize_corpus
    from repro_torch.index.build import build_inverted_index
    from repro_torch.serve import BooleanEngine, ServeConfig

    corpus = synthesize_corpus(CorpusConfig(n_docs=600, n_terms=2400, avg_doc_len=50, seed=31))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(2)
    params = {"term_embed": {"table": (rng.standard_normal((2400, 16)) * 0.3).astype(np.float32)},
              "doc_embed": {"table": (rng.standard_normal((600, 16)) * 0.3).astype(np.float32)},
              "bias": np.float32(0.0)}
    if head:
        dims = [32, *head, 1]
        params["mlp"] = [{"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                          "b": (rng.standard_normal(o) * 0.1).astype(np.float32)}
                         for i, o in zip(dims[:-1], dims[1:])]
    lb = fit_thresholds(params_from_jax(params, device=dev), inv)
    li = LearnedIndexConfig(embed_dim=16, truncation_k=16, block_size=64, mlp_hidden=tuple(head))
    eng = BooleanEngine(lb, inv, li, ServeConfig(n_shards=2, device=str(dev), **cfg))
    return corpus, inv, eng


@pytest.mark.cuda
def test_session_process_replicas_on_card_equal_inline(tmp_path):
    """Two shards, one spawned worker each, serving on the card: Boolean
    results and top-10 lists equal inline serving and brute force, and the
    workers' kernel spans land in their own trace lanes."""
    dev = _card()
    from repro_torch.data.queries import brute_force_answers, sample_queries, zipf_disjunctions
    from repro_torch.obs import Tracer, nesting_violations
    from repro_torch.rank.score import brute_force_topk
    from repro_torch.serve import QueryRequest, Session

    corpus, inv, eng = _small_engine(dev, ranked=dict(score_kernel=True))
    q = sample_queries(corpus, 32, seed=3)
    rq, _ = zipf_disjunctions(inv.dfs, 16, seed=7)
    answers = {}
    for replicas in (0, 1):
        eng.cfg.sched.n_replicas = replicas
        eng.cfg.obs.trace = tracer = Tracer()
        with Session(eng, store_dir=str(tmp_path) if replicas else None) as s:
            futs = [s.submit_async(QueryRequest(terms=row)) for row in q]
            rfuts = [s.submit_async(QueryRequest(terms=row, mode="ranked", k=10)) for row in rq]
            answers[replicas] = ([f.result(timeout=120) for f in futs],
                                 [f.result(timeout=120) for f in rfuts])
            pids = {r.pid for g in s._groups for r in g.replicas} if replicas else set()
    exact = brute_force_answers(corpus, q)
    oracle = brute_force_topk(inv, eng.impact_model, rq, 10)
    for replicas, (bools, ranked) in answers.items():
        for r, e in zip(bools, exact, strict=True):
            assert r.ok and np.array_equal(r.ids, e), replicas
        for r, o in zip(ranked, oracle, strict=True):
            assert r.ok and np.array_equal(r.ids, o.ids) and np.array_equal(r.scores, o.scores)
    worker = [sp for sp in tracer.spans if sp.pid != 0]
    assert {sp.pid for sp in worker} == pids and len(pids) == 2
    assert {"kernel.membership", "kernel.bitset"} <= {sp.name for sp in worker}
    assert nesting_violations(tracer.spans, slack_us=0.5) == []


@pytest.mark.cuda
def test_workers_find_the_kernels_already_built(tmp_path):
    """A session on a CUDA engine builds the kernels before it spawns any
    worker: the workers load the libraries and rebuild none."""
    dev = _card()
    from repro_torch.kernels import cuda
    from repro_torch.serve import Session

    corpus, inv, eng = _small_engine(dev, sched=dict(n_replicas=1))
    with Session(eng, store_dir=str(tmp_path)) as s:
        built = {p: p.stat().st_mtime_ns for p in cuda.BUILD_DIR.glob("lib*.so")}
        assert len(built) == len(list(cuda.CSRC.glob("*.cu")))
        s.warm()
        assert all(r.alive for g in s._groups for r in g.replicas)
    assert {p: p.stat().st_mtime_ns for p in cuda.BUILD_DIR.glob("lib*.so")} == built
    assert not list(cuda.BUILD_DIR.glob("*.tmp")) and cuda.build_all() == {}


# ------------------------------------------------- the MLP head on the card
# (S, D, dims): the main path's shard shape (398 slots, 132,000 docs, one
# hidden layer of 128); ragged slot and doc tiles (16 x 128 in the kernel),
# D off a word edge, H1 off the 32-unit stage; heads of depth 2 and 3 on
# the deep path
MLP_SHAPES = [(398, 132000, (128, 1)), (1, 31, (16, 1)), (17, 4097, (50, 1)),
              (65, 1000, (64, 1)), (17, 1000, (48, 32, 1)), (33, 70, (20, 24, 16, 1))]


def _mlp_inputs(rng, S, D, dims):
    """A, Bd, the later layers packed flat, and per-slot tau from the
    logits' quantiles (a quarter of them exactly on a logit)."""
    a = (rng.standard_normal((S, dims[0])) * 0.7).astype(np.float32)
    bd = (rng.standard_normal((D, dims[0])) * 0.7).astype(np.float32)
    later = np.concatenate([np.concatenate([
        (rng.standard_normal(i * o) / np.sqrt(i)).astype(np.float32),
        (rng.standard_normal(o) * 0.1).astype(np.float32)]) for i, o in zip(dims[:-1], dims[1:])])
    return a, bd, later


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,dims", MLP_SHAPES)
def test_mlp_membership_kernel_matches_plain_on_card(S, D, dims):
    dev = _card()
    rng = np.random.default_rng(11)
    a, bd, later = (_t(x).to(dev) for x in _mlp_inputs(rng, S, D, dims))
    logits = torch.cat([mlp_logits_ref(a, bd[i: i + 4096], later, dims, 0.05)
                        for i in range(0, D, 4096)], dim=1)
    tau = torch.quantile(logits[:, : min(D, 4096)], 0.6, dim=1).contiguous()
    n_on = max(1, S // 4)  # thresholds exactly on a logit: the comparison's boundary
    tau[:n_on] = logits[torch.arange(n_on), torch.from_numpy(rng.integers(0, D, n_on)).to(dev)]
    before = MLP.launches
    got = mlp_membership(a, bd, later, dims, tau, 0.05)
    assert MLP.launches == before + 1
    # every logit the kernel computes lies within the margin of the plain one
    kernel_logits = torch.empty_like(logits)
    assert torch.equal(mlp_membership(a, bd, later, dims, tau, 0.05, logits=kernel_logits), got)
    assert bool(((kernel_logits - logits).abs() <= NUMERIC_MARGIN * (1 + logits.abs())).all())
    want = mlp_membership_ref(a, bd, later, dims, tau, 0.05)
    assert got.shape == want.shape == (S, -(-D // 32))
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    differ = (((got ^ want).unsqueeze(-1) >> shifts) & 1).reshape(S, -1)[:, :D].bool()
    near = (logits - tau[:, None]).abs() <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    assert not bool((differ & ~near).any())
    g = got.cpu().numpy().view(np.uint32)
    if D % 32:
        assert (g[:, -1] >> np.uint32(D % 32)).max() == 0  # tail bits zero
    assert 0 < np.unpackbits(g.view(np.uint8)).sum() < S * D  # both verdicts occur


@pytest.mark.cuda
@pytest.mark.parametrize("head", [(24,), (24, 12)])
@pytest.mark.parametrize("algorithm", ["block", "exhaustive", "two_tier"])
def test_mlp_head_serves_exactly_on_card(head, algorithm):
    """An engine whose model has an MLP head, on the card: its candidates
    come from mlp_membership launches (one a shard and batch), hold every
    exact result (zero false negatives), and its verified results are
    exact (two-tier: to the paper's guarantee)."""
    dev = _card()
    from repro_torch.core import algorithms as alg
    from repro_torch.data.queries import brute_force_answers, sample_queries
    from repro_torch.launch.serve import check_two_tier
    from repro_torch.serve.planner import plan_batch
    from repro_torch.serve.shard import unpack_row

    corpus, inv, eng = _small_engine(dev, head=head, algorithm=algorithm)
    q = sample_queries(corpus, 32, seed=3)
    exact = brute_force_answers(corpus, q)
    for sh in eng.shards:
        cand = alg.run_queries(sh.state, eng._padded(q), algorithm).cpu().numpy().view(np.uint32)
        if algorithm == "two_tier":
            continue  # candidates cover only guaranteed queries; checked below
        for row, e in zip(cand, exact):
            local = e[(e >= sh.lo) & (e < sh.hi)] - sh.lo
            assert np.isin(local, unpack_row(row, sh.n_docs)).all()
    plan = plan_batch(eng._padded(q), eng._global_dfs, eng.shards, verified=True)
    kernels = {"exhaustive": MLP, "block": MLP_MASKED, "two_tier": MLP_TWO_TIER}
    before = {n: k.launches for n, k in kernels.items()}
    res = eng.query_batch(q)
    running = sum(bool(sp.run.any()) for sp in plan.shard_plans)
    assert running > 0
    for name, k in kernels.items():  # one launch a shard and batch, of the algorithm's entry
        assert k.launches - before[name] == (running if name == algorithm else 0), name
    if algorithm == "two_tier":
        check_two_tier(eng, q, res, exact, eng.li_cfg.truncation_k)
    else:
        for r, e in zip(res, exact):
            assert np.array_equal(r, e)


def _differ_outside(got, want, logits, tau, n):
    """Bits of (rows, words) ``got`` and ``want`` that differ where no
    pair's logit lies within the margin of tau."""
    shifts = torch.arange(32, device=got.device, dtype=torch.int32)
    differ = (((got ^ want).unsqueeze(-1) >> shifts) & 1).reshape(got.shape[0], -1)[:, :n].bool()
    near = (logits - tau[:, None]).abs() <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    return int((differ & ~near).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(128, 1), (24, 12, 1)])
def test_mlp_gelu_overflow_on_card(dims):
    """Pre-activations spanning +-30: for very negative x, 2^t overflows to
    +inf and the unit gives -0; every logit stays within the margin of the
    plain version's (F.gelu's tanh form)."""
    dev = _card()
    rng = np.random.default_rng(21)
    S, D = 9, 3000
    a, bd, later = (_t(x).to(dev) for x in _mlp_inputs(rng, S, D, dims))
    a = (a * 21.0).contiguous()  # A + Bd spans about +-60
    bd = (bd * 21.0).contiguous()
    logits = mlp_logits_ref(a, bd, later, dims, 0.05)
    tau = torch.quantile(logits, 0.5, dim=1).contiguous()
    kernel_logits = torch.empty_like(logits)
    got = mlp_membership(a, bd, later, dims, tau, 0.05, logits=kernel_logits)
    assert bool(torch.isfinite(kernel_logits).all())
    assert bool(((kernel_logits - logits).abs() <= NUMERIC_MARGIN * (1 + logits.abs())).all())
    want = mlp_membership_ref(a, bd, later, dims, tau, 0.05)
    assert _differ_outside(got, want, logits, tau, D) == 0
    x = a[:, None, :] + bd[None, :, :]
    assert float(x.min()) < -30 and float(x.max()) > 30


def _live_batch(rng, dev, D, block_size, S_per_q=(1, 8), Q=40, T=8, n_terms=60, density=0.6):
    words = -(-D // 32)
    Wb = -(-words // block_size)
    bits = rng.random((n_terms, Wb * 32)) < density
    table = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    terms = np.full((Q, T), -1, np.int32)
    for i in range(Q):
        n = int(rng.integers(S_per_q[0], S_per_q[1] + 1))
        terms[i, :n] = rng.choice(n_terms, n, replace=False)
    flat = terms.reshape(-1)
    valid = np.nonzero(flat >= 0)[0]
    return (_t(table).to(dev), _t(terms).to(dev),
            _t((valid // T).astype(np.int32)).to(dev), len(valid))


@pytest.mark.cuda
@pytest.mark.parametrize("D,block_size,dims,density", [
    (132000, 1024, (128, 1), 0.75), (5000, 64, (48, 1), 0.5), (5000, 1024, (50, 1), 0.0),
    (5000, 96, (64, 1), 1.0), (3000, 64, (24, 12, 1), 0.5)])
def test_mlp_masked_kernel_matches_plain_on_card(D, block_size, dims, density):
    """The masked launch against its plain version: zero words in dead
    blocks, the full rows' bits (outside the margin) in live ones, with
    all-dead (density 0) and all-live (density 1) masks, blocks smaller
    than, and not dividing, a 512-doc tile; a CUDA-graph replay rebuilds
    the item list and gives the same words."""
    dev = _card()
    rng = np.random.default_rng(D + block_size)
    table, terms, slot_query, S = _live_batch(rng, dev, D, block_size, density=density)
    a, bd, later = (_t(x).to(dev) for x in _mlp_inputs(rng, S, D, dims))
    logits = torch.cat([mlp_logits_ref(a, bd[i: i + 4096], later, dims, 0.05)
                        for i in range(0, D, 4096)], dim=1)
    tau = torch.quantile(logits[:, : min(D, 4096)], 0.5, dim=1).contiguous()
    live = LiveBlocks(table, terms, slot_query, block_size)
    before = MLP_MASKED.launches
    kernel_logits = torch.full_like(logits, float("nan"))
    got = mlp_membership(a, bd, later, dims, tau, 0.05, live=live, logits=kernel_logits)
    assert MLP_MASKED.launches == before + 1
    want = mlp_membership_ref(a, bd, later, dims, tau, 0.05, live)
    assert _differ_outside(got, want, logits, tau, D) == 0
    scored = ~torch.isnan(kernel_logits)
    assert bool(((kernel_logits - logits).abs() <= NUMERIC_MARGIN * (1 + logits.abs()))[scored].all())
    from repro_torch.kernels.mlp_membership.ref import live_words

    alive = live_words(live, got.shape[1])
    assert not bool(got[~alive].any())
    if density == 0.0:
        assert not bool(alive.any()) and not bool(scored.any())
    if density == 1.0:
        assert bool(alive.all())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mlp_membership(a, bd, later, dims, tau, 0.05, live=live)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = mlp_membership(a, bd, later, dims, tau, 0.05, live=live)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(128, 1), (50, 1), (24, 12, 1)])
def test_mlp_two_tier_kernel_matches_plain_on_card(dims):
    """The two-tier launch against its plain version and against the dense
    rows ANDed over each query's slots and with the union (the same
    arithmetic: equal bits): queries of 1 to 8 slots, an all-pad query, an
    empty union, a repeated term; a CUDA-graph replay starts from zero."""
    dev = _card()
    rng = np.random.default_rng(len(dims) + dims[0])
    D, n_terms, k, Q, T = 20000, 300, 400, 48, 8
    tier1 = np.full((n_terms, k), D, np.int32)
    lens = rng.integers(0, k + 1, n_terms).astype(np.int32)
    lens[:2] = 0
    for t in range(n_terms):
        tier1[t, : lens[t]] = np.sort(rng.choice(D, lens[t], replace=False))
    queries = np.full((Q, T), -1, np.int32)
    for i in range(Q):
        queries[i, : 1 + i % T] = rng.choice(np.arange(2, n_terms), 1 + i % T, replace=False)
    queries[1] = -1
    queries[2] = -1
    queries[2, :2] = [0, 1]
    queries[3, 1] = queries[3, 0]
    flat = queries.reshape(-1)
    slots = np.full(Q * T, -1, np.int32)
    S = int((flat >= 0).sum())
    slots[flat >= 0] = np.arange(S, dtype=np.int32)
    slots = slots.reshape(Q, T)
    a, bd, later = (_t(x).to(dev) for x in _mlp_inputs(rng, S, D, dims))
    logits = mlp_logits_ref(a, bd, later, dims, 0.05)
    tau = torch.quantile(logits, 0.2, dim=1).contiguous()
    t = [_t(x).to(dev) for x in (tier1, lens, queries, slots)]
    before = MLP_TWO_TIER.launches
    got = mlp_two_tier(*t, a, bd, later, dims, tau, 0.05)
    assert MLP_TWO_TIER.launches == before + 1
    want = mlp_two_tier_ref(*t, a, bd, later, dims, tau, 0.05)
    union = tier1_union(t[0], t[1], t[2], D)
    rows = mlp_membership(a, bd, later, dims, tau, 0.05)
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    bits = lambda w: ((w.unsqueeze(-1) >> shifts) & 1).reshape(w.shape[0], -1)[:, :D].bool()  # noqa: E731
    g, w, r = bits(got), bits(want), bits(rows)
    near = (logits - tau[:, None]).abs() <= NUMERIC_MARGIN * (1 + tau.abs()[:, None])
    for i in range(Q):
        ss = t[3][i][t[3][i] >= 0].long()
        exact = union[i] & r[ss].all(dim=0) if len(ss) else torch.zeros_like(union[i])
        assert torch.equal(g[i], exact), i  # the dense launch's arithmetic
        assert not bool(((g[i] != w[i]) & ~near[ss].any(dim=0)).any()), i
    assert not bool(g[1].any()) and not bool(union[2].any()) and bool(g.any())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mlp_two_tier(*t, a, bd, later, dims, tau, 0.05)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = mlp_two_tier(*t, a, bd, later, dims, tau, 0.05)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, got)


# ------------------------------------------------- membership: masked and bf16
def _membership_inputs(rng, S, D, E, dev, bf16=False):
    """Slot rows, doc rows (bf16 when asked), the fp32 logits of the table as
    the kernel reads it, and thresholds that pass about half of the docs."""
    q = _t((rng.standard_normal((S, E)) / np.sqrt(E)).astype(np.float32)).to(dev)
    d = _t(rng.standard_normal((D, E)).astype(np.float32)).to(dev)
    if bf16:
        d = d.to(torch.bfloat16)
    logits = q @ d.float().T + 0.05
    tau = torch.quantile(logits[:, : min(D, 4096)], 0.5, dim=1).contiguous()
    return q, d, logits, tau


@pytest.mark.cuda
@pytest.mark.parametrize("D,E,block_size,density,bf16", [
    (132000, 128, 1024, 0.75, False), (5000, 48, 32, 0.5, False), (5000, 64, 96, 0.0, False),
    (4097, 128, 96, 1.0, True), (3000, 50, 64, 0.5, False), (20000, 128, 1024, 0.5, True)])
def test_membership_masked_kernel_matches_plain_on_card(D, E, block_size, density, bf16):
    """The masked launch (Algorithm 3's rows) against its plain version and
    the dense launch: its words equal the dense launch's in live blocks,
    word for word (the same arithmetic), and are zero in dead ones; outside
    the margin of tau they equal the plain masked version's.  All-dead and
    all-live masks, blocks smaller than a 256-doc tile and not dividing it,
    E off the 16-byte piece (padded by the wrapper), a bf16 table; one
    launch a call, and a CUDA-graph replay rebuilds the item list."""
    dev = _card()
    rng = np.random.default_rng(D + block_size + E)
    table, terms, slot_query, S = _live_batch(rng, dev, D, block_size, density=density)
    q, d, logits, tau = _membership_inputs(rng, S, D, E, dev, bf16)
    live = LiveBlocks(table, terms, slot_query, block_size)
    before = MEMBERSHIP_MASKED.launches
    got = membership_bitmask(q, d, tau, 0.05, live=live)
    assert MEMBERSHIP_MASKED.launches == before + 1
    alive = live_words(live, got.shape[1])
    dense = membership_bitmask(q, d, tau, 0.05)
    assert torch.equal(got, torch.where(alive, dense, 0))
    want = membership_bitmask_ref(q, d, tau, 0.05, live)
    assert _differ_outside(got, want, logits, tau, D) == 0
    if density == 0.0:
        assert not bool(alive.any()) and not bool(got.any())
    elif density == 1.0:
        assert bool(alive.all())
    else:
        assert bool(got[alive].any())
    for out in _replays(lambda: membership_bitmask(q, d, tau, 0.05, live=live)):
        assert torch.equal(out, got)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,E", [(398, 132000, 128), (65, 4097, 48), (130, 300, 200),
                                   (63, 4097, 50), (1, 31, 16)])
def test_membership_bf16_table_equals_widened_on_card(S, D, E):
    """A bf16 doc table is widened exactly on its way to the FMAs: its words
    are those of the same table converted to float32, word for word, and
    within the margin of the plain version's."""
    dev = _card()
    q, d, logits, tau = _membership_inputs(np.random.default_rng(S + D + E), S, D, E, dev, True)
    got = membership_bitmask(q, d, tau, 0.05)
    assert torch.equal(got, membership_bitmask(q, d.float(), tau, 0.05))
    assert _differ_outside(got, membership_bitmask_ref(q, d, tau, 0.05), logits, tau, D) == 0
    assert bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [32, 96, 1024])
def test_block_and_two_tier_are_exhaustive_masked_on_card(block_size):
    """The identities the kernels' one arithmetic gives, at the port's width
    (E = 128): Algorithm 3's candidates (one masked membership launch, one
    bitset launch, no dense membership launch) equal Algorithm 1's ANDed
    with the expanded block AND, and Algorithm 2's equal Algorithm 1's
    ANDed with the tier-1 union, word for word."""
    from repro_torch.common.config import CorpusConfig
    from repro_torch.core import algorithms as alg
    from repro_torch.core.learned_bloom import fit_thresholds
    from repro_torch.core.membership import params_from_jax
    from repro_torch.data.corpus import synthesize_corpus
    from repro_torch.data.queries import sample_queries
    from repro_torch.index.build import build_inverted_index
    from repro_torch.kernels.bitset.kernel import KERNEL as BITSET
    from repro_torch.kernels.membership.kernel import KERNEL as MEMBERSHIP
    from repro_torch.kernels.membership.ref import pack_bool_words

    dev = _card()
    corpus = synthesize_corpus(CorpusConfig(n_docs=5000, n_terms=3000, avg_doc_len=60, seed=6))
    inv = build_inverted_index(corpus)
    rng = np.random.default_rng(block_size)
    params = {"term_embed": {"table": (rng.standard_normal((3000, 128)) * 0.1).astype(np.float32)},
              "doc_embed": {"table": (rng.standard_normal((5000, 128)) * 0.1).astype(np.float32)},
              "bias": np.float32(0.1)}
    lb = fit_thresholds(params_from_jax(params, device=dev), inv)
    state = alg.build_engine(lb.model, lb.tau, inv, truncation_k=40, block_size=block_size)
    q = np.pad(sample_queries(corpus, 100, seed=7), ((0, 0), (0, 2)), constant_values=-1)
    q[0] = -1
    counts = (MEMBERSHIP.launches, MEMBERSHIP_MASKED.launches, BITSET.launches)
    got = alg.run_queries(state, q, "block")
    assert (MEMBERSHIP.launches, MEMBERSHIP_MASKED.launches, BITSET.launches) == (
        counts[0], counts[1] + 1, counts[2] + 1)
    exhaustive = alg.run_queries(state, q, "exhaustive")
    qt = _t(q).to(dev).long()
    inter = state.block_bitmaps[qt.clamp(min=0)]
    inter = torch.where((qt >= 0)[..., None], inter, -1)
    anded = inter[:, 0]
    for t in range(1, inter.shape[1]):
        anded = anded & inter[:, t]
    wb = torch.arange(got.shape[1], device=dev) * 32 // block_size
    expand = -((anded[:, wb // 32] >> (wb % 32).to(torch.int32)) & 1)
    assert torch.equal(got, exhaustive & expand) and bool(got.any()) and not bool(got[0].any())
    union = pack_bool_words(tier1_union(state.tier1, state.tier1_len, _t(q).to(dev), 5000))
    assert torch.equal(alg.run_queries(state, q, "two_tier"), exhaustive & union)

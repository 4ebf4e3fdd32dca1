"""Each CUDA kernel of the port against its plain PyTorch version, on a card.

These tests import neither jax nor the reference, so they run where only
the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each decides inside the test whether a card exists and skips without one
(a CUDA kernel has no CPU mode).  Inputs are made with numpy from a seed.
Bitset words and counts, probe verdicts and decoded ids must be exactly
equal; membership bits may differ only where the logit lies within
NUMERIC_MARGIN * (1 + |tau|) of tau, since the two float32 products sum in
different orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.learned_bloom import NUMERIC_MARGIN
from repro_torch.kernels.bitset.kernel import bitset_and_popcount
from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref
from repro_torch.kernels.guided_search.kernel import probe_batch
from repro_torch.kernels.guided_search.ref import probe_ref
from repro_torch.kernels.membership.kernel import membership_bitmask
from repro_torch.kernels.membership.ref import membership_bitmask_ref
from repro_torch.kernels.plm_decode.kernel import decode_batch
from repro_torch.kernels.plm_decode.ref import decode_ref
from repro_torch.postings.plm import parse_stream, plm_encode
from repro_torch.postings.rmi import rmi_encode


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.cuda
def test_membership_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(1)
    q, d, e = 300, 5000, 128
    qe = (rng.standard_normal((q, e)) * 0.5).astype(np.float32)
    de = (rng.standard_normal((d, e)) * 0.5).astype(np.float32)
    logits = qe.astype(np.float64) @ de.astype(np.float64).T + 0.05
    tau = rng.standard_normal(q).astype(np.float32)
    tau[: q // 4] = logits[np.arange(q // 4), rng.integers(0, d, q // 4)].astype(np.float32)
    args = (_t(qe).to(dev), _t(de).to(dev), _t(tau).to(dev), 0.05)
    got = membership_bitmask(*args).cpu().numpy().view(np.uint32)
    want = membership_bitmask_ref(*args).cpu().numpy().view(np.uint32)
    differ = np.unpackbits((got ^ want).view(np.uint8), axis=-1, bitorder="little")[:, :d]
    near = np.abs(logits - tau[:, None]) <= NUMERIC_MARGIN * (1 + np.abs(tau[:, None]))
    assert not (differ.astype(bool) & ~near).any()
    assert (got[:, -1] >> np.uint32(d % 32)).max() == 0  # tail bits zero


@pytest.mark.cuda
def test_bitset_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(2)
    maps = _t(rng.integers(-2**31, 2**31, (64, 8, 3000)).astype(np.int32)).to(dev)
    valid = _t(rng.integers(0, 2, (64, 8)).astype(np.int32)).to(dev)
    (ga, gc), (wa, wc) = bitset_and_popcount(maps, valid), bitset_and_popcount_ref(maps, valid)
    assert torch.equal(ga, wa) and torch.equal(gc, wc)


@pytest.mark.cuda
def test_guided_search_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(3)
    p, w = 5000, 512
    seg = rng.integers(0, 5000, p).astype(np.int32)
    base = rng.integers(0, 1 << 22, p).astype(np.int32)
    # half-integer products exercise round-half-to-even
    slope = np.where(rng.random(p) < 0.3, rng.integers(0, 6, p) + 0.5,
                     rng.random(p) * 300).astype(np.float32)
    r_lo = (seg + rng.integers(0, 3000, p)).astype(np.int32)
    n_valid = rng.integers(0, w + 1, p).astype(np.int32)
    corr = rng.integers(-64, 64, (p, w)).astype(np.int32)
    j = rng.integers(0, w, p)
    cand = base + np.rint(slope * (r_lo + j - seg).astype(np.float32)).astype(np.int32)
    cand = np.where(rng.random(p) < 0.5, cand + corr[np.arange(p), j], cand + 1)
    cols = [_t(c).to(dev) for c in (seg, base, slope, r_lo, n_valid, cand.astype(np.int32), corr)]
    (gf, gl), (wf, wl) = probe_batch(*cols), probe_ref(*cols)
    assert torch.equal(gf, wf) and torch.equal(gl, wl)
    assert 0 < int(gf.sum()) < p


@pytest.mark.cuda
@pytest.mark.parametrize("encode", [plm_encode, rmi_encode], ids=["plm", "rmi"])
def test_plm_decode_kernel_matches_plain_on_card(encode):
    dev = _card()
    rng = np.random.default_rng(4)
    lists = [np.sort(rng.choice(1 << 24, n, replace=False)).astype(np.int32)
             for n in (1, 300, 5000, 20000)]
    parsed = [parse_stream(encode(ids), len(ids)) for ids in lists]
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    tabs = [_t(np.concatenate(a).astype(dt)).to(dev) for a, dt in (
        ([p[0] + off for p, off in zip(parsed, offsets)], np.int32),
        ([p[1] for p in parsed], np.int32),
        ([p[2] for p in parsed], np.float32),
        ([p[3] for p in parsed], np.int32),
    )]
    got = decode_batch(*tabs)
    assert torch.equal(got, decode_ref(*tabs))
    assert np.array_equal(got.cpu().numpy(), np.concatenate(lists))

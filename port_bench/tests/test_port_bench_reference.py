"""The plain references agree with a tiny brute force written out by hand."""
from __future__ import annotations

import numpy as np
import torch

from port_bench.gen import corpus
from port_bench.reference import membership as ref
from port_bench.reference.boolean import Conjunctions


def test_conjunctions_equal_a_loop_over_documents():
    c = corpus.synthesize(300, 50, 12, 1.2, 2.7, 5, "cpu")
    off, terms = c["doc_offsets"], c["term_ids"]
    docs = [set(terms[off[d]:off[d + 1]].tolist()) for d in range(300)]
    conj = Conjunctions(off, terms, 50, "cpu")
    rng = np.random.default_rng(0)
    for _ in range(200):
        q = rng.integers(-1, 50, size=5)
        valid = {int(t) for t in q if t >= 0}
        want = np.array([d for d in range(300) if valid and valid <= docs[d]], dtype=np.int32)
        assert torch.equal(conj.answer(q).nonzero().flatten().to(torch.int32),
                           torch.from_numpy(want))
        assert conj.is_right(q, want)
        if len(want):
            assert not conj.is_right(q, want[1:])  # an answer left out
            assert not conj.is_right(q, np.r_[want, want[-1]])  # a document twice
        extra = np.setdiff1d(np.arange(300), want)[:1]
        assert not conj.is_right(q, np.sort(np.r_[want, extra]).astype(np.int32))


def test_membership_words_equal_a_loop_over_pairs():
    gen = torch.Generator().manual_seed(1)
    params = {"doc_embed": torch.randn(96, 8, generator=gen).to(torch.bfloat16),
              "term_embed": (torch.randn(20, 8, generator=gen) / 3).to(torch.bfloat16),
              "tau": 0.3 + 0.5 * torch.rand(20, generator=gen)}
    q = torch.tensor([[1, 2, -1], [3, -1, -1], [-1, -1, -1], [4, 5, 6]], dtype=torch.int32)
    words = ref.words(params, q, "fp32")
    te, de, tau = params["term_embed"].double(), params["doc_embed"].double(), params["tau"]
    bits = ref.unpack(words)
    for i, row in enumerate(q.tolist()):
        for d in range(96):
            want = all(float(te[t] @ de[d]) >= float(tau[t]) for t in row if t >= 0)
            assert bool(bits[i, d]) == want
    assert torch.equal(ref.pack(bits), words)
    assert ref.compare(params, q, words) == {"outside": 0, "within": 0}
    flipped = words.clone()
    flipped[0, 0] ^= 1
    assert sum(ref.compare(params, q, flipped).values()) == 1


def test_pack_handles_the_sign_bit():
    bits = torch.zeros(1, 64, dtype=torch.bool)
    bits[0, 31] = bits[0, 32] = True
    w = ref.pack(bits)
    assert w.dtype == torch.int32 and int(w[0, 0]) == -2 ** 31 and int(w[0, 1]) == 1
    assert torch.equal(ref.unpack(w), bits)

"""Eq. (2) storage-gain estimator — the paper's §4 analysis, exactly (host
numpy over the port's InvertedIndex and index_size_bits).

  gain(R, s) = Σ_{t∈R} [size.full.list(t) − size.trunc.list(k)]
               − |R|·|D|·s − |T|

with size.trunc.list(k) estimated as "the average size of compressed lists of
the same length in the complete compressed inverted index" (paper §4), s the
model bits per (doc + term) pair (upper bound s=0, lower bound s=512), and the
final |T| the one replaced-or-not indicator bit per term.

`codec` may be any entry of repro_torch.index.compress.CODECS — including the
learned rank-model codecs "plm"/"rmi" and the per-term "hybrid" selector —
so the Eq. (2) bounds can be evaluated against a learned baseline index.
`learned_storage_fractions` reports the learned-vs-classical split per
correction budget ε (the storage-gain tradeoff the paper's §4 motivates).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.index.build import InvertedIndex
from repro_torch.index.compress import index_size_bits


@dataclass
class GainReport:
    k: int
    n_replaced: int
    index_bits: int  # full compressed index
    gain_upper_bits: int  # s = 0
    gain_lower_bits: int  # s = s_worst
    s_worst_bits: float

    @property
    def gain_upper_frac(self) -> float:
        return self.gain_upper_bits / max(1, self.index_bits)

    @property
    def gain_lower_frac(self) -> float:
        return self.gain_lower_bits / max(1, self.index_bits)


def avg_size_for_length(sizes: np.ndarray, dfs: np.ndarray, k: int) -> float:
    """Average compressed size of lists with length exactly (or nearest) k."""
    exact = dfs == k
    if exact.any():
        return float(sizes[exact].mean())
    # nearest-length fallback (sparse df histogram at large k)
    nz = dfs > 0
    if not nz.any():
        return 0.0
    nearest = np.abs(dfs[nz] - k)
    sel = nearest <= np.quantile(nearest, 0.001) + 1
    return float(sizes[nz][sel].mean())


def estimate_gain(
    inv: InvertedIndex,
    k: int,
    *,
    codec: str = "optpfd",
    eps: int | None = None,
    s_worst_bits: float = 512.0,
    sizes: np.ndarray | None = None,
) -> GainReport:
    dfs = inv.dfs
    if sizes is None:
        sizes = index_size_bits(inv.term_offsets, inv.doc_ids, inv.n_docs, codec, eps=eps)
    replaced = dfs > k  # R = terms whose lists get truncated
    trunc_bits = avg_size_for_length(sizes, dfs, k)
    saved = sizes[replaced].sum() - replaced.sum() * trunc_bits
    n_r = int(replaced.sum())
    model_cost_worst = n_r * inv.n_docs * s_worst_bits
    flag_bits = inv.n_terms  # one replaced-bit per term (paper §4)
    return GainReport(
        k=k,
        n_replaced=n_r,
        index_bits=int(sizes.sum()),
        gain_upper_bits=int(saved - flag_bits),
        gain_lower_bits=int(saved - model_cost_worst - flag_bits),
        s_worst_bits=s_worst_bits,
    )


def gain_curve(
    inv: InvertedIndex,
    ks: list[int],
    *,
    codec: str = "optpfd",
    eps: int | None = None,
    s_worst_bits: float = 512.0,
) -> list[GainReport]:
    sizes = index_size_bits(inv.term_offsets, inv.doc_ids, inv.n_docs, codec, eps=eps)
    return [
        estimate_gain(inv, k, codec=codec, s_worst_bits=s_worst_bits, sizes=sizes)
        for k in ks
    ]


@dataclass
class LearnedStorageReport:
    """Learned-vs-classical storage split at one correction budget ε."""

    eps: int
    classical_bits: int  # whole index under the classical codec
    learned_bits: int  # whole index under the learned codec
    hybrid_bits: int  # per-term min + 1 selector bit/term
    frac_terms_learned: float  # fraction of nonempty terms where learned wins
    frac_bits_saved: float  # 1 - hybrid/classical


def learned_storage_fractions(
    inv: InvertedIndex,
    epsilons: tuple[int, ...] = (7, 15, 63, 255),
    *,
    codec: str = "optpfd",
    learned: str = "plm",
) -> list[LearnedStorageReport]:
    """Per-ε storage split: where does the rank model beat the classical codec?

    For each ε the learned codec stores ⌈log2(2ε+1)⌉-bit corrections, so
    larger ε means fewer segments but wider corrections — this sweep is the
    Eq. (2)-style tradeoff curve for replacing postings with models.  The
    hybrid column charges 1 extra bit per term for the replaced-or-not flag
    (the paper's |T| term).
    """
    classical = index_size_bits(inv.term_offsets, inv.doc_ids, inv.n_docs, codec)
    nz = inv.dfs > 0
    out = []
    for eps in epsilons:
        lrn = index_size_bits(inv.term_offsets, inv.doc_ids, inv.n_docs, learned, eps=eps)
        hybrid = int(np.minimum(lrn, classical)[nz].sum()) + int(nz.sum())
        out.append(
            LearnedStorageReport(
                eps=eps,
                classical_bits=int(classical.sum()),
                learned_bits=int(lrn.sum()),
                hybrid_bits=hybrid,
                frac_terms_learned=float((lrn < classical)[nz].mean()) if nz.any() else 0.0,
                frac_bits_saved=1.0 - hybrid / max(1, int(classical.sum())),
            )
        )
    return out


def storage_fraction_curve(inv: InvertedIndex, codec: str = "optpfd") -> tuple[np.ndarray, np.ndarray]:
    """Fig-1 bottom: min #terms occupying each fraction of compressed storage."""
    sizes = index_size_bits(inv.term_offsets, inv.doc_ids, inv.n_docs, codec)
    order = np.argsort(sizes)[::-1]
    cum = np.cumsum(sizes[order]) / max(1, sizes.sum())
    return cum, np.arange(1, len(order) + 1)

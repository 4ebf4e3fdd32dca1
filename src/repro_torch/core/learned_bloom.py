"""Learned Bloom filter over (term, doc) pairs with zero false negatives.

Kraska et al. §5's construction as the paper uses it: a per-term threshold
τ_t = min logit over the indexed positives of t, so the model alone has ZERO
false negatives on the collection; f_hat(t,d) = logit(t,d) ≥ τ_t.

τ carries a small numerical margin (NUMERIC_MARGIN): the serving path scores
logits in another summation order than the fitting pass (the membership
kernel's sequential FMAs against a reduction here), so the same logit can
differ by a few ulp.  The margin makes the zero-FN guarantee robust to that
drift at negligible false-positive cost.

The fit is one batched pass over all postings — pair logits in chunks, then
a per-term ``scatter_reduce(amin)`` — where the reference loops over terms.
The reference's quantile spill to an exact backup set is not ported: with
the exact minimum (its default) the backup set is always empty.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.membership import MembershipModel, pair_logits
from repro_torch.index.build import InvertedIndex

# absolute + relative slack applied below the fitted min-positive logit
NUMERIC_MARGIN = 1e-5


@dataclass
class LearnedBloom:
    model: MembershipModel
    tau: torch.Tensor  # (n_terms,) float32 per-term zero-FN threshold, on the model's device
    n_docs: int
    backup_keys: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def device(self) -> torch.device:
        return self.tau.device

    def size_bits(self, embed_bits: int = 32) -> int:
        te = self.model.term_embed.weight
        de = self.model.doc_embed.weight
        return int(
            (te.numel() + de.numel()) * embed_bits
            + self.tau.numel() * 32
            + self.backup_keys.size * 64
        )


@torch.no_grad()
def fit_thresholds(
    model: MembershipModel, inv: InvertedIndex, *, chunk: int = 1 << 22
) -> LearnedBloom:
    """τ_t = min logit over t's indexed positives, minus the margin; terms
    with no postings get +inf (never fire)."""
    dev = model.bias.device
    n_terms = inv.n_terms
    term_of = np.repeat(np.arange(n_terms, dtype=np.int64), inv.dfs)
    tau = torch.full((n_terms,), float("inf"), dtype=torch.float32, device=dev)
    for s in range(0, inv.n_postings, chunk):
        t = torch.from_numpy(term_of[s : s + chunk]).to(dev)
        d = torch.from_numpy(inv.doc_ids[s : s + chunk].astype(np.int64)).to(dev)
        tau.scatter_reduce_(0, t, pair_logits(model, t, d), reduce="amin", include_self=True)
    finite = torch.isfinite(tau)
    tau[finite] -= NUMERIC_MARGIN * (1.0 + tau[finite].abs())
    return LearnedBloom(model=model, tau=tau, n_docs=inv.n_docs)


@torch.no_grad()
def bloom_predict(lb: LearnedBloom, terms: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Vectorized f_hat: logit ≥ τ_t."""
    return pair_logits(lb.model, terms, docs) >= lb.tau[terms]


def false_negative_rate(lb: LearnedBloom, inv: InvertedIndex, sample: int = 20000, seed: int = 0) -> float:
    """Must be exactly 0.0 on indexed pairs."""
    rng = np.random.default_rng(seed)
    term_of = np.repeat(np.arange(inv.n_terms, dtype=np.int64), inv.dfs)
    idx = rng.integers(0, inv.n_postings, size=min(sample, inv.n_postings))
    t = torch.from_numpy(term_of[idx]).to(lb.device)
    d = torch.from_numpy(inv.doc_ids[idx].astype(np.int64)).to(lb.device)
    pred = bloom_predict(lb, t, d)
    return float(1.0 - pred.float().mean().item())

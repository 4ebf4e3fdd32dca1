"""Public wrapper of the membership kernels: term ids -> packed f_hat
words over every doc, the reference's ``score_terms_bitmask``.

A dot-product model scores on ``membership_bitmask``, a model with an MLP
head on ``mlp_membership`` (each launches its CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor).  Neither pads: rows and docs past the
edge are masked in the kernel, so the (Q, ceil(D/32)) words are the
reference's after it strips its padded tau = +inf rows, with the tail bits
of the last word zero.
"""
from __future__ import annotations

import torch

from repro_torch.core.algorithms import score_slots
from repro_torch.core.membership import MembershipModel


def score_terms_bitmask(
    model: MembershipModel,
    terms: torch.Tensor,  # (Q,) term ids
    tau: torch.Tensor,  # (n_terms,) thresholds
) -> torch.Tensor:
    """(Q,) term ids -> (Q, ceil(D/32)) int32 packed membership bitmask."""
    terms = terms.long()
    return score_slots(model, terms, tau[terms])

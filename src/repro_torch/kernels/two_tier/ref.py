"""Plain PyTorch version of the two_tier kernel: Algorithm 2's candidate
step as the reference's ``two_tier_query`` computes it, query by query.

A query's valid tier-1 rows go through ``padded_union`` (sorted unique ids
and a count); the union's doc rows are gathered and scored against the
query's valid terms by one float32 product, thresholded against tau, and
the docs that pass for every valid term are set in the packed bitmap.  The
products sum in the matrix product's order, not the kernel's sequential
FMAs, so a bit may differ from the kernel only where the logit lies within
NUMERIC_MARGIN of tau.
"""
from __future__ import annotations

import torch

from repro_torch.index.intersect import padded_union
from repro_torch.kernels.membership.ref import pack_bool_words


def query_union(tier1: torch.Tensor, tier1_len: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """Sorted unique doc ids of the tier-1 lists of ``terms`` (valid ids)."""
    ids, count = padded_union(tier1[terms], tier1_len[terms])
    return ids[: int(count)].long()


def tier1_union(tier1: torch.Tensor, tier1_len: torch.Tensor, queries: torch.Tensor,
                n_docs: int) -> torch.Tensor:
    """(Q, n_docs) bool: doc d is in some valid slot's truncated list (an
    all-pad query's row is empty).  One scatter of the batch's list
    entries, no per-query loop."""
    q = queries.long()
    t = q.clamp(min=0)
    lens = torch.where(q >= 0, tier1_len[t], 0)  # (Q, T)
    ids = tier1[t]  # (Q, T, k)
    keep = torch.arange(ids.shape[2], device=ids.device) < lens[..., None]
    rows = torch.arange(q.shape[0], device=ids.device)[:, None, None].expand_as(ids)
    out = torch.zeros((q.shape[0], n_docs), dtype=torch.bool, device=tier1.device)
    out[rows[keep], ids[keep].long()] = True
    return out


def two_tier_ref(
    tier1: torch.Tensor,  # (n_terms, k) int32 truncated lists, padded with n_docs
    tier1_len: torch.Tensor,  # (n_terms,) int32 entries of each row
    queries: torch.Tensor,  # (Q, T) int32 term ids, -1 = pad
    term_embed: torch.Tensor,  # (n_terms, E) float32
    doc_embed: torch.Tensor,  # (D, E) float32
    tau: torch.Tensor,  # (n_terms,) float32
    bias: float,
) -> torch.Tensor:
    """-> (Q, ceil(D/32)) int32 packed candidates: the docs of the union of
    the query's valid tier-1 lists that pass f_hat for every valid term."""
    out = torch.zeros((queries.shape[0], doc_embed.shape[0]), dtype=torch.bool,
                      device=doc_embed.device)
    for i, row in enumerate(queries):
        terms = row[row >= 0].long()
        if not terms.numel():
            continue  # an all-pad query matches nothing
        ids = query_union(tier1, tier1_len, terms)
        logits = term_embed[terms] @ doc_embed[ids].T + bias
        out[i, ids[(logits >= tau[terms][:, None]).all(dim=0)]] = True
    return pack_bool_words(out)

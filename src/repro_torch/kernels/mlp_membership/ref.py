"""Plain PyTorch versions of the MLP-head membership kernels.

Per (slot, doc): h = gelu_tanh(A[slot] + Bd[doc]), the head's later
layers, + bias, >= tau[slot], packed 32 docs a word (bit i of word w = doc
32 w + i, tail bits zero).  Three forms, one a launch of
csrc/mlp_membership.cu: every pair (``mlp_membership_ref``); the same rows
with the words of dead blocks zeroed (``live``, Algorithm 3); and the
candidates of Algorithm 2 (``mlp_two_tier_ref``), which score only the
union of each query's tier-1 lists, as the reference's ``per_query`` does.  A = te[terms] @ W1[:E] and Bd = doc_embed @
W1[E:] + b1 are the first layer's halves (core/membership.py); the later
layers travel packed flat (each w row-major (h_in, h_out), then its b) with
their dims (H1, ..., 1).  It runs over doc tiles, each a broadcast (S,
tile, H1) pairing, the reference's ``term_doc_logits`` MLP branch; the
products sum in the matrix product's order, not the kernel's sequential
FMAs, so a bit may differ from the kernel only where the logit lies within
NUMERIC_MARGIN of tau.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.membership.ref import LANE, LiveBlocks, live_words, pack_bool_words
from repro_torch.kernels.two_tier.ref import query_union

TILE_FLOATS = 1 << 26  # (S, tile, H1) floats of one tile's pairing: 256 MB


def unpack_layers(later: torch.Tensor, dims: Sequence[int]) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Flat later layers -> [(w (h_in, h_out), b (h_out,)), ...]."""
    out, off = [], 0
    for h_in, h_out in zip(dims[:-1], dims[1:]):
        w = later[off: off + h_in * h_out].view(h_in, h_out)
        off += h_in * h_out
        out.append((w, later[off: off + h_out]))
        off += h_out
    if off != later.numel():
        raise ValueError(f"{later.numel()} weights for dims {tuple(dims)}, which need {off}")
    return out


def mlp_logits_ref(a: torch.Tensor, bd: torch.Tensor, later: torch.Tensor,
                   dims: Sequence[int], bias: float) -> torch.Tensor:
    """(S, H1) x (D, H1) -> (S, D) float32 logits of every (slot, doc) pair."""
    x = F.gelu(a[:, None, :] + bd[None, :, :], approximate="tanh")
    layers = unpack_layers(later, dims)
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1:
            x = F.gelu(x, approximate="tanh")
    return x[..., 0] + bias


def doc_tile(S: int, H1: int) -> int:
    """Docs per tile: whole words, about TILE_FLOATS floats of pairing."""
    return max(LANE, TILE_FLOATS // max(1, S * H1) // LANE * LANE)


def mlp_membership_ref(
    a: torch.Tensor,  # (S, H1) float32 term halves of the slots
    bd: torch.Tensor,  # (D, H1) float32 doc halves (b1 included)
    later: torch.Tensor,  # flat float32 layers after the first
    dims: Sequence[int],  # (H1, ..., 1)
    tau: torch.Tensor,  # (S,) float32 per-slot thresholds
    bias: float,
    live: LiveBlocks | None = None,
) -> torch.Tensor:
    """-> (S, ceil(D/32)) int32 packed hit mask: bit set iff logit >= tau;
    with ``live``, the words of a slot's dead blocks zero."""
    S, D = a.shape[0], bd.shape[0]
    out = torch.zeros((S, -(-D // LANE)), dtype=torch.int32, device=a.device)
    tile = doc_tile(S, a.shape[1])
    for d0 in range(0, D, tile):
        hits = mlp_logits_ref(a, bd[d0: d0 + tile], later, dims, bias) >= tau[:, None]
        w0 = d0 // LANE
        out[:, w0: w0 + -(-hits.shape[1] // LANE)] = pack_bool_words(hits)
    if live is not None:
        out = torch.where(live_words(live, out.shape[1]), out, torch.zeros_like(out))
    return out


def mlp_two_tier_ref(
    tier1: torch.Tensor,  # (n_terms, k) int32 truncated lists, padded with n_docs
    tier1_len: torch.Tensor,  # (n_terms,) int32 entries of each row
    queries: torch.Tensor,  # (Q, T) int32 term ids, -1 = pad
    slots: torch.Tensor,  # (Q, T) int32 row of ``a`` and ``tau`` per valid term, -1 = pad
    a: torch.Tensor,  # (S, H1) float32 term halves of the slots
    bd: torch.Tensor,  # (D, H1) float32 doc halves
    later: torch.Tensor,  # flat float32 layers after the first
    dims: Sequence[int],  # (H1, ..., 1)
    tau: torch.Tensor,  # (S,) float32 per-slot thresholds
    bias: float,
) -> torch.Tensor:
    """-> (Q, ceil(D/32)) int32 packed candidates: the docs of the union of
    the query's valid tier-1 lists whose logit passes tau for every valid
    slot; query by query, the union's docs only."""
    D = bd.shape[0]
    out = torch.zeros((queries.shape[0], D), dtype=torch.bool, device=bd.device)
    for i, (row, srow) in enumerate(zip(queries, slots)):
        ok = row >= 0
        if not bool(ok.any()):
            continue  # an all-pad query matches nothing
        ids = query_union(tier1, tier1_len, row[ok].long())
        rows = srow[ok].long()
        keep = torch.zeros(len(ids), dtype=torch.bool, device=bd.device)
        tile = doc_tile(len(rows), a.shape[1])
        for d0 in range(0, len(ids), tile):
            logits = mlp_logits_ref(a[rows], bd[ids[d0: d0 + tile]], later, dims, bias)
            keep[d0: d0 + tile] = (logits >= tau[rows][:, None]).all(dim=0)
        out[i, ids[keep]] = True
    return pack_bool_words(out)

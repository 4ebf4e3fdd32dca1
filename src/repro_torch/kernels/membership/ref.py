"""Plain PyTorch version of the fused membership-scoring kernel, and
Algorithm 3's live-block rule that its masked launch (and the MLP head's)
follows.

Packed words are carried as int32 tensors holding the uint32 bit patterns
(bit i of word w = doc 32*w + i); ``.numpy().view(np.uint32)`` reads them
back as unsigned words.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

LANE = 32  # docs per packed word


class LiveBlocks(NamedTuple):
    """Algorithm 3's live-block mask of a batch's slots: a slot's row is
    needed only in the blocks that survive its query's block AND."""

    table: torch.Tensor  # (n_terms, Wb) int32 block bitmaps, bit b = block b
    terms: torch.Tensor  # (Q, T) int32 term ids, -1 = pad
    slot_query: torch.Tensor  # (S,) int32 query of each slot
    block_size: int  # docs a block, a multiple of 32


def live_words(live: LiveBlocks, words: int) -> torch.Tensor:
    """-> (S, words) bool: the word lies in a block that survives the block
    AND of the slot's query (valid terms only; a query with none keeps no
    block)."""
    valid = live.terms >= 0
    rows = torch.where(valid[..., None], live.table[live.terms.clamp(min=0).long()], -1)
    anded = rows[:, 0].clone()
    for t in range(1, rows.shape[1]):
        anded &= rows[:, t]
    anded = torch.where(valid.any(dim=1, keepdim=True), anded, torch.zeros_like(anded))
    blk = torch.arange(words, device=anded.device) * LANE // live.block_size
    alive = ((anded[:, blk // 32] >> (blk % 32).to(torch.int32)) & 1).bool()  # (Q, words)
    return alive[live.slot_query.long()]


def to_int32_words(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bit pattern."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def pack_bool_words(bits: torch.Tensor) -> torch.Tensor:
    """(N, D) bool -> (N, ceil(D/32)) int32 words, little-endian bit order;
    the tail bits of the last word are zero."""
    n, d = bits.shape
    words = -(-d // LANE)
    padded = torch.zeros((n, words * LANE), dtype=torch.int64, device=bits.device)
    padded[:, :d] = bits.to(torch.int64)
    weights = torch.ones(LANE, dtype=torch.int64, device=bits.device) << torch.arange(
        LANE, device=bits.device
    )
    return to_int32_words((padded.view(n, words, LANE) * weights).sum(-1))


def membership_logits_ref(q_embed: torch.Tensor, d_embed: torch.Tensor, bias: float) -> torch.Tensor:
    """(Q, E) x (D, E)^T float32 logits + bias (full fp32 product)."""
    return q_embed.float() @ d_embed.float().T + bias


def membership_bitmask_ref(
    q_embed: torch.Tensor,  # (Q, E) float32 query-term embeddings
    d_embed: torch.Tensor,  # (D, E) float32 or bfloat16 doc embeddings
    tau: torch.Tensor,  # (Q,) float32 per-row thresholds
    bias: float,
    live: LiveBlocks | None = None,
) -> torch.Tensor:
    """-> (Q, ceil(D/32)) int32 packed hit mask: bit set iff logit >= tau;
    with ``live`` (Algorithm 3), the words of a row's dead blocks zero."""
    hits = membership_logits_ref(q_embed, d_embed, bias) >= tau[:, None]
    out = pack_bool_words(hits)
    if live is not None:
        out = torch.where(live_words(live, out.shape[1]), out, torch.zeros_like(out))
    return out

"""Plain PyTorch version of the fused membership-scoring kernel.

Packed words are carried as int32 tensors holding the uint32 bit patterns
(bit i of word w = doc 32*w + i); ``.numpy().view(np.uint32)`` reads them
back as unsigned words.
"""
from __future__ import annotations

import torch

LANE = 32  # docs per packed word


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
    d_embed: torch.Tensor,  # (D, E) float32 doc embeddings
    tau: torch.Tensor,  # (Q,) float32 per-row thresholds
    bias: float,
) -> torch.Tensor:
    """-> (Q, ceil(D/32)) int32 packed hit mask: bit set iff logit >= tau."""
    hits = membership_logits_ref(q_embed, d_embed, bias) >= tau[:, None]
    return pack_bool_words(hits)

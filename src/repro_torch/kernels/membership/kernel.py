"""Wrapper of the fused membership-scoring kernel (csrc/membership.cu).

(Q,E) x (D,E)^T true-fp32 logits + bias, thresholded per row against tau and
packed 32 docs per word.  Ragged Q and D need no padding: the kernel masks
rows and docs past the edge, and the tail bits of the last word are zero,
which is what the reference's padding (tau=+inf rows, 512-doc tiles, masked
tail word) computes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import F, I, P, CudaKernel, check
from repro_torch.kernels.membership.ref import LANE, membership_bitmask_ref

KERNEL = CudaKernel("membership", "membership_bitmask_launch", [P, P, P, F, P, I, I, I, I])


def membership_bitmask(
    q_embed: torch.Tensor,  # (Q, E) float32
    d_embed: torch.Tensor,  # (D, E) float32
    tau: torch.Tensor,  # (Q,) float32
    bias: float,
) -> torch.Tensor:
    """-> (Q, ceil(D/32)) int32 packed hit mask (uint32 bit patterns)."""
    dev = q_embed.device
    if dev.type == "cpu":
        return membership_bitmask_ref(q_embed, d_embed, tau, bias)
    if dev.type != "cuda":
        raise ValueError(f"membership_bitmask: unsupported device {dev}")
    check(q_embed, "q_embed", torch.float32, 2, dev)
    check(d_embed, "d_embed", torch.float32, 2, dev)
    check(tau, "tau", torch.float32, 1, dev)
    (Q, E), D = q_embed.shape, d_embed.shape[0]
    if d_embed.shape[1] != E or tau.shape[0] != Q:
        raise ValueError(f"shapes q {tuple(q_embed.shape)}, d {tuple(d_embed.shape)}, tau {tuple(tau.shape)}")
    words = -(-D // LANE)
    out = torch.empty((Q, words), dtype=torch.int32, device=dev)
    KERNEL.launch(q_embed.data_ptr(), d_embed.data_ptr(), tau.data_ptr(), float(bias),
                  out.data_ptr(), Q, D, E, words)
    return out

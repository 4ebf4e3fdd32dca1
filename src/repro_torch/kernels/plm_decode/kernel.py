"""Wrapper of the batched PLM/RMI decode kernel (csrc/plm_decode.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.plm_decode.ref import decode_ref

KERNEL = CudaKernel("plm_decode", "decode_batch_launch", [P, P, P, P, P, I, I])


def decode_batch(
    seg_pos: torch.Tensor,  # (S,) int32 flat position of each segment's first posting
    bases: torch.Tensor,  # (S,) int32
    slopes: torch.Tensor,  # (S,) float32
    corr: torch.Tensor,  # (N,) int32, the batch's lists end to end
) -> torch.Tensor:
    """Decode a ragged batch of lists -> (N,) int32 doc ids."""
    dev = corr.device
    if dev.type == "cpu":
        return decode_ref(seg_pos, bases, slopes, corr)
    if dev.type != "cuda":
        raise ValueError(f"decode_batch: unsupported device {dev}")
    check(seg_pos, "seg_pos", torch.int32, 1, dev)
    check(bases, "bases", torch.int32, 1, dev)
    check(slopes, "slopes", torch.float32, 1, dev)
    check(corr, "corr", torch.int32, 1, dev)
    S, N = seg_pos.shape[0], corr.shape[0]
    if bases.shape[0] != S or slopes.shape[0] != S:
        raise ValueError("segment positions, bases and slopes disagree on length")
    out = torch.empty(N, dtype=torch.int32, device=dev)
    KERNEL.launch(*(t.data_ptr() for t in (seg_pos, bases, slopes, corr, out)), S, N)
    return out

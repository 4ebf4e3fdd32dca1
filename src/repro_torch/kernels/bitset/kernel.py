"""Wrapper of the packed-bitset AND + popcount kernel (csrc/bitset.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset.ref import bitset_and_popcount_ref
from repro_torch.kernels.cuda import I, P, CudaKernel, check

KERNEL = CudaKernel("bitset", "bitset_and_popcount_launch", [P, P, P, P, I, I, I])


def bitset_and_popcount(
    bitmaps: torch.Tensor,  # (Q, T, W) int32 (uint32 bit patterns)
    valid: torch.Tensor,  # (Q, T) int32, > 0 marks a real term
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> ((Q, W) int32 AND over each query's valid terms, (Q,) int32 count
    of surviving blocks).  Invalid terms act as all-ones."""
    dev = bitmaps.device
    if dev.type == "cpu":
        return bitset_and_popcount_ref(bitmaps, valid)
    if dev.type != "cuda":
        raise ValueError(f"bitset_and_popcount: unsupported device {dev}")
    check(bitmaps, "bitmaps", torch.int32, 3, dev)
    check(valid, "valid", torch.int32, 2, dev)
    Q, T, W = bitmaps.shape
    if tuple(valid.shape) != (Q, T):
        raise ValueError(f"valid shape {tuple(valid.shape)} != {(Q, T)}")
    if Q > 65535:
        raise ValueError(f"{Q} queries exceed the kernel's grid (65535)")
    anded = torch.empty((Q, W), dtype=torch.int32, device=dev)
    count = torch.zeros(Q, dtype=torch.int32, device=dev)  # atomic accumulator
    KERNEL.launch(*(t.data_ptr() for t in (bitmaps, valid, anded, count)), Q, T, W)
    return anded, count

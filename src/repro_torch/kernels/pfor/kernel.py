"""Wrapper of the OptPFD block-decode kernel (csrc/pfor.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.pfor.ref import META, pfor_unpack_ref

KERNEL = CudaKernel("pfor", "pfor_unpack_launch", [P, P, P, I])


def pfor_unpack(words: torch.Tensor, meta: torch.Tensor, n_out: int) -> torch.Tensor:
    """Decode every block that ``meta`` describes -> (n_out,) int32 gaps
    (uint32 bit patterns); see ref.py for the layout."""
    dev = words.device
    if dev.type == "cpu":
        return pfor_unpack_ref(words, meta, n_out)
    if dev.type != "cuda":
        raise ValueError(f"pfor_unpack: unsupported device {dev}")
    check(words, "words", torch.int32, 1, dev)
    check(meta, "meta", torch.int32, 2, dev)
    if meta.shape[1] != META:
        raise ValueError(f"meta has {meta.shape[1]} columns, expected {META}")
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    KERNEL.launch(words.data_ptr(), meta.data_ptr(), out.data_ptr(), meta.shape[0])
    return out

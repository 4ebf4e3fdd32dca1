"""Wrapper of the batched epsilon-window probe kernel (csrc/guided_search.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.guided_search.ref import probe_ref

KERNEL = CudaKernel("guided_search", "probe_batch_launch", [P] * 9 + [I, I])


def probe_batch(
    seg_starts: torch.Tensor,  # (P,) int32
    bases: torch.Tensor,  # (P,) int32
    slopes: torch.Tensor,  # (P,) float32
    r_lo: torch.Tensor,  # (P,) int32
    n_valid: torch.Tensor,  # (P,) int32
    cands: torch.Tensor,  # (P,) int32
    corr: torch.Tensor,  # (P, W) int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe P windows -> (found (P,) int32, lt (P,) int32)."""
    dev = corr.device
    if dev.type == "cpu":
        return probe_ref(seg_starts, bases, slopes, r_lo, n_valid, cands, corr)
    if dev.type != "cuda":
        raise ValueError(f"probe_batch: unsupported device {dev}")
    check(corr, "corr", torch.int32, 2, dev)
    n_probes, width = corr.shape
    for name, t, dtype in (
        ("seg_starts", seg_starts, torch.int32), ("bases", bases, torch.int32),
        ("slopes", slopes, torch.float32), ("r_lo", r_lo, torch.int32),
        ("n_valid", n_valid, torch.int32), ("cands", cands, torch.int32),
    ):
        check(t, name, dtype, 1, dev)
        if t.shape[0] != n_probes:
            raise ValueError(f"{name} has {t.shape[0]} rows, corr {n_probes}")
    found = torch.empty(n_probes, dtype=torch.int32, device=dev)
    lt = torch.empty(n_probes, dtype=torch.int32, device=dev)
    cols = (seg_starts, bases, slopes, r_lo, n_valid, cands, corr, found, lt)
    KERNEL.launch(*(t.data_ptr() for t in cols), n_probes, width)
    return found, lt

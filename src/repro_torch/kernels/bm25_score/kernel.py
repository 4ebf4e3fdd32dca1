"""Wrapper of the batched quantized-BM25 scoring kernel (csrc/bm25_score.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.bm25_score.ref import score_ref
from repro_torch.kernels.cuda import F, I, P, CudaKernel, check

KERNEL = CudaKernel("bm25_score", "bm25_score_launch", [P, P, P, I, I, F])


def score_batch(impacts: torch.Tensor, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Score P candidate rows of a (P, T) int32 impact window -> (int32 (P,),
    float32 (P,)): the row sum and that sum times ``scale`` in float32."""
    dev = impacts.device
    if dev.type == "cpu":
        return score_ref(impacts, scale)
    if dev.type != "cuda":
        raise ValueError(f"score_batch: unsupported device {dev}")
    check(impacts, "impacts", torch.int32, 2, dev)
    n_rows, n_terms = impacts.shape
    ints = torch.empty(n_rows, dtype=torch.int32, device=dev)
    floats = torch.empty(n_rows, dtype=torch.float32, device=dev)
    KERNEL.launch(impacts.data_ptr(), ints.data_ptr(), floats.data_ptr(), n_rows, n_terms,
                  float(scale))
    return ints, floats

"""Host bridge: a (candidate, term) impact window -> bm25_score on a device.

The window goes to the device at its true width: the reference bridge pads
the term axis to 128 lanes and the candidate axis to buckets of 8 rows for
the TPU's tiles and jit shapes; this kernel needs neither.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bm25_score.kernel import score_batch
from repro_torch.obs import trace


def score_candidates(
    impacts: np.ndarray, scale: float, *, device: torch.device | str
) -> tuple[np.ndarray, np.ndarray]:
    """Score a (P, T) quantized-impact window -> (int32 scores (P,), float32
    scores (P,)), bit-exact against the reference's ``score_ref``."""
    imp = np.ascontiguousarray(impacts, np.int32)
    if imp.shape[0] == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    with trace.span("kernel.bm25_score", candidates=int(imp.shape[0]), terms=int(imp.shape[1])):
        ints, floats = score_batch(torch.from_numpy(imp).to(device), scale)
        return ints.cpu().numpy(), floats.cpu().numpy()

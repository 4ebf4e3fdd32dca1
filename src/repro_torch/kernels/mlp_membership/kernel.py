"""Wrapper of the MLP-head membership kernel (csrc/mlp_membership.cu).

The contract of ``membership_bitmask``, for a model with a head: per slot
its term half A = te[t] @ W1[:E] and its tau, per doc its half Bd =
doc_embed @ W1[E:] + b1, the later layers packed flat with their dims
(``MembershipModel.doc_side``) -> (S, ceil(D/32)) int32 packed hit words
(uint32 bit patterns), tail bits zero.  It drops into Algorithms 1-3 where
the dot-product model uses ``membership_bitmask`` (core/algorithms.py).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.cuda import F, I, P, CudaKernel, check
from repro_torch.kernels.membership.ref import LANE
from repro_torch.kernels.mlp_membership.ref import mlp_membership_ref

KERNEL = CudaKernel("mlp_membership", "mlp_membership_launch",
                    [P, P, P, P, I, P, F, P, P, I, I, I, I])
MAX_LAYERS = 4  # layers after the first
MAX_WIDTH = 256  # hidden widths after the first layer
MAX_SMEM = 227 << 10
SHALLOW_TILES = 4 * 32 * (17 + 129)  # the shallow path's static shared tiles, bytes


def mlp_membership(
    a: torch.Tensor,  # (S, H1) float32
    bd: torch.Tensor,  # (D, H1) float32
    later: torch.Tensor,  # flat float32 layers after the first
    dims: Sequence[int],  # (H1, ..., 1)
    tau: torch.Tensor,  # (S,) float32
    bias: float,
    *,
    logits: torch.Tensor | None = None,
) -> torch.Tensor:
    """-> (S, ceil(D/32)) int32 packed hit mask: bit set iff logit >= tau.

    ``logits``, an (S, D) float32 tensor on the card, also receives every
    pair's logit (a check against the plain version's ``mlp_logits_ref``)."""
    dev = a.device
    if dev.type == "cpu":
        if logits is not None:
            raise ValueError("mlp_membership: logits are written by the CUDA kernel only")
        return mlp_membership_ref(a, bd, later, dims, tau, bias)
    if dev.type != "cuda":
        raise ValueError(f"mlp_membership: unsupported device {dev}")
    check(a, "a", torch.float32, 2, dev)
    check(bd, "bd", torch.float32, 2, dev)
    check(later, "later", torch.float32, 1, dev)
    check(tau, "tau", torch.float32, 1, dev)
    (S, H1), D = a.shape, bd.shape[0]
    if logits is not None:
        check(logits, "logits", torch.float32, 2, dev)
        if tuple(logits.shape) != (S, D):
            raise ValueError(f"logits shape {tuple(logits.shape)} != {(S, D)}")
    dims = tuple(int(h) for h in dims)
    n_later = len(dims) - 1
    need = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    if bd.shape[1] != H1 or tau.shape[0] != S or dims[0] != H1 or dims[-1] != 1 \
            or later.numel() != need:
        raise ValueError(f"shapes a {tuple(a.shape)}, bd {tuple(bd.shape)}, tau "
                         f"{tuple(tau.shape)}, {later.numel()} later weights for dims {dims}")
    smem = 4 * need + (SHALLOW_TILES if n_later == 1 else 0)
    if not 1 <= n_later <= MAX_LAYERS or max(dims[1:-1], default=1) > MAX_WIDTH \
            or smem > MAX_SMEM:
        raise ValueError(f"dims {dims} exceed the kernel's {MAX_LAYERS} later layers, "
                         f"width {MAX_WIDTH} or {MAX_SMEM} bytes of shared memory")
    words = -(-D // LANE)
    out = torch.empty((S, words), dtype=torch.int32, device=dev)  # every word is written
    dims_host = np.asarray(dims, dtype=np.int32)  # read by the host before the launch
    KERNEL.launch(a.data_ptr(), bd.data_ptr(), later.data_ptr(), dims_host.ctypes.data, n_later,
                  tau.data_ptr(), float(bias), out.data_ptr(),
                  None if logits is None else logits.data_ptr(), S, D, H1, words)
    return out

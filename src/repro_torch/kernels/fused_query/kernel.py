"""Wrapper of the fused ranked-query kernel (csrc/fused_topk.cu).

Input contract, the reference bridge's tiles (Q padded queries, T tail
terms, C candidates, W window lanes):
  per (Q, T):       width (u32 bit patterns in int32), corr_min int32
  per (Q, T, C):    rlo, wlen, segstart, base int32; slope float32
  per (Q, T, C, W): correction and payload lo/hi word pairs (u32 in int32)
  per (Q, C):       candidate ids (pad = NEVER), partial scores int32
  per (Q, 1):       score floor int32
-> (Q, k) int32 ids (-1 for an empty slot) and (Q, k) int32 scores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.fused_query.ref import fused_topk_ref

KERNEL = CudaKernel("fused_topk", "fused_topk_launch", [P] * 18 + [I] * 6)
SLICE = 1024  # candidates per select block of csrc/fused_topk.cu

_NAMES = ("width", "cmin", "rlo", "wlen", "start", "base", "slope", "clo", "chi",
          "plo", "phi", "cand", "part", "floor")
_RANKS = (2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4, 2, 2, 2)


def fused_topk(width, cmin, rlo, wlen, start, base, slope, clo, chi, plo, phi,
               cand, part, floor, *, k: int, pbits: int):
    """One launch: (Q, T, C, W) probe tiles -> (Q, k) top-k ids and scores."""
    tiles = (width, cmin, rlo, wlen, start, base, slope, clo, chi, plo, phi, cand, part, floor)
    dev = clo.device
    if dev.type == "cpu":
        return fused_topk_ref(*tiles, k=k, pbits=pbits)
    if dev.type != "cuda":
        raise ValueError(f"fused_topk: unsupported device {dev}")
    Q, T, C, W = clo.shape
    for name, t, rank in zip(_NAMES, tiles, _RANKS):
        check(t, name, torch.float32 if name == "slope" else torch.int32, rank, dev)
        want = {2: (Q, T), 3: (Q, T, C), 4: (Q, T, C, W)}[rank]
        if name in ("cand", "part"):
            want = (Q, C)
        elif name == "floor":
            want = (Q, 1)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    out_ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    out_scores = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or k == 0:
        return out_ids, out_scores
    if C == 0:
        return out_ids.fill_(-1), out_scores.zero_()
    # scratch: each slice's sorted top min(k, SLICE) keys, and the merge's
    # position in each of them
    S = -(-C // SLICE)
    lists = torch.empty((Q, S, min(k, SLICE)), dtype=torch.int64, device=dev)
    pos = torch.empty((Q, S), dtype=torch.int32, device=dev)
    KERNEL.launch(*(t.data_ptr() for t in tiles), lists.data_ptr(), pos.data_ptr(),
                  out_ids.data_ptr(), out_scores.data_ptr(), Q, T, C, W, k, pbits)
    return out_ids, out_scores

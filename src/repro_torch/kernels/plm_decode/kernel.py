"""Wrapper of the batched PLM/RMI decode kernel (csrc/plm_decode.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.plm_decode.ref import LIST_COLS, decode_ref

KERNEL = CudaKernel("plm_decode", "decode_batch_launch", [P, P, P, P, P, P, I, I, I])


def decode_batch(
    seg_pos: torch.Tensor,  # (S,) int32 flat position of each segment's first posting
    bases: torch.Tensor,  # (S,) int32
    slopes: torch.Tensor,  # (S,) float32
    lists: torch.Tensor,  # (L, 4) int32 [first position, first word, width, corr_min]
    words: torch.Tensor,  # (n_words,) int32 packed corrections, lists end to end
    n: int,  # postings in the batch
) -> torch.Tensor:
    """Decode a ragged batch of lists -> (n,) int32 doc ids; see ref.py."""
    dev = words.device
    if dev.type == "cpu":
        return decode_ref(seg_pos, bases, slopes, lists, words, n)
    if dev.type != "cuda":
        raise ValueError(f"decode_batch: unsupported device {dev}")
    check(seg_pos, "seg_pos", torch.int32, 1, dev)
    check(bases, "bases", torch.int32, 1, dev)
    check(slopes, "slopes", torch.float32, 1, dev)
    check(lists, "lists", torch.int32, 2, dev)
    check(words, "words", torch.int32, 1, dev)
    S, L = seg_pos.shape[0], lists.shape[0]
    if bases.shape[0] != S or slopes.shape[0] != S:
        raise ValueError("segment positions, bases and slopes disagree on length")
    if lists.shape[1] != LIST_COLS or (n > 0 and L == 0):
        raise ValueError(f"lists must be (L >= 1, {LIST_COLS}) rows, got {tuple(lists.shape)}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    KERNEL.launch(*(t.data_ptr() for t in (seg_pos, bases, slopes, lists, words, out)), S, L, n)
    return out

"""Wrapper of the packed-bitset kernel (csrc/bitset.cu): Algorithm 3's block
step, the block AND + popcount and the AND of the membership rows in the
blocks that survive it, in one launch."""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset.ref import block_candidates_ref
from repro_torch.kernels.cuda import I, P, CudaKernel, check

# the kernel Algorithm 3's block step launches (core/algorithms.py:block_query)
KERNEL = CudaKernel("bitset", "block_candidates_launch",
                    [P, I, P, P, I, P, I, I, I, P, P, P, I])
MAX_TERMS = 64  # query slots the fused kernel keeps in shared memory
MAX_GRID_Y = 65535


def block_candidates(
    table: torch.Tensor,  # (n_terms, Wb) int32 block bitmaps, bit b = block b
    terms: torch.Tensor,  # (Q, T) int32 term ids, -1 = pad
    slots: torch.Tensor,  # (Q, T) int32 row of ``rows`` per valid slot, -1 = pad
    rows: torch.Tensor,  # (R, words) int32 packed f_hat rows of the valid slots
    n_docs: int,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 3's block step -> ((Q, words) int32 candidate words: the
    rows ANDed over each query's valid terms, kept in the blocks that
    survive the block AND, zero past ``n_docs`` and for an all-pad query;
    (Q, Wb) int32 block AND; (Q,) int32 surviving-block count).  The last
    two are ``bitset_and_popcount_ref`` of the query's table rows."""
    dev = table.device
    if dev.type == "cpu":
        return block_candidates_ref(table, terms, slots, rows, n_docs, block_size)
    if dev.type != "cuda":
        raise ValueError(f"block_candidates: unsupported device {dev}")
    check(table, "table", torch.int32, 2, dev)
    check(terms, "terms", torch.int32, 2, dev)
    check(slots, "slots", torch.int32, 2, dev)
    check(rows, "rows", torch.int32, 2, dev)
    Q, T = terms.shape
    Wb = table.shape[1]
    words = -(-n_docs // 32)
    if tuple(slots.shape) != (Q, T):
        raise ValueError(f"slots shape {tuple(slots.shape)} != {(Q, T)}")
    if rows.shape[1] != words:
        raise ValueError(f"rows have {rows.shape[1]} words, {n_docs} docs need {words}")
    if block_size % 32 or block_size <= 0:
        raise ValueError(f"block_size {block_size} is not a positive multiple of 32")
    if Wb != -(-words // block_size):
        raise ValueError(f"{Wb} block words per term, {n_docs} docs in blocks of "
                         f"{block_size} need {-(-words // block_size)}")
    if T > MAX_TERMS or Q > MAX_GRID_Y:
        raise ValueError(f"(Q, T) = {(Q, T)} exceeds the kernel's {MAX_GRID_Y} x {MAX_TERMS}")
    cand = torch.empty((Q, words), dtype=torch.int32, device=dev)
    anded = torch.empty((Q, Wb), dtype=torch.int32, device=dev)
    count = torch.empty(Q, dtype=torch.int32, device=dev)  # zeroed by the launch
    KERNEL.launch(table.data_ptr(), Wb, terms.data_ptr(), slots.data_ptr(), T, rows.data_ptr(),
                  words, block_size // 32, n_docs % 32, cand.data_ptr(), anded.data_ptr(),
                  count.data_ptr(), Q)
    return cand, anded, count

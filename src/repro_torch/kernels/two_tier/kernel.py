"""Wrapper of the two-tier candidate kernel (csrc/two_tier.cu): Algorithm
2's tier-1 union and its f_hat test over every valid term, one launch per
query batch."""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import F, I, P, CudaKernel, check
from repro_torch.kernels.two_tier.ref import two_tier_ref

# the kernel Algorithm 2 launches (core/algorithms.py:two_tier_query)
KERNEL = CudaKernel("two_tier", "two_tier_launch", [P, I, P, P, I, P, P, I, P, F, P, I, I, I, I])
MAX_TERMS = 64  # query slots the kernel keeps in shared memory
MAX_GRID_Y = 65535
THREADS = 256
PER_THREAD = 4  # candidate positions a thread takes, at the grid width chosen here
MAX_SMEM = 227 << 10
# shared memory beside the term rows: the 8 warps' staging tiles (32 rows
# of 36 floats) and, rounded up, their queues and the slot tables
OTHER_SMEM = 8 * 32 * 36 * 4 + (4 << 10)


def two_tier_candidates(
    tier1: torch.Tensor,  # (n_terms, k) int32 truncated lists, padded with n_docs
    tier1_len: torch.Tensor,  # (n_terms,) int32 entries of each row
    queries: torch.Tensor,  # (Q, T) int32 term ids, -1 = pad
    term_embed: torch.Tensor,  # (n_terms, E) float32
    doc_embed: torch.Tensor,  # (D, E) float32
    tau: torch.Tensor,  # (n_terms,) float32
    bias: float,
    *,
    max_candidates: int | None = None,
) -> torch.Tensor:
    """-> (Q, ceil(D/32)) int32 packed candidates (uint32 bit patterns): the
    docs of the union of each query's valid tier-1 lists that pass f_hat
    for every valid term.  ``max_candidates``, the largest sum of a query's
    valid list lengths, only sizes the grid (T * k when not given)."""
    dev = tier1.device
    if dev.type == "cpu":
        return two_tier_ref(tier1, tier1_len, queries, term_embed, doc_embed, tau, bias)
    if dev.type != "cuda":
        raise ValueError(f"two_tier_candidates: unsupported device {dev}")
    check(tier1, "tier1", torch.int32, 2, dev)
    check(tier1_len, "tier1_len", torch.int32, 1, dev)
    check(queries, "queries", torch.int32, 2, dev)
    check(term_embed, "term_embed", torch.float32, 2, dev)
    check(doc_embed, "doc_embed", torch.float32, 2, dev)
    check(tau, "tau", torch.float32, 1, dev)
    n_terms, k = tier1.shape
    Q, T = queries.shape
    D, E = doc_embed.shape
    if tier1_len.shape[0] != n_terms or tau.shape[0] != n_terms or tuple(
            term_embed.shape) != (n_terms, E):
        raise ValueError(f"shapes tier1 {tuple(tier1.shape)}, tier1_len {tuple(tier1_len.shape)}, "
                         f"tau {tuple(tau.shape)}, term_embed {tuple(term_embed.shape)}, "
                         f"doc_embed {tuple(doc_embed.shape)}")
    if T > MAX_TERMS or Q > MAX_GRID_Y or 16 * -(-T * E // 4) + OTHER_SMEM > MAX_SMEM:
        raise ValueError(f"(Q, T, E) = {(Q, T, E)} exceeds the kernel's {MAX_GRID_Y} queries, "
                         f"{MAX_TERMS} slots and {MAX_SMEM} bytes of shared memory")
    words = -(-D // 32)
    span = T * k if max_candidates is None else min(int(max_candidates), T * k)
    grid_x = max(1, -(-span // (THREADS * PER_THREAD)))
    out = torch.empty((Q, words), dtype=torch.int32, device=dev)  # zeroed by the launch
    KERNEL.launch(tier1.data_ptr(), k, tier1_len.data_ptr(), queries.data_ptr(), T,
                  term_embed.data_ptr(), doc_embed.data_ptr(), E, tau.data_ptr(), float(bias),
                  out.data_ptr(), D, words, Q, grid_x)
    return out

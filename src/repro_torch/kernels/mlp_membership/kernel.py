"""Wrappers of the MLP-head membership kernels (csrc/mlp_membership.cu).

The contract of ``membership_bitmask``, for a model with a head: per slot
its term half A = te[t] @ W1[:E] and its tau, per doc its half Bd =
doc_embed @ W1[E:] + b1, the later layers packed flat with their dims
(``MembershipModel.doc_side``) -> (S, ceil(D/32)) int32 packed hit words
(uint32 bit patterns), tail bits zero.  ``mlp_membership`` computes every
pair (Algorithm 1), or, given Algorithm 3's ``LiveBlocks``, only the blocks
that survive each slot's query's block AND (dead words zero);
``mlp_two_tier`` gives Algorithm 2's candidates, scoring only the union of
each query's tier-1 lists (core/algorithms.py).  Each of the three is its
own entry point with its own launch count.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.cuda import F, I, P, CudaKernel, check
from repro_torch.kernels.membership.ref import LANE
from repro_torch.kernels.mlp_membership.ref import (LiveBlocks, mlp_membership_ref,
                                                    mlp_two_tier_ref)

_HEAD = [P, P, P, P, I, P, F, P, P, I, I, I, I]  # A, Bd, W, dims, n_later, tau, bias, out, logits, S, D, H1, words
KERNEL = CudaKernel("mlp_membership", "mlp_membership_launch", _HEAD)  # Algorithm 1's rows
MASKED = CudaKernel("mlp_membership", "mlp_masked_launch",
                    [*_HEAD, P, I, P, I, I, P, I, P, P, P, P])  # Algorithm 3's rows
TWO_TIER = CudaKernel("mlp_membership", "mlp_two_tier_launch",
                      [P, I, P, P, P, I, I, P, P, P, P, I, P, F, P, I, I, I, I])  # Algorithm 2
MAX_LAYERS = 4  # layers after the first
MAX_WIDTH = 256  # hidden widths after the first layer
MAX_TERMS = 64  # query slots the two-tier kernel keeps in shared memory
MAX_GRID_Y = 65535
MAX_SMEM = 227 << 10
TILE_DOCS = 512  # docs of a shallow item's tile
ITEM_SLOTS = 16  # slots of a shallow item
ROW = 36  # floats between staged rows
SHALLOW_TILES = 4 * (ITEM_SLOTS + TILE_DOCS) * ROW  # the shallow rows' staged A and Bd, bytes
WARP_TILES = 4 * 8 * 32 * ROW  # the two-tier kernel's 8 warp tiles, bytes
THREADS, PER_THREAD = 256, 4  # two-tier: candidate positions a thread takes, at the grid chosen


def _head(a, bd, later, dims, tau):
    """Checks the head's inputs (all on a's CUDA device) -> (dims, later
    weights, dims as host int32)."""
    dev = a.device
    check(a, "a", torch.float32, 2, dev)
    check(bd, "bd", torch.float32, 2, dev)
    check(later, "later", torch.float32, 1, dev)
    check(tau, "tau", torch.float32, 1, dev)
    dims = tuple(int(h) for h in dims)
    need = sum(i * o + o for i, o in zip(dims[:-1], dims[1:]))
    H1 = a.shape[1]
    if bd.shape[1] != H1 or tau.shape[0] != a.shape[0] or dims[0] != H1 or dims[-1] != 1 \
            or later.numel() != need:
        raise ValueError(f"shapes a {tuple(a.shape)}, bd {tuple(bd.shape)}, tau "
                         f"{tuple(tau.shape)}, {later.numel()} later weights for dims {dims}")
    if not 1 <= len(dims) - 1 <= MAX_LAYERS or max(dims[1:-1], default=1) > MAX_WIDTH:
        raise ValueError(f"dims {dims} exceed the kernel's {MAX_LAYERS} later layers or "
                         f"width {MAX_WIDTH}")
    return dims, need, np.asarray(dims, dtype=np.int32)  # read by the host before the launch


def _fits(smem: int, what: str) -> None:
    if smem > MAX_SMEM:
        raise ValueError(f"{what} needs {smem} bytes of shared memory, over {MAX_SMEM}")


def mlp_membership(
    a: torch.Tensor,  # (S, H1) float32
    bd: torch.Tensor,  # (D, H1) float32
    later: torch.Tensor,  # flat float32 layers after the first
    dims: Sequence[int],  # (H1, ..., 1)
    tau: torch.Tensor,  # (S,) float32
    bias: float,
    *,
    live: LiveBlocks | None = None,
    logits: torch.Tensor | None = None,
) -> torch.Tensor:
    """-> (S, ceil(D/32)) int32 packed hit mask: bit set iff logit >= tau.

    ``live`` restricts the scoring to the blocks that survive each slot's
    query's block AND; the words of dead blocks are zero.  ``logits``, an
    (S, D) float32 tensor on the card, also receives the logit of every pair
    scored (a check against the plain version's ``mlp_logits_ref``)."""
    dev = a.device
    if dev.type == "cpu":
        if logits is not None:
            raise ValueError("mlp_membership: logits are written by the CUDA kernel only")
        return mlp_membership_ref(a, bd, later, dims, tau, bias, live)
    if dev.type != "cuda":
        raise ValueError(f"mlp_membership: unsupported device {dev}")
    dims, need, dims_host = _head(a, bd, later, dims, tau)
    (S, H1), D = a.shape, bd.shape[0]
    n_later = len(dims) - 1
    if logits is not None:
        check(logits, "logits", torch.float32, 2, dev)
        if tuple(logits.shape) != (S, D):
            raise ValueError(f"logits shape {tuple(logits.shape)} != {(S, D)}")
    _fits(4 * need if n_later > 1 else 4 * (-(-H1 // 4) * 4 + 4) + SHALLOW_TILES, f"dims {dims}")
    words = -(-D // LANE)
    out = torch.empty((S, words), dtype=torch.int32, device=dev)
    lp = None if logits is None else logits.data_ptr()
    if live is None:  # every word is written
        KERNEL.launch(a.data_ptr(), bd.data_ptr(), later.data_ptr(), dims_host.ctypes.data,
                      n_later, tau.data_ptr(), float(bias), out.data_ptr(), lp, S, D, H1, words)
        return out
    table, terms, slot_query, block_size = live
    check(table, "table", torch.int32, 2, dev)
    check(terms, "terms", torch.int32, 2, dev)
    check(slot_query, "slot_query", torch.int32, 1, dev)
    Q, T = terms.shape
    Wb = table.shape[1]
    if block_size % LANE or block_size <= 0:
        raise ValueError(f"block_size {block_size} is not a positive multiple of {LANE}")
    if Wb != -(-words // block_size):
        raise ValueError(f"{Wb} block words per term, {D} docs in blocks of {block_size} need "
                         f"{-(-words // block_size)}")
    if slot_query.shape[0] != S:
        raise ValueError(f"slot_query has {slot_query.shape[0]} entries for {S} slots")
    n_tiles, n_chunks = -(-D // TILE_DOCS), -(-S // ITEM_SLOTS)
    # scratch: the int4 item list first (the allocation's 16-byte edge),
    # its count, the block AND, each tile's live slots
    cap = 4 * n_tiles * n_chunks
    scratch = torch.empty(cap + 4 + Q * Wb + n_tiles * S, dtype=torch.int32, device=dev)
    items, n_items, anded = scratch[:cap], scratch[cap:], scratch[cap + 4: cap + 4 + Q * Wb]
    tile_slots = scratch[cap + 4 + Q * Wb:]
    MASKED.launch(a.data_ptr(), bd.data_ptr(), later.data_ptr(), dims_host.ctypes.data, n_later,
                  tau.data_ptr(), float(bias), out.data_ptr(), lp, S, D, H1, words,
                  table.data_ptr(), Wb, terms.data_ptr(), Q, T, slot_query.data_ptr(),
                  block_size // LANE, anded.data_ptr(), tile_slots.data_ptr(), items.data_ptr(),
                  n_items.data_ptr())
    return out


def mlp_two_tier(
    tier1: torch.Tensor,  # (n_terms, k) int32 truncated lists, padded with n_docs
    tier1_len: torch.Tensor,  # (n_terms,) int32 entries of each row
    queries: torch.Tensor,  # (Q, T) int32 term ids, -1 = pad
    slots: torch.Tensor,  # (Q, T) int32 row of ``a`` and ``tau`` per valid term, -1 = pad
    a: torch.Tensor,  # (S, H1) float32 term halves of the slots
    bd: torch.Tensor,  # (D, H1) float32 doc halves
    later: torch.Tensor,  # flat float32 layers after the first
    dims: Sequence[int],  # (H1, ..., 1)
    tau: torch.Tensor,  # (S,) float32 per-slot thresholds
    bias: float,
    *,
    max_candidates: int | None = None,
) -> torch.Tensor:
    """-> (Q, ceil(D/32)) int32 packed candidates: the docs of the union of
    each query's valid tier-1 lists that pass tau for every valid slot.
    ``max_candidates``, the largest sum of a query's valid list lengths,
    only sizes the grid (T * k when not given)."""
    dev = tier1.device
    if dev.type == "cpu":
        return mlp_two_tier_ref(tier1, tier1_len, queries, slots, a, bd, later, dims, tau, bias)
    if dev.type != "cuda":
        raise ValueError(f"mlp_two_tier: unsupported device {dev}")
    check(tier1, "tier1", torch.int32, 2, dev)
    check(tier1_len, "tier1_len", torch.int32, 1, dev)
    check(queries, "queries", torch.int32, 2, dev)
    check(slots, "slots", torch.int32, 2, dev)
    if a.device != dev:
        raise ValueError(f"a is on {a.device}, expected {dev}")
    dims, need, dims_host = _head(a, bd, later, dims, tau)
    n_terms, k = tier1.shape
    Q, T = queries.shape
    D, H1 = bd.shape
    if tier1_len.shape[0] != n_terms or tuple(slots.shape) != (Q, T):
        raise ValueError(f"shapes tier1 {tuple(tier1.shape)}, tier1_len "
                         f"{tuple(tier1_len.shape)}, queries {(Q, T)}, slots "
                         f"{tuple(slots.shape)}")
    if T > MAX_TERMS or Q > MAX_GRID_Y:
        raise ValueError(f"(Q, T) = {(Q, T)} exceeds the kernel's {MAX_GRID_Y} x {MAX_TERMS}")
    H4 = -(-H1 // 4) * 4
    _fits(4 * need if len(dims) > 2 else 4 * (H4 + 4 + T * H4) + WARP_TILES, f"dims {dims}")
    words = -(-D // LANE)
    span = T * k if max_candidates is None else min(int(max_candidates), T * k)
    grid_x = max(1, -(-span // (THREADS * PER_THREAD)))
    out = torch.empty((Q, words), dtype=torch.int32, device=dev)  # zeroed by the launch
    TWO_TIER.launch(tier1.data_ptr(), k, tier1_len.data_ptr(), queries.data_ptr(),
                    slots.data_ptr(), Q, T, a.data_ptr(), bd.data_ptr(), later.data_ptr(),
                    dims_host.ctypes.data, len(dims) - 1, tau.data_ptr(), float(bias),
                    out.data_ptr(), D, H1, words, grid_x)
    return out

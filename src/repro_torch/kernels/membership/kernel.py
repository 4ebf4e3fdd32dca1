"""Wrappers of the fused membership-scoring kernel (csrc/membership.cu).

(S,E) x (D,E)^T true-fp32 logits + bias, thresholded per row against tau and
packed 32 docs per word.  Ragged S and D need no padding: the kernel masks
rows and docs past the edge, and the tail bits of the last word are zero,
which is what the reference's padding (tau=+inf rows, 512-doc tiles, masked
tail word) computes.  The doc table is float32 or bfloat16 (read in place,
widened to float32 in the kernel).  Two entry points with a launch count
each: ``KERNEL`` scores every doc (Algorithm 1), ``MASKED``, given
Algorithm 3's ``LiveBlocks``, only the blocks that survive each slot's
query's block AND, with the words of dead blocks zero.
"""
from __future__ import annotations

import torch
from torch.nn.functional import pad as zero_pad

from repro_torch.kernels.cuda import F, I, P, CudaKernel, check
from repro_torch.kernels.membership.ref import LANE, LiveBlocks, membership_bitmask_ref

_ROWS = [P, P, I, P, F, P, I, I, I, I]  # q, d, d_bf16, tau, bias, out, S, D, E, words
KERNEL = CudaKernel("membership", "membership_bitmask_launch", _ROWS)
MASKED = CudaKernel("membership", "membership_masked_launch",
                    [*_ROWS, P, I, P, I, I, P, I, P])  # + table, Wb, terms, Q, T, slot_query,
                                                       # block_words, scratch
BM, BN = 128, 256  # slots an item, docs a tile (csrc/membership.cu)


def _pieces(q: torch.Tensor, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of whole 16-byte pieces, as the kernel reads them: E padded with
    zero dims to a multiple of 4 (float32 table) or 8 (bfloat16), and an
    unaligned table copied.  A zero dim adds fmaf(0, 0, acc) = acc.  The
    padding copies the whole doc table on every call (one read and one
    write of it, where the kernel alone reads it once); every table on the
    port's paths has E = 128 and is aligned, so none is copied there."""
    E = q.shape[1]
    piece = 8 if d.dtype == torch.bfloat16 else 4
    extra = -E % piece
    if extra:
        q, d = zero_pad(q, (0, extra)), zero_pad(d, (0, extra))
    if q.data_ptr() % 16:
        q = q.clone()
    if d.data_ptr() % 16:
        d = d.clone()
    return q, d


def membership_bitmask(
    q_embed: torch.Tensor,  # (S, E) float32
    d_embed: torch.Tensor,  # (D, E) float32 or bfloat16
    tau: torch.Tensor,  # (S,) float32
    bias: float,
    live: LiveBlocks | None = None,
) -> torch.Tensor:
    """-> (S, ceil(D/32)) int32 packed hit mask (uint32 bit patterns); with
    ``live``, only the words of blocks that survive each slot's query's
    block AND are scored, the others zero."""
    dev = q_embed.device
    if dev.type == "cpu":
        return membership_bitmask_ref(q_embed, d_embed, tau, bias, live)
    if dev.type != "cuda":
        raise ValueError(f"membership_bitmask: unsupported device {dev}")
    check(q_embed, "q_embed", torch.float32, 2, dev)
    check(d_embed, "d_embed", d_embed.dtype, 2, dev)
    if d_embed.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"d_embed has dtype {d_embed.dtype}, expected float32 or bfloat16")
    check(tau, "tau", torch.float32, 1, dev)
    (S, E), D = q_embed.shape, d_embed.shape[0]
    if d_embed.shape[1] != E or tau.shape[0] != S:
        raise ValueError(f"shapes q {tuple(q_embed.shape)}, d {tuple(d_embed.shape)}, tau {tuple(tau.shape)}")
    q, d = _pieces(q_embed, d_embed)
    E = q.shape[1]
    bf16 = int(d.dtype == torch.bfloat16)
    words = -(-D // LANE)
    out = torch.empty((S, words), dtype=torch.int32, device=dev)
    if live is None:  # every word is written
        KERNEL.launch(q.data_ptr(), d.data_ptr(), bf16, tau.data_ptr(), float(bias),
                      out.data_ptr(), S, D, E, words)
        return out
    table, terms, slot_query, block_size = live
    check(table, "table", torch.int32, 2, dev)
    check(terms, "terms", torch.int32, 2, dev)
    check(slot_query, "slot_query", torch.int32, 1, dev)
    Q, T = terms.shape
    Wb = table.shape[1]
    if block_size % LANE or block_size <= 0:
        raise ValueError(f"block_size {block_size} is not a positive multiple of {LANE}")
    block_words = block_size // LANE
    if Wb != -(-words // block_size):
        raise ValueError(f"{Wb} block words per term, {D} docs in blocks of {block_size} need "
                         f"{-(-words // block_size)}")
    if slot_query.shape[0] != S:
        raise ValueError(f"slot_query has {slot_query.shape[0]} entries for {S} slots")
    n_tiles, chunks = -(-D // BN), -(-S // BM)
    # scratch: the item count, the int4 items (from a 16-byte edge), the
    # block AND, each tile's live slots
    scratch = torch.empty(4 + 4 * n_tiles * chunks + Q * Wb + n_tiles * S, dtype=torch.int32,
                          device=dev)
    MASKED.launch(q.data_ptr(), d.data_ptr(), bf16, tau.data_ptr(), float(bias), out.data_ptr(),
                  S, D, E, words, table.data_ptr(), Wb, terms.data_ptr(), Q, T,
                  slot_query.data_ptr(), block_words, scratch.data_ptr())
    return out

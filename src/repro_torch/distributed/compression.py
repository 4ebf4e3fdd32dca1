"""int8-compressed ring all-reduce with error feedback (gradient compression).

Why: at (2,16,16) scale the DP gradient all-reduce for a 3.8B dense model
moves ~7.6 GB/step/chip in bf16; int8 + per-chunk scales cuts wire bytes 2x
(4x vs fp32) at <1e-2 relative error, and error feedback makes the *training
trajectory* bias-free (residuals re-injected next step — Karimireddy et al.).

A ring over one mesh axis with ``ppermute`` steps, run by every rank on its
own tree: a reduce-scatter phase (N-1 quantized hops), then an all-gather
phase (N-1 hops) in which each finished chunk is quantized once at its
owner, so every rank decodes the same bytes and ends with the same bits.
Leaves are flattened in the reference's order (mapping keys sorted, lists
in order): a ring chunk spans leaf boundaries, so the order decides which
values share a scale.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

from repro_torch.common.sharding import axis_index, axis_size, tree_map
from repro_torch.distributed.comm import ppermute


# absmax / 127 as the reference computes it: XLA folds a division by a
# constant into a product with the constant's fp32 reciprocal
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_chunk(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, fp32 scale): absmax / 127, rounded half to even."""
    scale = x.abs().max() * _INV_127
    q = torch.round(x / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def dequantize_chunk(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ring_allreduce_1d(x: torch.Tensor, axis_name: str, n: int, mesh=None) -> torch.Tensor:
    """Quantized ring all-reduce of a 1-D fp32 vector, length % n == 0."""
    chunks = x.reshape(n, -1).clone()
    idx = axis_index(axis_name, mesh)
    perm = [(i, (i + 1) % n) for i in range(n)]

    # reduce-scatter: after N-1 hops, chunk (idx+1) holds the full sum
    for i in range(n - 1):
        q, s = quantize_chunk(chunks[(idx - i) % n])
        q = ppermute(q, axis_name, perm, mesh)
        s = ppermute(s, axis_name, perm, mesh)
        recv_ix = (idx - i - 1) % n
        # dequantize and add in one rounding, as the reference's fused multiply-add
        chunks[recv_ix] = torch.addcmul(chunks[recv_ix], q.float(), s)

    # all-gather: each completed chunk is quantized ONCE at its owner and the
    # (q, scale) pair circulates verbatim -> every rank decodes identical bytes
    own_ix = (idx + 1) % n
    q, s = quantize_chunk(chunks[own_ix])
    chunks[own_ix] = dequantize_chunk(q, s)
    for i in range(n - 1):
        q = ppermute(q, axis_name, perm, mesh)
        s = ppermute(s, axis_name, perm, mesh)
        chunks[(idx - i) % n] = dequantize_chunk(q, s)
    return chunks.reshape(-1)


def _leaves(tree: Any) -> list[torch.Tensor]:
    """Leaves in the reference's flatten order (mapping keys sorted)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _rebuild(tree: Any, new: Iterator[torch.Tensor]) -> Any:
    """``tree`` with its leaves replaced, in ``_leaves``' order, by ``new``."""
    if isinstance(tree, Mapping):
        done = {k: _rebuild(tree[k], new) for k in sorted(tree)}
        return type(tree)((k, done[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, new) for t in tree)
    return next(new)


def compressed_allreduce(tree: Any, mesh=None, axis_name: str = "data") -> Any:
    """All-reduce (sum) a gradient tree over ``axis_name`` with an int8 wire
    format.  Every rank calls it on its own tree; leaves are flattened into
    one fp32 vector so a quantization block is a ring chunk.  On an axis of
    one rank the tree comes back unchanged."""
    n = axis_size(axis_name, mesh)
    if n == 1:
        return tree
    leaves = _leaves(tree)
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.float().reshape(-1) for leaf in leaves])
    pad = (-flat.shape[0]) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    out = _ring_allreduce_1d(flat, axis_name, n, mesh)
    parts = []
    off = 0
    for leaf, size in zip(leaves, sizes):
        parts.append(out[off: off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return _rebuild(tree, iter(parts))


class ErrorFeedback:
    """Residual accumulator: g_compressed = C(g + e); e = (g + e) - g_compressed.

    State is a tree matching grads; ``pre`` returns the corrected grads and
    ``post`` the new residual."""

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    @staticmethod
    def pre(grads: Any, residual: Any) -> Any:
        return tree_map(lambda g, e: g.float() + e, grads, residual)

    @staticmethod
    def post(corrected: Any, compressed: Any) -> Any:
        return tree_map(lambda c, q: c - q.float(), corrected, compressed)

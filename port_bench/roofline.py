"""Published peaks of one NVIDIA H100 SXM and the work of the timed kernels.

Peaks are the data sheet's dense rates at the full 700 W limit.  A share of
a roofline is the least time the card could take (the larger of operations
over the peak of the operands' type and bytes over the memory bandwidth)
over the measured device time.  Each count below is taken from shapes and
counts every input byte read once and every output byte written once.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
# dense FLOP/s by the dtype of a product's operands: bf16 and fp16 on the
# tensor cores, fp32 inputs as TF32 on the tensor cores, fp32 on the SIMT units
PEAK_FLOPS = {
    torch.bfloat16: 989e12,
    torch.float16: 989e12,
    "tf32": 495e12,
    torch.float32: 67e12,
}


def peak_flops(dtype) -> float:
    return PEAK_FLOPS[dtype]


def least_time(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """-> (seconds, "operations" | "bytes"): what bounds the work."""
    t_ops = flops / peak_flops(dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def membership_flops(slots: int, docs: int, embed: int) -> int:
    """2·E operations for every scored (slot, doc) pair."""
    return 2 * embed * slots * docs


def membership_bytes(slots: int, docs: int, embed: int, *, doc_bytes: int = 2,
                     slot_bytes: int = 4) -> int:
    """The doc table read once, the slots' rows and thresholds read once,
    one bit per (slot, doc) written once, in 32-bit words."""
    words = -(-docs // 32)
    return docs * embed * doc_bytes + slots * (embed * slot_bytes + 4) + slots * words * 4


def membership_least_time(slots: int, docs: int, embed: int,
                          dtype=torch.bfloat16) -> tuple[float, str]:
    """``membership``'s least time: its products are of bf16 values (the doc
    table, and term rows that are bf16 values widened to fp32)."""
    return least_time(membership_flops(slots, docs, embed),
                      membership_bytes(slots, docs, embed), dtype)

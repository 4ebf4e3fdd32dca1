"""Wrapper of the OptPFD batch-decode kernel (csrc/pfor.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.pfor.ref import META, pfor_decode_ref

KERNEL = CudaKernel("pfor", "pfor_decode_launch", [P, P, I, P, I])
BLOCKS_PER_CTA = 32  # csrc/pfor.cu: 8 warps of 4 PFor blocks each
MAX_VALUES = 1 << 30  # keeps every list's 64-bit sum under the 62 bits a status word holds


def scratch_words(n_out: int, n_blocks: int) -> int:
    """int32 words of the kernel's buffer: ids, overflow flag, padding to an
    even count, then one u64 look-back status word per CTA."""
    head = n_out + 1 + ((n_out + 1) & 1)
    return head + 2 * -(-n_blocks // BLOCKS_PER_CTA)


def pfor_decode(words: torch.Tensor, meta: torch.Tensor, n_out: int) -> torch.Tensor:
    """Decode every list that ``meta`` describes -> (n_out + 1,) int32: the
    ids (low 32 bits), then the overflow flag; see ref.py for the layout."""
    dev = words.device
    if dev.type == "cpu":
        return pfor_decode_ref(words, meta, n_out)
    if dev.type != "cuda":
        raise ValueError(f"pfor_decode: unsupported device {dev}")
    check(words, "words", torch.int32, 1, dev)
    check(meta, "meta", torch.int32, 2, dev)
    if meta.shape[1] != META:
        raise ValueError(f"meta has {meta.shape[1]} columns, expected {META}")
    if not 0 <= n_out < MAX_VALUES:
        raise ValueError(f"{n_out} values: the kernel takes fewer than {MAX_VALUES}")
    buf = torch.empty(scratch_words(n_out, meta.shape[0]), dtype=torch.int32, device=dev)
    KERNEL.launch(words.data_ptr(), meta.data_ptr(), meta.shape[0], buf.data_ptr(), n_out)
    return buf[: n_out + 1]

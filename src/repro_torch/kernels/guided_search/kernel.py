"""Wrapper of the batched epsilon-window probe kernel (csrc/guided_search.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.guided_search.ref import ROW_COLS, SEG_COLS, TERM_COLS, probe_ref

KERNEL = CudaKernel("guided_search", "probe_batch_launch", [P, P, P, P, P, I, I])


def probe_batch(
    rows: torch.Tensor,  # (R, 6) int32 [term row, global segment, r_lo, n_valid, cand, out]
    terms: torch.Tensor,  # (L, 3) int32 [first word, width, corr_min]
    segs: torch.Tensor,  # (S, 3) int32 [start, base, slope bits]
    words: torch.Tensor,  # (n_words,) int32 packed corrections, terms end to end
    n_out: int,  # output slots
) -> torch.Tensor:
    """Probe R window rows -> (2, n_out) int32 [found, lt]; see ref.py."""
    dev = words.device
    if dev.type == "cpu":
        return probe_ref(rows, terms, segs, words, n_out)
    if dev.type != "cuda":
        raise ValueError(f"probe_batch: unsupported device {dev}")
    for name, t, cols in (("rows", rows, ROW_COLS), ("terms", terms, TERM_COLS),
                          ("segs", segs, SEG_COLS)):
        check(t, name, torch.int32, 2, dev)
        if t.shape[1] != cols:
            raise ValueError(f"{name} has {t.shape[1]} columns, expected {cols}")
    check(words, "words", torch.int32, 1, dev)
    if not 0 <= n_out < 2**31 or rows.shape[0] >= 2**31:
        raise ValueError(f"{rows.shape[0]} rows / {n_out} slots exceed the kernel's int32 indices")
    out = torch.empty(2, n_out, dtype=torch.int32, device=dev)
    KERNEL.launch(rows.data_ptr(), terms.data_ptr(), segs.data_ptr(), words.data_ptr(),
                  out.data_ptr(), rows.shape[0], n_out)
    return out

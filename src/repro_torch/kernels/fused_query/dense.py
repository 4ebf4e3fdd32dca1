"""Dense ranked scoring over a shard's resident impact table.

The reference runs this loop as one jitted XLA program (a gather-sum plus a
``lax.while_loop`` of argmax peels), not as a Pallas kernel.  The port runs
it as one hand-written kernel, csrc/dense_topk.cu: each query row's top k by
(score desc, id asc) among docs whose summed impact beats max(floor, 0) —
what k argmax peels with first-maximum ties pick — with no (Q, n_docs)
accumulator in device memory.  ``dense_impl`` launches it on a CUDA table
and runs the plain version (``ref.dense_ref``, the peel loop as PyTorch
operations) on a CPU table.

Exactness: the dense sum over term rows equals the host merge's posting
sums (integer adds, order-free), per-row floors mask exactly
``score > max(floor, 0)`` (the ``select_topk`` rule), and the tie order is
the oracle's (score desc, id asc).

Rows and term slots are padded to power-of-two multiples of the tile quanta
(``tile_params``: 8 rows and 4 slots unless ``set_tile_params`` or the
autotuner, kernels.autotune, changed them), the reference's defaults, so
both packages hand the same shapes to the pass.  ``observed_shapes()`` lists
the (n_docs, Q, T, k) shapes this process has dispatched.  The port has no
jit cache: ``cache_size()`` counts those shapes, so a respawned worker whose
warm replay covered every shape serves without a new one, and
``warm_shape`` runs the pass once at a shape on inert inputs.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels.cuda import I, P, CudaKernel, check
from repro_torch.kernels.fused_query.ref import NEVER, dense_ref  # NEVER: the empty-slot id

# the reference's cap (past it its peel loop loses to the bucketed path),
# and the kernel's own: a CTA's top keys are sorted by one warp, a key a
# lane, so k <= 32; the bridge routes larger k to the bucketed path
DENSE_MAX_K = 32

KERNEL = CudaKernel("dense_topk", "dense_topk_launch", [P, I, I, I, P, P, I, I, I, P, P, P, P, P])
CHUNK = 4096  # docs one CTA of csrc/dense_topk.cu scores
MAX_CHUNKS = 128  # CTAs a row (the merge copies the row's lists into 48 KB of shared memory)
MAX_ROWS = 65535
_ELEM_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}  # DeviceArena's table dtypes

# shape-bucket quanta: power-of-two multiples bound the shape count; the
# autotuner (kernels.autotune) may retune these per device
_ROW_QUANTUM = 8
_TERM_QUANTUM = 4

# static shapes this process has dispatched: (n_docs, Q, T, k)
_SHAPES: set[tuple[int, int, int, int]] = set()

launches = 0  # dense passes issued (one per dense_topk call)
_count_lock = threading.Lock()


def tile_params() -> dict[str, int]:
    return {"row_quantum": _ROW_QUANTUM, "term_quantum": _TERM_QUANTUM}


def set_tile_params(row_quantum: int | None = None, term_quantum: int | None = None) -> None:
    global _ROW_QUANTUM, _TERM_QUANTUM
    if row_quantum is not None:
        _ROW_QUANTUM = max(1, int(row_quantum))
    if term_quantum is not None:
        _TERM_QUANTUM = max(1, int(term_quantum))


def dense_impl(table: torch.Tensor, qt: torch.Tensor, floors: torch.Tensor, *, k: int):
    """(n_terms+1, n_docs) table, (Q, T) int32 term ids (-1 = pad), (Q,)
    int32 floors -> ((Q, k) int32 ids (NEVER where empty), (Q, k) int32
    scores, 0-d int64 rounds), all three on the table's device.

    ``rounds`` is the reference loop's round count: with H the most hits a
    row has (at most k), H + 1 when H < k, else k, and 0 when k = 0.  On a
    card the pass is one ``dense_topk`` launch and returns before the
    kernel has run."""
    dev = table.device
    if dev.type == "cpu":
        return dense_ref(table, qt, floors, k=k)
    if dev.type != "cuda":
        raise ValueError(f"dense_impl: unsupported device {dev}")
    if table.dtype not in _ELEM_BYTES:
        raise TypeError(f"table has dtype {table.dtype}, expected one of {list(_ELEM_BYTES)}")
    check(table, "table", table.dtype, 2, dev)
    check(qt, "qt", torch.int32, 2, dev)
    check(floors, "floors", torch.int32, 1, dev)
    Q, T = qt.shape
    n_rows, n_docs = table.shape
    S = -(-n_docs // CHUNK)
    if floors.shape[0] != Q or not 0 < S <= MAX_CHUNKS or Q > MAX_ROWS or not 0 <= k <= DENSE_MAX_K:
        raise ValueError(f"table {tuple(table.shape)}, qt {tuple(qt.shape)}, "
                         f"floors {tuple(floors.shape)}, k={k}: need Q <= {MAX_ROWS} floors, "
                         f"0 < n_docs <= {CHUNK * MAX_CHUNKS} and 0 <= k <= {DENSE_MAX_K}")
    if Q == 0 or k == 0:  # the reference's loop: no round when k = 0, else one empty round
        return (torch.empty((Q, k), dtype=torch.int32, device=dev),
                torch.empty((Q, k), dtype=torch.int32, device=dev),
                torch.full((), 1 if k else 0, dtype=torch.int64, device=dev))
    # one int64 buffer: rounds; each CTA's sorted top-k keys; the per-row
    # arrival counts, the most hits of any row and the rows merged (int32,
    # zeroed by the launch).  One int32 buffer: the ids, then the scores.
    n_lists = Q * S * k
    scratch = torch.empty(1 + n_lists + (Q + 3) // 2, dtype=torch.int64, device=dev)
    rounds, lists, counts = scratch[0], scratch[1:1 + n_lists], scratch[1 + n_lists:]
    out_i, out_s = torch.empty((2, Q, k), dtype=torch.int32, device=dev)
    KERNEL.launch(table.data_ptr(), _ELEM_BYTES[table.dtype], n_rows, n_docs, qt.data_ptr(),
                  floors.data_ptr(), Q, T, k, lists.data_ptr(), counts.data_ptr(),
                  out_i.data_ptr(), out_s.data_ptr(), rounds.data_ptr())
    return out_i, out_s, rounds


def dense_topk(arena, qt: np.ndarray, floors: np.ndarray, *, k: int):
    """One dense pass: (Q, T) padded term rows -> (ids, scores, rounds) as
    tensors on the arena's device, still being computed when it returns."""
    global launches
    dev = arena.table.device
    Q, T = qt.shape
    with _count_lock:
        _SHAPES.add((arena.n_docs, Q, T, int(k)))
        launches += 1
        arena.counters.hits += 1
    return dense_impl(
        arena.table, torch.from_numpy(np.ascontiguousarray(qt, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(floors, np.int32)).to(dev), k=int(k),
    )


def observed_shapes() -> list[tuple[int, int, int, int]]:
    """Static shapes dispatched by this process: (n_docs, Q, T, k)."""
    return sorted(_SHAPES)


def cache_size() -> int:
    """Distinct dense-pass shapes this process has dispatched (the count the
    reference reads off its jit cache)."""
    return len(_SHAPES)


def warm_shape(arena, shape) -> None:
    """Run the pass once at one observed (n_docs, Q, T, k) shape on
    ``arena`` with inert inputs (all-pad rows) and wait for it."""
    n_docs, Q, T, k = (int(x) for x in shape)
    if n_docs != arena.n_docs:
        return
    ids, _, _ = dense_topk(arena, np.full((Q, T), -1, np.int32), np.zeros(Q, np.int32), k=k)
    ids.cpu()  # the copy waits for the pass

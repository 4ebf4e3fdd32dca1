"""Two-stage RMI codec for very long posting lists.

A recursive-model-index [Kraska et al. '18] specialized to the postings
setting: stage 1 is a *linear root* over rank (ranks are uniform, so the
root reduces to the exact affine bucketing ``leaf = i * L // n``); stage 2
is one linear model per leaf, trained with closed-form least squares
(segment-sum normal equations, no iterative optimizer).  Leaf models are
anchored at the leaf's first doc id and the fitted intercept is rounded into
that integer base, so the float32 regression only has to cover the
within-leaf span and the decode formula is plm.py's single-multiply form.

The per-leaf sums are float32 ``index_add_`` reductions on the host: one
vectorised pass per term with no per-leaf-count compilation, the same
formula as the reference's segment sums, so the streams stay byte-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.postings.plm import decode_stream, emit_stream, eval_segments, _stream_size_bits

LEAF_TARGET = 64  # target postings per leaf model
MAX_LEAVES = 4096


def n_leaves(n: int, leaf_target: int = LEAF_TARGET) -> int:
    return max(1, min(MAX_LEAVES, n // max(1, leaf_target)))


def _leaf_starts(n: int, L: int) -> np.ndarray:
    """Rank boundaries of the affine root: leaf l covers ranks with i*L//n == l."""
    l = np.arange(L, dtype=np.int64)
    return np.ceil(l * n / L).astype(np.int64)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with the product kept exact: the float64 product of
    two float32 values is exact, so only the sum rounds (to float64, then to
    float32)."""
    return (a.double() * b.double() + c.double()).float()


def _leaf_lstsq(x: np.ndarray, y: np.ndarray, leaf: np.ndarray, L: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-leaf 1D least squares via float32 segment-sum normal equations.

    x, y are leaf-centered (rank - leaf_start, doc_id - leaf_base) so float32
    precision covers the within-leaf span only.  Returns (slopes, iceps).

    The reference's compiled CPU program contracts ``a*b - c*d`` into
    ``fma(a, b, -(c*d))`` and ``sy - slope*sx`` into ``fma(-slope, sx, sy)``;
    the same contractions are written out here, so slopes and intercepts,
    and with them the streams, are bit-identical.
    """
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    idx = torch.from_numpy(leaf)

    def seg_sum(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(L, dtype=torch.float32).index_add_(0, idx, v)

    cnt = seg_sum(torch.ones_like(xt))
    sx, sy = seg_sum(xt), seg_sum(yt)
    sxx, sxy = seg_sum(xt * xt), seg_sum(xt * yt)
    denom = _fma(cnt, sxx, -(sx * sx))
    one = torch.ones((), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)
    num = _fma(cnt, sxy, -(sx * sy))
    slope = torch.where(denom > 0, num / torch.where(denom > 0, denom, one), zero)
    icep = torch.where(cnt > 0, _fma(-slope, sx, sy) / torch.where(cnt > 0, cnt, one), zero)
    return slope.numpy(), icep.numpy()


def fit_rmi(
    doc_ids: np.ndarray, leaf_target: int = LEAF_TARGET
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fit the two-stage model -> (starts i64, bases i64, slopes f32).

    The least-squares intercept is rounded into the integer base (plm.py's
    decode has no separate intercept term); the sub-integer remainder lands
    in the corrections, costing at most one extra correction value."""
    n = len(doc_ids)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    L = n_leaves(n, leaf_target)
    starts = _leaf_starts(n, L)
    ids64 = np.asarray(doc_ids, np.int64)
    anchors = ids64[starts]
    ranks = np.arange(n, dtype=np.int64)
    leaf = (ranks * L) // n
    x = (ranks - starts[leaf]).astype(np.float32)
    y = (ids64 - anchors[leaf]).astype(np.float32)
    if L == 1:
        # degenerate single-leaf model: the same normal equations in float64
        # scalars, as the reference computes them
        denom = float(n * (x * x).sum() - x.sum() ** 2)
        sl = (n * float((x * y).sum()) - float(x.sum()) * float(y.sum())) / denom if denom else 0.0
        slopes = np.array([sl], np.float32)
        iceps = np.array([(float(y.sum()) - sl * float(x.sum())) / n], np.float32)
    else:
        slopes, iceps = _leaf_lstsq(x, y, leaf, L)
    i32 = np.iinfo(np.int32)
    bases = np.clip(
        anchors + np.rint(np.asarray(iceps, np.float64)).astype(np.int64), i32.min, i32.max
    )
    return starts, bases, np.asarray(slopes, np.float32)


def rmi_encode(doc_ids: np.ndarray, leaf_target: int = LEAF_TARGET) -> np.ndarray:
    starts, bases, slopes = fit_rmi(doc_ids, leaf_target)
    return emit_stream(doc_ids, starts, bases, slopes, eps=0)


def rmi_decode(words: np.ndarray, n: int) -> np.ndarray:
    return decode_stream(words, n)


def rmi_size_bits(doc_ids: np.ndarray, leaf_target: int = LEAF_TARGET) -> int:
    starts, bases, slopes = fit_rmi(doc_ids, leaf_target)
    n = len(doc_ids)
    pred = eval_segments(starts, bases, slopes, n)
    corr = np.asarray(doc_ids, np.int64) - pred
    width = int(int(corr.max() - corr.min()).bit_length()) if n else 0
    return _stream_size_bits(n, len(starts), width)

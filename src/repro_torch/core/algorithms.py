"""Algorithms 1 and 3 from the paper, as batched evaluators on one device.

Both take a padded query batch (Q, T) of term ids (-1 = pad) and return the
candidate documents of each query as a packed (Q, ceil(n_docs/32)) int32
bitmap (uint32 bit patterns, bit d%32 of word d//32):

  * exhaustive — f_hat over every doc for every query term (Alg. 1)
  * block      — f_hat only matters inside blocks that survive the per-term
                 block-bitmap AND (Alg. 3)

Document scoring uses the learned-Bloom thresholds (no false negatives), so
candidates are supersets of the exact answer; serve/shard.py re-checks them
against the exact tier-2 store.  Invalid (-1) terms act as all-ones and an
all-pad query matches nothing.

On a CUDA device Algorithm 3 makes two launches: the f(t, ·) scan of every
valid (query, term) slot on one ``membership`` launch, then the block AND,
the AND over each query's terms and the block mask on one ``bitset``
launch (``block_candidates``); on the CPU the same wrappers run their plain
versions.  Algorithm 2 (two-tier)
belongs to a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.membership import MembershipModel
from repro_torch.index.build import InvertedIndex, block_lists
from repro_torch.kernels.bitset.kernel import block_candidates
from repro_torch.kernels.cuda import staging
from repro_torch.kernels.membership.kernel import membership_bitmask
from repro_torch.kernels.membership.ref import LANE


@dataclass
class EngineState:
    """Dense state for the algorithms, resident on ``device``."""

    model: MembershipModel
    tau: torch.Tensor  # (n_terms,) float32 per-term zero-FN thresholds
    n_docs: int
    block_size: int
    block_bitmaps: torch.Tensor  # (n_terms, words) int32 (uint32 bit patterns)
    n_blocks: int

    @property
    def device(self) -> torch.device:
        return self.tau.device


def build_engine(
    model: MembershipModel, tau: torch.Tensor, inv: InvertedIndex, *, block_size: int
) -> EngineState:
    if block_size % LANE:
        # block_query expands surviving blocks a packed word at a time
        raise ValueError(f"block_size {block_size} is not a multiple of {LANE}")
    dev = tau.device
    bitmaps, n_blocks = block_lists(inv, block_size)
    return EngineState(
        model=model,
        tau=tau,
        n_docs=inv.n_docs,
        block_size=block_size,
        block_bitmaps=torch.from_numpy(bitmaps.view(np.int32)).to(dev),
        n_blocks=n_blocks,
    )


@torch.no_grad()
def _term_rows(state: EngineState, queries: np.ndarray) -> torch.Tensor:
    """(Q, T) queries -> (Q, T, words) packed f_hat rows of every (query,
    term); invalid slots are all-ones.  One membership launch covers the
    valid rows."""
    Q, T = queries.shape
    dev = state.device
    words = -(-state.n_docs // LANE)
    rows = torch.full((Q * T, words), -1, dtype=torch.int32, device=dev)
    flat = queries.reshape(-1)
    idx = np.nonzero(flat >= 0)[0]
    if len(idx):
        terms = torch.from_numpy(flat[idx].astype(np.int64)).to(dev)
        rows[torch.from_numpy(idx).to(dev)] = membership_bitmask(
            state.model.term_embed.weight[terms].contiguous(),
            state.model.doc_embed.weight.detach(),
            state.tau[terms].contiguous(),
            float(state.model.bias),
        )
    return rows.view(Q, T, words)


def _and_terms(rows: torch.Tensor, queries: np.ndarray) -> torch.Tensor:
    """AND over the term axis; all-pad queries come out empty."""
    acc = rows[:, 0].clone()
    for t in range(1, rows.shape[1]):
        acc &= rows[:, t]
    live = torch.from_numpy((queries >= 0).any(axis=1)).to(rows.device)
    acc[~live] = 0
    return acc


# ---------------------------------------------------------------- Algorithm 1
def exhaustive_query(state: EngineState, queries: np.ndarray) -> torch.Tensor:
    """(Q, T) padded queries -> (Q, words) packed candidate bitmap."""
    return _and_terms(_term_rows(state, queries), queries)


# ---------------------------------------------------------------- Algorithm 3
@torch.no_grad()
def block_query(state: EngineState, queries: np.ndarray) -> torch.Tensor:
    """(Q, T) -> (Q, words) packed candidates: f_hat ANDed over the query's
    terms, kept only in blocks that survive the block-bitmap AND.

    One upload of the (Q, T) term ids, their slots in the compact row
    table and the valid slots' term ids; one ``membership`` launch over the
    valid slots; one ``block_candidates`` launch for the rest."""
    Q, T = queries.shape
    dev = state.device
    flat = queries.reshape(-1)
    valid = np.nonzero(flat >= 0)[0]
    host = staging(2 * Q * T + len(valid), dev)
    buf = host.numpy()
    buf[: Q * T] = flat
    buf[Q * T : 2 * Q * T] = -1
    buf[Q * T + valid] = np.arange(len(valid), dtype=np.int32)
    buf[2 * Q * T :] = flat[valid]
    up = host.to(dev, non_blocking=True)
    words = -(-state.n_docs // LANE)
    if len(valid):
        terms = up[2 * Q * T :].long()
        rows = membership_bitmask(
            state.model.term_embed.weight[terms],
            state.model.doc_embed.weight.detach(),
            state.tau[terms],
            float(state.model.bias),
        )
    else:
        rows = torch.zeros((0, words), dtype=torch.int32, device=dev)
    cand, _, _ = block_candidates(
        state.block_bitmaps, up[: Q * T].view(Q, T), up[Q * T : 2 * Q * T].view(Q, T), rows,
        state.n_docs, state.block_size)
    return cand


# ---------------------------------------------------------------- dispatch
def run_queries(state: EngineState, queries: np.ndarray, algorithm: str) -> torch.Tensor:
    """-> (Q, words) packed candidate bitmap on the state's device."""
    queries = np.asarray(queries, dtype=np.int32)
    if algorithm == "exhaustive":
        return exhaustive_query(state, queries)
    if algorithm == "block":
        return block_query(state, queries)
    raise ValueError(f"unknown algorithm {algorithm!r} (two_tier is not ported yet)")

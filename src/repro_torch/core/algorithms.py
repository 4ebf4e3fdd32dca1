"""Algorithms 1–3 from the paper, as batched evaluators on one device.

All three take a padded query batch (Q, T) of term ids (-1 = pad) and return
the candidate documents of each query as a packed (Q, ceil(n_docs/32)) int32
bitmap (uint32 bit patterns, bit d%32 of word d//32):

  * exhaustive — f_hat over every doc for every query term (Alg. 1)
  * two_tier   — f_hat only on the union of the query's tier-1 lists, each
                 term's list truncated to its k lowest doc ids (Alg. 2)
  * block      — f_hat only matters inside blocks that survive the per-term
                 block-bitmap AND (Alg. 3)

Document scoring uses the learned-Bloom thresholds (no false negatives), so
candidates are supersets of the exact answer (for two_tier only where the
tier-1 lists cover it: ``two_tier_guaranteed``); serve/shard.py re-checks
them against the exact tier-2 store.  Invalid (-1) terms act as all-ones
and an all-pad query matches nothing.

On a CUDA device Algorithm 3 makes two launches: the f(t, ·) scan of every
valid (query, term) slot on one masked ``membership`` launch, which scores
only the blocks that survive each slot's query's block AND (``LiveBlocks``)
and leaves the other words zero, then the block AND, the AND over each
query's terms and the block mask on one ``bitset`` launch
(``block_candidates``).  Algorithm 1 scores every doc on one dense
``membership`` launch.  Algorithm 2 is one ``two_tier`` launch
(``two_tier_candidates``): the tier-1 union and its f_hat test, with the
membership kernel's dot product, so its candidates are Algorithm 1's ANDed
with the union, bit for bit.  A model with an MLP head scores on the
``mlp_membership`` kernels instead (``score_slots``), with the same dense
and masked split; Algorithm 2 on one ``mlp_two_tier`` launch that scores
only the union of each query's tier-1 lists, in the dense launch's
arithmetic, so its candidates too are Algorithm 1's ANDed with the union.
On the CPU the same wrappers run their plain versions.  The (n_terms, k)
tier-1 table reaches the device at the first two-tier call, not when the
state is built.  Each launch sits in a ``kernel.*`` span (repro_torch.obs)
that covers its issue only: the caller's copy of the candidates back is
where the host waits for the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.membership import MembershipModel, term_doc_logits
from repro_torch.index.build import InvertedIndex, block_lists, truncate_index
from repro_torch.kernels.bitset.kernel import block_candidates
from repro_torch.kernels.cuda import staging
from repro_torch.kernels.membership.kernel import membership_bitmask
from repro_torch.kernels.membership.ref import LANE, LiveBlocks
from repro_torch.kernels.mlp_membership.kernel import mlp_membership, mlp_two_tier
from repro_torch.kernels.two_tier.kernel import two_tier_candidates
from repro_torch.obs import trace


@dataclass
class EngineState:
    """Dense state for the algorithms, resident on ``device``."""

    model: MembershipModel
    tau: torch.Tensor  # (n_terms,) float32 per-term zero-FN thresholds
    n_docs: int
    block_size: int
    truncation_k: int
    tier1_len: torch.Tensor  # (n_terms,) int32 entries of each tier-1 list
    dfs: np.ndarray  # (n_terms,) int32 local document frequencies
    block_bitmaps: torch.Tensor  # (n_terms, words) int32 (uint32 bit patterns)
    n_blocks: int
    inv: InvertedIndex = field(repr=False)  # the index the tier-1 lists are cut from
    _tier1: torch.Tensor | None = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.tau.device

    @property
    def tier1_bits(self) -> int:
        """Bits of the (n_terms, k) int32 tier-1 table, resident or not."""
        return int(len(self.dfs) * self.truncation_k * 32)

    @property
    def tier1(self) -> torch.Tensor:
        """(n_terms, k) int32: row t = the k lowest doc ids of term t, padded
        with n_docs; built and moved to the device on first use."""
        if self._tier1 is None:
            self._tier1 = tier1_table(self.inv, self.truncation_k, self.device)
        return self._tier1


def tier1_table(inv: InvertedIndex, k: int, device: torch.device) -> torch.Tensor:
    """(n_terms, k) int32 table of the truncated lists, padded with n_docs,
    built on ``device``: only the truncated lists cross from the host, and
    each lands in its row's first entries."""
    tr = truncate_index(inv, k)
    lens = torch.from_numpy(np.diff(tr.term_offsets)).to(device)
    starts = torch.from_numpy(np.asarray(tr.term_offsets[:-1])).to(device)
    table = torch.full((inv.n_terms, k), inv.n_docs, dtype=torch.int32, device=device)
    rows = torch.repeat_interleave(torch.arange(inv.n_terms, device=device), lens)
    cols = torch.arange(len(tr.doc_ids), device=device) - torch.repeat_interleave(starts, lens)
    table[rows, cols] = torch.from_numpy(tr.doc_ids).to(device)
    return table


def build_engine(
    model: MembershipModel, tau: torch.Tensor, inv: InvertedIndex, *, truncation_k: int,
    block_size: int,
) -> EngineState:
    if block_size % LANE:
        # block_query expands surviving blocks a packed word at a time
        raise ValueError(f"block_size {block_size} is not a multiple of {LANE}")
    if truncation_k < 1:
        raise ValueError(f"truncation_k {truncation_k} < 1")
    dev = tau.device
    bitmaps, n_blocks = block_lists(inv, block_size)
    dfs = inv.dfs.astype(np.int32)
    return EngineState(
        model=model,
        tau=tau,
        n_docs=inv.n_docs,
        block_size=block_size,
        truncation_k=truncation_k,
        tier1_len=torch.from_numpy(np.minimum(dfs, truncation_k)).to(dev),
        dfs=dfs,
        block_bitmaps=torch.from_numpy(bitmaps.view(np.int32)).to(dev),
        n_blocks=n_blocks,
        inv=inv,
    )


@torch.no_grad()
def score_slots(model: MembershipModel, terms: torch.Tensor, tau: torch.Tensor,
                live: LiveBlocks | None = None) -> torch.Tensor:
    """(S,) int64 term ids and their (S,) thresholds -> (S, words) packed
    f_hat rows: one ``membership`` launch for a dot-product model, one
    ``mlp_membership`` launch (its doc side computed once per model,
    ``MembershipModel.doc_side``) for a model with a head.  Without
    ``live`` every doc is scored; given it, only the blocks that survive
    each slot's query's block AND, and the other words are zero."""
    n_docs = model.doc_embed.weight.shape[0]
    if model.mlp is None:
        with trace.span("kernel.membership", slots=len(terms), docs=n_docs,
                        masked=live is not None):
            return membership_bitmask(model.term_embed.weight[terms].contiguous(),
                                      model.doc_embed.weight.detach(), tau.contiguous(),
                                      float(model.bias), live=live)
    bd, later, dims = model.doc_side()
    a = model.term_side(terms).contiguous()
    with trace.span("kernel.mlp_membership", slots=len(terms), docs=n_docs,
                    masked=live is not None):
        return mlp_membership(a, bd, later, dims, tau.contiguous(), float(model.bias), live=live)


def _slot_upload(queries: np.ndarray, device: torch.device):
    """(Q, T) padded queries -> on ``device``, in one upload: the (Q, T)
    term ids, the (Q, T) row of each valid (query, term) in the compact
    slot order (-1 = pad), and, per slot, its term id and its query."""
    Q, T = queries.shape
    flat = queries.reshape(-1)
    valid = np.nonzero(flat >= 0)[0]
    n, S = Q * T, len(valid)
    host = staging(2 * n + 2 * S, device)
    buf = host.numpy()
    buf[:n] = flat
    buf[n: 2 * n] = -1
    buf[n + valid] = np.arange(S, dtype=np.int32)
    buf[2 * n: 2 * n + S] = flat[valid]
    buf[2 * n + S:] = valid // T
    up = host.to(device, non_blocking=True)
    return up[:n].view(Q, T), up[n: 2 * n].view(Q, T), up[2 * n: 2 * n + S], up[2 * n + S:]


@torch.no_grad()
def _term_rows(state: EngineState, queries: np.ndarray) -> torch.Tensor:
    """(Q, T) queries -> (Q, T, words) packed f_hat rows of every (query,
    term); invalid slots are all-ones.  One scoring launch covers the
    valid rows."""
    Q, T = queries.shape
    dev = state.device
    words = -(-state.n_docs // LANE)
    rows = torch.full((Q * T, words), -1, dtype=torch.int32, device=dev)
    flat = queries.reshape(-1)
    idx = np.nonzero(flat >= 0)[0]
    if len(idx):
        terms = torch.from_numpy(flat[idx].astype(np.int64)).to(dev)
        rows[torch.from_numpy(idx).to(dev)] = score_slots(state.model, terms, state.tau[terms])
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


# ---------------------------------------------------------------- Algorithm 2
@torch.no_grad()
def _f_hat_docs(state: EngineState, terms: torch.Tensor, doc_ids: torch.Tensor) -> torch.Tensor:
    """(T,) terms x (D',) docs -> (T, D') thresholded membership."""
    return term_doc_logits(state.model, terms, doc_ids) >= state.tau[terms][:, None]


@torch.no_grad()
def two_tier_query(state: EngineState, queries: np.ndarray) -> torch.Tensor:
    """(Q, T) -> (Q, words) packed candidates: the union of the query's
    valid tier-1 lists, kept where f_hat holds for every valid term.  One
    ``two_tier`` launch on the resident tier-1 table; with an MLP head, one
    ``mlp_two_tier`` launch, which scores the union's docs only."""
    valid = queries >= 0
    lens = np.where(valid, np.minimum(state.dfs[np.maximum(queries, 0)], state.truncation_k), 0)
    most = int(lens.sum(axis=1).max()) if len(lens) else 0
    span = dict(queries=int(queries.shape[0]), terms=int(queries.shape[1]),
                entries=int(lens.sum()))
    model = state.model
    if model.mlp is not None:
        terms2d, slots2d, slot_terms, _ = _slot_upload(queries, state.device)
        terms = slot_terms.long()
        bd, later, dims = model.doc_side()
        a = model.term_side(terms).contiguous()
        with trace.span("kernel.mlp_two_tier", **span):
            return mlp_two_tier(state.tier1, state.tier1_len, terms2d, slots2d, a, bd, later, dims,
                                state.tau[terms].contiguous(), float(model.bias),
                                max_candidates=most)
    with trace.span("kernel.two_tier", **span):
        return two_tier_candidates(
            state.tier1, state.tier1_len,
            torch.from_numpy(np.ascontiguousarray(queries)).to(state.device),
            model.term_embed.weight.detach(), model.doc_embed.weight.detach(),
            state.tau, float(model.bias), max_candidates=most)


def two_tier_guaranteed(dfs: np.ndarray, queries: np.ndarray, k: int, *, with_model: bool
                        ) -> np.ndarray:
    """Fig-3 correctness guarantee per query -> (Q,) bool.

    with model:   ≥1 term has a complete tier-1 list (df ≤ k)     (paper §3.2)
    without:      ALL terms must have complete lists.
    """
    queries = np.asarray(queries)
    valid = queries >= 0
    complete = np.asarray(dfs)[np.maximum(queries, 0)] <= k
    if with_model:
        return (complete & valid).any(axis=1)
    return (complete | ~valid).all(axis=1) & valid.any(axis=1)


# ---------------------------------------------------------------- Algorithm 3
@torch.no_grad()
def block_query(state: EngineState, queries: np.ndarray) -> torch.Tensor:
    """(Q, T) -> (Q, words) packed candidates: f_hat ANDed over the query's
    terms, kept only in blocks that survive the block-bitmap AND.

    One upload of the (Q, T) term ids, their slots in the compact row
    table and the valid slots' term ids and queries; one masked
    ``membership`` launch (with a head, ``mlp_membership``) that scores
    the valid slots in their live blocks only; one ``block_candidates``
    launch for the rest."""
    Q, T = queries.shape
    dev = state.device
    terms2d, slots2d, slot_terms, slot_query = _slot_upload(queries, dev)
    words = -(-state.n_docs // LANE)
    if len(slot_terms):
        terms = slot_terms.long()
        live = LiveBlocks(state.block_bitmaps, terms2d, slot_query, state.block_size)
        rows = score_slots(state.model, terms, state.tau[terms], live=live)
    else:
        rows = torch.zeros((0, words), dtype=torch.int32, device=dev)
    with trace.span("kernel.bitset", queries=Q, terms=T, words=words):
        cand, _, _ = block_candidates(state.block_bitmaps, terms2d, slots2d, rows, state.n_docs,
                                      state.block_size)
    return cand


# ---------------------------------------------------------------- dispatch
def run_queries(state: EngineState, queries: np.ndarray, algorithm: str) -> torch.Tensor:
    """-> (Q, words) packed candidate bitmap on the state's device."""
    queries = np.asarray(queries, dtype=np.int32)
    if algorithm == "exhaustive":
        return exhaustive_query(state, queries)
    if algorithm == "block":
        return block_query(state, queries)
    if algorithm == "two_tier":
        return two_tier_query(state, queries)
    raise ValueError(f"unknown algorithm {algorithm!r}")

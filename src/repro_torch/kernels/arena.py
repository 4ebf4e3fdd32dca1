"""Device-resident impact arena: a shard's ranked scoring table, uploaded once.

``DeviceArena`` holds one shard's decoded term impacts as a dense
``(n_terms + 1, n_docs)`` table on the shard's device (row t = term t's
quantized impact per local doc, zero where absent; the extra row is an
all-zero pad target for -1 query slots).  It is the input of the dense
ranked loop (kernels.fused_query.dense): scoring a batch is a row gather
plus a sum over the term axis.  The dense layout trades memory for launch
shape, so it is built only while ``n_docs <= DENSE_MAX_DOCS`` and
``(n_terms + 1) * n_docs <= DENSE_MAX_CELLS`` — the reference's caps, so
both packages route every item the same way.  It is built lazily on the
first fused use (decoding is startup cost, not serving).

``counters`` prove residence: ``uploads``/``upload_bytes`` move only while
the arena is built, ``hits`` on every dense pass that reused it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.obs import trace
from repro_torch.postings.search import byte_chunks

# the dense loop keeps a (Q, n_docs) int32 accumulator plus the impact table
# in device memory; past these sizes the bucketed kernel path wins
DENSE_MAX_DOCS = 1 << 17
DENSE_MAX_CELLS = 1 << 26  # (n_terms + 1) * n_docs cap (64 MB at uint8)


@dataclass
class ArenaCounters:
    uploads: int = 0  # host-to-device copies (arena build only)
    upload_bytes: int = 0
    hits: int = 0  # dense passes served from the resident table

    def as_dict(self) -> dict[str, int]:
        return {
            "uploads": int(self.uploads),
            "upload_bytes": int(self.upload_bytes),
            "hits": int(self.hits),
        }


def _impact_dtype(max_impact: int):
    if max_impact <= np.iinfo(np.uint8).max:
        return np.uint8
    if max_impact <= np.iinfo(np.int16).max:
        return np.int16  # torch has no uint16 arithmetic on every device
    return np.int32


@dataclass
class DeviceArena:
    """One shard's device-resident ranked-scoring table."""

    n_docs: int
    n_terms: int
    table: torch.Tensor  # (n_terms + 1, n_docs) on the device, smallest impact dtype
    host_lens: np.ndarray  # (n_terms,) int64 — lane counting stays host-side
    counters: ArenaCounters = field(default_factory=ArenaCounters)

    @classmethod
    def eligible(cls, n_terms: int, n_docs: int) -> bool:
        return (
            0 < n_docs <= DENSE_MAX_DOCS
            and (n_terms + 1) * n_docs <= DENSE_MAX_CELLS
        )

    @classmethod
    def build(cls, src, n_terms: int, n_docs: int, device: torch.device) -> "DeviceArena":
        """Decode every non-empty term through ``src`` (a RankedSource) and
        upload the dense impact table to ``device``."""
        lens = np.zeros(n_terms, np.int64)
        table = np.zeros((n_terms + 1, n_docs), np.int32)
        max_imp = 0
        terms = [t for t in range(n_terms) if src.n(t) > 0]
        for chunk in byte_chunks(terms, [4 * src.n(t) for t in terms]):
            with src.prefetch(chunk):  # one decode launch per kernel a chunk
                for t in chunk:
                    ids, q = src.full(t)
                    lens[t] = len(ids)
                    table[t, np.asarray(ids, np.int64)] = q
                    if len(q):
                        max_imp = max(max_imp, int(np.max(q)))
        table = table.astype(_impact_dtype(max_imp))
        with trace.span("arena.upload", terms=int((lens > 0).sum()), lanes=int(lens.sum()),
                        bytes=int(table.nbytes)):
            arena = cls(
                n_docs=int(n_docs),
                n_terms=int(n_terms),
                table=torch.from_numpy(table).to(device),
                host_lens=lens,
            )
        arena.counters.uploads = 1
        arena.counters.upload_bytes = int(table.nbytes)
        return arena

    @property
    def itemsize(self) -> int:
        return int(self.table.element_size())

    def lanes(self, terms) -> int:
        """Total postings lanes the given term ids cover (host-side count)."""
        return int(self.host_lens[np.asarray(terms, np.int64)].sum()) if len(terms) else 0

"""Serving configuration: the engine-core flags of the reference's
ServeConfig, its ranked sub-config, plus the device the engine runs on.

``use_kernel`` and ``guided_kernel`` are accepted for parity with the
reference but select nothing here: on a CUDA device candidate masks, guided
probes and decodes always run on the port's kernels, and on the CPU always
on their plain versions.  ``ranked`` takes a ``RankedConfig`` or a dict of
its fields.  The reference's observability and scheduler sub-configs belong
to later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RankedConfig:
    """Ranked (BM25 top-k) tier knobs, with the reference's defaults."""

    enabled: bool = True  # build payload streams when the index carries tfs
    payload_bits: int = 8  # quantized-impact width (BM25Params.bits)
    # queries whose total postings fit under this skip MaxScore bookkeeping
    # and score exhaustively (still exact); 0 forces pruning everywhere
    topk_exhaustive_cutoff: int = 2048
    score_kernel: bool = False  # score exhaustive queries on the bm25_score kernel
    # answer each shard's ranked batch with fused_topk launches (one per
    # candidate bucket) instead of the multi-phase probe/unpack/score/select
    # pipeline; bit-identical, with the multi-phase path as oracle
    fused_kernel: bool = False
    # keep a device-resident impact arena per shard (kernels.arena) so the
    # fused path answers no-required-term items with the dense loop; built
    # lazily on first fused use, only while the shard fits the size caps
    device_arena: bool = True


@dataclass
class ServeConfig:
    algorithm: str = "block"  # 'block' (Alg. 3) | 'two_tier' (Alg. 2) | 'exhaustive' (Alg. 1)
    verified: bool = True  # re-check candidates exactly against tier-2
    use_kernel: bool = False  # accepted for parity; see module doc
    max_query_terms: int = 8
    postings_store: str = "hybrid"  # tier-2: "hybrid" (compressed) | "raw"
    use_guided: bool = True  # model-guided contains() probes
    guided_kernel: bool = False  # accepted for parity; see module doc
    cache_budget_bytes: int = 32 << 20  # decode-cost budget per shard LRU
    n_shards: int = 1  # document partitions (contiguous, 32-aligned)
    device: str = "cuda"  # where candidate masks, probes, decodes and scoring run
    ranked: RankedConfig = field(default_factory=RankedConfig)

    def __post_init__(self):
        if isinstance(self.ranked, dict):
            self.ranked = RankedConfig(**self.ranked)
        elif not isinstance(self.ranked, RankedConfig):
            raise TypeError(f"ranked must be a RankedConfig or a dict, got {self.ranked!r}")

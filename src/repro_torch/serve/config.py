"""Serving configuration: the engine-core flags of the reference's
ServeConfig, plus the device the engine runs on.

``use_kernel`` and ``guided_kernel`` are accepted for parity with the
reference but select nothing here: on a CUDA device candidate masks, guided
probes and learned-codec decodes always run on the port's kernels, and on
the CPU always on their plain versions.  The reference's observability,
ranked and scheduler sub-configs belong to later slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ServeConfig:
    algorithm: str = "block"  # 'block' (Algorithm 3) | 'exhaustive' (Algorithm 1)
    verified: bool = True  # re-check candidates exactly against tier-2
    use_kernel: bool = False  # accepted for parity; see module doc
    max_query_terms: int = 8
    postings_store: str = "hybrid"  # tier-2: "hybrid" (compressed) | "raw"
    use_guided: bool = True  # model-guided contains() probes
    guided_kernel: bool = False  # accepted for parity; see module doc
    cache_budget_bytes: int = 32 << 20  # decode-cost budget per shard LRU
    n_shards: int = 1  # document partitions (contiguous, 32-aligned)
    device: str = "cuda"  # where candidate masks, probes and decodes run

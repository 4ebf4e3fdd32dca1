"""Typed, frozen configs for the port (the reference's config system, less
the LM-side ``ArchConfig``, ``MeshConfig`` and ``ShapeSpec``).  Plain data,
no torch."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    # 'fp32' | 'int8' — int8 moments with per-256-element fp32 absmax scales
    moment_dtype: str = "fp32"
    compress_grads: bool = False  # accepted for parity; single-device here


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatch: int | None = None  # grad accumulation if < global_batch/dp
    remat: str = "none"  # 'none' | 'full' | 'dots' (checkpoint policy)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
    # straggler mitigation: abort+log if a step exceeds this multiple of the
    # trailing median step time
    straggler_factor: float = 3.0


@dataclass(frozen=True)
class LearnedIndexConfig:
    """Config for the paper's contribution (core/)."""

    algorithm: str = "two_tier"  # 'exhaustive' | 'two_tier' | 'block'
    embed_dim: int = 128  # paper's s=512bit worst case = 128 fp32 units
    mlp_hidden: tuple[int, ...] = ()  # () = pure dot-product model
    truncation_k: int = 4000  # two-tier tier-1 list length
    block_size: int = 1024  # block-based approach: docs per block
    replace_df_threshold: int = 4000  # terms with df>k get replaced by f
    guarantee: bool = True  # zero-FN threshold + exact backup set
    threshold: float = 0.5
    train_negatives_per_positive: int = 4
    model_bits_per_pair: float = 512.0  # 's' in Eq.(2), upper bound


@dataclass(frozen=True)
class CorpusConfig:
    """Synthetic Zipf-Mandelbrot collection calibrated to a TREC target."""

    name: str = "robust-like"
    n_docs: int = 5280  # Robust05 |D|=528k scaled 1/100
    n_terms: int = 60_000
    avg_doc_len: int = 230
    zipf_a: float = 1.2
    zipf_b: float = 2.7
    seed: int = 7


PAPER_COLLECTIONS: Mapping[str, CorpusConfig] = {
    # scaled 1/100 from published sizes; scale=1.0 reproduces full scale
    "robust": CorpusConfig(name="robust-like", n_docs=5280, n_terms=60_000, avg_doc_len=230),
    "gov2": CorpusConfig(name="gov2-like", n_docs=252_000, n_terms=390_000, avg_doc_len=410),
    "clueweb": CorpusConfig(name="clueweb-like", n_docs=502_000, n_terms=960_000, avg_doc_len=380),
}


def scaled_collection(base: CorpusConfig, scale: float) -> CorpusConfig:
    return dataclasses.replace(
        base,
        n_docs=max(64, int(base.n_docs * scale)),
        n_terms=max(256, int(base.n_terms * scale)),
    )

"""Typed, frozen configs for the port (the reference's config system, cut to
the classes the Boolean serving slice reads).  Plain data, no torch."""
from __future__ import annotations

from dataclasses import dataclass


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
    moment_dtype: str = "fp32"  # the port keeps fp32 moments only
    compress_grads: bool = False  # accepted for parity; single-device here


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
